"""Pixel-format conversion, and kernel K11 (unpack, crop, channel map,
pack).

Counterpart of `picha_tpu/ops/colorconvert.py`: unpack -> channel map ->
pack over a normalised-float intermediate, with the reference's channel
table (grey replicated, luma reduction with weights renormalised to sum
1, alpha kept or synthesised as 1.0, alpha dropped on -> rgb, and
greya -> rgb as [g, g, g], the reference's deliberate deviation).

  `normalize_weights`  a copy of the reference's (pinned by
                       tests/test_torch_host_copies.py)
  `map_channels`       the channel table on a float32 (..., C) tensor:
                       the plain version of K11's map
  `pixel_map`          kernel K11 (`csrc/pixel_map.cu`) for CUDA
                       tensors, `pixel_map_plain` for CPU tensors:
                       (N, H, W, C) uint8 / uint16 / float32, optional
                       crop window -> channel map -> uint8 / uint16
                       (pack), float32, or float32 clipped to [0, 1]
  `map_plan`           K11's cut of the window into segments and work
                       items within the kernel's limits (a pure host
                       function, modelled in numpy by
                       tests/test_torch_pixel_map_tiles.py)
  `staging`            those limits, read from the library
  `kernel_info`        the plan, grid and build of a K11 call, from the
                       card
  `convert_batch`      the reference's `convert_batch` (`_jit_convert`):
                       one K11 launch per batch
  `color_convert_image` the Image-level op: a same-format request is a
                       copy, otherwise one K11 launch on the device
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..errors import InvalidImageError, InvalidOptionsError
from ..image import Image
from ..kernels._build import KERNELS, ptr, require_cuda, stream_of
from ..pixels import TORCH_DTYPE, pack_f32, pixel_format, unpack_f32
from ..runtime.device import resolve_device, to_device

DEFAULT_WEIGHTS = (0.299, 0.587, 0.114)


def normalize_weights(red=None, green=None, blue=None):
    """Apply defaults then renormalise to sum 1. A NaN weight keeps its
    default (as the reference's getSettings); a non-numeric one raises
    InvalidOptionsError; weights summing to zero raise too."""

    def coerce(v, default):
        if v is None:
            return default
        try:
            v = float(v)
        except (TypeError, ValueError) as e:
            raise InvalidOptionsError("invalid colour weight") from e
        return default if math.isnan(v) else v

    r = coerce(red, DEFAULT_WEIGHTS[0])
    g = coerce(green, DEFAULT_WEIGHTS[1])
    b = coerce(blue, DEFAULT_WEIGHTS[2])
    if r + g + b == 0:
        raise InvalidOptionsError("colour weights must not sum to zero")
    n = 1.0 / (r + g + b)
    return (np.float32(r * n), np.float32(g * n), np.float32(b * n))


def map_channels(x, src_channels: int, dst_channels: int, weights):
    """Map a float32 (..., src_channels) tensor to (..., dst_channels) by
    the reference's table; the luma is t0*wr + t1*wg + t2*wb, each
    product and sum rounded to f32 in that order."""
    sc, dc = src_channels, dst_channels
    if sc == dc:
        return x
    wr, wg, wb = (float(w) for w in weights)

    def luma():
        return (x[..., 0] * wr + x[..., 1] * wg + x[..., 2] * wb)[..., None]

    def ones():
        return torch.ones_like(x[..., :1])

    if sc == 1:
        grey = x[..., 0:1]
        if dc == 2:
            return torch.cat([grey, ones()], -1)
        if dc == 3:
            return torch.cat([grey, grey, grey], -1)
        if dc == 4:
            return torch.cat([grey, grey, grey, ones()], -1)
    elif sc == 2:
        grey, alpha = x[..., 0:1], x[..., 1:2]
        if dc == 1:
            return grey
        if dc == 3:
            return torch.cat([grey, grey, grey], -1)
        if dc == 4:
            return torch.cat([grey, grey, grey, alpha], -1)
    elif sc == 3:
        if dc == 1:
            return luma()
        if dc == 2:
            return torch.cat([luma(), ones()], -1)
        if dc == 4:
            return torch.cat([x, ones()], -1)
    elif sc == 4:
        if dc == 1:
            return luma()
        if dc == 2:
            return torch.cat([luma(), x[..., 3:4]], -1)
        if dc == 3:
            return x[..., :3]
    raise InvalidOptionsError(f"no conversion {sc} -> {dc} channels")


def _window(x, crop):
    """(x0, y0, w, h) of the crop window, the whole frame when None."""
    if crop is None:
        return 0, 0, x.shape[2], x.shape[1]
    return tuple(int(v) for v in crop)


def pixel_map_plain(x, dst_channels: int, out_dtype, crop=None,
                    clip: bool = False, weights=None):
    """Plain torch version of K11: crop -> unpack -> map -> pack (uint8,
    uint16), or float32 as mapped, or clipped to [0, 1] (`clip`)."""
    x0, y0, w, h = _window(x, crop)
    f = unpack_f32(x[:, y0:y0 + h, x0:x0 + w])
    f = map_channels(f, x.shape[-1], dst_channels,
                     weights or normalize_weights())
    if out_dtype == torch.float32:
        return f.clamp(0.0, 1.0) if clip else f
    return pack_f32(f, out_dtype)


_KIND = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}  # K11's codes
_BYTES = {torch.uint8: 1, torch.uint16: 2, torch.float32: 4}
_INFO_KEYS = ("compiled_in", "registers", "local_bytes", "shared_bytes",
              "threads", "blocks_an_sm", "sms", "builds", "stage_in_bytes",
              "stage_out_bytes", "max_rows", "chunk_bytes")


def row_words(span: int, bpi: int) -> int:
    """Words of 16 bytes K11 stages for a row of `span` pixels of `bpi`
    bytes: its bytes at any shift 0-15 into its first word."""
    return (30 + span * bpi) >> 4


@functools.lru_cache(maxsize=256)
def map_plan(n, h, w, sc, y0, x0, oh, ow, dc, in_bytes, out_bytes,
             limits) -> dict:
    """K11's plan for the window (x0, y0, ow, oh) of (n, h, w, sc) pixels
    of `in_bytes` a channel to dc channels of `out_bytes`: the window cut
    into segments of contiguous input pixels (a crop row; an image where
    the window takes whole rows; the batch where it takes the frame),
    their input offsets in elements (segment s at base + (s //
    segs_per_img) * img_stride + (s % segs_per_img) * row_stride), and
    the work items: chunks of `chunk` pixels of a segment (rows 1), or
    `rows` whole segments where a segment fits a chunk. `limits`: the
    bytes an item's staged rows and staged output hold, the segments an
    item and the bytes a chunk's input or output fills (`staging()`)."""
    stage_in, _stage_out, max_rows, chunk_bytes = limits
    if ow == w and oh == h:
        seg_len, segs, spi, img_stride, row_stride, base = n * h * w, 1, 1, 0, \
            0, 0
    elif ow == w:
        seg_len, segs, spi, img_stride, row_stride, base = oh * w, n, 1, \
            h * w * sc, 0, y0 * w * sc
    else:
        seg_len, segs, spi, img_stride, row_stride, base = ow, n * oh, oh, \
            h * w * sc, w * sc, (y0 * w + x0) * sc
    bpi, bpo = sc * in_bytes, dc * out_bytes
    chunk = chunk_bytes // max(bpi, bpo) // 16 * 16
    if seg_len > chunk:
        rows, cps = 1, -(-seg_len // chunk)
    else:
        rows = min(max_rows, chunk // seg_len,
                   stage_in // (16 * row_words(seg_len, bpi)))
        cps = 1
    return dict(seg_len=seg_len, segs=segs, segs_per_img=spi,
                img_stride=img_stride, row_stride=row_stride, base=base,
                cps=cps, items=-(-segs // rows) * cps, chunk=chunk, rows=rows)


_PLAN_KEYS = ("seg_len", "segs", "segs_per_img", "img_stride", "row_stride",
              "base", "cps", "items", "chunk", "rows")


def _info(in_kind, out_kind, sc, dc) -> dict:
    """`picha_pixel_map_info` of a signature on the current card."""
    from ..kernels._build import library

    out = (ctypes.c_int * len(_INFO_KEYS))()
    rc = library().picha_pixel_map_info(in_kind, out_kind, sc, dc, out)
    if rc != 0:
        raise RuntimeError(f"picha_pixel_map_info: CUDA error {rc}")
    return dict(zip(_INFO_KEYS, out))


@functools.lru_cache(maxsize=None)
def staging() -> tuple:
    """K11's limits (csrc/pixel_map.cu), asked of the library once: the
    bytes an item's staged rows and staged output hold, the segments an
    item, the bytes a chunk's input or output fills."""
    info = _info(0, 0, 1, 1)
    return tuple(info[k] for k in _INFO_KEYS[8:])


def _args(x, dst_channels, out_dtype, crop, clip):
    """K11's checks -> (plan, in_kind, out_kind, window) of a call."""
    require_cuda(x, "K11")
    if x.dim() != 4 or x.dtype not in _KIND:
        raise TypeError("K11 takes an (N, H, W, C) uint8, uint16 or float32 "
                        "tensor")
    if out_dtype not in _KIND or (clip and out_dtype != torch.float32):
        raise TypeError(f"K11 writes uint8, uint16 or float32 (clip only "
                        f"float32), not {out_dtype}")
    n, h, w, c = x.shape
    window = x0, y0, cw, ch = _window(x, crop)
    if not (1 <= c <= 4 and 1 <= dst_channels <= 4):
        raise ValueError(f"K11 maps 1-4 channels, not {c} -> {dst_channels}")
    if x0 < 0 or y0 < 0 or cw < 1 or ch < 1 or x0 + cw > w or y0 + ch > h:
        raise ValueError(f"K11: crop {crop} outside the {w}x{h} frame")
    plan = map_plan(n, h, w, c, y0, x0, ch, cw, dst_channels,
                    _BYTES[x.dtype], _BYTES[out_dtype], staging())
    return plan, _KIND[x.dtype], 3 if clip else _KIND[out_dtype], window


def kernel_info(x, dst_channels: int, out_dtype, crop=None,
                clip: bool = False) -> dict:
    """The plan (`map_plan`), grid and build of `pixel_map(x, ...)` on x's
    card: whether its channel counts are compiled in, the build's
    registers, local bytes, shared bytes, threads and blocks an SM, the
    SMs, the grid (the items, at most the blocks the card holds at once),
    the kernels the library holds for K11 (`builds`) and its limits
    (`staging`)."""
    plan, in_kind, out_kind, _ = _args(x, dst_channels, out_dtype, crop,
                                       clip)
    with torch.cuda.device(x.device):
        info = _info(in_kind, out_kind, x.shape[-1], dst_channels)
    info["compiled_in"] = bool(info["compiled_in"])
    return dict(plan=plan, grid=min(plan["items"],
                                    info["blocks_an_sm"] * info["sms"]),
                **info)


def pixel_map(x, dst_channels: int, out_dtype, crop=None, clip: bool = False,
              weights=None):
    """(N, H, W, C) uint8, uint16 or float32 pixels -> (N, h, w,
    dst_channels): the crop window `crop` = (x0, y0, w, h) (the whole
    frame when None), unpacked to [0, 1] (v / MAX; float32 as it is),
    mapped from C to dst_channels channels by the reference's table with
    the luma `weights` (the defaults when None), then packed to
    `out_dtype` uint8 / uint16, or kept float32 (clipped to [0, 1] with
    `clip`). Launches K11 for CUDA tensors; the plain version runs only
    for CPU tensors."""
    if x.device.type == "cpu":
        return pixel_map_plain(x, dst_channels, out_dtype, crop, clip,
                               weights)
    plan, in_kind, out_kind, (_x0, _y0, cw, ch) = _args(
        x, dst_channels, out_dtype, crop, clip)
    n, c = x.shape[0], x.shape[-1]
    wr, wg, wb = weights or normalize_weights()
    x = x.contiguous()
    out = torch.empty((n, ch, cw, dst_channels), dtype=out_dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    KERNELS["pixel_map"](ptr(x), in_kind, c, dst_channels, out_kind,
                         *(plan[k] for k in _PLAN_KEYS), float(wr),
                         float(wg), float(wb), ptr(out), stream_of(x))
    return out


def convert_batch(arr, src_pixel: str, dst_pixel: str, *, red_weight=None,
                  green_weight=None, blue_weight=None, device="cuda"):
    """(N, H, W, C) (or (H, W, C)) pixels of `src_pixel` -> `dst_pixel`
    as a tensor on `device`: one K11 launch (unpack -> map -> pack) on a
    CUDA device, its plain version on the CPU. numpy input is
    uploaded; a tensor moves to `device`."""
    weights = normalize_weights(red_weight, green_weight, blue_weight)
    src_fmt, dst_fmt = pixel_format(src_pixel), pixel_format(dst_pixel)
    x = to_device(arr, resolve_device(device))
    single = x.dim() == 3
    if single:
        x = x[None]
    if x.dim() != 4 or x.shape[-1] != src_fmt.channels \
            or x.dtype != TORCH_DTYPE[src_fmt.dtype]:
        raise InvalidImageError(
            f"{tuple(x.shape)} {x.dtype} pixels are not {src_pixel}")
    out = pixel_map(x, dst_fmt.channels, TORCH_DTYPE[dst_fmt.dtype],
                    weights=weights)
    return out[0] if single else out


def color_convert_image(img: Image, opts: dict, device="cuda") -> Image:
    """Image-level colorConvert: a same-format request is a plain copy;
    otherwise the image goes through `convert_batch` on `device`."""
    dst_pixel = opts.get("pixel")
    if dst_pixel is None:
        raise InvalidOptionsError("colorConvert requires opts['pixel']")
    if dst_pixel == img.pixel:
        return img.clone()
    src_fmt = img.format
    dst_fmt = pixel_format(dst_pixel)
    if src_fmt.channels == dst_fmt.channels and src_fmt.dtype == dst_fmt.dtype:
        # same geometry, different name cannot happen among the 8 formats
        raise InvalidImageError("inconsistent pixel formats")
    out = convert_batch(
        img.to_array(), img.pixel, dst_pixel,
        red_weight=opts.get("redWeight", opts.get("red_weight")),
        green_weight=opts.get("greenWeight", opts.get("green_weight")),
        blue_weight=opts.get("blueWeight", opts.get("blue_weight")),
        device=device)
    return Image.from_array(out.cpu().numpy(), dst_pixel)
