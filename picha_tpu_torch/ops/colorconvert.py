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
  `convert_batch`      the reference's `convert_batch` (`_jit_convert`):
                       one K11 launch per batch
  `color_convert_image` the Image-level op: a same-format request is a
                       copy, otherwise one K11 launch on the device
"""
from __future__ import annotations

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
    require_cuda(x, "K11")
    if x.dim() != 4 or x.dtype not in _KIND:
        raise TypeError("K11 takes an (N, H, W, C) uint8, uint16 or float32 "
                        "tensor")
    if out_dtype not in _KIND or (clip and out_dtype != torch.float32):
        raise TypeError(f"K11 writes uint8, uint16 or float32 (clip only "
                        f"float32), not {out_dtype}")
    n, h, w, c = x.shape
    x0, y0, cw, ch = _window(x, crop)
    if not (1 <= c <= 4 and 1 <= dst_channels <= 4):
        raise ValueError(f"K11 maps 1-4 channels, not {c} -> {dst_channels}")
    if x0 < 0 or y0 < 0 or cw < 1 or ch < 1 or x0 + cw > w or y0 + ch > h:
        raise ValueError(f"K11: crop {crop} outside the {w}x{h} frame")
    wr, wg, wb = weights or normalize_weights()
    x = x.contiguous()
    out = torch.empty((n, ch, cw, dst_channels), dtype=out_dtype,
                      device=x.device)
    out_kind = 3 if clip else _KIND[out_dtype]
    KERNELS["pixel_map"](ptr(x), _KIND[x.dtype], n, h, w, c, y0, x0, ch,
                         cw, dst_channels, out_kind, float(wr), float(wg),
                         float(wb), ptr(out), stream_of(x))
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
