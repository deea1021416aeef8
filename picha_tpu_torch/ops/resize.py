"""Separable image resize on the device.

Counterpart of `picha_tpu/ops/resize.py` (`_apply_axis`, `resize_f32`).
The weights come from `ops/resize_weights.py` (`resize_weights`,
`banded_resize_plan`, `resize_windows`: the port's copies of the
reference's weight functions), so the taps are the reference's float32 values;
the caller uploads them once per configuration.

  `resize_f32_plain`            the reference's semantics: per axis a
                                dense einsum at a source <= 512, the
                                banded tile plan above, in full f32
  `resize_axis_windowed_plain`  the plain twin of kernel K8: the same
                                taps, accumulated per output in window
                                order
  `resize_axis`                 one axis: K8's per-axis kernels
                                (`csrc/resize_axis.cu`: resize_rows for
                                the width pass, resize_cols for the
                                height pass) for CUDA tensors, the
                                windowed twin for CPU tensors
  `resize_windowed`             width pass, then height pass: K8's
                                one-launch kernel (resize_2d) for CUDA
                                tensors where `resize_plan` fits a tile
                                in shared memory, else `resize_axis`
                                twice; the twin twice for CPU tensors
  `resize_plan`, `axis_plan`    the tiles of those kernels, planned on
                                the host from the windows and the card
                                (from `starts_host`: the starts' host
                                copy `window_tensors` records)
  `kernel_info`                 K8's plan and builds at a call's shapes
  `resize_f32`                  the same with the windows built here
  `crop_resize_map`             the pixel-array chain: K11 (unpack
                                v / MAX, crop window) -> K8 (both axes,
                                `resize_windowed`) -> K11 (channel map,
                                pack or clip); one K11 launch without a
                                resize
  `resize_batch`                the reference's `_jit_resize` through
                                that chain, uint8 or uint16 in and out
  `resize_array`, `resize_image` the single-image API on the device (the
                                reference's native host resize has no
                                counterpart here)
  `crop_flip_resize`            the training ingest's per-image crop,
                                horizontal flip and both resize passes:
                                K9, resize_2d's crop mode in one launch
                                (`csrc/resize_axis.cu`), for CUDA tensors
                                where `resize_plan` fits a tile, else
                                the per-axis route below;
                                `crop_flip_resize_plain` (the flipped
                                crops, then K8's twin on each axis) for
                                CPU tensors
  `crop_flip_resize_w`          the per-axis route's crop, flip and width
                                pass (`csrc/crop_resize.cu`), then
                                `resize_axis` for the height;
                                `crop_flip_resize_w_plain` for CPU
                                tensors
  `crop_kernel_info`            K9's plan and build at a call's shapes

Tensors are (N, H, W, C); the width axis is -2 and the height axis -3,
as in the reference. K8 unpacks a uint8 input as v * f32(1/255) before
any tap (the decode paths' rule); `resize_batch` unpacks with K11's IEEE
division first, as the reference's `junpack_f32` does.
"""
from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from ..errors import InvalidImageError, InvalidOptionsError
from ..image import Image
from ..kernels._build import KERNELS, ptr, require_cuda, stream_of
from ..runtime.device import resolve_device, to_device
from .colorconvert import pixel_map
from .jpeg import full_fp32
from .resize_weights import (BANDED_THRESHOLD, banded_resize_plan,
                             parse_resize_options, resize_weights,
                             resize_windows)

INV255 = float(np.float32(1.0 / 255.0))


def _apply_axis_plain(x, dst_size, src_size, filter_name, fscale, axis):
    """One axis of a float32 (N, H, W, C) tensor, as the reference's
    `_apply_axis` computes it."""
    dev = x.device
    x2 = x.movedim(axis, -2)                        # (..., L, C)
    if src_size <= BANDED_THRESHOLD:
        w = torch.as_tensor(resize_weights(dst_size, src_size, filter_name,
                                           fscale), device=dev)
        with full_fp32():
            out = torch.matmul(w, x2)               # (..., dst, C)
        return out.movedim(-2, axis)
    starts, weights, dst_pad = banded_resize_plan(dst_size, src_size,
                                                  filter_name, fscale)
    in_len = weights.shape[2]
    idx = (torch.as_tensor(starts, dtype=torch.int64, device=dev)[:, None]
           + torch.arange(in_len, device=dev))      # (T, in_len)
    g = x2.index_select(-2, idx.reshape(-1))
    g = g.reshape(*x2.shape[:-2], len(starts), in_len, x2.shape[-1])
    with full_fp32():
        out = torch.matmul(torch.as_tensor(weights, device=dev), g)
    out = out.reshape(*x2.shape[:-2], dst_pad, x2.shape[-1])[..., :dst_size, :]
    return out.movedim(-2, axis)


def resize_f32_plain(x, dst_w, dst_h, filter_name, fscale):
    """The reference's `resize_f32`: float32 (N, H, W, C) -> (N, dst_h,
    dst_w, C), horizontal then vertical."""
    src_h, src_w = x.shape[-3], x.shape[-2]
    tmp = _apply_axis_plain(x, dst_w, src_w, filter_name, fscale, -2)
    return _apply_axis_plain(tmp, dst_h, src_h, filter_name, fscale, -3)


def resize_axis_windowed_plain(x, starts, taps, axis, out_scale=1.0):
    """Plain torch version of K8: out[o] = out_scale * sum_j taps[o, j] *
    v[starts[o] + j], with v = x (float32) or x * f32(1/255) (uint8),
    products and sums each rounded to f32 in j order. starts (dst,)
    int32, taps (dst, k) float32 on x's device."""
    v = x.to(torch.float32)
    if x.dtype == torch.uint8:
        v = v * INV255
    v = v.movedim(axis, -2)                         # (..., L, C)
    st = starts.to(torch.int64)
    acc = None
    for j in range(taps.shape[1]):
        term = taps[:, j, None] * v.index_select(-2, st + j)
        acc = term if acc is None else acc + term
    if out_scale != 1.0:
        acc = acc * out_scale
    return acc.movedim(-2, axis)


# -- K8's plans ------------------------------------------------------------
# The kernels' constants (csrc/resize_axis.cu): threads a block, rows a
# block of resize_rows takes.
THREADS = 256
ROWS = 4
STATIC_SMEM = 64   # bytes a block the plans leave for static shared memory


def tile_2d(c: int) -> int:
    """resize_2d's output columns a tile at c channels: tx * c at most a
    block's threads (one width-pass column a thread) and a multiple of 4
    (the height pass's float4 quads)."""
    return THREADS // c // 4 * 4


def tile_rows(c: int) -> int:
    """resize_rows's outputs a tile at c channels: 4 outputs a thread."""
    return 4 * THREADS // c // 4 * 4


def tile_spans(starts, k: int, tile: int):
    """Per tile of `tile` consecutive outputs: (lo, hi), the source
    span [lo, hi) its windows read, from the min and the max of its
    starts (no monotone windows assumed), as the kernels take it."""
    st = np.asarray(starts, np.int64)
    pad = -len(st) % tile
    lo = np.concatenate([st, np.full(pad, st.max())]).reshape(-1, tile)
    hi = np.concatenate([st, np.full(pad, st.min())]).reshape(-1, tile)
    return lo.min(1), hi.max(1) + k


def _chunks(elems: int, elem_bytes: int) -> int:
    # 16-byte words that cover a span of `elems` elements at any alignment
    return (15 + elems * elem_bytes + 15) // 16


def _blocks_an_sm(smem: int, card: dict) -> int:
    by_smem = card["smem_sm"] // (smem + STATIC_SMEM + card["reserved"])
    by_regs = 65536 // (max(card["registers"], 1) * THREADS)
    return min(2048 // THREADS, by_smem, by_regs)


def axis_plan(starts, k: int, inner: int, card: dict,
              elem_bytes: int = 1) -> dict:
    """resize_rows's plan (one axis, inner <= 4): `tile` outputs a
    block of ROWS rows, `span_chunks` 16-byte words of staged source span
    a row (0: the spans and the taps do not fit `card`'s shared memory a
    block, and the kernel reads global memory), `smem` bytes."""
    tile = tile_rows(inner)
    lo, hi = tile_spans(starts, k, tile)
    chunks = _chunks(int((hi - lo).max()) * inner, elem_bytes)
    smem = ROWS * chunks * 16 + tile * (k + 1) * 4
    if smem + STATIC_SMEM > card["smem_block"]:
        chunks = smem = 0
    return dict(tile=tile, span_chunks=chunks, smem=smem)


def resize_plan(sw, kw: int, sh, kh: int, c: int, card: dict,
                elem_bytes: int = 1) -> dict:
    """K8's route for both axes of an (N, H, W, c) resize with width
    starts `sw` (kw taps) and height starts `sh` (kh taps), host arrays.
    `card`: smem_block (opt-in shared bytes a block), smem_sm (a
    multiprocessor's), reserved (the runtime's a block), registers
    (resize_2d's a thread); elem_bytes: the input's (1 uint8, 4 f32).

    One launch (resize_2d) takes tiles of tx = `tile_2d(c)` output
    columns (fewer where the width is narrower) by ty output rows; a
    tile's shared memory holds its f32 intermediate (rows_max source
    rows x tx * c), its rows_max source rows staged as span_chunks
    16-byte words of raw input each, and its taps, starts and shifts. Of
    ty in 32, 16, ..., 1 whose tile fits a block, the plan takes the one
    with the most min(blocks an SM, 3) x ty / rows_max (resident warps,
    to 24 an SM, times output rows a staged source row), the larger ty
    on a tie: on an H100 the best of ty 2-32 at the transcode's and at
    config 4's shapes (PERF.md §6).
    Where no ty fits (a large downscale with a long window), or c > 4,
    the route is "per_axis": resize_rows for the width, resize_cols for
    the height. The choice depends only on the shapes, the windows and
    the card's shared memory."""
    plan = dict(route="per_axis", tx=0, ty=0, rows_max=0, span_chunks=0,
                smem=0, blocks_an_sm=0)
    if not 1 <= c <= 4:
        return plan
    tx = min(tile_2d(c), -(-len(sw) // 4) * 4)
    xlo, xhi = tile_spans(sw, kw, tx)
    chunks = _chunks(int((xhi - xlo).max()) * c, elem_bytes)
    best = None
    for ty in (32, 16, 8, 4, 2, 1):
        if ty > 1 and ty // 2 >= len(sh):
            continue   # the same single tile as a smaller ty
        ylo, yhi = tile_spans(sh, kh, ty)
        rows = int((yhi - ylo).max())
        smem = rows * chunks * 16 + 4 * (rows * tx * c + tx * kw + ty * kh
                                         + tx + ty + rows)
        if smem + STATIC_SMEM > card["smem_block"]:
            continue
        bps = _blocks_an_sm(smem, card)
        if bps < 1:
            continue
        score = min(bps, 3) * ty / rows
        if best is None or score > best[0]:
            best = (score, dict(route="one_launch", tx=tx, ty=ty,
                                rows_max=rows, span_chunks=chunks,
                                smem=smem, blocks_an_sm=bps))
    return plan if best is None else best[1]


# The starts' host copies by tensor: `window_tensors` records the numpy
# starts it uploads, so a plan never reads them back from the card. An
# entry goes when its tensor is freed (weakref.finalize runs before the
# tensor's id can be reused); starts from elsewhere, or changed in place
# since (their _version), are read back once and recorded.
_HOSTS = {}


def _record(starts, host) -> None:
    host = np.ascontiguousarray(host, dtype=np.int32)
    _HOSTS[id(starts)] = (starts._version, host, host.tobytes())
    weakref.finalize(starts, _HOSTS.pop, id(starts), None)


def starts_host(starts):
    """(host copy, its bytes) of a starts tensor: the copy recorded by
    `window_tensors`, else the tensor read back (a sync)."""
    entry = _HOSTS.get(id(starts))
    if entry is None or entry[0] != starts._version:
        _record(starts, starts.cpu().numpy())
        entry = _HOSTS[id(starts)]
    return entry[1], entry[2]


_CARDS = {}


def card_info(device, which: int, elem_bytes: int, c: int, k: int,
              smem: int = 0) -> dict:
    """`picha_resize_info` of K8's kernel `which` (0 resize_2d, 1
    resize_rows, 2 resize_cols, 3 resize_2d's crop mode: K9) on `device`,
    the build that serves c channels and windows of k taps: registers,
    local bytes, blocks an SM at `smem` dynamic bytes, SMs and the
    shared-memory limits (cached)."""
    from ..kernels._build import library

    key = (device.index, which, elem_bytes, c, k, smem)
    if key not in _CARDS:
        out = (ctypes.c_int * 7)()
        with torch.cuda.device(device):
            rc = library().picha_resize_info(which, elem_bytes, c, k, smem,
                                             out)
        if rc != 0:
            raise RuntimeError(f"picha_resize_info: CUDA error {rc}")
        _CARDS[key] = dict(zip(("registers", "local_bytes", "blocks_an_sm",
                                "sms", "smem_block", "smem_sm", "reserved"),
                               out))
    return _CARDS[key]


def _check_windows(x, starts, taps, src, kernel):
    dst, k = taps.shape
    if starts.dtype != torch.int32 or taps.dtype != torch.float32 \
            or starts.device != x.device or taps.device != x.device \
            or tuple(starts.shape) != (dst,):
        raise TypeError(f"{kernel} takes (dst,) int32 starts and (dst, k) "
                        f"float32 taps on the input's device")
    if k > src:
        raise ValueError(f"{kernel}: window {k} longer than the axis "
                         f"({src})")


def _check_input(x, kernel):
    require_cuda(x, kernel)
    if x.dtype not in (torch.uint8, torch.float32) or x.dim() != 4:
        raise TypeError(f"{kernel} takes an (N, H, W, C) uint8 or float32 "
                        f"tensor")


def resize_axis(x, starts, taps, axis, out_scale=1.0):
    """Resize one axis (-2 width, -3 height) of an (N, H, W, C) uint8 or
    float32 tensor with per-output windows (`resize_windows` as device
    tensors) -> float32. Launches K8's per-axis kernel for CUDA tensors
    (resize_rows where the axis's inner stride is at most 4 elements,
    planned by `axis_plan`; resize_cols otherwise); the plain twin runs
    only for CPU tensors."""
    if x.device.type == "cpu":
        return resize_axis_windowed_plain(x, starts, taps, axis, out_scale)
    _check_input(x, "K8")
    if axis not in (-2, -3):
        raise ValueError(f"K8 resizes axis -2 (width) or -3 (height), "
                         f"not {axis}")
    dst, k = taps.shape
    _check_windows(x, starts, taps, x.shape[axis], "K8")
    x, st, taps = x.contiguous(), starts.contiguous(), taps.contiguous()
    n, h, w, c = x.shape
    src = x.shape[axis]
    outer, inner = (n * h, c) if axis == -2 else (n, w * c)
    shape = (n, h, dst, c) if axis == -2 else (n, dst, w, c)
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    in_scale = INV255 if x.dtype == torch.uint8 else 1.0
    tile, chunks = tile_rows(min(inner, 4)), 0
    if inner <= 4 and out.numel():
        host, key = starts_host(starts)
        p = _cached(("axis", key, k, inner, x.dtype, x.device.index),
                    lambda: axis_plan(host, k, inner,
                                      card_info(x.device, 1, x.element_size(),
                                                inner, k),
                                      x.element_size()))
        tile, chunks = p["tile"], p["span_chunks"]
    KERNELS["resize_axis"](ptr(x), x.element_size(), outer, src, dst, inner,
                           ptr(st), ptr(taps), k, in_scale, out_scale,
                           ptr(out), tile, chunks, stream_of(x))
    return out


def flipped_crops(rgb, xs, ys, flip, crop):
    """(N, H, W, C) images -> (N, crop, crop, C) crops at per-image
    corners (xs, ys), mirrored left-right where `flip`: column c of a
    crop is source column xs + (crop - 1 - c) when flipped, else xs + c.
    Corners are clamped into the frame, as the reference's
    `lax.dynamic_slice` clamps them."""
    n, h, w = rgb.shape[0], rgb.shape[1], rgb.shape[2]
    dev = rgb.device
    ar = torch.arange(crop, device=dev)
    x0 = xs.to(device=dev, dtype=torch.int64).clamp(0, w - crop)[:, None]
    y0 = ys.to(device=dev, dtype=torch.int64).clamp(0, h - crop)[:, None]
    fl = flip.to(device=dev, dtype=torch.bool)[:, None]
    cols = torch.where(fl, x0 + (crop - 1 - ar), x0 + ar)       # (N, crop)
    rows = y0 + ar                                              # (N, crop)
    img = torch.arange(n, device=dev)[:, None, None]
    return rgb[img, rows[:, :, None], cols[:, None, :]]


def crop_flip_resize_w_plain(rgb, xs, ys, flip, crop, starts, taps):
    """Plain torch version of K9: the flipped crops (`flipped_crops`),
    then K8's windowed twin on their width axis -> (N, crop, dst, C)
    float32 (uint8 unpacked as v * f32(1/255) before any tap)."""
    return resize_axis_windowed_plain(flipped_crops(rgb, xs, ys, flip, crop),
                                      starts, taps, -2)


def crop_flip_resize_w(rgb, xs, ys, flip, crop, starts, taps):
    """Per-image crop at (xs, ys) (clamped into the frame), optional
    left-right flip, and the width pass of the resize with per-output
    windows (`resize_windows(dst, crop, ...)` as device tensors): (N, H,
    W, C) uint8 -> (N, crop, dst, C) float32 on the 0-1 scale. xs, ys
    (N,) int32, flip (N,) bool, all on rgb's device. Launches K9 for
    CUDA tensors; the plain version runs only for CPU tensors. Equals
    `resize_axis` (K8) on the flipped crops bit for bit."""
    if rgb.device.type == "cpu":
        return crop_flip_resize_w_plain(rgb, xs, ys, flip, crop, starts,
                                        taps)
    require_cuda(rgb, "K9")
    dev = rgb.device
    if rgb.dtype != torch.uint8 or rgb.dim() != 4:
        raise TypeError("K9 takes an (N, H, W, C) uint8 tensor")
    n, h, w, c = rgb.shape
    if not 0 < crop <= min(h, w):
        raise ValueError(f"K9: crop {crop} outside the {h}x{w} frame")
    dst, k = taps.shape
    if starts.dtype != torch.int32 or taps.dtype != torch.float32 \
            or tuple(starts.shape) != (dst,) or k > crop:
        raise TypeError("K9 takes (dst,) int32 starts and (dst, k <= crop) "
                        "float32 taps")
    for t, dt in ((xs, torch.int32), (ys, torch.int32), (flip, torch.bool),
                  (starts, torch.int32), (taps, torch.float32)):
        if t.device != dev or t.dtype != dt:
            raise TypeError("K9 takes int32 xs/ys, bool flip, int32 starts "
                            "and float32 taps on the image's device")
        if t is xs or t is ys or t is flip:
            if tuple(t.shape) != (n,):
                raise TypeError("K9 takes one xs, ys and flip per image")
    rgb, xs, ys = rgb.contiguous(), xs.contiguous(), ys.contiguous()
    flip, starts, taps = flip.contiguous(), starts.contiguous(), \
        taps.contiguous()
    out = torch.empty((n, crop, dst, c), dtype=torch.float32, device=dev)
    KERNELS["crop_flip_resize_w"](
        ptr(rgb), n, h, w, c, ptr(xs), ptr(ys), ptr(flip), crop, ptr(starts),
        ptr(taps), dst, k, INV255, ptr(out), stream_of(rgb))
    return out


def crop_flip_resize_plain(rgb, xs, ys, flip, crop, windows):
    """Plain torch version of `crop_flip_resize`: the flipped crops
    (`flipped_crops`), then K8's windowed twin on the width axis and on
    the height axis -> (N, dst_h, dst_w, C) float32."""
    (sw, tw), (sh, th) = windows
    return resize_axis_windowed_plain(resize_axis_windowed_plain(
        flipped_crops(rgb, xs, ys, flip, crop), sw, tw, -2), sh, th, -3)


def crop_flip_resize(rgb, xs, ys, flip, crop, windows):
    """The training ingest's crop + flip + resize: per-image crop at (xs,
    ys) (clamped into the frame), optional left-right flip, and both
    passes of the resize with per-output windows (`windows`: ((starts,
    taps) of the width axis, then of the height axis) for a crop x crop
    source, on rgb's device): (N, H, W, C) uint8 -> (N, dst_h, dst_w, C)
    float32 on the 0-1 scale. xs, ys (N,) int32, flip (N,) bool. For
    CUDA tensors K9 in one launch (resize_2d's crop mode) where
    `resize_plan` fits a tile in shared memory, else the per-axis route
    (`crop_flip_resize_w`, then `resize_axis` on the height); both give
    the plain version's bits. The plain version runs only for CPU
    tensors."""
    if rgb.device.type == "cpu":
        return crop_flip_resize_plain(rgb, xs, ys, flip, crop, windows)
    (sw, tw), (sh, th) = windows
    require_cuda(rgb, "K9")
    if rgb.dtype != torch.uint8 or rgb.dim() != 4:
        raise TypeError("K9 takes an (N, H, W, C) uint8 tensor")
    n, h, w, c = rgb.shape
    if not 0 < crop <= min(h, w):
        raise ValueError(f"K9: crop {crop} outside the {h}x{w} frame")
    _check_windows(rgb, sw, tw, crop, "K9")
    _check_windows(rgb, sh, th, crop, "K9")
    for t, dt in ((xs, torch.int32), (ys, torch.int32), (flip, torch.bool)):
        if t.device != rgb.device or t.dtype != dt or tuple(t.shape) != (n,):
            raise TypeError("K9 takes one int32 xs, int32 ys and bool flip "
                            "per image on the image's device")
    plan = windowed_plan(rgb, windows, crop=True)
    if plan["route"] == "per_axis":
        return resize_axis(crop_flip_resize_w(rgb, xs, ys, flip, crop, sw,
                                              tw), sh, th, -3)
    rgb, xs, ys, flip = (t.contiguous() for t in (rgb, xs, ys, flip))
    sw, tw, sh, th = (t.contiguous() for t in (sw, tw, sh, th))
    dst_w, kw = tw.shape
    dst_h, kh = th.shape
    out = torch.empty((n, dst_h, dst_w, c), dtype=torch.float32,
                      device=rgb.device)
    KERNELS["crop_flip_resize"](
        ptr(rgb), n, h, w, c, ptr(xs), ptr(ys), ptr(flip), crop, dst_h,
        dst_w, ptr(sw), ptr(tw), kw, ptr(sh), ptr(th), kh, INV255, ptr(out),
        plan["tx"], plan["ty"], plan["rows_max"], plan["span_chunks"],
        plan["smem"], stream_of(rgb))
    return out


def crop_kernel_info(rgb, crop: int, windows) -> dict:
    """K9's plan for `crop_flip_resize(rgb, ..., crop, windows)` on rgb's
    card (`resize_plan`'s route and tile) and its builds: resize_2d's
    crop mode at the plan's shared bytes (registers, local bytes, blocks
    an SM); on the per-axis route, K8's height pass (resize_cols)."""
    (_, tw), (_, th) = windows
    c = rgb.shape[-1]
    plan = windowed_plan(rgb, windows, crop=True)
    k = max(tw.shape[1], th.shape[1])
    out = dict(plan=plan, crop=crop)
    if plan["route"] == "one_launch":
        out["crop_resize_2d"] = card_info(rgb.device, 3, 1, c, k,
                                          plan["smem"])
    else:
        out["height_pass"] = card_info(rgb.device, 2, 4, 4, th.shape[1])
    return out


def window_tensors(dst_size, src_size, filter_name, fscale, device):
    """The reference's `resize_windows` as device tensors (starts int32,
    taps float32)."""
    starts, taps = resize_windows(dst_size, src_size, filter_name, fscale)
    dev_starts = torch.as_tensor(starts, device=device)
    _record(dev_starts, starts)
    return dev_starts, torch.as_tensor(taps, device=device)


# Plans by the content of the windows' starts and the call's shape (a plan
# costs ~0.1 ms of numpy, more than the kernel): the same starts always
# give the same plan, so a cached plan holds every tile it is used for.
_PLAN_CACHE = {}


def _cached(key, make):
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        if len(_PLAN_CACHE) >= 256:
            _PLAN_CACHE.clear()
        plan = _PLAN_CACHE[key] = make()
    return plan


def windowed_plan(x, windows, crop: bool = False) -> dict:
    """`resize_plan` of `resize_windowed(x, windows)` on x's card; with
    `crop`, of `crop_flip_resize` on the frames x (resize_2d's crop
    build: the same tiles, windows of the crop)."""
    (sw, tw), (sh, th) = windows
    c = x.shape[-1]
    hw, bw = starts_host(sw)
    hh, bh = starts_host(sh)

    def make():
        card = card_info(x.device, 3 if crop else 0, x.element_size(),
                         min(max(c, 1), 4), max(tw.shape[1], th.shape[1]))
        return resize_plan(hw, tw.shape[1], hh, th.shape[1], c, card,
                           x.element_size())

    return _cached(("crop" if crop else "2d", bw, tw.shape[1], bh,
                    th.shape[1], c, x.dtype, x.device.index), make)


def resize_windowed(x, windows, out_scale=1.0):
    """The width pass, then the height pass (`resize_axis`'s arithmetic,
    out_scale on the second). `windows`: ((starts, taps) of the width
    axis, (starts, taps) of the height axis) on x's device. For CUDA
    tensors K8 in one launch (resize_2d) where `resize_plan` fits a tile
    in shared memory, else its per-axis kernels twice (`windowed_plan`
    says which); both give the twin's bits. For CPU tensors the plain
    twin twice."""
    (sw, tw), (sh, th) = windows
    if x.device.type == "cpu":
        return resize_axis(resize_axis(x, sw, tw, -2), sh, th, -3, out_scale)
    _check_input(x, "K8")
    n, h, w, c = x.shape
    _check_windows(x, sw, tw, w, "K8")
    _check_windows(x, sh, th, h, "K8")
    plan = windowed_plan(x, windows)
    if plan["route"] == "per_axis":
        return resize_axis(resize_axis(x, sw, tw, -2), sh, th, -3, out_scale)
    x, sw, tw, sh, th = (t.contiguous() for t in (x, sw, tw, sh, th))
    dst_w, kw = tw.shape
    dst_h, kh = th.shape
    out = torch.empty((n, dst_h, dst_w, c), dtype=torch.float32,
                      device=x.device)
    in_scale = INV255 if x.dtype == torch.uint8 else 1.0
    KERNELS["resize_2d"](
        ptr(x), x.element_size(), n, h, w, c, dst_h, dst_w, ptr(sw), ptr(tw),
        kw, ptr(sh), ptr(th), kh, in_scale, out_scale, ptr(out), plan["tx"],
        plan["ty"], plan["rows_max"], plan["span_chunks"], plan["smem"],
        stream_of(x))
    return out


def kernel_info(x, windows) -> dict:
    """K8's plans and builds for `resize_windowed(x, windows)` on x's
    card: the route and tile of `resize_plan`, the width pass's
    `axis_plan`, and each kernel's registers, local bytes and blocks an
    SM (resize_2d at the plan's shared bytes)."""
    (sw, tw), (_, th) = windows
    c, eb = x.shape[-1], x.element_size()
    kw, k = tw.shape[1], max(tw.shape[1], th.shape[1])
    plan = windowed_plan(x, windows)
    cc = min(max(c, 1), 4)
    out = dict(plan=plan, resize_2d=card_info(x.device, 0, eb, cc, k,
                                              plan["smem"]))
    if c <= 4:
        wp = axis_plan(starts_host(sw)[0], kw, c,
                       card_info(x.device, 1, eb, c, kw), eb)
        out["width_pass"] = dict(wp, **card_info(x.device, 1, eb, c, kw,
                                                 wp["smem"]))
    out["height_pass"] = card_info(x.device, 2, 4, 4, th.shape[1])
    return out


def resize_f32(x, dst_w, dst_h, filter_name, fscale, out_scale=1.0):
    """(N, H, W, C) uint8 (unpacked by 1/255) or float32 -> (N, dst_h,
    dst_w, C) float32 on the 0-1 scale times `out_scale`, through
    `resize_windowed` with the reference's `resize_windows`."""
    windows = (window_tensors(dst_w, x.shape[-2], filter_name, fscale,
                              x.device),
               window_tensors(dst_h, x.shape[-3], filter_name, fscale,
                              x.device))
    return resize_windowed(x, windows, out_scale)


def crop_resize_map(x, windows, dst_channels, out_dtype, crop=None,
                    clip=False):
    """(N, H, W, C) uint8 / uint16 pixels -> the crop window `crop` (x0,
    y0, w, h), resized with `windows` (as `resize_windowed` takes them;
    None: no resize), mapped to `dst_channels` and packed to `out_dtype`
    (or float32 clipped to [0, 1] with `clip`): K11 -> K8 (both axes,
    `resize_windowed`) -> K11, or one K11 without a resize. The reference composes the same
    stages in `image_batch._jit_transform` and `_jit_resize`."""
    if windows is None:
        return pixel_map(x, dst_channels, out_dtype, crop=crop, clip=clip)
    f = pixel_map(x, x.shape[-1], torch.float32, crop=crop)
    return pixel_map(resize_windowed(f, windows), dst_channels, out_dtype,
                     clip=clip)


def resize_batch(x, dst_w, dst_h, filter_name, fscale):
    """The reference's `_jit_resize` on an (N, H, W, C) uint8 or uint16
    tensor (1-4 channels) -> (N, dst_h, dst_w, C) of the same dtype,
    through `crop_resize_map`. On CPU tensors every stage runs its plain
    version."""
    if x.dim() != 4 or x.dtype not in (torch.uint8, torch.uint16):
        raise TypeError("resize_batch takes an (N, H, W, C) uint8 or uint16 "
                        "tensor")
    windows = (window_tensors(dst_w, x.shape[2], filter_name, fscale,
                              x.device),
               window_tensors(dst_h, x.shape[1], filter_name, fscale,
                              x.device))
    return crop_resize_map(x, windows, x.shape[-1], x.dtype)


def resize_array(arr, width: int, height: int, filter: str = None,
                 filter_scale: float = None, device="cuda") -> np.ndarray:
    """(H, W, C) or (N, H, W, C) uint8 / uint16 channel array -> the
    resized array (same rank), through `resize_batch` on `device`."""
    opts = {}
    if filter is not None:
        opts["filter"] = filter
    if filter_scale is not None:
        opts["filterScale"] = filter_scale
    name, fscale = parse_resize_options(opts)
    arr = np.asarray(arr)
    single = arr.ndim == 3
    x = to_device(arr[None] if single else arr, resolve_device(device))
    out = resize_batch(x, width, height, name, fscale).cpu().numpy()
    return out[0] if single else out


def resize_image(img: Image, opts: dict, device="cuda") -> Image:
    """Image-level resize with the reference's resize(Sync) semantics:
    the output keeps the source pixel format."""
    width = int(opts.get("width", 0))
    height = int(opts.get("height", 0))
    if width <= 0 or height <= 0:
        raise InvalidOptionsError("invalid dimensions")
    if img.width <= 0 or img.height <= 0:
        raise InvalidImageError("invalid image")
    name, fscale = parse_resize_options(opts)
    out = resize_array(img.to_array(), width, height, filter=name,
                       filter_scale=fscale, device=device)
    return Image.from_array(out, img.pixel)
