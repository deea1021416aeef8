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
  `resize_axis`                 one axis: K8 (`csrc/resize_axis.cu`) for
                                CUDA tensors, the windowed twin for CPU
                                tensors
  `resize_windowed`             width pass, then height pass, through
                                `resize_axis`
  `resize_f32`                  the same with the windows built here
  `crop_resize_map`             the pixel-array chain: K11 (unpack
                                v / MAX, crop window) -> K8 width -> K8
                                height -> K11 (channel map, pack or
                                clip); one K11 launch without a resize
  `resize_batch`                the reference's `_jit_resize` through
                                that chain, uint8 or uint16 in and out
  `resize_array`, `resize_image` the single-image API on the device (the
                                reference's native host resize has no
                                counterpart here)
  `crop_flip_resize_w`          the training ingest's per-image crop,
                                horizontal flip and width pass: K9
                                (`csrc/crop_resize.cu`) for CUDA
                                tensors, `crop_flip_resize_w_plain` (the
                                flipped crop gathered, then K8's twin)
                                for CPU tensors

Tensors are (N, H, W, C); the width axis is -2 and the height axis -3,
as in the reference. K8 unpacks a uint8 input as v * f32(1/255) before
any tap (the decode paths' rule); `resize_batch` unpacks with K11's IEEE
division first, as the reference's `junpack_f32` does.
"""
from __future__ import annotations

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


def resize_axis(x, starts, taps, axis, out_scale=1.0):
    """Resize one axis (-2 width, -3 height) of an (N, H, W, C) uint8 or
    float32 tensor with per-output windows (`resize_windows` as device
    tensors) -> float32. Launches K8 for CUDA tensors; the plain twin
    runs only for CPU tensors."""
    if x.device.type == "cpu":
        return resize_axis_windowed_plain(x, starts, taps, axis, out_scale)
    require_cuda(x, "K8")
    dev = x.device
    if x.dtype not in (torch.uint8, torch.float32) or x.dim() != 4:
        raise TypeError("K8 takes an (N, H, W, C) uint8 or float32 tensor")
    if axis not in (-2, -3):
        raise ValueError(f"K8 resizes axis -2 (width) or -3 (height), "
                         f"not {axis}")
    dst, k = taps.shape
    if starts.dtype != torch.int32 or taps.dtype != torch.float32 \
            or starts.device != dev or taps.device != dev \
            or tuple(starts.shape) != (dst,):
        raise TypeError("K8 takes (dst,) int32 starts and (dst, k) float32 "
                        "taps on the input's device")
    x, starts, taps = x.contiguous(), starts.contiguous(), taps.contiguous()
    n, h, w, c = x.shape
    src = x.shape[axis]
    if k > src:
        raise ValueError(f"K8: window {k} longer than the axis ({src})")
    outer, inner = (n * h, c) if axis == -2 else (n, w * c)
    shape = (n, h, dst, c) if axis == -2 else (n, dst, w, c)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    in_scale = INV255 if x.dtype == torch.uint8 else 1.0
    KERNELS["resize_axis"](ptr(x), x.element_size(), outer, src, dst, inner,
                           ptr(starts), ptr(taps), k, in_scale, out_scale,
                           ptr(out), stream_of(x))
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


def window_tensors(dst_size, src_size, filter_name, fscale, device):
    """The reference's `resize_windows` as device tensors (starts int32,
    taps float32)."""
    starts, taps = resize_windows(dst_size, src_size, filter_name, fscale)
    return (torch.as_tensor(starts, device=device),
            torch.as_tensor(taps, device=device))


def resize_windowed(x, windows, out_scale=1.0):
    """The width pass, then the height pass, each through `resize_axis`
    (K8 twice for CUDA tensors). `windows`: ((starts, taps) of the
    width axis, (starts, taps) of the height axis) on x's device."""
    (sw, tw), (sh, th) = windows
    return resize_axis(resize_axis(x, sw, tw, -2), sh, th, -3, out_scale)


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
    (or float32 clipped to [0, 1] with `clip`): K11 -> K8 W -> K8 H ->
    K11, or one K11 without a resize. The reference composes the same
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
