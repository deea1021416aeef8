"""Separable image resize on the device.

Counterpart of `picha_tpu/ops/resize.py` (`_apply_axis`, `resize_f32`).
The weights come from the reference's own numpy functions (`resize_weights`,
`banded_resize_plan`, `resize_windows`), so the taps are the reference's
float32 values; the caller uploads them once per configuration.

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

Tensors are (N, H, W, C); the width axis is -2 and the height axis -3,
as in the reference. A uint8 input is unpacked as v * f32(1/255) before
any tap, as the reference unpacks before resizing.
"""
from __future__ import annotations

import numpy as np
import torch

from picha_tpu.ops.resize import (BANDED_THRESHOLD, banded_resize_plan,
                                  resize_weights, resize_windows)

from ..kernels._build import KERNELS, ptr, require_cuda, stream_of
from .jpeg_fused import full_fp32

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
