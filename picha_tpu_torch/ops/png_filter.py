"""Batched PNG encode filtering with the per-row adaptive pick: kernel
K12.

Counterpart of `picha_tpu/ops/png_filter_tpu.py`. The encode direction
predicts every byte from the ORIGINAL source neighbours (a: bpp bytes to
the left, b: above, c: above-left; 0 outside the image, the first row's
prev is zeros), so all five filters and the adaptive pick are
independent per row, with no recurrence.

  `filter_batch_plain`  the torch translation of the reference's `_build`
  `filter_batch`        K12 (`csrc/png_filter.cu`) for CUDA tensors, the
                        plain version for CPU tensors

Both are byte-identical to the reference's `filter_batch` for every
strategy: -1 adaptive (least sum of |int8| residuals per row, the first
minimum in type order 0..4) or 0..4 fixed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels._build import KERNELS, ptr, require_cuda, stream_of


def _validate(rows, strategy):
    if rows.dim() != 3 or rows.dtype != torch.uint8:
        raise ValueError("filter_batch expects (N, H, RB) uint8")
    if not -1 <= strategy <= 4:
        raise ValueError("strategy must be -1 (adaptive) or 0..4")


def filter_batch_plain(rows, bpp: int, strategy: int = -1):
    """(N, H, RB) uint8 source rows -> (N, H, RB+1) uint8 filtered rows
    (type byte + residuals), as the reference's `_build` computes them."""
    _validate(rows, strategy)
    n, h, rb = rows.shape
    xi = rows.to(torch.int32)
    zeros = torch.zeros_like(xi)
    a = F.pad(xi[:, :, :-bpp], (bpp, 0)) if bpp < rb else zeros
    b = F.pad(xi[:, :-1, :], (0, 0, 1, 0))
    c = F.pad(xi[:, :-1, :-bpp], (bpp, 0, 1, 0)) if bpp < rb else zeros
    p = a + b - c
    pa, pb, pc = (p - a).abs(), (p - b).abs(), (p - c).abs()
    paeth = torch.where((pa <= pb) & (pa <= pc), a,
                        torch.where(pb <= pc, b, c))
    preds = (zeros, a, b, (a + b) >> 1, paeth)
    if strategy >= 0:
        res = (xi - preds[strategy]) & 0xFF
        best = torch.full((n, h), strategy, dtype=torch.int64,
                          device=rows.device)
    else:
        v = torch.stack([(xi - pr) & 0xFF for pr in preds])  # (5, N, H, RB)
        cost = torch.minimum(v, 256 - v).sum(dim=3)            # (5, N, H)
        best = torch.argmin(cost, dim=0)                       # first min
        res = torch.gather(v, 0, best[None, :, :, None].expand(
            1, n, h, rb))[0]
    return torch.cat([best[:, :, None], res], dim=2).to(torch.uint8)


def filter_batch(rows, bpp: int, strategy: int = -1, out=None):
    """(N, H, RB) uint8 source rows -> (N, H, RB+1) uint8 filtered rows,
    byte-identical to the reference's `filter_batch`. `out`, when given,
    is a contiguous (N, H, RB+1) uint8 tensor on the rows' device to
    write into. Launches K12 for CUDA tensors; the plain version runs
    only for CPU tensors."""
    bpp, strategy = int(bpp), int(strategy)
    if rows.device.type == "cpu":
        res = filter_batch_plain(rows, bpp, strategy)
        if out is None:
            return res
        out.copy_(res)
        return out
    require_cuda(rows, "K12")
    _validate(rows, strategy)
    if bpp < 1:
        raise ValueError("K12: bpp must be >= 1")
    n, h, rb = rows.shape
    shape = (n, h, rb + 1)
    if out is None:
        out = torch.empty(shape, dtype=torch.uint8, device=rows.device)
    elif (tuple(out.shape) != shape or out.dtype != torch.uint8
          or out.device != rows.device or not out.is_contiguous()):
        raise TypeError(f"K12 writes a contiguous {shape} uint8 tensor on "
                        f"the rows' device")
    rows = rows.contiguous()
    KERNELS["png_filter"](ptr(rows), n, h, rb, bpp, strategy, ptr(out),
                          stream_of(rows))
    return out
