"""Batched PNG encode filtering with the per-row adaptive pick: kernel
K12.

Counterpart of `picha_tpu/ops/png_filter_tpu.py`. The encode direction
predicts every byte from the ORIGINAL source neighbours (a: bpp bytes to
the left, b: above, c: above-left; 0 outside the image, the first row's
prev is zeros), so all five filters and the adaptive pick are
independent per row, with no recurrence.

  `filter_batch_plain`  the torch translation of the reference's `_build`
  `filter_streams`      K12 (`csrc/png_filter.cu`) for CUDA tensors: one
                        launch reads the rows once and writes a stream a
                        strategy; the plain version for CPU tensors
  `filter_batch`        `filter_streams` of one strategy
  `kernel_info`         K12's plan and build for a shape, from the card

All are byte-identical to the reference's `filter_batch` for every
strategy: -1 adaptive (least sum of |int8| residuals per row, the first
minimum in type order 0..4) or 0..4 fixed.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..kernels._build import KERNELS, ptr, require_cuda, stream_of

MAX_STREAMS = 6        # strategies a K12 launch writes at most
MAX_BPP = 8            # PNG's widest pixel: 16-bit RGBA
_INFO_KEYS = ("band_rows", "chunk_bytes", "chunks", "pitch", "shared_bytes",
              "words_a_row", "registers", "local_bytes", "static_shared_bytes",
              "blocks_an_sm", "sms", "blocks")


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


def filter_streams(rows, bpp: int, strategies, out=None):
    """(N, H, RB) uint8 source rows -> (S, N, H, RB+1) uint8 streams,
    stream j the rows filtered by strategies[j] (1 <= S <= 6), each
    byte-identical to the reference's `filter_batch`. `out`, when given,
    is a contiguous (S, N, H, RB+1) uint8 tensor on the rows' device to
    write into. One K12 launch for CUDA tensors (the rows read once); the
    plain version runs only for CPU tensors."""
    bpp = int(bpp)
    strategies = tuple(int(s) for s in strategies)
    if not 1 <= len(strategies) <= MAX_STREAMS:
        raise ValueError(f"K12 writes 1 to {MAX_STREAMS} streams, not "
                         f"{len(strategies)}")
    for s in strategies:
        _validate(rows, s)
    n, h, rb = rows.shape
    shape = (len(strategies), n, h, rb + 1)
    if out is not None and (
            tuple(out.shape) != shape or out.dtype != torch.uint8
            or out.device != rows.device or not out.is_contiguous()):
        raise TypeError(f"K12 writes a contiguous {shape} uint8 tensor on "
                        f"the rows' device")
    if rows.device.type == "cpu":
        res = torch.stack([filter_batch_plain(rows, bpp, s)
                           for s in strategies])
        if out is None:
            return res
        out.copy_(res)
        return out
    require_cuda(rows, "K12")
    if not 1 <= bpp <= MAX_BPP:
        raise ValueError(f"K12: bpp must be 1..{MAX_BPP}")
    if out is None:
        out = torch.empty(shape, dtype=torch.uint8, device=rows.device)
    rows = rows.contiguous()
    codes = sum((s + 1) << (3 * j) for j, s in enumerate(strategies))
    KERNELS["png_filter"](ptr(rows), n, h, rb, bpp, len(strategies), codes,
                          ptr(out), n * h * (rb + 1), stream_of(rows))
    return out


def filter_batch(rows, bpp: int, strategy: int = -1, out=None):
    """(N, H, RB) uint8 source rows -> (N, H, RB+1) uint8 filtered rows,
    byte-identical to the reference's `filter_batch`: `filter_streams`
    of the one strategy. `out`, when given, is a contiguous (N, H, RB+1)
    uint8 tensor on the rows' device to write into."""
    if out is None:
        return filter_streams(rows, bpp, (strategy,))[0]
    filter_streams(rows, bpp, (strategy,), out[None])
    return out


def kernel_info(shape, bpp: int, strategies, device) -> dict:
    """K12's plan for (N, H, RB) rows and the strategies' launch (band
    rows, chunk bytes and chunks, slot pitch, shared bytes, words a row,
    blocks), and the build of the kernel it launches (registers, local
    and static shared bytes, blocks an SM at the plan's shared bytes),
    asked of `device`'s card."""
    from ..kernels._build import library

    n, h, rb = shape
    strategies = tuple(int(s) for s in strategies)
    adaptive = -1 in strategies
    nfixed = sum(s >= 0 for s in strategies)
    out = (ctypes.c_int * len(_INFO_KEYS))()
    with torch.cuda.device(device):
        rc = library().picha_png_filter_info(n * h, rb, int(adaptive), nfixed,
                                             out)
    if rc != 0:
        raise RuntimeError(f"picha_png_filter_info: CUDA error {rc}")
    return dict(zip(_INFO_KEYS, out), adaptive=adaptive, bpp=int(bpp),
                streams=len(strategies), fixed_streams=nfixed)
