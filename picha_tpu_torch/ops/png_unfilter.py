"""PNG filter reconstruction (unfilter) over a batch: kernel K13.

The port's form of the reference's host stage `native.png_unfilter`
(`picha_tpu/native/src/pngfilter.cc:110-221`, called by
`picha_tpu/codecs/png.py:169`), which cannot build on the card machine.
The decode direction predicts every byte from the RECONSTRUCTED
neighbours (a: bpp bytes to the left, b: above, c: above-left; a and c
are 0 in the first bpp columns, b and c on the first row), so rows run in
order, and within a sub, average or Paeth row each byte lane x = lane
mod bpp is a dependent chain.

  `png_unfilter_plain`  the torch version: rows in order; none, up and
                        sub rows whole (sub as a per-lane running sum),
                        average and Paeth rows along x, vectorised over
                        the images and the bpp lanes
  `png_unfilter`        K13 (`csrc/png_unfilter.cu`, a skewed row
                        wavefront: rows one pixel apart, a warp a group
                        of 32 // bpp rows, column chunks in block-wide
                        phases) for CUDA tensors, the plain version for
                        CPU tensors
  `check_status`        one readback of the per-image statuses; raises
                        CodecError("invalid PNG filter type") where a
                        filter type byte was > 4
  `kernel_info`         the launch K13 makes for a shape, as the card
                        reports it

Both are byte-identical to the native function for every filter type.
"""
from __future__ import annotations

import torch

from ..errors import CodecError
from ..kernels._build import KERNELS, ptr, require_cuda, stream_of


_INFO = ("registers", "local_bytes", "dynamic_shared_bytes", "blocks_per_sm",
         "threads", "chunk", "rows_a_warp", "phases")


def _validate(rows, bpp):
    if rows.dim() != 3 or rows.dtype != torch.uint8 or rows.shape[2] < 2:
        raise ValueError("png_unfilter expects (N, H, RB+1) uint8 rows")
    if not 1 <= bpp <= 8:
        raise ValueError("png_unfilter: bpp must be in 1..8")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = (p - a).abs(), (p - b).abs(), (p - c).abs()
    return torch.where((pa <= pb) & (pa <= pc), a, torch.where(pb <= pc, b, c))


def png_unfilter_plain(rows, bpp: int):
    """(N, H, RB+1) uint8 filtered rows -> ((N, H, RB) uint8
    reconstructed bytes, (N,) int32 status: 1 where a type byte is > 4)."""
    _validate(rows, bpp)
    n, h, rb1 = rows.shape
    rb = rb1 - 1
    lanes = -(-rb // bpp)
    rbp = lanes * bpp              # a whole number of lanes (zero tail)
    types = rows[:, :, 0].to(torch.int64)
    status = (types > 4).any(dim=1).to(torch.int32)
    res = torch.zeros((n, h, rbp), dtype=torch.int64)
    res[:, :, :rb] = rows[:, :, 1:].cpu().to(torch.int64)
    types = types.cpu()
    out = torch.zeros((n, h, rbp), dtype=torch.int64)
    prev = torch.zeros((n, rbp), dtype=torch.int64)
    for y in range(h):
        t, r = types[:, y], res[:, y]
        row = r.clone()                                   # none (and > 4)
        up = t == 2
        row[up] = (r[up] + prev[up]) & 0xFF
        sub = t == 1
        if sub.any():
            row[sub] = (r[sub].view(-1, lanes, bpp).cumsum(1) & 0xFF).view(
                -1, rbp)
        seq = (t == 3) | (t == 4)
        if seq.any():
            idx = seq.nonzero()[:, 0]
            avg = (t[idx] == 3)[:, None]
            rs, bs = r[idx], prev[idx]
            vs = torch.zeros_like(rs)
            a = c = torch.zeros((len(idx), bpp), dtype=torch.int64)
            for j in range(0, rbp, bpp):
                b = bs[:, j:j + bpp]
                pred = torch.where(avg, (a + b) >> 1, _paeth(a, b, c))
                a = (rs[:, j:j + bpp] + pred) & 0xFF
                vs[:, j:j + bpp] = a
                c = b
            row[idx] = vs
        out[:, y] = row
        prev = row
    out = out[:, :, :rb].to(torch.uint8).to(rows.device)
    return out, status.to(rows.device)


def png_unfilter(rows, bpp: int):
    """(N, H, RB+1) uint8 filtered rows -> ((N, H, RB) uint8, (N,) int32
    status), without reading the status back (`check_status` does).
    The image dimension may be strided (an Adam7 pass cut from the
    whole stream); each image's rows must be contiguous. Launches K13
    for CUDA tensors (its chunk width and warps a block come from the
    shape and the card's occupancy); the plain version runs only for CPU
    tensors."""
    bpp = int(bpp)
    if rows.device.type == "cpu":
        return png_unfilter_plain(rows, bpp)
    require_cuda(rows, "K13")
    _validate(rows, bpp)
    n, h, rb1 = rows.shape
    if rows.stride(2) != 1 or rows.stride(1) != rb1 or (
            n > 1 and rows.stride(0) < h * rb1):
        rows = rows.contiguous()
    out = torch.empty((n, h, rb1 - 1), dtype=torch.uint8, device=rows.device)
    status = torch.zeros((n,), dtype=torch.int32, device=rows.device)
    KERNELS["png_unfilter"](ptr(rows), max(rows.stride(0), h * rb1), n, h,
                            rb1 - 1, bpp, ptr(out), ptr(status),
                            stream_of(rows))
    return out, status


def kernel_info(n: int, h: int, rb: int, bpp: int) -> dict:
    """The launch K13 makes for n images of h rows of rb bytes at bpp, as
    the card reports it: registers and local (spill) bytes a thread,
    dynamic shared bytes a block, resident blocks a multiprocessor,
    threads a block, the chunk width in pixels, rows a warp and the
    block-wide phases. Launches nothing."""
    import ctypes

    from ..kernels._build import library

    vals = (ctypes.c_int * len(_INFO))()
    rc = library().picha_png_unfilter_info(n, h, rb, bpp, vals)
    if rc != 0:
        raise RuntimeError(f"picha_png_unfilter_info: CUDA error {rc}")
    return dict(zip(_INFO, vals))


def check_status(*statuses):
    """Read the unfilter statuses back once; raise CodecError when any
    image had a filter type > 4."""
    if bool(torch.cat([s.reshape(-1) for s in statuses]).any()):
        raise CodecError("invalid PNG filter type")
