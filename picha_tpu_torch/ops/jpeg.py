"""JPEG encoder front on the device: RGB float image -> quantised DCT
coefficients.

Counterpart of the encode half of `picha_tpu/ops/jpeg_tpu.py`
(`rgb_to_ycbcr`, `box_downsample_2x2`, `plane_to_blocks`, `fdct_quant`,
`_jit_encode`) plus the u8 pack the reference pipeline applies first
(`picha_tpu/pipeline/jpeg_batch.py`, floor(clip(v + 0.5))).

`encode_blocks` launches kernel K2 (`csrc/jpeg_encode_front.cu`) for
CUDA tensors and runs `encode_blocks_plain` for CPU tensors. The
quantisation tables (`quality_tables`) and the 64x64 Kronecker DCT
(`_idct_kron`) are the reference's numpy constants, uploaded once per
configuration by the caller.
"""
from __future__ import annotations

import torch

from picha_tpu.ops.jpeg_tpu import FIX, _ONE_HALF

from ..kernels._build import KERNELS, ptr, require_cuda, stream_of
from .jpeg_fused import full_fp32, pack_u8


def _cdiv(a, b):
    return -(-a // b)


def rgb_to_ycbcr(rgb):
    """libjpeg jccolor.c forward transform (int32 fixed point)."""
    r, g, b = (rgb[..., i].to(torch.int32) for i in range(3))
    y = (FIX(0.29900) * r + FIX(0.58700) * g + FIX(0.11400) * b
         + _ONE_HALF) >> 16
    cb = ((-FIX(0.16874)) * r + (-FIX(0.33126)) * g + FIX(0.50000) * b
          + (128 << 16) + _ONE_HALF - 1) >> 16
    cr = (FIX(0.50000) * r + (-FIX(0.41869)) * g + (-FIX(0.08131)) * b
          + (128 << 16) + _ONE_HALF - 1) >> 16
    return y, cb, cr


def _edge_pad(plane, h2, w2):
    """Pad the last two dims to (h2, w2) by edge replication."""
    h, w = plane.shape[-2], plane.shape[-1]
    rows = torch.arange(h2, device=plane.device).clamp(max=h - 1)
    cols = torch.arange(w2, device=plane.device).clamp(max=w - 1)
    return plane.index_select(-2, rows).index_select(-1, cols)


def box_downsample_2x2(plane):
    """2x2 average with (+2) >> 2 rounding, odd dims edge-padded."""
    h, w = plane.shape[-2], plane.shape[-1]
    p = _edge_pad(plane, h + h % 2, w + w % 2)
    p = p.reshape(p.shape[:-2] + ((h + 1) // 2, 2, (w + 1) // 2, 2))
    return (p.sum(dim=(-3, -1)) + 2) >> 2


def plane_to_blocks(plane, bh, bw):
    """(..., h, w) -> (..., bh, bw, 64), edge-padding to whole blocks."""
    p = _edge_pad(plane, bh * 8, bw * 8)
    p = p.reshape(p.shape[:-2] + (bh, 8, bw, 8)).transpose(-3, -2)
    return p.reshape(p.shape[:-2] + (64,))


def fdct_quant(blocks, qtable, kron):
    """(..., 64) int samples -> quantised int16 coefficients: Kronecker
    fDCT in float32, divide by the table, round half to even."""
    b = blocks.to(torch.float32) - 128.0
    with full_fp32():
        f = torch.matmul(b, kron.t())
    return torch.round(f / qtable.to(torch.float32)).to(torch.int16)


def front_samples(f255):
    """f255 (N, H, W, C) float32 (C 1 or 3) -> per-component (N, bh,
    bw, 64) int32 sample blocks: pack, colour convert, 4:2:0 chroma
    downsample, pad."""
    height, width, ncomp = f255.shape[1], f255.shape[2], f255.shape[3]
    img = pack_u8(f255).to(torch.int32)
    ybh, ybw = _cdiv(height, 8), _cdiv(width, 8)
    if ncomp == 1:
        return (plane_to_blocks(img[..., 0], ybh, ybw),)
    y, cb, cr = rgb_to_ycbcr(img)
    cb, cr = box_downsample_2x2(cb), box_downsample_2x2(cr)
    cbh, cbw = _cdiv(cb.shape[-2], 8), _cdiv(cb.shape[-1], 8)
    return (plane_to_blocks(y, ybh, ybw), plane_to_blocks(cb, cbh, cbw),
            plane_to_blocks(cr, cbh, cbw))


def encode_blocks_plain(f255, qluma, qchroma, kron):
    """Plain torch version of K2. f255 (N, H, W, C) float32 (C 1 or 3)
    -> tuple of (N, bh, bw, 64) int16 per component."""
    return tuple(fdct_quant(b, qluma if i == 0 else qchroma, kron)
                 for i, b in enumerate(front_samples(f255)))


def encode_blocks(f255, qluma, qchroma, kron):
    """f255 (N, H, W, C) float32 -> quantised coefficient planes (4:2:0
    for colour, as the reference pipeline encodes). qluma /
    qchroma (64,) int32 natural order, kron the (64, 64) float32
    Kronecker DCT, all on f255's device. Launches K2 for CUDA tensors;
    the plain version runs only for CPU tensors."""
    if f255.device.type == "cpu":
        return encode_blocks_plain(f255, qluma, qchroma, kron)
    require_cuda(f255, "K2")
    dev = f255.device
    if f255.dtype != torch.float32 or f255.dim() != 4 \
            or f255.shape[3] not in (1, 3):
        raise TypeError("K2 takes a (N, H, W, 1|3) float32 image")
    for t, dt in ((qluma, torch.int32), (qchroma, torch.int32),
                  (kron, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise TypeError("K2 tables must be contiguous int32 qtables "
                            "and a float32 kron on the image's device")
    f255 = f255.contiguous()
    n, h, w, c = f255.shape
    ybh, ybw = _cdiv(h, 8), _cdiv(w, 8)
    cbh, cbw = _cdiv(_cdiv(h, 2), 8), _cdiv(_cdiv(w, 2), 8)
    out_y = torch.empty((n, ybh, ybw, 64), dtype=torch.int16, device=dev)
    if c == 3:
        out_cb = torch.empty((n, cbh, cbw, 64), dtype=torch.int16,
                             device=dev)
        out_cr = torch.empty_like(out_cb)
    else:
        out_cb = out_cr = out_y
    KERNELS["jpeg_encode_front"](
        ptr(f255), n, h, w, c, ptr(qluma), ptr(qchroma),
        ptr(kron), ptr(out_y), ptr(out_cb), ptr(out_cr), ybh, ybw, cbh,
        cbw, stream_of(f255))
    return (out_y,) if c == 1 else (out_y, out_cb, out_cr)
