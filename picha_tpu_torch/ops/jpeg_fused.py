"""Fused JPEG decode+resize: coefficients -> resized RGB/grey in two
matmuls per component.

Counterpart of `picha_tpu/ops/jpeg_fused.py` (`fused_component`,
`fused_decode_resize`). The folded per-axis weights (resize o upsample
o IDCT, `component_weights`) are built here in numpy, as the port's copy
of the reference's weight functions (`upsample_matrix`, `component_weights`;
pinned by `tests/test_torch_host_copies.py`), and converted to device
tensors once per signature by the caller
(`pipeline.jpeg_batch.device_constants`):

    tmp[n,bh,v,ox] = sum_{bw,u} coefq[n,bh,bw,v,u] * Th[ox,bw,u]
    out[n,oy,ox]   = sum_{bh,v} tmp[n,bh,v,ox]   * Tv[oy,bh,v]

These are plain large matrix products, left to `torch.matmul` (cuBLAS),
in full float32: the K~1900 contraction does not hold the <=1 LSB
contract with TF32's 10-bit mantissa, so `full_fp32()` switches TF32
off for the call whatever the process set globally, and restores it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .jpeg import (_IDCT_A, CS_CMYK, CS_GRAYSCALE, CS_RGB, CS_YCBCR, CS_YCCK,
                   check_integer_sampling, full_fp32)
from .resize_weights import resize_weights


def upsample_matrix(factor: int, n_out: int, n_in: int,
                    fancy: bool = True) -> np.ndarray:
    """(n_out, n_in) linear operator of libjpeg's upsampler: triangle
    ("fancy") weights for 2x when `fancy`, replication otherwise;
    edge-replicated."""
    U = np.zeros((n_out, n_in), dtype=np.float32)
    if factor == 1:
        for i in range(n_out):
            U[i, min(i, n_in - 1)] = 1.0
        return U
    if factor == 2 and fancy:
        for o in range(n_out):
            i = o // 2
            if o % 2 == 0:
                far = max(i - 1, 0)
            else:
                far = min(i + 1, n_in - 1)
            U[o, min(i, n_in - 1)] += 0.75
            U[o, far] += 0.25
        return U
    for o in range(n_out):
        U[o, min(o // factor, n_in - 1)] = 1.0
    return U


IDENTITY = "__identity__"  # decode-only: no resampling, W = I


@functools.lru_cache(maxsize=64)
def component_weights(dst_size: int, full_size: int, comp_size: int,
                      factor: int, filter_name: str, fscale: float,
                      fancy: bool = True):
    """(dst_size, blocks, 8) float32: resize o upsample o IDCT folded."""
    if filter_name == IDENTITY:
        W = np.eye(dst_size, full_size, dtype=np.float32)
    else:
        W = resize_weights(dst_size, full_size, filter_name, fscale)
    if factor != 1 or comp_size != full_size:
        U = upsample_matrix(factor, full_size, comp_size, fancy)
        W = W @ U  # (dst, comp_size)
    # zero-pad to the block grid
    blocks = -(-comp_size // 8)
    Wp = np.zeros((dst_size, blocks * 8), dtype=np.float32)
    Wp[:, :comp_size] = W[:, :comp_size]
    Wb = Wp.reshape(dst_size, blocks, 8)
    # fold the IDCT basis: T[o, b, u] = sum_x Wb[o, b, x] * A[u, x]
    return np.einsum("obx,ux->obu", Wb, _IDCT_A).astype(np.float32)


def fused_component(coefs, qtable, th, tv):
    """coefs (N, bh, bw, 64) int, qtable (N, 1, 1, 64), th (ox, bw, 8),
    tv (oy, bh, 8) float32 -> (N, oy, ox) float32 samples (level-shifted,
    unclamped)."""
    n, bh, bw = coefs.shape[0], coefs.shape[1], coefs.shape[2]
    cq = coefs.to(torch.float32) * qtable.to(torch.float32)
    # [n, bh, bw, v, u] -> rows (n, bh, v), contraction (bw, u)
    cq = cq.view(n, bh, bw, 8, 8).permute(0, 1, 3, 2, 4)
    cq = cq.reshape(n * bh * 8, bw * 8)
    ox = th.shape[0]
    tmp = torch.matmul(cq, th.reshape(ox, bw * 8).t())     # (n*bh*8, ox)
    oy = tv.shape[0]
    out = torch.matmul(tv.reshape(oy, bh * 8),
                       tmp.view(n, bh * 8, ox))             # (n, oy, ox)
    return out + 128.0


def fused_decode_resize(comp_sig, color_space, coefs, qtabs, weights):
    """Per-component fused matmuls -> colour transform at the target
    resolution -> (N, oy, ox, C) float32 in [0, 255] (unrounded).
    `weights`: per-component (th, tv) device tensors."""
    check_integer_sampling(comp_sig)
    with full_fp32():
        planes = [fused_component(coefs[i], qtabs[i], th, tv)
                  for i, (th, tv) in enumerate(weights)]

    if color_space == CS_GRAYSCALE or len(planes) == 1:
        return planes[0][..., None]
    if color_space == CS_RGB:
        return torch.stack(planes[:3], dim=-1)

    def ycc_to_rgb(y, cb, cr):
        cbs = cb - 128.0
        crs = cr - 128.0
        r = y + 1.40200 * crs
        g = y - 0.34414 * cbs - 0.71414 * crs
        b = y + 1.77200 * cbs
        return torch.stack([r, g, b], dim=-1)

    if color_space == CS_YCBCR:
        return ycc_to_rgb(planes[0], planes[1], planes[2])
    # CMYK/YCCK: the reference floors the fold (c*k // 255) and the
    # pack rounds half up, so subtract 0.5 here to net a floor
    if color_space == CS_YCCK:
        cmy = 255.0 - ycc_to_rgb(planes[0], planes[1], planes[2]).clamp(
            0.0, 255.0)
        k = planes[3].clamp(0.0, 255.0)
        return cmy * k[..., None] * (1.0 / 255.0) - 0.5
    if color_space == CS_CMYK:
        cmy = torch.stack(planes[:3], dim=-1)
        k = planes[3]
        return (cmy.clamp(0.0, 255.0) * k.clamp(0.0, 255.0)[..., None]
                * (1.0 / 255.0)) - 0.5
    raise ValueError(f"unsupported colour space {color_space}")
