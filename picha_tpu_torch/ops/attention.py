"""Multi-head self-attention of the ViT blocks: kernel K18.

Counterpart of `picha_tpu/models/vit.py::forward`'s attention
(:171-180): q, k, v read out of the qkv product's (N, S, 3, H, D) bf16
layout, the f32 dot of bf16 q.k, `* scale` after the dot, an f32
softmax (max-subtract, exp, true division), the probabilities rounded
to bf16, the f32 sum of bf16 p . bf16 v, and o rounded to bf16 as
(N, S, H * D) for the proj product.

  `attention_plain`  the torch version (f32 einsums in IEEE f32)
  `attention`        K18 (`csrc/vit_attention.cu`) for CUDA tensors, the
                     plain version for CPU tensors
"""
from __future__ import annotations

import torch

from ..kernels._build import KERNELS, aligned, ptr, require_cuda, stream_of
from .jpeg import full_fp32

MAX_SEQ = 256                    # K18 holds 8 key columns a lane
HEAD_DIMS = (32, 64, 128)        # K18's instantiations


def attention_plain(qkv, scale: float):
    """qkv (N, S, 3, H, D) bf16 -> o (N, S, H * D) bf16."""
    n, s, _, h, d = qkv.shape
    q, k, v = (qkv[:, :, i].to(torch.float32) for i in range(3))
    with full_fp32():
        att = torch.einsum("nqhd,nkhd->nhqk", q, k) * scale
        e = torch.exp(att - att.amax(-1, keepdim=True))
        p = (e / e.sum(-1, keepdim=True)).to(torch.bfloat16)
        o = torch.einsum("nhqk,nkhd->nqhd", p.to(torch.float32), v)
    return o.to(torch.bfloat16).reshape(n, s, h * d)


def attention(qkv, scale: float):
    """qkv (N, S, 3, H, D) bf16 -> o (N, S, H * D) bf16 on the same
    device. Launches K18 for CUDA tensors; the plain version runs only
    for CPU tensors."""
    if qkv.device.type == "cpu":
        return attention_plain(qkv, scale)
    require_cuda(qkv, "K18")
    if qkv.dtype != torch.bfloat16 or qkv.dim() != 5 or qkv.shape[2] != 3:
        raise TypeError(f"K18 takes (N, S, 3, H, D) bfloat16, got "
                        f"{tuple(qkv.shape)} {qkv.dtype}")
    n, s, _, h, d = qkv.shape
    if d not in HEAD_DIMS or not 1 <= s <= MAX_SEQ:
        raise ValueError(f"K18 takes head widths {HEAD_DIMS} and 1-{MAX_SEQ} "
                         f"tokens, got {d} and {s}")
    qkv = aligned(qkv, 4)
    out = torch.empty((n, s, h * d), dtype=torch.bfloat16, device=qkv.device)
    KERNELS["vit_attention"](ptr(qkv), n, s, h, d, float(scale), ptr(out),
                             stream_of(qkv))
    return out
