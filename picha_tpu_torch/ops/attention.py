"""Multi-head self-attention of the ViT blocks: kernels K18 (forward) and
K22 (backward).

Counterpart of `picha_tpu/models/vit.py::forward`'s attention
(:171-180): q, k, v read out of the qkv product's (N, S, 3, H, D) bf16
layout, the f32 dot of bf16 q.k, `* scale` after the dot, an f32
softmax (max-subtract, exp, true division), the probabilities rounded
to bf16, the f32 sum of bf16 p . bf16 v, and o rounded to bf16 as
(N, S, H * D) for the proj product.

The backward is the VJP JAX derives from those lines, with its rounding
points: dP = do . v summed in f32 and rounded to bf16 (p was bf16); the
softmax's VJP on the unnormalised exponentials e and their sum l (not
on the rounded p): dS = ((dP / l) + -(sum_k dP * l^-2 * e)) * e * scale,
kept in f32; dq = dS . k, dk = dS^T . q, dv = p^T . do, each summed in
f32 and rounded to bf16 once. The scores are recomputed from qkv: no
(N, H, S, S) tensor is kept between the passes.

  `attention_plain`, `attention_backward_plain`  the torch versions
  `attention`  differentiable (`torch.autograd.Function`): K18 forward
               (`csrc/vit_attention.cu`) and K22 backward
               (`csrc/vit_attention_bwd.cu`) for CUDA tensors, the plain
               versions for CPU tensors

Each kernel has a tuned build (K18: up to 256 tokens, head width 32, 64
or 128; K22: up to 256 tokens, head width 32 or 64) and a tiled one for
every other head width and any token count (`csrc/vit_attention_tiled.cu`,
`csrc/vit_attention_bwd_tiled.cu`; past head width 128 their wide
kernels, which read the operands from global memory and split the
outputs into windows of 128 columns), chosen by shape in the C entry
point. The tiled K22's two kernels share each query row's statistics and
the settled bf16 dP through scratches that `attention_backward`
allocates: (N, H, S', S') bf16 with S' = S rounded up to 64.
"""
from __future__ import annotations

import torch

from ..kernels._build import KERNELS, aligned, ptr, require_cuda, stream_of
from .jpeg import full_fp32

MAX_SEQ = 256                    # the tuned K18 / K22: a head's rows in one block
HEAD_DIMS = (32, 64, 128)        # the tuned K18's instantiations
BWD_HEAD_DIMS = (32, 64)         # the tuned K22's: q, k, v, do of a head in
                                 # shared memory
TILED_MAX_D = 128                # past it the tiled builds' wide kernels
TILED_CHUNK = 64                 # the tiled K22's chunk of rows


def tiled(s: int, d: int, backward: bool = False) -> bool:
    """Whether (s tokens, head width d) takes K18's (K22's) tiled build."""
    return s > MAX_SEQ or d not in (BWD_HEAD_DIMS if backward else HEAD_DIMS)


def attention_plain(qkv, scale: float):
    """qkv (N, S, 3, H, D) bf16 -> o (N, S, H * D) bf16."""
    n, s, _, h, d = qkv.shape
    q, k, v = (qkv[:, :, i].to(torch.float32) for i in range(3))
    with full_fp32():
        att = torch.einsum("nqhd,nkhd->nhqk", q, k) * scale
        # detached: the reference's softmax takes no gradient through its max
        e = torch.exp(att - att.amax(-1, keepdim=True).detach())
        p = (e / e.sum(-1, keepdim=True)).to(torch.bfloat16)
        o = torch.einsum("nhqk,nkhd->nqhd", p.to(torch.float32), v)
    return o.to(torch.bfloat16).reshape(n, s, h * d)


def attention_backward_plain(qkv, do, scale: float):
    """The VJP of `attention` at qkv: qkv (N, S, 3, H, D) bf16, do (N, S,
    H * D) bf16 -> dqkv (N, S, 3, H, D) bf16 (see the module doc)."""
    n, s, _, h, d = qkv.shape
    q, k, v = (qkv[:, :, i].to(torch.float32) for i in range(3))
    g = do.reshape(n, s, h, d).to(torch.float32)
    with full_fp32():
        att = torch.einsum("nqhd,nkhd->nhqk", q, k) * scale
        e = torch.exp(att - att.amax(-1, keepdim=True))
        l = e.sum(-1, keepdim=True)
        p = (e / l).to(torch.bfloat16).to(torch.float32)
        dp = torch.einsum("nqhd,nkhd->nhqk", g, v).to(torch.bfloat16).to(
            torch.float32)
        c = ((dp * (l * l).reciprocal()) * e).sum(-1, keepdim=True)
        ds = ((dp / l) + -c) * e * scale
        dq = torch.einsum("nhqk,nkhd->nqhd", ds, k)
        dk = torch.einsum("nhqk,nqhd->nkhd", ds, q)
        dv = torch.einsum("nhqk,nqhd->nkhd", p, g)
    return torch.stack([dq, dk, dv], 2).to(torch.bfloat16)


def _check(qkv, kernel):
    require_cuda(qkv, kernel)
    if qkv.dtype != torch.bfloat16 or qkv.dim() != 5 or qkv.shape[2] != 3:
        raise TypeError(f"{kernel} takes (N, S, 3, H, D) bfloat16, got "
                        f"{tuple(qkv.shape)} {qkv.dtype}")
    _n, s, _, _h, d = qkv.shape
    if d < 1 or s < 1:
        raise ValueError(f"{kernel} takes a head width and a token count of "
                         f"at least 1, got {d} and {s}")


def attention_k18(qkv, scale: float, force_tiled: bool = False):
    """K18: qkv (N, S, 3, H, D) bf16 -> o (N, S, H * D) bf16 on the card
    (the tiled build past the tuned one's shapes, or with
    `force_tiled`)."""
    _check(qkv, "K18")
    n, s, _, h, d = qkv.shape
    qkv = aligned(qkv)
    out = torch.empty((n, s, h * d), dtype=torch.bfloat16, device=qkv.device)
    KERNELS["vit_attention"](ptr(qkv), n, s, h, d, float(scale),
                             int(force_tiled), ptr(out), stream_of(qkv))
    return out


def attention_backward(qkv, do, scale: float, force_tiled: bool = False):
    """`attention_backward_plain`'s result: K22 for CUDA tensors (the
    tiled build past the tuned one's shapes, or with `force_tiled`), the
    plain version only for CPU tensors. K22 sums dk and dv over the query
    rows in order inside one warp, so two runs give the same bits."""
    if qkv.device.type == "cpu":
        return attention_backward_plain(qkv, do, scale)
    _check(qkv, "K22")
    n, s, _, h, d = qkv.shape
    if do.dtype != torch.bfloat16 or do.device != qkv.device or \
            do.numel() != n * s * h * d:
        raise TypeError(f"K22 takes a bfloat16 cotangent of shape "
                        f"{(n, s, h * d)}")
    qkv, do = aligned(qkv), aligned(do)
    dqkv = torch.empty_like(qkv)
    stats = dp = None
    if force_tiled or tiled(s, d, backward=True):
        # each query row's max, l, 1 / l and c, and the settled bf16 dP
        # (rows and columns rounded up to the tiled build's 64-row chunks)
        # that its two kernels share
        stats = torch.empty((max(n, 1), h, s, 4), dtype=torch.float32,
                            device=qkv.device)
        if d <= TILED_MAX_D:
            sp = -(-s // TILED_CHUNK) * TILED_CHUNK
            dp = torch.empty((max(n, 1), h, sp, sp), dtype=torch.bfloat16,
                             device=qkv.device)
    KERNELS["vit_attention_bwd"](ptr(qkv), ptr(do), n, s, h, d, float(scale),
                                 int(force_tiled), ptr(dqkv),
                                 None if stats is None else ptr(stats),
                                 None if dp is None else ptr(dp),
                                 stream_of(qkv))
    return dqkv


_INFO = ("registers", "local_bytes", "shared_bytes", "threads",
         "blocks_per_sm")


def kernel_info(s: int, d: int, backward: bool = False,
                force_tiled: bool = False) -> dict:
    """K18's (K22's) build at `s` tokens of head width `d` (the tiled one
    past the tuned one's shapes, or with `force_tiled`), as the card
    reports it: registers and local (spill) bytes a thread, dynamic
    shared bytes, threads and resident blocks a multiprocessor. For the
    tiled K22 these are its query-side kernel's, with the key-side
    kernel's under "key_side". Launches nothing and counts no launch."""
    import ctypes

    from ..kernels._build import library

    vals = (ctypes.c_int * 10)()
    fn = "picha_vit_attention_bwd_info" if backward else \
        "picha_vit_attention_info"
    rc = getattr(library(), fn)(s, d, int(force_tiled), vals)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc}")
    out = dict(zip(_INFO, vals[:5]))
    if backward and (force_tiled or tiled(s, d, backward=True)):
        out["key_side"] = dict(zip(_INFO, vals[5:]))
    return out


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, scale):
        ctx.save_for_backward(qkv)
        ctx.scale = scale
        if qkv.device.type == "cpu":
            return attention_plain(qkv, scale)
        return attention_k18(qkv, scale)

    @staticmethod
    def backward(ctx, do):
        (qkv,) = ctx.saved_tensors
        return attention_backward(qkv, do, ctx.scale), None


def attention(qkv, scale: float):
    """qkv (N, S, 3, H, D) bf16 -> o (N, S, H * D) bf16 on the same
    device, differentiable in qkv. Launches K18 (and K22 in the
    backward) for CUDA tensors; the plain versions run only for CPU
    tensors."""
    return _Attention.apply(qkv, scale)
