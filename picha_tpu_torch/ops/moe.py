"""Top-1 switch routing of the ViT's MoE blocks: kernels K19 and K20.

Counterpart of `picha_tpu/models/vit.py::_switch_moe` (:194-230) around
its expert products:
- route + dispatch (:211-224): per token the softmax of its f32 router
  logits, the first-max expert and its gate; the token's slot is its
  rank among the tokens of the same expert in token order (the
  reference's `cumsum(one_hot)`); tokens at a slot >= `cap` are dropped;
  kept rows are scattered into the (E, cap, d) bf16 expert buffer
  (rows past an expert's count stay zero). Returns the buffer and, per
  token, (eidx, sidx, gk): the expert and slot (E and 0 when dropped)
  and gate * keep in f32;
- combine (:228-230): out[t] = ye[eidx, sidx] * bf16(gk) in bf16, 0 for
  a dropped token.

  `route_dispatch_plain`, `combine_plain`  the torch versions
  `route_dispatch`  K19 (`csrc/vit_moe.cu`) for CUDA tensors
  `combine`         K20 (the same file) for CUDA tensors
Each runs its plain version for CPU tensors.
"""
from __future__ import annotations

import math

import torch

from ..kernels._build import KERNELS, aligned, ptr, require_cuda, stream_of

MAX_EXPERTS = 64
TOKENS_PER_BLOCK = 256           # K19's block of tokens (its count table)


def capacity(t: int, experts: int, capacity_factor: float) -> int:
    """Slots per expert, as the reference computes them (:211)."""
    return max(1, int(math.ceil(t / experts * capacity_factor)))


def route_plain(logits):
    """(t, E) f32 logits -> (expert (t,) int64, gate (t,) f32): softmax
    as max-subtract, exp, the sum in expert order and a true division;
    the first maximum wins."""
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    s = e[:, 0]
    for i in range(1, e.shape[1]):
        s = s + e[:, i]
    gates = e / s[:, None]
    return gates.argmax(-1), gates.amax(-1)


def route_dispatch_plain(logits, y, cap: int):
    """logits (t, E) f32, y (t, d) bf16 -> (xe (E, cap, d) bf16, eidx,
    sidx (t,) int32, gk (t,) f32)."""
    t, experts = logits.shape
    expert, gate = route_plain(logits)
    oh = torch.nn.functional.one_hot(expert, experts)
    slot = ((oh.cumsum(0) - 1) * oh).sum(-1)
    keep = slot < cap
    eidx = torch.where(keep, expert, experts)
    sidx = torch.where(keep, slot, 0)
    # the reference adds into zeros (so -0 lands as +0); dropped rows go
    # to a trash row that is cut off
    xe = torch.zeros((experts + 1, cap, y.shape[1]), dtype=y.dtype,
                     device=y.device)
    xe.index_put_((eidx, sidx), y, accumulate=True)
    return (xe[:experts], eidx.to(torch.int32), sidx.to(torch.int32),
            gate * keep)


def route_dispatch(logits, y, cap: int):
    """K19 for CUDA tensors (see the module doc); the plain version runs
    only for CPU tensors."""
    if logits.device.type == "cpu":
        return route_dispatch_plain(logits, y, cap)
    require_cuda(logits, "K19")
    if logits.dtype != torch.float32 or logits.dim() != 2 or \
            y.dtype != torch.bfloat16 or y.dim() != 2 or \
            y.device != logits.device or y.shape[0] != logits.shape[0]:
        raise TypeError("K19 takes (t, E) float32 logits and (t, d) "
                        "bfloat16 rows on one device")
    t, experts = logits.shape
    d = y.shape[1]
    if not 1 <= experts <= MAX_EXPERTS or d % 8 or cap < 1:
        raise ValueError(f"K19 takes 1-{MAX_EXPERTS} experts, a width that "
                         f"is a multiple of 8 and cap >= 1; got {experts}, "
                         f"{d}, {cap}")
    logits, y = logits.contiguous(), aligned(y)
    dev = y.device
    nblk = -(-t // TOKENS_PER_BLOCK)
    counts = torch.empty((nblk, experts), dtype=torch.int32, device=dev)
    eidx = torch.empty(t, dtype=torch.int32, device=dev)
    sidx = torch.empty(t, dtype=torch.int32, device=dev)
    gk = torch.empty(t, dtype=torch.float32, device=dev)
    xe = torch.empty((experts, cap, d), dtype=torch.bfloat16, device=dev)
    KERNELS["moe_route_dispatch"](ptr(logits), ptr(y), t, experts, d, cap,
                                  ptr(counts), ptr(eidx), ptr(sidx), ptr(gk),
                                  ptr(xe), stream_of(y))
    return xe, eidx, sidx, gk


def combine_plain(ye, eidx, sidx, gk):
    """ye (E, cap, d) bf16, eidx / sidx (t,) int32, gk (t,) f32 -> (t, d)
    bf16."""
    experts, cap, d = ye.shape
    yep = torch.cat([ye, ye.new_zeros((1, cap, d))])
    return yep[eidx.long(), sidx.long()] * gk[:, None].to(ye.dtype)


def combine(ye, eidx, sidx, gk):
    """K20 for CUDA tensors (see the module doc); the plain version runs
    only for CPU tensors."""
    if ye.device.type == "cpu":
        return combine_plain(ye, eidx, sidx, gk)
    require_cuda(ye, "K20")
    if ye.dtype != torch.bfloat16 or ye.dim() != 3 or \
            eidx.dtype != torch.int32 or sidx.dtype != torch.int32 or \
            gk.dtype != torch.float32 or \
            any(a.device != ye.device for a in (eidx, sidx, gk)):
        raise TypeError("K20 takes (E, cap, d) bfloat16 rows, int32 "
                        "eidx / sidx and float32 gk on one device")
    experts, cap, d = ye.shape
    t = eidx.shape[0]
    if d % 8 or sidx.shape != (t,) or gk.shape != (t,):
        raise ValueError(f"K20 takes a width that is a multiple of 8 and "
                         f"(t,) indices; got {d}, {tuple(sidx.shape)}, "
                         f"{tuple(gk.shape)}")
    ye = aligned(ye)
    eidx, sidx, gk = eidx.contiguous(), sidx.contiguous(), gk.contiguous()
    out = torch.empty((t, d), dtype=torch.bfloat16, device=ye.device)
    KERNELS["moe_combine"](ptr(ye), ptr(eidx), ptr(sidx), ptr(gk), t,
                           experts, cap, d, ptr(out), stream_of(ye))
    return out
