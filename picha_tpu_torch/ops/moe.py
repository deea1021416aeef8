"""Top-1 switch routing of the ViT's MoE blocks: kernels K19 and K20, and
their backwards K23 and K24.

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

The backwards are the VJPs JAX derives from those lines. The indices
carry no gradient (`argmax`, `keep`); the gate does:
- dispatch (K23): dy_t[t] = dxe[eidx, sidx] (0 for a dropped token, whose
  row went to the trash row the reference cuts off); the gate's
  cotangent dgate = dgk * keep goes back through `max` (split equally
  among tied gates) and the softmax, recomputed with K19's arithmetic:
  dlogits = ((dg / l) + -(sum_e dg_e * l^-2 * ex_e)) * ex, with ex the
  unnormalised exponentials and l their sum;
- combine (K24): dye[eidx, sidx] = dout * bf16(gk) (every other slot 0,
  -0 stored as +0: the reference's scatter adds into zeros), and dgk =
  the sum over the row of bf16(dout * ye[eidx, sidx]), summed in f32
  and rounded to bf16 (the gate entered the product as a bf16 value).
  The sum's order is fixed (`warp_order_sum`), the same in K24 and its
  plain version.

  `route_dispatch_plain`, `combine_plain`, `dispatch_backward_plain`,
  `combine_backward_plain`  the torch versions
  `route_dispatch`  K19 forward, K23 backward (`csrc/vit_moe.cu`,
                    `csrc/vit_moe_bwd.cu`) for CUDA tensors
  `combine`         K20 forward, K24 backward (the same files)
Both are `torch.autograd.Function`s and run their plain versions for CPU
tensors.
"""
from __future__ import annotations

import math

import torch

from ..kernels._build import KERNELS, aligned, ptr, require_cuda, stream_of

MAX_EXPERTS = 64                 # the tuned K19's count table in shared memory
TOKENS_PER_BLOCK = 256           # K19's block of tokens (its count table)


def tuned(experts: int, d: int) -> bool:
    """Whether K19-K24 take their tuned kernels (at most MAX_EXPERTS
    experts, 16-byte rows); any other shape takes the kernels past that
    envelope, chosen by the C entry points alone."""
    return experts <= MAX_EXPERTS and d % 8 == 0


def capacity(t: int, experts: int, capacity_factor: float) -> int:
    """Slots per expert, as the reference computes them (:211)."""
    return max(1, int(math.ceil(t / experts * capacity_factor)))


def _softmax_parts(logits):
    """(t, E) f32 -> (ex, l): the exponentials after the max subtract and
    their sum in expert order (K19's arithmetic; the max detached, as the
    reference's softmax takes no gradient through it)."""
    ex = torch.exp(logits - logits.amax(-1, keepdim=True).detach())
    s = ex[:, 0]
    for i in range(1, ex.shape[1]):
        s = s + ex[:, i]
    return ex, s[:, None]


def route_plain(logits):
    """(t, E) f32 logits -> (expert (t,) int64, gate (t,) f32): softmax
    as max-subtract, exp, the sum in expert order and a true division;
    the first maximum wins."""
    ex, s = _softmax_parts(logits)
    gates = ex / s
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


def combine_plain(ye, eidx, sidx, gk):
    """ye (E, cap, d) bf16, eidx / sidx (t,) int32, gk (t,) f32 -> (t, d)
    bf16."""
    experts, cap, d = ye.shape
    yep = torch.cat([ye, ye.new_zeros((1, cap, d))])
    return yep[eidx.long(), sidx.long()] * gk[:, None].to(ye.dtype)


def dispatch_backward_plain(dxe, eidx, sidx, logits, dgk):
    """The VJP of `route_dispatch` (see the module doc): dxe (E, cap, d)
    bf16, eidx / sidx (t,) int32, logits (t, E) f32, dgk (t,) f32 ->
    (dy_t (t, d) bf16, dlogits (t, E) f32)."""
    experts, cap, d = dxe.shape
    dxp = torch.cat([dxe, dxe.new_zeros((1, cap, d))])
    dy = dxp[eidx.long(), sidx.long()]
    ex, l = _softmax_parts(logits)
    gates = ex / l
    tied = (gates == gates.amax(-1, keepdim=True)).to(torch.float32)
    count = tied.sum(-1, keepdim=True)
    dgate = dgk * (eidx < experts).to(torch.float32)
    dg = (dgate[:, None] / count) * tied
    w = (dg * (l * l).reciprocal()) * ex
    c = w[:, :1]
    for i in range(1, experts):
        c = c + w[:, i:i + 1]
    return dy, ((dg / l) + -c) * ex


def warp_order_sum(prod):
    """(t, d) f32 -> (t,) f32: each row summed in K24's order. Lane j of a
    warp adds the 8 values of the chunks j, j + 32, ... in turn (the last
    chunk cut short where d is not a multiple of 8); then the 32 lane
    sums meet in a butterfly (xor 16, 8, 4, 2, 1). The zeros this pads
    with change no sum: an f32 sum that starts at +0 never reaches -0."""
    t, d = prod.shape
    chunks = -(-d // 8)
    k = -(-chunks // 32)
    v = torch.zeros((t, k * 32 * 8), dtype=torch.float32, device=prod.device)
    v[:, :d] = prod
    v = v.view(t, k, 32, 8)
    acc = torch.zeros((t, 32), dtype=torch.float32, device=prod.device)
    for kk in range(k):
        for e in range(8):
            acc = acc + v[:, kk, :, e]
    lanes = torch.arange(32, device=prod.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lanes ^ o]
    return acc[:, 0]


def combine_backward_plain(dout, ye, eidx, sidx, gk):
    """The VJP of `combine` (see the module doc): dout (t, d) bf16, ye (E,
    cap, d) bf16, eidx / sidx (t,) int32, gk (t,) f32 -> (dye (E, cap, d)
    bf16, dgk (t,) f32)."""
    experts, cap, d = ye.shape
    e, s = eidx.long(), sidx.long()
    dye = torch.zeros((experts + 1, cap, d), dtype=ye.dtype, device=ye.device)
    dye.index_put_((e, s), dout * gk[:, None].to(ye.dtype), accumulate=True)
    yep = torch.cat([ye, ye.new_zeros((1, cap, d))])
    prod = (dout * yep[e, s]).to(torch.float32)
    dgk = warp_order_sum(prod).to(torch.bfloat16).to(torch.float32)
    return dye[:experts], dgk


def _check_route(logits, y, cap, kernel):
    require_cuda(logits, kernel)
    if logits.dtype != torch.float32 or logits.dim() != 2 or \
            y.dtype != torch.bfloat16 or y.dim() != 2 or \
            y.device != logits.device or y.shape[0] != logits.shape[0]:
        raise TypeError(f"{kernel} takes (t, E) float32 logits and (t, d) "
                        f"bfloat16 rows on one device")
    experts, d = logits.shape[1], y.shape[1]
    if experts < 1 or d < 1 or cap < 1:
        raise ValueError(f"{kernel} takes at least one expert, a width of at "
                         f"least 1 and cap >= 1; got {experts}, {d}, {cap}")


def route_dispatch_k19(logits, y, cap: int):
    """K19 on the card (see the module doc)."""
    _check_route(logits, y, cap, "K19")
    t, experts = logits.shape
    d = y.shape[1]
    logits, y = logits.contiguous(), aligned(y)
    dev = y.device
    nblk = -(-t // TOKENS_PER_BLOCK)
    counts = torch.empty((nblk + 1, experts), dtype=torch.int32, device=dev)
    # the kernels past the tuned envelope keep each token's rank in its block
    rank = None if tuned(experts, d) else torch.empty(
        max(t, 1), dtype=torch.int32, device=dev)
    eidx = torch.empty(t, dtype=torch.int32, device=dev)
    sidx = torch.empty(t, dtype=torch.int32, device=dev)
    gk = torch.empty(t, dtype=torch.float32, device=dev)
    xe = torch.empty((experts, cap, d), dtype=torch.bfloat16, device=dev)
    KERNELS["moe_route_dispatch"](ptr(logits), ptr(y), t, experts, d, cap,
                                  ptr(counts),
                                  None if rank is None else ptr(rank),
                                  ptr(eidx), ptr(sidx), ptr(gk), ptr(xe),
                                  stream_of(y))
    return xe, eidx, sidx, gk


def _check_slots(ye, eidx, sidx, gk, kernel):
    if ye.dtype != torch.bfloat16 or ye.dim() != 3 or \
            eidx.dtype != torch.int32 or sidx.dtype != torch.int32 or \
            gk.dtype != torch.float32 or \
            any(a.device != ye.device for a in (eidx, sidx, gk)):
        raise TypeError(f"{kernel} takes (E, cap, d) bfloat16 rows, int32 "
                        f"eidx / sidx and float32 gk on one device")
    t = eidx.shape[0]
    if ye.shape[2] < 1 or sidx.shape != (t,) or gk.shape != (t,):
        raise ValueError(f"{kernel} takes a width of at least 1 and (t,) "
                         f"indices; got {ye.shape[2]}, "
                         f"{tuple(sidx.shape)}, {tuple(gk.shape)}")


def combine_k20(ye, eidx, sidx, gk):
    """K20 on the card (see the module doc)."""
    require_cuda(ye, "K20")
    _check_slots(ye, eidx, sidx, gk, "K20")
    experts, cap, d = ye.shape
    t = eidx.shape[0]
    ye = aligned(ye)
    eidx, sidx, gk = eidx.contiguous(), sidx.contiguous(), gk.contiguous()
    out = torch.empty((t, d), dtype=torch.bfloat16, device=ye.device)
    KERNELS["moe_combine"](ptr(ye), ptr(eidx), ptr(sidx), ptr(gk), t,
                           experts, cap, d, ptr(out), stream_of(ye))
    return out


def dispatch_backward(dxe, eidx, sidx, logits, dgk):
    """`dispatch_backward_plain`'s result: K23 for CUDA tensors, the plain
    version only for CPU tensors."""
    if dxe.device.type == "cpu":
        return dispatch_backward_plain(dxe, eidx, sidx, logits, dgk)
    require_cuda(dxe, "K23")
    _check_slots(dxe, eidx, sidx, dgk, "K23")
    experts, cap, d = dxe.shape
    t = eidx.shape[0]
    if logits.dtype != torch.float32 or logits.device != dxe.device or \
            tuple(logits.shape) != (t, experts):
        raise ValueError(f"K23 takes ({t}, {experts}) float32 logits")
    dxe, logits = aligned(dxe), logits.contiguous()
    eidx, sidx, dgk = eidx.contiguous(), sidx.contiguous(), dgk.contiguous()
    dy = torch.empty((t, d), dtype=torch.bfloat16, device=dxe.device)
    dlogits = torch.empty((t, experts), dtype=torch.float32,
                          device=dxe.device)
    KERNELS["moe_dispatch_bwd"](ptr(dxe), ptr(eidx), ptr(sidx), ptr(logits),
                                ptr(dgk), t, experts, cap, d, ptr(dy),
                                ptr(dlogits), stream_of(dxe))
    return dy, dlogits


def combine_backward(dout, ye, eidx, sidx, gk):
    """`combine_backward_plain`'s result: K24 for CUDA tensors, the plain
    version only for CPU tensors. K24 writes every byte of dye."""
    if ye.device.type == "cpu":
        return combine_backward_plain(dout, ye, eidx, sidx, gk)
    require_cuda(ye, "K24")
    _check_slots(ye, eidx, sidx, gk, "K24")
    experts, cap, d = ye.shape
    t = eidx.shape[0]
    if dout.dtype != torch.bfloat16 or dout.device != ye.device or \
            tuple(dout.shape) != (t, d):
        raise TypeError(f"K24 takes a ({t}, {d}) bfloat16 cotangent")
    dout, ye = aligned(dout), aligned(ye)
    eidx, sidx, gk = eidx.contiguous(), sidx.contiguous(), gk.contiguous()
    dye = torch.empty_like(ye)
    dgk = torch.empty(t, dtype=torch.float32, device=ye.device)
    KERNELS["moe_combine_bwd"](ptr(dout), ptr(ye), ptr(eidx), ptr(sidx),
                               ptr(gk), t, experts, cap, d, ptr(dye),
                               ptr(dgk), stream_of(ye))
    return dye, dgk


class _RouteDispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, y, cap):
        if logits.device.type == "cpu":
            out = route_dispatch_plain(logits, y, cap)
        else:
            out = route_dispatch_k19(logits, y, cap)
        ctx.save_for_backward(logits, out[1], out[2])
        ctx.mark_non_differentiable(out[1], out[2])
        return out

    @staticmethod
    def backward(ctx, dxe, _deidx, _dsidx, dgk):
        logits, eidx, sidx = ctx.saved_tensors
        dy, dlogits = dispatch_backward(dxe.contiguous(), eidx, sidx, logits,
                                        dgk.contiguous())
        return dlogits, dy, None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ye, eidx, sidx, gk):
        ctx.save_for_backward(ye, eidx, sidx, gk)
        if ye.device.type == "cpu":
            return combine_plain(ye, eidx, sidx, gk)
        return combine_k20(ye, eidx, sidx, gk)

    @staticmethod
    def backward(ctx, dout):
        ye, eidx, sidx, gk = ctx.saved_tensors
        dye, dgk = combine_backward(dout.contiguous(), ye, eidx, sidx, gk)
        return dye, None, None, dgk


def route_dispatch(logits, y, cap: int):
    """(xe, eidx, sidx, gk), differentiable in logits and y through xe
    and gk: K19 (and K23 in the backward) for CUDA tensors; the plain
    versions run only for CPU tensors."""
    return _RouteDispatch.apply(logits, y, cap)


def combine(ye, eidx, sidx, gk):
    """(t, d) bf16, differentiable in ye and gk: K20 (and K24 in the
    backward) for CUDA tensors; the plain versions run only for CPU
    tensors."""
    return _Combine.apply(ye, eidx, sidx, gk)
