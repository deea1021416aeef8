"""LayerNorm of the ViT, bf16 in and out, float32 inside: kernels K17
(forward) and K21 (backward).

Counterpart of `picha_tpu/models/vit.py::_ln` (:145-152): x -> f32, the
mean, then the mean of the squared deviations (two passes), (x - mu) /
sqrt(var + 1e-6) as a true division, `* scale + bias` with the f32
parameters, and one rounding to x's dtype at the end. The backward is the
VJP JAX derives from those lines (`jax.vjp(_ln, ...)`), with its
rounding points: everything in f32 from the bf16 cotangent, dx rounded
once to x's dtype, dscale / dbias the f32 sums over the rows.

  `layer_norm_plain`, `layer_norm_backward_plain`  the torch versions
  `layer_norm_lanes`  K17's exact order of operations in torch ops: the
                kernel's bits on either device
  `layer_norm`  differentiable (`torch.autograd.Function`): K17 forward
                and K21 (`csrc/vit_layernorm_bwd.cu`) backward for CUDA
                tensors, the plain versions for CPU tensors
  `kernel_info` K21's and K17's launch plans and builds at a shape,
                from the card
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels._build import KERNELS, aligned, ptr, require_cuda, stream_of

EPS = 1e-6
MAX_DIM = 1024        # K17 / K21's tuned kernels keep a row in registers
                      # (16 bf16 pairs a lane, even widths); any other
                      # width takes their block-a-row kernels


def tuned(d: int) -> bool:
    """Whether width d takes K17's / K21's tuned warp-a-row kernels (an
    even width up to MAX_DIM); the others take the block-a-row ones."""
    return d % 2 == 0 and d <= MAX_DIM


def true_div(a, n):
    """a / n by an IEEE division on both devices: the divisor is a
    tensor on a's device (torch's CUDA division by a Python scalar, or by
    a CPU scalar tensor, multiplies by the reciprocal)."""
    return a / torch.tensor(float(n), dtype=a.dtype, device=a.device)


def layer_norm_plain(x, scale, bias):
    """(..., d) -> (..., d) in x's dtype; scale, bias (d,) float32."""
    x32 = x.to(torch.float32)
    d = x.shape[-1]
    mu = true_div(x32.sum(-1, keepdim=True), d)
    dev = x32 - mu
    var = true_div((dev * dev).sum(-1, keepdim=True), d)
    out = dev / torch.sqrt(var + EPS)
    return (out * scale + bias).to(x.dtype)


def layer_norm_lanes(x, scale, bias):
    """K17's tuned kernel (even d <= 1024) in torch ops, in its exact
    order, on x's device: lane L of a row's warp holds pairs L, L + 32,
    ... and sums them in that order (x, then y); the 32 lanes' sums meet
    in the xor-shuffle tree (strides 16, 8, 4, 2, 1); then true
    divisions, an IEEE square root and `* scale + bias` as separate
    float32 steps. Its bits are the kernel's, where the plain version's
    sums run in torch's order (within 1 bf16 ulp)."""
    d = x.shape[-1]
    if not tuned(d):
        raise ValueError(f"K17's tuned kernel takes even widths up to "
                         f"{MAX_DIM}, not {d}")
    rows, pairs, f32 = x.numel() // d, d // 2, torch.float32
    slots = (pairs + 31) // 32
    v = torch.zeros((rows, slots * 32, 2), dtype=f32, device=x.device)
    v[:, :pairs] = x.reshape(rows, pairs, 2).to(f32)
    v = v.view(rows, slots, 32, 2)
    live = (torch.arange(slots * 32, device=x.device) < pairs).view(
        slots, 32, 1)
    lane = torch.arange(32, device=x.device)

    def lane_sums(t):
        s = torch.zeros((rows, 32), dtype=f32, device=x.device)
        for i in range(slots):
            s = (s + t[:, i, :, 0]) + t[:, i, :, 1]
        for o in (16, 8, 4, 2, 1):
            s = s + s[:, lane ^ o]
        return s[:, :1, None, None]

    n = torch.tensor(float(d), dtype=f32, device=x.device)
    dev = torch.where(live, v - lane_sums(v) / n, 0.0)
    # the IEEE square root: float64's, rounded once to float32 (exact for
    # a square root; torch's float32 sqrt on the CPU is not always the
    # nearest float)
    den = torch.sqrt((lane_sums(dev * dev) / n + torch.tensor(
        EPS, dtype=f32, device=x.device)).double()).to(f32)
    sc = scale.to(f32).reshape(pairs, 2)
    bi = bias.to(f32).reshape(pairs, 2)
    y = (dev / den).view(rows, slots * 32, 2)[:, :pairs]
    return ((y * sc) + bi).to(x.dtype).reshape(x.shape)


def layer_norm_backward_plain(x, scale, dy):
    """The VJP of `layer_norm` at x: x, dy (..., d) bf16, scale (d,)
    float32 -> (dx in x's dtype, dscale (d,) float32, dbias (d,)
    float32), in the order of operations of JAX's derivative of `_ln`."""
    d = x.shape[-1]
    x32 = x.to(torch.float32)
    p = x32 - true_div(x32.sum(-1, keepdim=True), d)
    r = torch.sqrt(true_div((p * p).sum(-1, keepdim=True), d) + EPS)
    z = dy.to(torch.float32)
    dscale = (p / r * z).reshape(-1, d).sum(0)
    dbias = z.reshape(-1, d).sum(0)
    g = z * scale
    # the path through the variance: d/dr of (x - mu) / r, then sqrt
    dvar = -((g * (r * r).reciprocal()) * p).sum(-1, keepdim=True) * \
        (torch.tensor(0.5, device=x.device) / r)
    dvar_d = true_div(dvar, d)
    gr = g / r
    bv = dvar_d * (2.0 * p)
    # the two paths through the mean
    dmu = (-gr).sum(-1, keepdim=True) + (-bv).sum(-1, keepdim=True)
    dx = (gr + bv) + true_div(dmu, d)
    return dx.to(x.dtype), dscale, dbias


def _check(x, scale, kernel):
    require_cuda(x, kernel)
    d = x.shape[-1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{kernel} takes bfloat16 rows, got {x.dtype}")
    if d < 1:
        raise ValueError(f"{kernel} takes a width of at least 1, got {d}")
    if scale.dtype != torch.float32 or scale.device != x.device or \
            tuple(scale.shape) != (d,):
        raise TypeError(f"{kernel}'s scale and bias are ({d},) float32 on "
                        f"{x.device}")


def layer_norm_k17(x, scale, bias):
    """K17: (..., d) bf16 -> (..., d) bf16 on the card."""
    _check(x, scale, "K17")
    _check(x, bias, "K17")
    d = x.shape[-1]
    x = aligned(x, 4) if tuned(d) else x.contiguous()
    scale, bias = scale.contiguous(), bias.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    KERNELS["vit_layernorm"](ptr(x), ptr(scale), ptr(bias), rows, d,
                             ptr(out), stream_of(x))
    return out


_PLANS = {}


def _plan(rows: int, d: int, device, symbol="picha_vit_layernorm_bwd_info",
          n=11) -> list:
    """K21's (or, with `symbol` picha_vit_layernorm_info and n = 9,
    K17's) launch plan at (rows, d) on `device`'s card, as the C info
    function reports it (cached: the plan depends only on the shape and
    the card)."""
    from ..kernels._build import library

    key = (symbol, rows, d, device.index)
    if key not in _PLANS:
        out = (ctypes.c_int * n)()
        with torch.cuda.device(device):
            rc = getattr(library(), symbol)(rows, d, out)
        if rc != 0:
            raise RuntimeError(f"{symbol}: CUDA error {rc}")
        _PLANS[key] = list(out)
    return _PLANS[key]


_PLAN_KEYS = ("pairs_a_lane", "rows_a_block", "blocks", "blocks_an_sm",
              "sms", "shared_bytes", "registers", "local_bytes")


def kernel_info(rows: int, d: int, device=None) -> dict:
    """K21's plan and build at (rows, d) on the card: the path ("tuned",
    a warp a row through a cp.async ring; or "block_a_row"), bf16 pairs a
    lane, rows a block, blocks, blocks a multiprocessor, multiprocessors,
    dynamic shared bytes, registers and local bytes of the row kernel,
    and the columns kernel's blocks and threads; under "k17" the same
    plan keys of K17's row kernel (its block-a-row path: one row a
    block)."""
    device = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    p = _plan(rows, d, device)
    f = _plan(rows, d, device, "picha_vit_layernorm_info", 9)
    return dict(path="tuned" if p[0] else "block_a_row",
                **dict(zip(_PLAN_KEYS, p[1:9])), column_blocks=p[9],
                column_threads=p[10],
                k17=dict(path="tuned" if f[0] else "block_a_row",
                         **dict(zip(_PLAN_KEYS, f[1:9]))))


def layer_norm_backward(x, scale, dy):
    """`layer_norm_backward_plain`'s result: K21 for CUDA tensors, the
    plain version only for CPU tensors. K21 sums dscale / dbias in a
    fixed order (a partial a block over the plan's run of rows, then the
    blocks' partials in a fixed tree), so two runs give the same bits."""
    if x.device.type == "cpu":
        return layer_norm_backward_plain(x, scale, dy)
    _check(x, scale, "K21")
    if dy.dtype != torch.bfloat16 or dy.shape != x.shape or \
            dy.device != x.device:
        raise TypeError(f"K21 takes a bfloat16 cotangent of x's shape "
                        f"{tuple(x.shape)}")
    d = x.shape[-1]
    x, dy, scale = aligned(x, 4), aligned(dy, 4), aligned(scale, 8)
    rows = x.numel() // d if d else 0
    dx = torch.empty_like(x)
    nblk = _plan(rows, d, x.device)[3] if rows else 1
    partial = torch.empty((nblk, 2, d), dtype=torch.float32, device=x.device)
    dsb = torch.empty((2, d), dtype=torch.float32, device=x.device)
    # the block-a-row path keeps each row's (mu, r) for its column sums
    stats = None if tuned(d) else torch.empty((max(rows, 1), 2),
                                              dtype=torch.float32,
                                              device=x.device)
    KERNELS["vit_layernorm_bwd"](ptr(x), ptr(scale), ptr(dy), rows, d,
                                 ptr(dx), ptr(partial), partial.numel(),
                                 ptr(dsb),
                                 None if stats is None else ptr(stats),
                                 stream_of(x))
    return dx, dsb[0], dsb[1]


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias):
        ctx.save_for_backward(x, scale)
        if x.device.type == "cpu":
            return layer_norm_plain(x, scale, bias)
        return layer_norm_k17(x, scale, bias)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        return layer_norm_backward(x, scale, dy.contiguous())


def layer_norm(x, scale, bias):
    """(..., d) bf16 -> (..., d) bf16 on the same device, differentiable
    in x, scale and bias. Launches K17 (and K21 in the backward) for
    CUDA tensors; the plain versions run only for CPU tensors."""
    return _LayerNorm.apply(x, scale, bias)
