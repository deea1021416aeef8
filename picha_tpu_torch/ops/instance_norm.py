"""The ResNet's instance norm + scale + ReLU, bf16 NHWC in and out, float32
inside: kernels K25 (forward) and K26 (backward).

Counterpart of `picha_tpu/models/resnet.py::_norm` (:100-106) followed by
`jax.nn.relu` (:129, :131): per (image, channel), x -> f32, the mean over
(H, W), then the mean of the squared deviations around it, (x - mu) /
sqrt(var + 1e-5) as a true division, `* scale` with the f32 (C,) scale,
one rounding to bf16, then the ReLU. The plain version takes two passes;
K25 one pass for both sums (x and x * x, exact float64 where they meet)
and one for the output. The backward is the VJP JAX derives
from those lines, with its rounding points (read off `jax.make_jaxpr`):
the ReLU's mask is `w > 0` on the bf16 norm output (the saved output y
has `y > 0` exactly there), the bf16 cotangent is selected and then
converted to f32, dscale is the f32 sum of x_hat * g over (N, H, W), both
means divide by H * W as a true division, and dx is rounded once to bf16.

  `norm_relu_plain`, `norm_relu_backward_plain`  the torch versions
  `normalize_relu`   the elementwise pass alone, on given mu and sigma
  `norm_relu_k25`    K25 (`csrc/resnet_norm.cu`) on CUDA tensors
  `norm_relu_backward`  K26 (`csrc/resnet_norm_bwd.cu`) for CUDA tensors,
                     the plain version only for CPU tensors
  `kernel_info`      K25's and K26's plans and builds at a shape
  `norm_relu`        differentiable (`torch.autograd.Function`): K25 and
                     K26 for CUDA tensors, the plain versions for CPU ones

Layout: x (N, H, W, C) bf16 with C contiguous, scale (C,) f32; mu and
sigma = sqrt(var + 1e-5) are (N, C) f32, kept from the forward for the
backward.
"""
from __future__ import annotations

import torch

from ..kernels._build import KERNELS, ptr, require_cuda, stream_of
from .layernorm import true_div

EPS = 1e-5


def normalize_relu(x, scale, mu, sigma, dtype=torch.bfloat16):
    """relu(dtype((x - mu) / sigma * scale)) on given (N, C) statistics:
    the elementwise pass of the forward (IEEE f32 operations, one
    rounding to `dtype`)."""
    d = x.to(torch.float32) - mu[:, None, None, :]
    return torch.relu((d / sigma[:, None, None, :] * scale).to(dtype))


def _stats(x32):
    """(mu, sigma) (N, C) f32 of x32 (N, H, W, C) f32: two passes, true
    divisions by H * W."""
    hw = x32.shape[1] * x32.shape[2]
    mu = true_div(x32.sum((1, 2)), hw)
    d = x32 - mu[:, None, None, :]
    var = true_div((d * d).sum((1, 2)), hw)
    return mu, torch.sqrt(var + EPS)


def norm_relu_plain(x, scale):
    """x (N, H, W, C) bf16, scale (C,) f32 -> (y in x's dtype, mu,
    sigma). x is converted to f32 once, as the reference does (so its
    autograd rounds dx to bf16 once)."""
    x32 = x.to(torch.float32)
    mu, sigma = _stats(x32)
    return normalize_relu(x32, scale, mu, sigma, x.dtype), mu, sigma


def norm_relu_backward_plain(x, y, dy, scale, mu, sigma):
    """The VJP of `norm_relu` at x: x, y (its output), dy (N, H, W, C)
    bf16, scale (C,), mu, sigma (N, C) f32 -> (dx in x's dtype, dscale
    (C,) f32), in the order of operations of JAX's derivative of
    `relu(_norm(x, scale))`."""
    hw = x.shape[1] * x.shape[2]
    x32 = x.to(torch.float32)
    p = x32 - mu[:, None, None, :]
    r = sigma[:, None, None, :]
    # the ReLU's mask on the bf16 output, the cotangent selected in bf16
    g = torch.where(y > 0, dy, torch.zeros_like(dy)).to(torch.float32)
    dscale = (p / r * g).sum((0, 1, 2))
    gs = g * scale
    # the path through the variance: d/dr of (x - mu) / r, then sqrt
    dvar = -((gs * (r * r).reciprocal()) * p).sum((1, 2), keepdim=True) * \
        (torch.tensor(0.5, device=x.device) / r)
    dvar_hw = true_div(dvar, hw)
    gr = gs / r
    bv = dvar_hw * (2.0 * p)
    # the two paths through the mean
    dmu = (-gr).sum((1, 2), keepdim=True) + (-bv).sum((1, 2), keepdim=True)
    dx = (gr + bv) + true_div(dmu, hw)
    return dx.to(x.dtype), dscale


def _check(x, scale, kernel):
    require_cuda(x, kernel)
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise TypeError(f"{kernel} takes (N, H, W, C) bfloat16, got "
                        f"{tuple(x.shape)} {x.dtype}")
    c = x.shape[3]
    if c < 1:
        raise ValueError(f"{kernel} takes at least one channel, got {c}")
    if scale.dtype != torch.float32 or scale.device != x.device or \
            tuple(scale.shape) != (c,):
        raise TypeError(f"{kernel}'s scale is ({c},) float32 on {x.device}")


def norm_relu_k25(x, scale):
    """K25: x (N, H, W, C) bf16 on the card -> (y bf16, mu, sigma (N, C)
    f32). Each plane's sums of x and x * x run in one pass, in f32 over a
    few pixels a thread, then in float64 in a fixed order (a thread-block
    cluster a plane, no atomics): two runs give the same bits."""
    _check(x, scale, "K25")
    n, h, w, c = x.shape
    x, scale = x.contiguous(), scale.contiguous()
    y = torch.empty_like(x)
    stats = torch.empty((2, n, c), dtype=torch.float32, device=x.device)
    KERNELS["resnet_norm"](ptr(x), ptr(scale), n, h * w, c, ptr(y),
                           ptr(stats), stream_of(x))
    return y, stats[0], stats[1]


def norm_relu_backward(x, y, dy, scale, mu, sigma):
    """`norm_relu_backward_plain`'s result: K26 for CUDA tensors, the
    plain version only for CPU tensors. y must be K25's output for this
    x, scale, mu and sigma, as `norm_relu` saves them: K26 does not read
    it, it recomputes the ReLU's mask, bf16(((x - mu) / sigma) * scale)
    > 0, in K25's rounding order, which is y > 0 bit for bit. K26 sums
    each plane's terms in f32 over a few pixels a thread, then in float64
    in a fixed order, and dscale's per-(n, c) terms over n in order: two
    runs give the same bits."""
    if x.device.type == "cpu":
        return norm_relu_backward_plain(x, y, dy, scale, mu, sigma)
    _check(x, scale, "K26")
    for t in (y, dy):
        if t.dtype != torch.bfloat16 or t.shape != x.shape or \
                t.device != x.device:
            raise TypeError(f"K26 takes y and dy as bfloat16 of x's shape "
                            f"{tuple(x.shape)}")
    n, h, w, c = x.shape
    for t in (mu, sigma):
        if t.dtype != torch.float32 or tuple(t.shape) != (n, c) or \
                t.device != x.device:
            raise TypeError(f"K26 takes mu and sigma as ({n}, {c}) float32")
    x, dy = x.contiguous(), dy.contiguous()
    scale, mu, sigma = scale.contiguous(), mu.contiguous(), sigma.contiguous()
    dx = torch.empty_like(x)
    dscale = torch.empty((c,), dtype=torch.float32, device=x.device)
    plane = torch.empty((n, 3, c), dtype=torch.float64, device=x.device)
    KERNELS["resnet_norm_bwd"](ptr(x), ptr(dy), ptr(scale), ptr(mu),
                               ptr(sigma), n, h * w, c, ptr(dx), ptr(dscale),
                               ptr(plane), stream_of(x))
    return dx, dscale


_PLAN = ("vector_width", "threads_per_pixel", "channel_groups",
         "cluster_size", "launches")
_BUILD = ("registers", "local_bytes", "shared_bytes", "threads",
          "blocks_per_sm")


def kernel_info(hw: int, c: int, vector_width: int = 8) -> dict:
    """K25's and K26's plans and builds for a call on planes of hw pixels
    and c channels at a vector width (8: c % 8 == 0 and 16-byte aligned
    bases, 2, or 1), as the card reports them: channels a thread, threads
    across a pixel, channel groups, CTAs a cluster and launches a call;
    then for each kernel (the plane kernel; K25's output kernel, K26's
    dx kernel) its registers and local (spill) bytes a thread, shared
    bytes a block (static and dynamic), threads a block and resident
    blocks a multiprocessor. Launches nothing and counts no launch."""
    import ctypes

    from ..kernels._build import library

    out = {}
    for key, sym in (("K25", "picha_resnet_norm_info"),
                     ("K26", "picha_resnet_norm_bwd_info")):
        vals = (ctypes.c_int * 15)()
        rc = getattr(library(), sym)(hw, c, vector_width, vals)
        if rc != 0:
            raise RuntimeError(f"{sym}: CUDA error {rc}")
        plan = dict(zip(_PLAN, vals[:5]))
        names = ("plane", "output") if key == "K25" else ("plane", "dx")
        plan["kernels"] = {name: dict(zip(_BUILD, vals[5 + 5 * i:10 + 5 * i]))
                           for i, name in enumerate(names)}
        out[key] = plan
    return out


class _NormReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        if x.device.type == "cpu":
            y, mu, sigma = norm_relu_plain(x, scale)
        else:
            y, mu, sigma = norm_relu_k25(x, scale)
        ctx.save_for_backward(x, y, scale, mu, sigma)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y, scale, mu, sigma = ctx.saved_tensors
        return norm_relu_backward(x, y, dy.contiguous(), scale, mu, sigma)


def norm_relu(x, scale):
    """relu(instance_norm(x) * scale): (N, H, W, C) bf16 -> the same, on
    x's device, differentiable in x and scale. Launches K25 (and K26 in
    the backward) for CUDA tensors; the plain versions run only for CPU
    tensors."""
    return _NormReLU.apply(x, scale)
