"""LayerNorm of the ViT, bf16 in and out, float32 inside: kernel K17.

Counterpart of `picha_tpu/models/vit.py::_ln` (:145-152): x -> f32, the
mean, then the mean of the squared deviations (two passes), (x - mu) /
sqrt(var + 1e-6) as a true division, `* scale + bias` with the f32
parameters, and one rounding to x's dtype at the end.

  `layer_norm_plain`  the torch version
  `layer_norm`        K17 (`csrc/vit_layernorm.cu`) for CUDA tensors, the
                      plain version for CPU tensors
"""
from __future__ import annotations

import torch

from ..kernels._build import KERNELS, aligned, ptr, require_cuda, stream_of

EPS = 1e-6
MAX_DIM = 1024        # K17 keeps a row in registers: 16 bf16 pairs a lane


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


def layer_norm(x, scale, bias):
    """(..., d) bf16 -> (..., d) bf16 on the same device. Launches K17
    for CUDA tensors; the plain version runs only for CPU tensors."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias)
    require_cuda(x, "K17")
    d = x.shape[-1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"K17 takes bfloat16 rows, got {x.dtype}")
    if d % 2 or d > MAX_DIM:
        raise ValueError(f"K17 takes an even width up to {MAX_DIM}, got {d}")
    for t in (scale, bias):
        if t.dtype != torch.float32 or t.device != x.device or \
                tuple(t.shape) != (d,):
            raise TypeError(f"K17's scale and bias are ({d},) float32 on "
                            f"{x.device}")
    x = aligned(x, 4)
    scale, bias = scale.contiguous(), bias.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    KERNELS["vit_layernorm"](ptr(x), ptr(scale), ptr(bias), rows, d,
                             ptr(out), stream_of(x))
    return out
