"""The precision design of the attention kernels K18 (forward) and K22
(backward), checked on the CPU: an emulation of their tensor-core
arithmetic (`torch_helpers.attention_mma`, `attention_backward_mma`:
each 16-deep step the exact sum of the accumulator and 16 bf16 x bf16
products truncated to f32; the scores and dP taken step by step from a
zero accumulator and added with round-to-nearest; the dP values whose
bf16 rounding that leaves ambiguous summed again in order) against the
plain versions (`attention_plain`,
`attention_backward_plain`), under the bounds `chip_smoke.py` holds the
kernels to on the card:

- the forward: each o within 1 bf16 ulp of itself plus 1 ulp of its
  row's largest |o| (a probability may round to the neighbouring bf16
  value when the scores are summed in another order; o can cancel);
- the backward: each value of dq, dk, dv within 1 ulp of itself plus 1
  ulp of the largest |value| of its row (D values).

At ViT-S's head shape (S = 196, D = 64), the card tests' odd shapes
(S = 1, 17, 255, 256 at D = 32) and a shape of the tiled builds (S = 300,
past one tile of 256 keys, at D = 40, zero-padded to the 16-deep step:
the tiled kernels take the scores, e, l and p of all keys before any
product with v, so their arithmetic is this same emulation), on random heads and on three rows that
strain the arithmetic: a uniform row (all scores equal), a saturated row
(one score far above the rest) and keys that differ little (dq = sum dS k
cancels, since a softmax row's dS sums to 0).

The emulation does not model the truncation of the products as the
hardware aligns them inside a step, so it holds the design, not the
kernels' bits; the card tests and chip_smoke.py hold those.

It also records what the two designs the kernels do not take would do:
- the scale folded into q (bf16(q * scale) . k): exact at D = 64, where
  the scale is 2^-3, and 1.6-2.7 times the forward's bound at D = 32;
- dS given to the tensor cores as one bf16 value, where the kernels give
  hi = bf16(dS) and lo = bf16(dS - hi): on keys that differ little, dq
  lands 7-10 times the bound away, where the split stays within half of
  it.
(measured: `PYTHONPATH=. python tests/test_torch_attention_numerics.py`
prints every ratio.)
"""
import numpy as np
import pytest
import torch

from torch_helpers import attention_backward_mma, attention_mma

from picha_tpu_torch.ops.attention import (attention_backward_plain,
                                           attention_plain)

SHAPES = [(2, 196, 3, 64), (2, 1, 2, 32), (2, 17, 2, 32), (1, 255, 2, 32),
          (1, 256, 2, 32), (1, 300, 2, 40), (1, 576, 1, 64)]
KINDS = ["random", "uniform", "saturated", "near_keys"]


def _ulp(v):
    m = v.abs().double().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


def _inputs(n, s, h, d, kind, seed=0):
    """(N, S, 3, H, D) bf16 qkv and (N, S, H * D) bf16 do from a seed;
    `kind` shapes every third query row (uniform: q = 0, so all its
    scores are equal; saturated: q = 8 x key 5, one score far above the
    rest) or the keys (near_keys: key 0 plus a quarter of noise)."""
    rng = np.random.default_rng([s, h, d, seed])
    qkv = (2.0 * rng.standard_normal((n, s, 3, h, d))).astype(np.float32)
    if kind == "uniform":
        qkv[:, ::3, 0] = 0.0
    elif kind == "saturated":
        qkv[:, ::3, 0] = 8.0 * qkv[:, 5 % s, 1][:, None]
    elif kind == "near_keys":
        qkv[:, :, 1] = qkv[:, :1, 1] + 0.25 * rng.standard_normal(
            (n, s, h, d))
    do = rng.standard_normal((n, s, h * d)).astype(np.float32)
    return (torch.from_numpy(qkv).to(torch.bfloat16),
            torch.from_numpy(do).to(torch.bfloat16))


def _forward_ratio_by_head(got, want, h):
    """max |got - want| / (1 ulp + 1 ulp of the row's largest |o|), a
    row being one head's D values of a token."""
    n, s, hd = want.shape
    d = hd // h
    row = want.view(n, s, h, d).abs().amax(-1, keepdim=True).expand(
        n, s, h, d).reshape(n, s, hd)
    diff = (got.double() - want.double()).abs()
    return float((diff / (_ulp(torch.maximum(got.abs(), want.abs()))
                          + _ulp(row))).max())


def _backward_ratios(got, want):
    """max |got - want| / (1 ulp + 1 ulp of the row's largest |value|),
    for dq, dk and dv."""
    diff = (got.double() - want.double()).abs()
    lim = _ulp(torch.maximum(got.abs(), want.abs())) + \
        _ulp(want.abs().amax(-1, keepdim=True))
    r = diff / lim
    return [float(r[:, :, i].max()) for i in range(3)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,s,h,d", SHAPES)
def test_forward_arithmetic_within_the_card_bound(n, s, h, d, kind):
    """The scale applied after the f32 dot, the exact row max, expf, the
    true division, p rounded to bf16, p . v summed 16 keys at a time."""
    qkv, _do = _inputs(n, s, h, d, kind)
    scale = 1.0 / d ** 0.5
    got = attention_mma(qkv, scale)
    want = attention_plain(qkv, scale)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _forward_ratio_by_head(got, want, h) <= 1.0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,s,h,d", SHAPES)
def test_backward_arithmetic_within_the_card_bound(n, s, h, d, kind):
    """dP rounded to bf16, c and dS in f32 at the reference's rounding
    points, dS split into hi + lo bf16 terms for dq and dk, p^T . do."""
    qkv, do = _inputs(n, s, h, d, kind)
    scale = 1.0 / d ** 0.5
    got = attention_backward_mma(qkv, do, scale)
    want = attention_backward_plain(qkv, do, scale)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert max(_backward_ratios(got, want)) <= 1.0


@pytest.mark.parametrize("n,s,h,d", SHAPES)
def test_scale_folded_into_q_rounds_otherwise(n, s, h, d):
    """bf16(q * scale) . k in place of (q . k) * scale: the same bits at D
    = 64 (scale 2^-3 is exact); past the bound at D = 32 wherever a row
    has more than one key (1.6-2.7 times it, measured)."""
    qkv, _do = _inputs(n, s, h, d, "random")
    scale = 1.0 / d ** 0.5
    want = attention_plain(qkv, scale)
    folded = attention_mma(qkv, scale, fold_scale=True)
    if d == 64:
        assert torch.equal(folded, attention_mma(qkv, scale))
    elif s == 1:
        assert torch.equal(folded, want)          # o = v whatever p rounds
    else:
        assert _forward_ratio_by_head(folded, want, h) > 1.5


@pytest.mark.parametrize("n,s,h,d", [sh for sh in SHAPES if sh[1] > 1])
def test_single_bf16_ds_breaks_dq_where_keys_differ_little(n, s, h, d):
    """dS rounded once to bf16 (2^-9) leaves dq = sum dS k, which cancels
    where the keys differ little, 7-10 times the bound away (measured);
    the hi + lo split (2^-17) stays within half of it. dk and dv stay in
    bound either way."""
    qkv, do = _inputs(n, s, h, d, "near_keys")
    scale = 1.0 / d ** 0.5
    want = attention_backward_plain(qkv, do, scale)
    split = _backward_ratios(attention_backward_mma(qkv, do, scale), want)
    single = _backward_ratios(
        attention_backward_mma(qkv, do, scale, terms=1), want)
    assert max(split) <= 0.5
    assert single[0] > 5.0
    assert max(single[1:]) <= 1.0


if __name__ == "__main__":
    # the ratios this file's docstring quotes:
    # PYTHONPATH=. python tests/test_torch_attention_numerics.py
    for n, s, h, d in SHAPES:
        scale = 1.0 / d ** 0.5
        for kind in KINDS:
            qkv, do = _inputs(n, s, h, d, kind)
            fwd = _forward_ratio_by_head(attention_mma(qkv, scale),
                                         attention_plain(qkv, scale), h)
            bwd = _backward_ratios(attention_backward_mma(qkv, do, scale),
                                   attention_backward_plain(qkv, do, scale))
            print(f"S={s} D={d} {kind}: forward {fwd:.3f}, backward "
                  f"dq/dk/dv {[round(r, 3) for r in bwd]}")
        qkv, do = _inputs(n, s, h, d, "random")
        folded = _forward_ratio_by_head(
            attention_mma(qkv, scale, fold_scale=True),
            attention_plain(qkv, scale), h)
        print(f"S={s} D={d} scale folded into q: forward {folded:.3f}")
        if s > 1:
            qkv, do = _inputs(n, s, h, d, "near_keys")
            want = attention_backward_plain(qkv, do, scale)
            single = _backward_ratios(
                attention_backward_mma(qkv, do, scale, terms=1), want)
            print(f"S={s} D={d} near keys, single bf16 dS: dq/dk/dv "
                  f"{[round(r, 3) for r in single]}")
