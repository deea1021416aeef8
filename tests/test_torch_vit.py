"""The port's ViT forward (picha_tpu_torch.models.vit) on CPU tensors, the
plain versions of K17-K20, against picha_tpu/models/vit.py on JAX-CPU,
with the same numpy-seeded inputs and the same weights
(`params_from_jax` of the reference's `init_params`):

- K17's plain version (`layer_norm_plain`) against `_ln`: within 1 bf16
  ulp (both sum in f32, in different orders; the rest is elementwise in
  the same order);
- K18's plain version (`attention_plain`) against the reference's
  attention lines (:171-180, transcribed in jnp below): within 2 bf16
  ulp plus one ulp of the largest |o| in the row (the dots' sums are
  taken in other orders, so a probability may round to the neighbouring
  bf16 value);
- the port's `_switch_moe` (K19 and K20 plain) against the reference's,
  called directly: the routing (expert, slot, keep) exactly equal on
  inputs whose top-2 router gates are more than 1e-4 apart (the router
  product's f32 sums differ in order, so a closer call could flip), the
  output within 2 bf16 ulp of its row's largest |value|: the reference's
  tanh-GELU on bf16 rounds after every op (x^3, the products, tanh)
  where `F.gelu` rounds once, which moves 40 % of the hidden values,
  those near 0 by up to 253 of their own ulps, and the second expert
  product sums those moves over 512 terms; also with a skewed router
  that drops tokens past capacity;
- one dense block (depth 1) at TINY widths and at ViT-S widths on 64 px,
  and the whole forward at TINY and TINY_MOE: logits within 0.03 (the
  logits are bf16 values: 0.03 is two bf16 ulp at |logit| in [2, 4),
  where the largest of these logits lie), argmax equal where the top-2
  margin exceeds 0.06;
- `init_params` leaf for leaf against the reference's tree (shapes,
  dtype, the normal / sqrt(fan_in) scale);
- the plain versions' own rules (first maximum on a router tie, an empty
  expert, -0 dispatched as +0, cap 1, dropped tokens giving 0), the
  precision guard restoring the caller's flags, the `mark` stages, and
  the wrappers refusing a device that is neither the CPU nor CUDA.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picha_tpu.models import vit as ref_vit
from picha_tpu_torch.models import vit as port_vit
from picha_tpu_torch.ops import jpeg as port_jpeg
from picha_tpu_torch.ops.attention import attention, attention_plain
from picha_tpu_torch.ops.layernorm import layer_norm, layer_norm_plain
from picha_tpu_torch.ops.moe import (capacity, combine, combine_plain,
                                     route_dispatch, route_dispatch_plain)

LOGIT_TOL = 0.03
ARGMAX_MARGIN = 0.06
GAP_MIN = 1e-4


def _bf16_np(a):
    """float32 numpy -> its bf16 values as float32 numpy (JAX's rounding)."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _torch_bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _ulp(v):
    """One bf16 ulp at |v| (8 significant bits), elementwise."""
    m = np.maximum(np.abs(v).astype(np.float64), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def _within_ulps(a, b, k, extra=0.0):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    lim = k * _ulp(np.maximum(np.abs(a), np.abs(b))) + extra
    return np.abs(a - b) <= lim


def _jax_params(cfg, seed):
    params = ref_vit.init_params(jax.random.PRNGKey(seed), cfg)
    return params, jax.tree.map(np.asarray, params)


def _images(n, size, seed):
    return np.random.default_rng(seed).random((n, size, size, 3),
                                              dtype=np.float32)


def _port_cfg(cfg):
    return port_vit.ViTConfig(**{f: getattr(cfg, f) for f in (
        "image_size", "patch", "dim", "depth", "heads", "mlp_ratio",
        "classes", "moe_experts", "moe_every", "capacity_factor")})


# --- K17: LayerNorm ---------------------------------------------------------

@pytest.mark.parametrize("shape,offset,spread", [
    ((7, 13, 384), 0.0, 1.0), ((5, 128), 3.0, 0.01),
    ((2, 9, 128), -40.0, 25.0), ((1, 1024), 0.5, 4.0)])
def test_layer_norm_plain_matches_ln(shape, offset, spread):
    """<= 1 bf16 ulp of `_ln` (see the module doc)."""
    rng = np.random.default_rng(sum(shape))
    d = shape[-1]
    x = _bf16_np(offset + spread * rng.standard_normal(shape)
                 .astype(np.float32))
    scale = (1.0 + 0.3 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(d)).astype(np.float32)
    want = np.asarray(ref_vit._ln(jnp.asarray(x, jnp.bfloat16),
                                  {"scale": scale, "bias": bias})
                      .astype(jnp.float32))
    got = layer_norm_plain(_torch_bf16(x), torch.from_numpy(scale),
                           torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    assert _within_ulps(got.float().numpy(), want, 1).all()
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(layer_norm(_torch_bf16(x), torch.from_numpy(scale),
                                  torch.from_numpy(bias)), got)


# K17's lane order: `torch_helpers.k17_lane_model` (numpy) is the card
# tests' oracle for the kernel's bits; here it is held to the port's torch
# transcription of the same order (`layer_norm_lanes`, chip_smoke's
# oracle) bit for bit, and to the plain version and `_ln` within 1 bf16
# ulp (the sums' order is the only difference), at TINY (128) and ViT-S
# (384) widths and at the card tests' edge widths.
K17_LANE_CASES = [((7, 13, 384), 0.0, 1.0), ((2, 9, 128), -40.0, 25.0),
                  ((37, 128), 1.5, 3.0), ((5, 1024), 0.5, 4.0),
                  ((3, 2), 1.5, 3.0), ((9, 6), 1.5, 3.0),
                  ((4, 196, 384), 0.5, 2.0), ((3, 130), 0.0, 1e-3)]


@pytest.mark.parametrize("shape,offset,spread", K17_LANE_CASES)
def test_k17_lane_model_is_layer_norm_lanes(shape, offset, spread):
    from picha_tpu_torch.ops.layernorm import layer_norm_lanes
    from torch_helpers import k17_lane_model

    x, scale, bias = _ln_inputs(shape, offset, spread)
    got = k17_lane_model(_torch_bf16(x), torch.from_numpy(scale),
                         torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    assert torch.equal(got, layer_norm_lanes(
        _torch_bf16(x), torch.from_numpy(scale), torch.from_numpy(bias)))


@pytest.mark.parametrize("shape,offset,spread", K17_LANE_CASES)
def test_k17_lane_model_within_ulp_of_plain_and_ln(shape, offset, spread):
    from torch_helpers import k17_lane_model

    x, scale, bias = _ln_inputs(shape, offset, spread)
    got = k17_lane_model(_torch_bf16(x), torch.from_numpy(scale),
                         torch.from_numpy(bias)).float().numpy()
    plain = layer_norm_plain(_torch_bf16(x), torch.from_numpy(scale),
                             torch.from_numpy(bias)).float().numpy()
    ref = np.asarray(ref_vit._ln(jnp.asarray(x, jnp.bfloat16),
                                 {"scale": scale, "bias": bias})
                     .astype(jnp.float32))
    assert _within_ulps(got, plain, 1).all()
    assert _within_ulps(got, ref, 1).all()


def test_k17_lane_model_takes_only_the_tuned_widths():
    from picha_tpu_torch.ops.layernorm import layer_norm_lanes

    w = torch.ones(7)
    with pytest.raises(ValueError, match="even widths"):
        layer_norm_lanes(torch.ones((2, 7), dtype=torch.bfloat16), w, w)


def _ln_inputs(shape, offset, spread):
    rng = np.random.default_rng(sum(shape) + 17)
    d = shape[-1]
    x = _bf16_np(offset + spread * rng.standard_normal(shape)
                 .astype(np.float32))
    scale = (1.0 + 0.3 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(d)).astype(np.float32)
    return x, scale, bias


# --- K18: attention ---------------------------------------------------------

def _ref_attention(qkv, scale):
    """The reference's attention lines (vit.py:174-180) on (N, S, 3, H, D)."""
    n, s, _, h, d = qkv.shape
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    att = jnp.einsum("nqhd,nkhd->nhqk", q, k,
                     preferred_element_type=jnp.float32) * scale
    att = jax.nn.softmax(att, axis=-1).astype(jnp.bfloat16)
    o = jnp.einsum("nhqk,nkhd->nqhd", att, v,
                   preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    return o.reshape(n, s, h * d)


@pytest.mark.parametrize("n,s,h,d,spread", [
    (2, 16, 4, 32, 1.0), (1, 196, 6, 64, 1.0), (3, 5, 2, 64, 3.0),
    (1, 37, 1, 128, 0.5)])
def test_attention_plain_matches_reference(n, s, h, d, spread):
    """Within 2 bf16 ulp of each o plus one ulp of the row's largest |o|
    (see the module doc)."""
    rng = np.random.default_rng(n * 1000 + s)
    qkv = _bf16_np(spread * rng.standard_normal((n, s, 3, h, d))
                   .astype(np.float32))
    scale = 1.0 / np.sqrt(d)
    want = np.asarray(_ref_attention(jnp.asarray(qkv, jnp.bfloat16), scale)
                      .astype(jnp.float32))
    got = attention_plain(_torch_bf16(qkv), scale)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (n, s, h * d)
    g = got.float().numpy()
    row = np.abs(want).reshape(n, s, h, d).max(-1, keepdims=True)
    extra = np.broadcast_to(_ulp(row), (n, s, h, d)).reshape(n, s, h * d)
    assert _within_ulps(g, want, 2, extra).all()
    assert torch.equal(attention(_torch_bf16(qkv), scale), got)


# --- K19 / K20: the switch MoE ----------------------------------------------

def _ref_routing(y, router, cap):
    """The reference's routing (vit.py:213-222): expert, slot, keep."""
    t, d = y.shape[0] * y.shape[1], y.shape[2]
    logits = jnp.asarray(y, jnp.bfloat16).reshape(t, d).astype(
        jnp.float32) @ router
    gates = jax.nn.softmax(logits, axis=-1)
    expert = jnp.argmax(gates, axis=-1)
    oh = jax.nn.one_hot(expert, router.shape[1], dtype=jnp.float32)
    slot = jnp.sum((jnp.cumsum(oh, axis=0) - 1.0) * oh, -1).astype(jnp.int32)
    srt = np.sort(np.asarray(gates), -1)
    return (np.asarray(expert), np.asarray(slot), np.asarray(slot < cap),
            srt[:, -1] - srt[:, -2])


def _moe_case(cfg, seed, skew=0.0, n=4):
    """A block's MoE weights (the reference's init) and bf16 inputs y of
    (n, S, d); `skew` adds a common direction to y that the router's
    expert 0 follows, so its tokens overflow capacity."""
    _params, npp = _jax_params(cfg, seed)
    blk = npp["blocks"][cfg.moe_every - 1]
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((n, cfg.seq_len, cfg.dim)).astype(np.float32)
    if skew:
        u = rng.standard_normal(cfg.dim).astype(np.float32)
        u /= np.linalg.norm(u)
        y += skew * u
        blk = dict(blk, router=blk["router"].copy())
        blk["router"][:, 0] += 4.0 * u
    return blk, _bf16_np(y)


@pytest.mark.parametrize("seed,skew", [(0, 0.0), (4, 0.0), (2, 3.0),
                                       (3, 6.0)])
def test_switch_moe_matches_reference(seed, skew):
    """Routing exact (top-2 gates > 1e-4 apart on these inputs), output
    within 2 bf16 ulp of each row's largest |value| (see the module doc);
    skew > 0 drops tokens."""
    cfg = ref_vit.TINY_MOE
    blk, y = _moe_case(cfg, seed, skew)
    t = y.shape[0] * y.shape[1]
    cap = capacity(t, cfg.moe_experts, cfg.capacity_factor)
    expert, slot, keep, gap = _ref_routing(y, blk["router"], cap)
    assert gap.min() > GAP_MIN          # the inputs hold no near tie
    if skew:
        assert not keep.all()           # tokens really drop
    want = np.asarray(ref_vit._switch_moe(
        jnp.asarray(y, jnp.bfloat16), jax.tree.map(jnp.asarray, blk), cfg)
        .astype(jnp.float32))
    tblk = port_vit.params_from_jax(blk, "cpu")
    yt = _torch_bf16(y)
    got = port_vit._switch_moe(yt, tblk, _port_cfg(cfg))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == y.shape
    row = np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got.float().numpy() - want) <= 2 * _ulp(row)).all()
    logits = yt.reshape(t, -1).float() @ tblk["router"]
    xe, eidx, sidx, gk = route_dispatch_plain(logits, yt.reshape(t, -1), cap)
    kept = eidx.numpy() < cfg.moe_experts
    np.testing.assert_array_equal(kept, keep)
    np.testing.assert_array_equal(eidx.numpy()[kept], expert[keep])
    np.testing.assert_array_equal(sidx.numpy()[kept], slot[keep])
    assert (sidx.numpy()[~kept] == 0).all()
    assert (gk.numpy()[~kept] == 0).all() and (gk.numpy()[kept] > 0).all()


def test_route_dispatch_plain_rules():
    """First maximum on a tie, an empty expert, cap 1, -0 stored as +0,
    rows past an expert's count zero, dropped tokens combining to 0."""
    logits = torch.tensor([[1.0, 1.0, 0.0, 0.0],     # tie: expert 0
                           [0.0, 2.0, 2.0, 0.0],     # tie: expert 1
                           [0.0, 0.0, 0.0, 0.0],     # all equal: expert 0
                           [0.0, 3.0, 0.0, 0.0]])    # expert 1 again
    y = torch.tensor([[-0.0, 1.0], [2.0, -0.0], [3.0, 4.0], [5.0, 6.0]],
                     dtype=torch.bfloat16).repeat(1, 4)
    xe, eidx, sidx, gk = route_dispatch(logits, y, 1)
    assert eidx.tolist() == [0, 1, 4, 4] and sidx.tolist() == [0, 0, 0, 0]
    assert gk[2:].tolist() == [0.0, 0.0]
    assert torch.equal(gk[:2], torch.softmax(logits[:2], -1).amax(-1))
    assert tuple(xe.shape) == (4, 1, 8)
    # +0 where y held -0: the reference adds into zeros
    assert not torch.signbit(xe[0, 0, 0]) and not torch.signbit(xe[1, 0, 1])
    assert (xe[2:] == 0).all()                       # empty experts 2, 3
    out = combine(xe, eidx, sidx, gk)
    assert torch.equal(out[2:], torch.zeros((2, 8), dtype=torch.bfloat16))
    assert torch.equal(out[0], y[0] * gk[0].to(torch.bfloat16))
    xe2, e2, s2, _ = route_dispatch(logits, y, 3)
    assert e2.tolist() == [0, 1, 0, 1] and s2.tolist() == [0, 0, 1, 1]
    assert torch.equal(xe2[0, 1], y[2]) and (xe2[0, 2] == 0).all()


def test_combine_plain_matches_reference_gather():
    """`combine_plain` is the reference's yep[eidx, sidx] * bf16(gk)."""
    rng = np.random.default_rng(5)
    ye = _bf16_np(rng.standard_normal((3, 4, 16)).astype(np.float32))
    eidx = np.array([0, 3, 2, 1, 3, 0], np.int32)
    sidx = np.array([1, 0, 3, 2, 0, 0], np.int32)
    gk = np.where(eidx < 3, rng.random(6), 0).astype(np.float32)
    yep = jnp.concatenate([jnp.asarray(ye, jnp.bfloat16),
                           jnp.zeros((1, 4, 16), jnp.bfloat16)])
    want = np.asarray((yep[eidx, sidx] * jnp.asarray(gk)[:, None].astype(
        jnp.bfloat16)).astype(jnp.float32))
    got = combine_plain(_torch_bf16(ye), torch.from_numpy(eidx),
                        torch.from_numpy(sidx), torch.from_numpy(gk))
    np.testing.assert_array_equal(got.float().numpy(), want)


# --- the forward ------------------------------------------------------------

def _compare_forward(cfg, seed, n=8):
    params, npp = _jax_params(cfg, seed)
    x = _images(n, cfg.image_size, seed)
    want = np.asarray(jax.jit(lambda p, im: ref_vit.forward(p, im, cfg))(
        params, x))
    model = port_vit.ViT(_port_cfg(cfg), params=port_vit.params_from_jax(
        npp, "cpu"), device="cpu")
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    got = got.numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= LOGIT_TOL
    top2 = np.sort(want, -1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > ARGMAX_MARGIN
    np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])
    return got


@pytest.mark.parametrize("widths", ["tiny", "vit_s_64px", "vit_s_384px"])
@pytest.mark.parametrize("seed", [0, 1])
def test_one_dense_block_matches_reference(widths, seed):
    """depth 1: logits within 0.03, argmax equal past a 0.06 margin
    (vit_s_384px: ViT-S/16's widths at 384², 576 tokens, the tiled K18's
    shapes on the card, 2 images)."""
    if widths == "tiny":
        cfg = ref_vit.ViTConfig(image_size=32, patch=8, dim=128, depth=1,
                                heads=4, classes=16)
    elif widths == "vit_s_64px":
        cfg = ref_vit.ViTConfig(image_size=64, depth=1)
    else:
        cfg = ref_vit.ViTConfig(image_size=384, depth=1)
    _compare_forward(cfg, seed, n=2 if widths == "vit_s_384px" else 4)


@pytest.mark.parametrize("name", ["TINY", "TINY_MOE"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_matches_reference(name, seed):
    """The whole forward: logits within 0.03, argmax equal past a 0.06
    margin (see the module doc)."""
    _compare_forward(getattr(ref_vit, name), seed)


@pytest.mark.parametrize("head", [160, 256])
def test_forward_past_head_128_matches_reference(head):
    """Head widths past 128 (two heads, TINY's depth and patching): the
    plain path takes them as the reference does (K18 takes them on the
    card), logits within 0.03."""
    cfg = ref_vit.ViTConfig(image_size=32, patch=8, dim=2 * head, depth=2,
                            heads=2, mlp_ratio=4, classes=16)
    _compare_forward(cfg, head, n=4)


def test_function_and_module_forms_agree():
    cfg = port_vit.TINY_MOE
    model = port_vit.ViT(cfg, seed=3, device="cpu")
    x = torch.from_numpy(_images(2, cfg.image_size, 3))
    assert torch.equal(model(x), port_vit.forward(model.params(), x, cfg))
    again = port_vit.ViT(cfg, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))


def test_mark_names_every_stage():
    cfg = port_vit.TINY_MOE          # block 0 dense, block 1 MoE
    stages = []
    port_vit.ViT(cfg, device="cpu")(
        torch.from_numpy(_images(2, cfg.image_size, 0)), stages.append)
    assert stages == ["embed",
                      "K17", "qkv", "K18", "proj", "K17", "mlp_in", "gelu",
                      "mlp_out",
                      "K17", "qkv", "K18", "proj", "K17", "router", "K19",
                      "experts", "K20", "residual",
                      "K17", "head"]


# --- parameters -------------------------------------------------------------

@pytest.mark.parametrize("name", ["TINY", "TINY_MOE", "vit_s"])
def test_init_params_matches_reference_tree(name):
    """Leaf for leaf: the same keys, shapes and dtype, and weights scaled
    as normal / sqrt(fan_in) (std within 10 %), pos_embed 0.02."""
    cfg = ref_vit.ViTConfig() if name == "vit_s" else getattr(ref_vit, name)
    _params, ref = _jax_params(cfg, 0)
    port = port_vit.init_params(_port_cfg(cfg), torch.Generator()
                                .manual_seed(0), "cpu")
    ref_leaves, ref_tree = jax.tree.flatten(ref)
    port_leaves, port_tree = jax.tree.flatten(
        port_vit._map(lambda t: t.numpy(), port))
    assert ref_tree == port_tree
    for a, b in zip(ref_leaves, port_leaves):
        assert a.shape == b.shape and b.dtype == np.float32
        if a.ndim > 1 and a.size > 1000:
            assert abs(b.std() / a.std() - 1.0) < 0.1


def test_params_from_jax_round_trip():
    _params, npp = _jax_params(ref_vit.TINY_MOE, 4)
    tp = port_vit.params_from_jax(npp, "cpu")
    for a, b in zip(jax.tree.leaves(npp),
                    jax.tree.leaves(port_vit._map(lambda t: t.numpy(), tp))):
        np.testing.assert_array_equal(a, b)
    assert "router" in tp["blocks"][1] and "mlp_in" in tp["blocks"][0]


def test_vit_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        port_vit.ViT(port_vit.TINY)


# --- the precision guard and the wrappers -----------------------------------

@pytest.mark.parametrize("before", [True, False])
def test_full_precision_restores_the_callers_flags(before):
    m = torch.backends.cuda.matmul
    old = (m.allow_bf16_reduced_precision_reduction, m.fp32_precision)
    try:
        m.allow_bf16_reduced_precision_reduction = before
        m.fp32_precision = "tf32"
        with port_jpeg.full_precision():
            assert m.allow_bf16_reduced_precision_reduction is False
            assert m.fp32_precision == "ieee"
        assert m.allow_bf16_reduced_precision_reduction is before
        assert m.fp32_precision == "tf32"
    finally:
        m.allow_bf16_reduced_precision_reduction = old[0]
        m.fp32_precision = old[1]


def test_wrappers_refuse_other_devices():
    """CPU tensors take the plain version, CUDA tensors the kernel, and
    anything else raises."""
    x = torch.zeros((4, 8), dtype=torch.bfloat16, device="meta")
    w = torch.zeros(8, device="meta")
    with pytest.raises(ValueError):
        layer_norm(x, w, w)
    with pytest.raises(ValueError):
        attention(torch.zeros((1, 4, 3, 2, 32), dtype=torch.bfloat16,
                              device="meta"), 0.1)
    with pytest.raises(ValueError):
        route_dispatch(torch.zeros((4, 2), device="meta"), x, 2)
    with pytest.raises(ValueError):
        combine(torch.zeros((2, 2, 8), dtype=torch.bfloat16, device="meta"),
                *[torch.zeros(4, dtype=torch.int32, device="meta")] * 2,
                torch.zeros(4, device="meta"))
