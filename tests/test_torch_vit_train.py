"""The port's ViT train step (picha_tpu_torch.models.vit.loss_fn and
make_train_step, optim.adamw, models.checkpoint) on CPU tensors, where
K21-K24 run as their plain versions, against picha_tpu/models/vit.py and
picha_tpu/models/checkpoint.py on JAX-CPU with optax 0.2.6, with the same
numpy-seeded inputs and the same weights (the port's `init_params` as
numpy arrays, handed to both). Tolerances, each with its reason:

- K21's plain backward (`layer_norm_backward_plain`) against
  `jax.vjp(_ln)`: dx within 1 bf16 ulp (the same f32 formula; only the
  sums' order differs), dscale / dbias within 1e-5 of the sum of their
  terms' magnitudes; against torch's autograd of `layer_norm_plain`
  (another order of the same derivative): dx within 1 bf16 ulp, dscale /
  dbias within 1e-5 likewise;
- K22's (`attention_backward_plain`) against `jax.vjp` of the reference's
  attention lines (as tests/test_torch_vit.py transcribes them) and
  against autograd of `attention_plain`: each value within 1 bf16 ulp of
  itself plus 1 ulp of the largest |value| of its (image, q/k/v, head)
  block (the dots' sums run in other orders, so dP may round to the
  neighbouring bf16 value; where a softmax row saturates, dS = e (dP / l
  - c) cancels in f32 and that row of dq is small against the head's
  others: up to 7.5 ulp of its own row's largest, 0.06 of the block's,
  measured);
- K23 / K24's (`dispatch_backward_plain`, `combine_backward_plain`): the
  port's `_switch_moe` differentiated through them against
  `jax.vjp(_switch_moe)`, every cotangent within 2e-2 relative L2 (the
  reference's bf16 tanh-GELU rounds after every op where `F.gelu` rounds
  once: 0.3-1.1 % measured); against autograd of the plain forwards,
  the gathers and scatters bit for bit, dlogits within 1e-6 of the
  largest |dlogit|, dgk within 1 bf16 ulp (its sum in another order
  before the bf16 rounding);
- each autograd Function on CPU tensors equal to its plain backward;
- `loss_fn` within 5e-3 of `vit.loss_fn`, every gradient leaf within
  2e-2 relative L2 of `jax.grad(vit.loss_fn)` (0.7-1.1 % measured, the
  GELU rounding again); TINY and depth-1 ViT-S widths on seeds 0 and 1,
  TINY_MOE on seeds 5 and 9, where the port and the reference route every
  token alike (checked). The router's gradient sums many cancelling
  terms: on other seeds it moves by up to 4 % between the reference's
  own jitted and op-by-op runs;
- one `optim.adamw` update with the same gradients against optax's
  `adamw(lr)` update + `apply_updates` (jitted), twice (count 1 and 2):
  the count equal, mu, nu and the parameters within 1e-6 of each leaf's
  largest |value| (XLA fuses the update's elementwise chain; op by op,
  optax's state and the port's are equal);
- three `make_train_step` steps from `params_from_jax` against the
  reference's jitted step: losses within 5e-3; a falling loss at
  learning_rate=1e-2 as tests/test_models.py:24-36;
- checkpoints written by `picha_tpu.models.checkpoint` load in the port
  and resume to the reference's next step (loss within 5e-3), and the
  reverse; both packages write the same npz keys and values; the port's
  ingest (`TrainingInput` on Pillow-made JPEGs) resumes from the saved
  `state()` bit for bit;
- `make_train_step(..., device="cuda")` raises without a card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from unittest import mock

from torch_helpers import pil_jpeg, smooth_rgb

from picha_tpu.models import checkpoint as ref_ckpt
from picha_tpu.models import vit as ref_vit
from picha_tpu_torch import optim
from picha_tpu_torch.models import checkpoint as port_ckpt
from picha_tpu_torch.models import vit as port_vit
from picha_tpu_torch.ops import moe
from picha_tpu_torch.ops.attention import (attention, attention_backward_plain,
                                           attention_plain)
from picha_tpu_torch.ops.layernorm import (layer_norm,
                                           layer_norm_backward_plain,
                                           layer_norm_plain)
from picha_tpu_torch.pipeline import TrainingInput

LOSS_TOL = 5e-3
GRAD_RL2 = 2e-2
ADAMW_TOL = 1e-6


def _bf16_np(a):
    """float32 numpy -> its bf16 values as float32 numpy (JAX's rounding)."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _tb(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _ulp(v):
    """One bf16 ulp at |v| (8 significant bits), elementwise."""
    m = np.maximum(np.abs(np.asarray(v, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def _rl2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _np(t):
    return t.detach().float().numpy()


def _port_cfg(cfg):
    return port_vit.ViTConfig(**{f: getattr(cfg, f) for f in (
        "image_size", "patch", "dim", "depth", "heads", "mlp_ratio",
        "classes", "moe_experts", "moe_every", "capacity_factor")})


def _setup(cfg, seed, n=8):
    """Weights from the port's `init_params` (the reference's tree, shapes
    and scales; tests/test_torch_vit.py pins them), as numpy for both
    packages, and numpy-seeded images and labels."""
    npp = port_vit._map(lambda t: t.numpy(), port_vit.init_params(
        _port_cfg(cfg), torch.Generator().manual_seed(seed), "cpu"))
    rng = np.random.default_rng(seed)
    x = rng.random((n, cfg.image_size, cfg.image_size, 3), dtype=np.float32)
    labels = rng.integers(0, cfg.classes, n).astype(np.int32)
    return jax.tree.map(jnp.asarray, npp), npp, x, labels


@functools.lru_cache(maxsize=None)
def _ref_train_step(cfg, lr):
    """The reference's (init_opt, jitted train_step) for (cfg, lr)."""
    init_opt, step = ref_vit.make_train_step(cfg, learning_rate=lr)
    return init_opt, jax.jit(step)


def _jit_vjp(fn):
    """(primals, cotangent) -> the cotangents of the primals, jitted."""
    return jax.jit(lambda primals, ct: jax.vjp(fn, *primals)[1](ct))


def _ref_ln(x, scale, bias):
    return ref_vit._ln(x, {"scale": scale, "bias": bias})


# --- K21: the LayerNorm backward --------------------------------------------

def _sum_tol(terms, rel=1e-5):
    """rel x the sum of the terms' magnitudes over the rows, per column."""
    return rel * np.abs(terms).reshape(-1, terms.shape[-1]).sum(0) + 1e-30


@pytest.mark.parametrize("shape,offset,spread", [
    ((7, 13, 384), 1.0, 2.0), ((5, 128), 3.0, 0.01), ((2, 9, 128), -4.0, 25.0)])
def test_layer_norm_backward_plain_matches_jax_and_autograd(shape, offset,
                                                            spread):
    rng = np.random.default_rng(sum(shape))
    d = shape[-1]
    x = _bf16_np(offset + spread * rng.standard_normal(shape)
                 .astype(np.float32))
    dy = _bf16_np(rng.standard_normal(shape).astype(np.float32))
    scale = (1.0 + 0.3 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(d)).astype(np.float32)
    jdx, jds, jdb = (np.asarray(jnp.asarray(v, jnp.float32))
                     for v in _jit_vjp(_ref_ln)(
                         (jnp.asarray(x, jnp.bfloat16), scale, bias),
                         jnp.asarray(dy, jnp.bfloat16)))
    dx, ds, db = layer_norm_backward_plain(_tb(x), torch.from_numpy(scale),
                                           _tb(dy))
    assert dx.dtype == torch.bfloat16 and tuple(dx.shape) == shape
    assert ds.dtype == db.dtype == torch.float32 and tuple(ds.shape) == (d,)
    xhat = np.asarray(ref_vit._ln(jnp.asarray(x, jnp.bfloat16),
                                  {"scale": np.ones(d, np.float32),
                                   "bias": np.zeros(d, np.float32)})
                      .astype(jnp.float32))
    ds_tol, db_tol = _sum_tol(xhat * dy), _sum_tol(dy)
    for want in (jdx, None):
        if want is None:      # torch's autograd of the plain forward
            xs = _tb(x).requires_grad_()
            ss = torch.from_numpy(scale).requires_grad_()
            bs = torch.from_numpy(bias).requires_grad_()
            layer_norm_plain(xs, ss, bs).backward(_tb(dy))
            want, jds, jdb = _np(xs.grad), _np(ss.grad), _np(bs.grad)
        got = _np(dx)
        assert (np.abs(got - want)
                <= _ulp(np.maximum(np.abs(got), np.abs(want)))).all()
        assert (np.abs(_np(ds) - jds) <= ds_tol).all()
        assert (np.abs(_np(db) - jdb) <= db_tol).all()


def test_layer_norm_function_backward_is_the_plain_backward():
    rng = np.random.default_rng(3)
    x = _tb(2.0 * rng.standard_normal((6, 10, 128)))
    dy = _tb(rng.standard_normal((6, 10, 128)))
    scale = torch.from_numpy((1 + 0.1 * rng.standard_normal(128))
                             .astype(np.float32))
    bias = torch.zeros(128)
    xs, ss, bs = (t.clone().requires_grad_() for t in (x, scale, bias))
    out = layer_norm(xs, ss, bs)
    assert torch.equal(out, layer_norm_plain(x, scale, bias))
    out.backward(dy)
    want = layer_norm_backward_plain(x, scale, dy)
    for got, w in zip((xs.grad, ss.grad, bs.grad), want):
        assert torch.equal(got, w)


# --- K22: the attention backward --------------------------------------------

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


def _within_block(got, want):
    """(N, S, 3, H, D): within 1 bf16 ulp of each value plus 1 ulp of the
    largest |value| of its (image, q/k/v, head) block."""
    blk = np.abs(want).max(axis=(1, 4), keepdims=True)
    lim = _ulp(np.maximum(np.abs(got), np.abs(want))) + _ulp(blk)
    return (np.abs(got - want) <= lim).all()


@pytest.mark.parametrize("n,s,h,d,spread", [
    (2, 16, 4, 32, 1.0), (1, 196, 6, 64, 1.0), (3, 5, 2, 64, 3.0),
    (1, 37, 2, 32, 0.5)])
def test_attention_backward_plain_matches_jax_and_autograd(n, s, h, d,
                                                           spread):
    rng = np.random.default_rng(n * 1000 + s)
    qkv = _bf16_np(spread * rng.standard_normal((n, s, 3, h, d))
                   .astype(np.float32))
    do = _bf16_np(rng.standard_normal((n, s, h * d)).astype(np.float32))
    scale = 1.0 / np.sqrt(d)
    want = np.asarray(_jit_vjp(lambda a: _ref_attention(a, scale))(
        (jnp.asarray(qkv, jnp.bfloat16),), jnp.asarray(do, jnp.bfloat16))[0]
        .astype(jnp.float32))
    got = attention_backward_plain(_tb(qkv), _tb(do), scale)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == qkv.shape
    assert _within_block(_np(got), want)
    qs = _tb(qkv).requires_grad_()
    attention_plain(qs, scale).backward(_tb(do))
    assert _within_block(_np(got), _np(qs.grad))
    qs = _tb(qkv).requires_grad_()
    out = attention(qs, scale)
    assert torch.equal(out, attention_plain(_tb(qkv), scale))
    out.backward(_tb(do))
    assert torch.equal(qs.grad, got)


# --- K23 / K24: the switch MoE's backward ------------------------------------

def _moe_block(cfg, seed, skew=0.0, n=4):
    _params, npp, _x, _l = _setup(cfg, seed)
    blk = {k: npp["blocks"][cfg.moe_every - 1][k]
           for k in ("router", "w_in", "w_out")}
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((n, cfg.seq_len, cfg.dim)).astype(np.float32)
    if skew:            # a common direction that expert 0 follows: drops
        u = rng.standard_normal(cfg.dim).astype(np.float32)
        u /= np.linalg.norm(u)
        y += skew * u
        blk["router"] = blk["router"].copy()
        blk["router"][:, 0] += 4.0 * u
    dout = rng.standard_normal(y.shape).astype(np.float32)
    return blk, _bf16_np(y), _bf16_np(dout)


@pytest.mark.parametrize("seed,skew", [(0, 0.0), (4, 0.0), (2, 3.0)])
def test_switch_moe_backward_matches_jax(seed, skew):
    cfg = ref_vit.TINY_MOE
    blk, y, dout = _moe_block(cfg, seed, skew)
    jdy, jdb = _jit_vjp(lambda a, b: ref_vit._switch_moe(a, b, cfg))(
        (jnp.asarray(y, jnp.bfloat16), blk), jnp.asarray(dout, jnp.bfloat16))
    tblk = {k: v.requires_grad_()
            for k, v in port_vit.params_from_jax(blk, "cpu").items()}
    ty = _tb(y).requires_grad_()
    port_vit._switch_moe(ty, tblk, _port_cfg(cfg)).backward(_tb(dout))
    assert _rl2(_np(ty.grad), np.asarray(jdy.astype(jnp.float32))) < GRAD_RL2
    for k in tblk:
        assert _rl2(_np(tblk[k].grad), np.asarray(jdb[k])) < GRAD_RL2


def _router_case(t, e, d, seed, kind):
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(rng.standard_normal((t, e)).astype(np.float32))
    if kind == "tie":           # equal top logits: the gradient splits
        logits[::3, 1] = logits[::3].amax(-1)
        logits[::3, 2] = logits[::3, 1]
    elif kind == "skewed":      # expert 0 takes most tokens: drops
        logits[:, 0] += 2.0
    y = _tb(rng.standard_normal((t, d)))
    return rng, logits, y


@pytest.mark.parametrize("t,e,d,kind,cf", [
    (300, 4, 16, "tie", 1.0), (257, 4, 128, "skewed", 1.5),
    (64, 8, 8, "random", 0.5), (33, 1, 8, "random", 1.5)])
def test_moe_plain_backwards_match_autograd(t, e, d, kind, cf):
    rng, logits, y = _router_case(t, e, d, t + e, kind)
    cap = moe.capacity(t, e, cf)
    ls, ys = logits.clone().requires_grad_(), y.clone().requires_grad_()
    xe, eidx, sidx, gk = moe.route_dispatch_plain(ls, ys, cap)
    if kind == "skewed":
        assert bool((eidx == e).any())          # tokens really drop
    dxe = _tb(rng.standard_normal(tuple(xe.shape)))
    dxe[0, 0, ::3] = -0.0
    dgk = torch.from_numpy(rng.standard_normal(t).astype(np.float32))
    torch.autograd.backward([xe, gk], [dxe, dgk])
    dy, dl = moe.dispatch_backward_plain(dxe, eidx, sidx, logits, dgk)
    assert dy.dtype == torch.bfloat16 and dl.dtype == torch.float32
    assert torch.equal(dy.view(torch.int16), ys.grad.view(torch.int16))
    assert (dl - ls.grad).abs().max() <= 1e-6 * dl.abs().max()
    assert not dy[eidx == e].any()
    ye = _tb(rng.standard_normal(tuple(xe.shape)))
    ys2, gs = ye.clone().requires_grad_(), gk.detach().clone().requires_grad_()
    out = moe.combine_plain(ys2, eidx, sidx, gs)
    dout = _tb(rng.standard_normal((t, d)))
    dout[::4, ::5] = -0.0
    out.backward(dout)
    dye, dg = moe.combine_backward_plain(dout, ye, eidx, sidx, gk.detach())
    assert dye.dtype == torch.bfloat16 and dg.dtype == torch.float32
    assert torch.equal(dye.view(torch.int16), ys2.grad.view(torch.int16))
    assert (_np(dg - gs.grad) <= _ulp(_np(gs.grad)) + 1e-30).all()
    assert not dg[eidx == e].any()
    # the slots no kept token fills are +0, as the reference's scatter
    # into zeros leaves them
    filled = torch.zeros(tuple(dye.shape[:2]), dtype=torch.bool)
    kept = eidx < e
    filled[eidx[kept].long(), sidx[kept].long()] = True
    assert not dye[~filled].view(torch.int16).any()


def test_moe_functions_backward_are_the_plain_backwards():
    rng, logits, y = _router_case(300, 4, 16, 5, "tie")
    cap = moe.capacity(300, 4, 1.0)
    ls, ys = logits.clone().requires_grad_(), y.clone().requires_grad_()
    xe, eidx, sidx, gk = moe.route_dispatch(ls, ys, cap)
    want = moe.route_dispatch_plain(logits, y, cap)
    assert all(torch.equal(a, b) for a, b in zip((xe, eidx, sidx, gk), want))
    ye = _tb(rng.standard_normal(tuple(xe.shape))).requires_grad_()
    out = moe.combine(ye, eidx, sidx, gk)
    dxe = _tb(rng.standard_normal(tuple(xe.shape)))
    dout = _tb(rng.standard_normal((300, 16)))
    torch.autograd.backward([xe, out], [dxe, dout])
    dye, dgk = moe.combine_backward_plain(dout, ye.detach(), eidx, sidx,
                                          gk.detach())
    dy, dl = moe.dispatch_backward_plain(dxe, eidx, sidx, logits, dgk)
    assert torch.equal(ye.grad, dye)
    assert torch.equal(ys.grad, dy) and torch.equal(ls.grad, dl)


def test_warp_order_sum_is_a_sum():
    rng = np.random.default_rng(0)
    for d in (8, 16, 128, 384, 264):
        a = torch.from_numpy(rng.standard_normal((5, d)).astype(np.float32))
        got = moe.warp_order_sum(a)
        assert (got - a.double().sum(-1).float()).abs().max() <= 1e-5
    assert moe.warp_order_sum(torch.ones((2, 512))).tolist() == [512.0] * 2


# --- the loss and its gradients ----------------------------------------------

def _grads_vs_reference(cfg, seed, n=8):
    params, npp, x, labels = _setup(cfg, seed, n)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p, a, b: ref_vit.loss_fn(p, a, b, cfg)))(params, x, labels)
    tp = port_vit.params_from_jax(npp, "cpu")
    leaves = [p.requires_grad_() for p in optim.tree_leaves(tp)]
    routes = []
    real = port_vit.route_dispatch

    def record(*a):
        out = real(*a)
        routes.append(out[1])
        return out

    with mock.patch.object(port_vit, "route_dispatch", record):
        loss = port_vit.loss_fn(tp, torch.from_numpy(x),
                                torch.from_numpy(labels), _port_cfg(cfg))
    grads = torch.autograd.grad(loss, leaves)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss.detach()) - float(want_loss)) <= LOSS_TOL
    ref_leaves = jax.tree.leaves(want)
    assert len(ref_leaves) == len(grads)
    for g, w in zip(grads, ref_leaves):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rl2(_np(g), w) < GRAD_RL2
    return params, x, routes


def _reference_routes(params, x, cfg):
    """The reference's (expert, or E when dropped) per token of each MoE
    block, recorded from its forward (the routing lines :213-222)."""
    real = ref_vit._switch_moe

    def run(p, a):
        routes = []

        def record(y, blk, c):
            t = y.shape[0] * y.shape[1]
            gates = jax.nn.softmax(y.reshape(t, -1).astype(jnp.float32)
                                   @ blk["router"], axis=-1)
            e = jnp.argmax(gates, axis=-1)
            oh = jax.nn.one_hot(e, c.moe_experts, dtype=jnp.float32)
            slot = jnp.sum((jnp.cumsum(oh, axis=0) - 1.0) * oh, -1)
            cap = moe.capacity(t, c.moe_experts, c.capacity_factor)
            routes.append(jnp.where(slot < cap, e, c.moe_experts))
            return real(y, blk, c)

        with mock.patch.object(ref_vit, "_switch_moe", record):
            ref_vit.forward(p, a, cfg)
        return routes

    return [np.asarray(r) for r in jax.jit(run)(params, x)]


@pytest.mark.parametrize("name,seed", [
    ("TINY", 0), ("TINY", 1), ("vit_s_64px", 0), ("vit_s_64px", 1),
    ("TINY_MOE", 5), ("TINY_MOE", 9), ("vit_s_384px", 0)])
def test_loss_and_gradients_match_reference(name, seed):
    """Loss and every gradient leaf (vit_s_384px: ViT-S/16's widths at
    384², 576 tokens, the tiled K18 / K22's shapes on the card, depth 1,
    2 images)."""
    sizes = {"vit_s_64px": 64, "vit_s_384px": 384}
    cfg = (ref_vit.ViTConfig(image_size=sizes[name], depth=1)
           if name in sizes else getattr(ref_vit, name))
    params, x, routes = _grads_vs_reference(
        cfg, seed, 2 if name == "vit_s_384px" else 8)
    if cfg.moe_experts:
        want = _reference_routes(params, x, cfg)
        assert len(routes) == len(want) == 1
        np.testing.assert_array_equal(routes[0].numpy(), want[0])


@pytest.mark.parametrize("head", [160, 256])
def test_gradients_past_head_128_match_reference(head):
    """Head widths past 128 (two heads, TINY's depth and patching): loss
    and every gradient leaf within the bounds above (K22 takes these
    widths on the card)."""
    cfg = ref_vit.ViTConfig(image_size=32, patch=8, dim=2 * head, depth=2,
                            heads=2, mlp_ratio=4, classes=16)
    _grads_vs_reference(cfg, head)


# --- the optimizer -----------------------------------------------------------

@pytest.mark.parametrize("lr", [3e-4, 1e-2])
def test_adamw_update_matches_optax(lr):
    params, npp, _x, _l = _setup(ref_vit.TINY_MOE, 1)
    rng = np.random.default_rng(7)
    grads = jax.tree.map(
        lambda a: (1e-2 * rng.standard_normal(a.shape)).astype(np.float32),
        npp)
    tx = optax.adamw(lr)
    state = tx.init(params)
    update, apply = jax.jit(tx.update), jax.jit(optax.apply_updates)
    ptx = optim.adamw(lr)
    tp = port_vit.params_from_jax(npp, "cpu")
    pstate = ptx.init(tp)
    tg = port_vit.params_from_jax(grads, "cpu")
    for _ in range(2):     # count 1, then 2: both bias corrections
        updates, state = update(grads, state, params)
        params = apply(params, updates)
        pu, pstate = ptx.update(tg, pstate, tp)
        tp = optim.apply_updates(tp, pu)
        for got, want in zip(optim.tree_leaves(tp), jax.tree.leaves(params)):
            want = np.asarray(want)
            assert np.abs(got.numpy() - want).max() <= \
                ADAMW_TOL * np.abs(want).max()
        ref_state = jax.tree.leaves(state)
        assert len(ref_state) == len(optim.tree_leaves(pstate))
        for got, want in zip(optim.tree_leaves(pstate), ref_state):
            want = np.asarray(want)
            assert np.abs(got.numpy() - want).max() <= \
                ADAMW_TOL * np.abs(want).max()
    assert pstate.count.dtype == torch.int32 and int(pstate.count) == 2


def test_adamw_decays_every_leaf():
    tree = {"w": torch.ones(3), "ln": {"scale": torch.ones(2)}}
    tx = optim.adamw(0.1, weight_decay=0.5)
    zero = optim.tree_unflatten(tree, [torch.zeros_like(t)
                                       for t in optim.tree_leaves(tree)])
    upd, _ = tx.update(zero, tx.init(tree), tree)
    for u in optim.tree_leaves(upd):      # no gradient: only the decay
        assert torch.allclose(u, torch.full_like(u, -0.05))


# --- the train step ----------------------------------------------------------

def test_train_steps_match_reference():
    cfg = ref_vit.TINY
    params, npp, x, labels = _setup(cfg, 0)
    init_opt, step = _ref_train_step(cfg, 1e-3)
    state = init_opt(params)
    p_init, p_step = port_vit.make_train_step(_port_cfg(cfg), 1e-3, "cpu")
    tp = port_vit.params_from_jax(npp, "cpu")
    before = [t.clone() for t in optim.tree_leaves(tp)]
    pstate = p_init(tp)
    for _ in range(3):
        params, state, loss = step(params, state, x, labels)
        tp, pstate, ploss = p_step(tp, pstate, torch.from_numpy(x),
                                   torch.from_numpy(labels))
        assert abs(float(ploss) - float(loss)) <= LOSS_TOL
    assert int(pstate.count) == 3
    # functional: the first tree is unchanged
    assert all(torch.equal(a, b) for a, b in zip(
        before, optim.tree_leaves(port_vit.params_from_jax(npp, "cpu"))))


@pytest.mark.parametrize("name", ["TINY", "TINY_MOE"])
def test_train_step_reduces_loss(name):
    """As tests/test_models.py:24-36, on the port."""
    cfg = getattr(port_vit, name)
    init_opt, step = port_vit.make_train_step(cfg, learning_rate=1e-2,
                                              device="cpu")
    _p, npp, _x, _l = _setup(getattr(ref_vit, name), 1)
    params = port_vit.params_from_jax(npp, "cpu")
    state = init_opt(params)
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.random((8, 32, 32, 3), np.float32))
    labels = torch.from_numpy((np.arange(8) % cfg.classes).astype(np.int32))
    losses = []
    for _ in range(5):
        params, state, loss = step(params, state, images, labels)
        assert bool(torch.isfinite(loss))
        losses.append(float(loss))
    assert losses[-1] < losses[0]


def test_train_step_marks_its_stages():
    cfg = port_vit.TINY
    init_opt, step = port_vit.make_train_step(cfg, device="cpu")
    params = port_vit.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    stages = []
    step(params, init_opt(params), torch.rand((2, 32, 32, 3)),
         torch.tensor([1, 2]), mark=stages.append)
    assert stages[0] == "embed" and stages[-4:] == ["head", "loss",
                                                    "backward", "optimizer"]


def test_train_step_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        port_vit.make_train_step(port_vit.TINY, device="cuda")


# --- the checkpoint ----------------------------------------------------------

def _tiny_ingest(**kw):
    bufs = [pil_jpeg(smooth_rgb(61, 90, 7 * i), quality=90, subsampling=2)
            for i in range(5)]
    return TrainingInput(bufs, batch=2, crop=48, size=32, seed=4,
                         device="cpu", **kw)


def _keys(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_reference_checkpoint_resumes_in_port(tmp_path):
    cfg = ref_vit.TINY
    params, npp, x, labels = _setup(cfg, 1)
    init_opt, step = _ref_train_step(cfg, 1e-3)
    params, state, _ = step(params, init_opt(params), x, labels)
    ti = _tiny_ingest()
    images = next(ti)
    path = str(tmp_path / "ref.npz")
    ref_ckpt.save_checkpoint(path, params, state, input_state=ti.state(),
                             step=1)
    p_init, p_step = port_vit.make_train_step(_port_cfg(cfg), 1e-3, "cpu")
    tmpl = port_vit.params_from_jax(npp, "cpu")
    tp, pstate, inp, at = port_ckpt.load_checkpoint(path, tmpl, p_init(tmpl))
    assert at == 1 and inp == ti.state()
    for got, want in zip(optim.tree_leaves(tp), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(optim.tree_leaves(pstate), jax.tree.leaves(state)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pstate.count.dtype == torch.int32
    # the next step from the loaded state is the reference's next step
    _p, _s, loss = step(params, state, x, labels)
    _tp, pstate, ploss = p_step(tp, pstate, torch.from_numpy(x),
                                torch.from_numpy(labels))
    assert abs(float(ploss) - float(loss)) <= LOSS_TOL
    assert int(pstate.count) == 2
    # the ingest resumes where the saved one stood
    want = next(ti)
    assert torch.equal(next(_tiny_ingest(state=inp)), want)
    assert images.shape == want.shape == (2, 32, 32, 3)


def test_port_checkpoint_loads_in_reference(tmp_path):
    cfg = ref_vit.TINY_MOE
    params, npp, x, labels = _setup(cfg, 2)
    p_init, p_step = port_vit.make_train_step(_port_cfg(cfg), 1e-3, "cpu")
    tp = port_vit.params_from_jax(npp, "cpu")
    tp, pstate, _ = p_step(tp, p_init(tp), torch.from_numpy(x),
                           torch.from_numpy(labels))
    state_in = {"seed": 4, "epoch": 1, "pos": 2}
    path = str(tmp_path / "port.npz")
    port_ckpt.save_checkpoint(path, tp, pstate, input_state=state_in, step=1)
    init_opt, step = _ref_train_step(cfg, 1e-3)
    rp, rstate, inp, at = ref_ckpt.load_checkpoint(path, params,
                                                   init_opt(params))
    assert at == 1 and inp == state_in
    for got, want in zip(jax.tree.leaves(rp), optim.tree_leaves(tp)):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())
    for got, want in zip(jax.tree.leaves(rstate), optim.tree_leaves(pstate)):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())
    _rp, _rs, loss = step(rp, rstate, x, labels)
    _tp, _ps, ploss = p_step(tp, pstate, torch.from_numpy(x),
                             torch.from_numpy(labels))
    assert abs(float(ploss) - float(loss)) <= LOSS_TOL
    # both packages write the same keys and values for the same state
    again = str(tmp_path / "again.npz")
    ref_ckpt.save_checkpoint(again, rp, rstate, input_state=inp, step=at)
    a, b = _keys(path), _keys(again)
    assert sorted(a) == sorted(b)
    assert len([k for k in a if k.startswith("opt/")]) == \
        1 + 2 * len(optim.tree_leaves(tp))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_tiny_checkpoint_has_optax_leaf_count(tmp_path):
    """count, then 21 mu and 21 nu leaves at TINY (optax's order)."""
    cfg = port_vit.TINY
    init_opt, _ = port_vit.make_train_step(cfg, device="cpu")
    params = port_vit.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    path = str(tmp_path / "t.npz")
    port_ckpt.save_checkpoint(path, params, init_opt(params))
    z = _keys(path)
    assert len([k for k in z if k.startswith("opt/")]) == 43
    assert z["opt/0"].dtype == np.int32 and z["opt/0"].shape == ()
    assert sum(k.startswith("params/") for k in z) == 21
    assert not list(tmp_path.glob("*.tmp"))
