"""The port's training ingest (picha_tpu_torch.pipeline.TrainingInput and
its stages) on device="cpu" against picha_tpu's (JAX on the CPU), on the
same numpy-seeded inputs and the same jax.random draws:

- crop -> flip -> unpack -> resize -> clip: K9's plain twin
  (`crop_flip_resize_w_plain`) then K8's (`resize_axis`) and a clamp,
  against the reference graph's vmapped dynamic_slice + flip +
  `resize_f32` + clip, at atol 1e-6;
- each augment function, and K10's plain twin, against
  picha_tpu/pipeline/augment.py with the factors and cutout corners of
  the keys the reference splits, at atol 1e-5;
- the slice: the port's TrainingInput with the reference's draws
  injected through `_draws`, against the reference's TrainingInput on a
  homogeneous batch (atol 1e-6 without augment, 1e-5 with);
- the port's own stream: state() resume bit for bit, epoch rollover,
  mixed-signature order, pre_crop=False, the oversized-crop ValueError,
  and the Pillow fallbacks (counted).

Sources are small (96x112 and 61x90; 4:2:0, 4:4:4 and grey), crop 48,
size 32, batch 3-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import pil_jpeg, smooth_rgb

from picha_tpu.ops.resize import resize_f32 as ref_resize_f32
from picha_tpu.pipeline import augment as ref_aug
from picha_tpu_torch.kernels import launch_counts
from picha_tpu_torch.ops.resize import (crop_flip_resize_w,
                                        crop_flip_resize_w_plain,
                                        flipped_crops, resize_axis,
                                        resize_axis_windowed_plain,
                                        window_tensors)
from picha_tpu_torch.ops.resize_weights import FILTERS
from picha_tpu_torch.pipeline import augment as port_aug
from picha_tpu_torch.pipeline import training as port_tr
from picha_tpu_torch.pipeline.augment import AugmentDraws
from picha_tpu_torch.pipeline.training import StepDraws, TrainingInput

CROP, SIZE = 48, 32
AUG = {"brightness_s": 0.2, "contrast_s": 0.2, "saturation_s": 0.2,
       "cutout_size": 8}


def _frames(h, w, n=4, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                np.uint8)


def _ref_crop_resize(frames, xs, ys, flip, filt, fscale):
    """The reference graph's crop -> flip -> unpack -> resize -> clip
    (`_jit_crop_resize_normalize` :64-70) on uint8 frames."""
    def crop_one(img, x, y, fl):
        c = jax.lax.dynamic_slice(img, (y, x, 0), (CROP, CROP, 3))
        return jax.lax.cond(fl, lambda t: t[:, ::-1], lambda t: t, c)

    cropped = jax.vmap(crop_one)(jnp.asarray(frames, jnp.int32),
                                 jnp.asarray(xs), jnp.asarray(ys),
                                 jnp.asarray(flip))
    f = cropped.astype(jnp.float32) * jnp.float32(1.0 / 255.0)
    return np.asarray(jnp.clip(ref_resize_f32(f, SIZE, SIZE, filt, fscale),
                               0.0, 1.0))


@pytest.mark.parametrize("filt", sorted(FILTERS))
@pytest.mark.parametrize("hw", [(96, 112), (61, 90)])
def test_crop_flip_resize_matches_reference(hw, filt):
    """K9's twin + K8's twin + clamp vs the reference graph, flips drawn
    by jax, windows at both edges and one past the frame (clamped, as
    dynamic_slice clamps)."""
    h, w = hw
    frames = _frames(h, w, seed=h + w)
    xs = np.array([0, w - CROP, 7, w + 5], np.int32)
    ys = np.array([h - CROP, 0, 3, 1], np.int32)
    flip = np.array(jax.random.bernoulli(jax.random.PRNGKey(h), 0.5,
                                           (4,)))
    flip[:2] = [True, False]
    fscale = 0.7 if filt == "triangle" else 1.0
    want = _ref_crop_resize(frames, xs, ys, flip, filt, fscale)
    (sw, tw) = window_tensors(SIZE, CROP, filt, fscale, "cpu")
    rgb = torch.from_numpy(frames)
    args = (torch.from_numpy(xs), torch.from_numpy(ys),
            torch.from_numpy(flip))
    before = launch_counts()
    got = crop_flip_resize_w(rgb, *args, CROP, sw, tw)
    assert launch_counts() == before
    assert torch.equal(got, crop_flip_resize_w_plain(rgb, *args, CROP, sw,
                                                     tw))
    got = resize_axis(got, sw, tw, -3).clamp(0.0, 1.0)
    assert got.shape == (4, SIZE, SIZE, 3)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-6


def test_k9_twin_is_k8_twin_on_the_flipped_crop():
    """K9's plain twin equals K8's windowed twin run on the explicitly
    flipped crop, bit for bit (the tap order K9 keeps)."""
    frames = torch.from_numpy(_frames(61, 90, n=3, seed=5))
    xs = torch.tensor([0, 42, 20], dtype=torch.int32)
    ys = torch.tensor([13, 0, 5], dtype=torch.int32)
    flip = torch.tensor([True, True, False])
    sw, tw = window_tensors(SIZE, CROP, "lanczos", 1.0, "cpu")
    crops = []
    for i in range(3):
        c = frames[i, ys[i]:ys[i] + CROP, xs[i]:xs[i] + CROP]
        crops.append(c.flip(1) if flip[i] else c)
    crops = torch.stack(crops)
    assert torch.equal(flipped_crops(frames, xs, ys, flip, CROP), crops)
    assert torch.equal(
        crop_flip_resize_w_plain(frames, xs, ys, flip, CROP, sw, tw),
        resize_axis_windowed_plain(crops, sw, tw, -2))
    with pytest.raises((RuntimeError, TypeError, ValueError)):
        crop_flip_resize_w(frames.to("meta"), xs.to("meta"), ys.to("meta"),
                           flip.to("meta"), CROP, sw.to("meta"),
                           tw.to("meta"))


# -- augment -----------------------------------------------------------------

def _batch(seed=3, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, (4, SIZE, SIZE, 3)).astype(np.float32)


def _f(key, s, n=4):
    return torch.from_numpy(np.array(ref_aug._factors(key, n, s))[:, 0, 0,
                                                                    0])


def _corners(key, size, n=4):
    ky, kx = jax.random.split(key)
    ty = jax.random.randint(ky, (n,), 0, SIZE) - size // 2
    tx = jax.random.randint(kx, (n,), 0, SIZE) - size // 2
    return (torch.from_numpy(np.array(ty, np.int32)),
            torch.from_numpy(np.array(tx, np.int32)))


def ref_augment_draws(key, n, cfg):
    """The factors and cutout corners `picha_tpu.pipeline.augment.augment`
    draws from `key`, as port AugmentDraws."""
    kj, kc = jax.random.split(key)
    kb, kcon, ks = jax.random.split(kj, 3)
    fb = _f(kb, cfg["brightness_s"], n) if cfg.get("brightness_s") else None
    fc = _f(kcon, cfg["contrast_s"], n) if cfg.get("contrast_s") else None
    fs = _f(ks, cfg["saturation_s"], n) if cfg.get("saturation_s") else None
    ty = tx = None
    if cfg.get("cutout_size"):
        ty, tx = _corners(kc, cfg["cutout_size"], n)
    return AugmentDraws(fb, fc, fs, ty, tx)


AUG_CASES = ["brightness", "contrast", "saturation", "cutout", "cutout_fill",
             "color_jitter", "augment", "augment_fused", "mixup"]


@pytest.mark.parametrize("case", AUG_CASES)
def test_augment_matches_reference(case):
    key = jax.random.PRNGKey(len(case))
    x = _batch(seed=len(case), lo=-0.1 if case == "augment_fused" else 0.0,
               hi=1.1 if case == "augment_fused" else 1.0)
    xt = torch.from_numpy(x)
    xj = jnp.asarray(x)
    if case in ("brightness", "contrast", "saturation"):
        want = getattr(ref_aug, case)(xj, key, 0.3)
        got = getattr(port_aug, case)(xt, _f(key, 0.3))
    elif case.startswith("cutout"):
        fill = 0.5 if case == "cutout_fill" else 0.0
        want = ref_aug.cutout(xj, key, 24, fill)
        got = port_aug.cutout(xt, *_corners(key, 24), 24, fill)
    elif case == "color_jitter":
        want = ref_aug.color_jitter(xj, key, 0.2, 0.3, 0.0)
        kb, kc, _ks = jax.random.split(key, 3)
        got = port_aug.color_jitter(xt, _f(kb, 0.2), _f(kc, 0.3))
    elif case == "mixup":
        labels = np.eye(4, dtype=np.float32)
        want, want_l, want_lam = ref_aug.mixup(xj, jnp.asarray(labels), key,
                                               0.4)
        lam = float(jax.random.beta(key, 0.4, 0.4))
        got, got_l, got_lam = port_aug.mixup(xt, torch.from_numpy(labels),
                                             lam)
        assert abs(got_lam - float(want_lam)) <= 1e-6
        assert float(np.abs(got_l.numpy() - np.asarray(want_l)).max()) <= 1e-5
    else:
        cfg = dict(AUG, cutout_fill=0.25)
        draws = ref_augment_draws(key, 4, cfg)
        if case == "augment":
            want = ref_aug.augment(xj, key, **cfg)
            got = port_aug.augment(xt, draws, cfg)
        else:   # the ingest's clip, then augment (K10's twin)
            want = ref_aug.augment(jnp.clip(xj, 0.0, 1.0), key, **cfg)
            before = launch_counts()
            got = port_aug.augment_fused(xt, draws, cfg)
            assert launch_counts() == before
            assert torch.equal(got, port_aug.augment_fused_plain(xt, draws,
                                                                 cfg))
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5


def test_draw_augment_is_deterministic_and_in_range():
    cfg = dict(AUG, cutout_size=9)
    a = port_aug.draw_augment(torch.Generator().manual_seed(4), 64, 20, 30,
                              cfg)
    b = port_aug.draw_augment(torch.Generator().manual_seed(4), 64, 20, 30,
                              cfg)
    for ta, tb in zip(a, b):
        assert torch.equal(ta, tb)
    for f in (a.fb, a.fc, a.fs):
        assert f.dtype == torch.float32
        assert float(f.min()) >= 0.8 and float(f.max()) <= 1.2
    assert a.ty.dtype == torch.int32
    assert int(a.ty.min()) >= -4 and int(a.ty.max()) <= 19 - 4
    assert int(a.tx.min()) >= -4 and int(a.tx.max()) <= 29 - 4
    none = port_aug.draw_augment(torch.Generator(), 4, 8, 8,
                                 {"brightness_s": 0.1})
    assert none.fc is None and none.fs is None and none.ty is None


# -- the slice against the reference -----------------------------------------

def _sources(kind, hw, n=4):
    h, w = hw
    sub = {"420": 2, "444": 0}.get(kind)
    out = []
    for i in range(n):
        img = smooth_rgb(h, w, 10 * i + h)
        if kind == "grey":
            out.append(pil_jpeg(np.ascontiguousarray(img[..., 0]),
                                quality=90))
        else:
            out.append(pil_jpeg(img, quality=90, subsampling=sub))
    return out


def _inject_reference_draws(ti, seed, cfg):
    """Replace the port's `_draws` with the reference's jax.random draws:
    the step key fold_in(fold_in(PRNGKey(seed), epoch), pos) (then the
    group index), split in three for (x, y, flip), the augment key
    fold_in(key, 0x5eed)."""
    def draws(epoch, pos, group, n, width, height):
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(seed), epoch), pos)
        if group is not None:
            key = jax.random.fold_in(key, group)
        kx, ky, kf = jax.random.split(key, 3)
        flip = torch.from_numpy(np.array(
            jax.random.bernoulli(kf, 0.5, (n,))))
        xs = ys = None
        if not ti.pre_crop:
            xs, ys = (torch.from_numpy(np.array(jax.random.randint(
                k, (n,), 0, d - CROP + 1), np.int32))
                for k, d in ((kx, width), (ky, height)))
        aug = None
        if cfg:
            aug = ref_augment_draws(jax.random.fold_in(key, 0x5eed), n, cfg)
        return StepDraws(flip, xs, ys, aug)

    ti._draws = draws


SLICE_CASES = {
    "420": ("420", (96, 112), None, True),
    "420_augment": ("420", (96, 112), AUG, True),
    "444": ("444", (96, 112), None, True),
    "grey_augment": ("grey", (96, 112), AUG, True),
    "420_61x90_augment": ("420", (61, 90), AUG, True),
    "420_no_pre_crop": ("420", (96, 112), None, False),
}


@pytest.mark.parametrize("case", list(SLICE_CASES))
def test_training_input_matches_reference(case):
    """Two steps of the port's TrainingInput (every plain version on the
    CPU) against the reference's, with the reference's draws injected:
    the host windows are the same numpy draws, the full-frame decode +
    crop equals the reference's region decode + residual crop, so the
    outputs agree to the resize's f32 rounding."""
    from picha_tpu.pipeline.training import TrainingInput as RefInput

    kind, hw, cfg, pre_crop = SLICE_CASES[case]
    bufs = _sources(kind, hw, n=5)
    kw = dict(batch=3, crop=CROP, size=SIZE, seed=11, augment=cfg,
              pre_crop=pre_crop)
    ref = RefInput(bufs, **kw)
    port = TrainingInput(bufs, device="cpu", **kw)
    _inject_reference_draws(port, 11, cfg)
    tol = 1e-5 if cfg else 1e-6
    for _ in range(2):     # the second step rolls over into epoch 1
        want = np.asarray(next(ref))
        got = next(port)
        assert got.shape == want.shape == (3, SIZE, SIZE, 3)
        assert float(np.abs(got.numpy() - want).max()) <= tol
    assert port.state() == {k: ref.state()[k] for k in ("seed", "epoch",
                                                        "pos")}
    assert port.scan_fallbacks == 0


# -- the port's own stream ---------------------------------------------------

def _ti(bufs, **kw):
    kw = {"batch": 3, "crop": CROP, "size": SIZE, "seed": 2,
          "device": "cpu", **kw}
    return TrainingInput(bufs, **kw)


@pytest.mark.parametrize("augment", [None, AUG])
def test_state_resume_is_bit_exact(augment):
    """Resuming from state() (also a reference-style state with ks_high)
    continues the stream bit for bit, across an epoch rollover."""
    bufs = _sources("420", (61, 90), n=5)
    a = _ti(bufs, augment=augment)
    next(a)
    saved = a.state()
    rest = [next(a) for _ in range(2)]
    assert a.state()["epoch"] == 2
    for state in (saved, {**saved, "ks_high": [[["k"], ["v"]]]}):
        b = _ti(bufs, augment=augment, state=state)
        for want in rest:
            assert torch.equal(next(b), want)
    other = _ti(bufs, augment=augment, seed=3)
    assert not torch.equal(next(other), next(_ti(bufs, augment=augment)))


def test_epoch_rollover_and_permutation():
    """Epochs walk numpy's default_rng((seed, epoch)) permutation; a
    partial tail is dropped and the next epoch starts at position 0."""
    bufs = _sources("420", (61, 90), n=5)
    ti = _ti(bufs, batch=2)
    states = []
    for _ in range(3):
        next(ti)
        states.append(ti.state())
    assert states == [{"seed": 2, "epoch": 0, "pos": 2},
                      {"seed": 2, "epoch": 0, "pos": 4},
                      {"seed": 2, "epoch": 1, "pos": 2}]
    perm = np.random.default_rng((2, 1)).permutation(5)
    assert list(ti._perm) == list(perm)


def _one(bufs, i, window, flip, **kw):
    """Image i alone through the port at a given window and flip."""
    ti = _ti([bufs[i]], batch=1, **kw)
    groups, _w = ti.plan(0, 0, [bufs[i]])
    rgb, _ok = ti.decode(groups[0][2])
    return port_tr.crop_resize_normalize(
        rgb, torch.tensor([window[0]], dtype=torch.int32),
        torch.tensor([window[1]], dtype=torch.int32), torch.tensor([flip]),
        ti._windows, crop=CROP)[0]


def test_mixed_signature_batch_keeps_input_order():
    """A batch of two signatures is decoded per group (padded to 8) and
    comes back in input order: each row equals that image run alone at
    its host window and its group's flip."""
    bufs = (_sources("420", (96, 112), n=2) + _sources("444", (61, 90), n=2))
    order = [0, 2, 1, 3]
    bufs = [bufs[i] for i in order]
    ti = _ti(bufs, batch=4)
    groups, windows = ti.plan(0, 0, bufs)
    assert [g[1] for g in groups] == [[0, 2], [1, 3]]
    assert all(len(g[2]) == 8 for g in groups)
    got = ti.step(0, 0, bufs)
    assert got.shape == (4, SIZE, SIZE, 3)
    for _sig, idxs, _items, draws in groups:
        for j, i in enumerate(idxs):
            want = _one(bufs, i, windows[i], bool(draws.flip[j]))
            assert float((got[i] - want).abs().max()) <= 1e-6


def test_pre_crop_false_draws_windows_on_the_port_stream():
    """pre_crop=False: offsets from the port's generator, within the
    frame, deterministic; the output equals the chain run at those
    offsets."""
    bufs = _sources("420", (61, 90), n=3)
    ti = _ti(bufs, pre_crop=False)
    groups, windows = ti.plan(0, 0, bufs)
    assert windows is None
    draws = groups[0][3]
    assert int(draws.xs.max()) <= 90 - CROP and int(draws.ys.max()) <= 61 - CROP
    assert draws.xs.dtype == torch.int32
    got = ti.step(0, 0, bufs)
    assert torch.equal(got, _ti(bufs, pre_crop=False).step(0, 0, bufs))
    rgb, _ok = ti.decode(groups[0][2])
    want = port_tr.crop_resize_normalize(rgb, draws.xs, draws.ys, draws.flip,
                                         ti._windows, crop=CROP)
    assert torch.equal(got, want)


@pytest.mark.parametrize("pre_crop", [True, False])
def test_oversized_crop_raises(pre_crop):
    bufs = _sources("420", (61, 90), n=3)
    with pytest.raises(ValueError, match="crop larger than image"):
        next(_ti(bufs, crop=64, pre_crop=pre_crop))


@pytest.mark.parametrize("case", ["progressive", "flag", "capacity"])
def test_fallbacks_match_device_path(monkeypatch, case):
    """A progressive batch (parse_baseline refuses it), a decoder flag
    and a batch past ScanBatch's capacity gate take Pillow's decode,
    then K9 -> K8 -> K10: within 1 LSB (mean) of the device decode on
    the same coefficients, counted once."""
    imgs = [smooth_rgb(96, 112, i) for i in range(3)]
    base = [pil_jpeg(a, quality=85) for a in imgs]
    want = _ti(base).step(0, 0, base)
    bufs = base
    if case == "progressive":
        bufs = [pil_jpeg(a, quality=85, progressive=True) for a in imgs]
    elif case == "flag":
        decode = port_tr.decode_scan

        def flagged(*a, **k):
            out, _ok = decode(*a, **k)
            return out, torch.tensor(False)

        monkeypatch.setattr(port_tr, "decode_scan", flagged)
    else:
        def full(_infos):
            raise ValueError("batch past the capacity gate")

        monkeypatch.setattr(port_tr, "scan_wire", full)
    ti = _ti(bufs)
    got = ti.step(0, 0, bufs)
    assert ti.scan_fallbacks == 1
    assert got.shape == want.shape
    assert float((got - want).abs().mean()) * 255 <= 1.0
