"""K10's design (`csrc/augment.cu`) on the CPU: its lane-order model
`augment_sum_lanes` held bit for bit to a scalar float32 emulation of the
kernel's fixed order for the contrast mean (the first design's: each of
512 sums runs over the whole image, pixel t, t + 512, ..., then a
halving tree), the plain chain on that mean (`augment_fused_lanes`,
K10's bits) within 1e-6 of `augment_fused_plain` and within the training
tests' 1e-5 of the reference's `augment` on JAX-CPU (draws from its
keys), and the kernel's split of each share into whole quads of four
pixels (three 16-byte words at a flat index that is a multiple of 4) and
single edge pixels, with each thread's row and column stepped without
division: every pixel once, at its own (row, column).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picha_tpu.pipeline import augment as ref_aug

from picha_tpu_torch.pipeline import augment as port_aug
from picha_tpu_torch.pipeline.augment import (LUMA, AugmentDraws,
                                              augment_fused_lanes,
                                              augment_fused_plain,
                                              augment_sum_lanes)

F32 = np.float32
ZERO, ONE = F32(0.0), F32(1.0)
AUG = {"brightness_s": .2, "contrast_s": .2, "saturation_s": .2,
       "cutout_size": 32}


def emulate_sums(x, fb, threads):
    """The kernel's sum, one scalar float32 operation at a time."""
    n, h, w = x.shape[:3]
    hw = h * w
    l0, l1, l2 = (F32(v) for v in LUMA)
    out = np.zeros(n, F32)
    for i in range(n):
        img = x[i].reshape(hw, 3)
        acc = np.zeros(threads, F32)
        for t in range(threads):
            a = ZERO
            for p in range(t, hw, threads):
                v = [min(max(img[p, c], ZERO), ONE) for c in range(3)]
                if fb is not None:
                    v = [min(max(F32(vc * fb[i]), ZERO), ONE) for vc in v]
                g = F32(F32(F32(v[0] * l0) + F32(v[1] * l1))
                        + F32(v[2] * l2))
                a = F32(a + g)
            acc[t] = a
        s = threads // 2
        while s > 0:
            for t in range(s):
                acc[t] = F32(acc[t] + acc[t + s])
            s //= 2
        out[i] = acc[0]
    return out


def _x(n, h, w, seed, lo=-0.05, hi=1.05):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, (n, h, w, 3)).astype(F32)


def _draws(n, h, w, cfg, seed):
    return port_aug.draw_augment(torch.Generator().manual_seed(seed), n, h,
                                 w, cfg)


@pytest.mark.parametrize("hwt", [(37, 23, 64), (5, 7, 32), (19, 41, 32),
                                 (16, 16, 128), (1, 3, 32)])
@pytest.mark.parametrize("bright", [False, True])
def test_sum_lanes_match_the_scalar_emulation(hwt, bright):
    """Images that do not divide by the sums, one-row and tiny images
    (most sums empty), with and without brightness."""
    h, w, threads = hwt
    x = _x(3, h, w, seed=h * w + threads)
    fb = np.array([0.85, 1.13, 1.0], F32) if bright else None
    got = augment_sum_lanes(torch.from_numpy(x),
                            None if fb is None else torch.from_numpy(fb),
                            threads)
    np.testing.assert_array_equal(got.numpy(), emulate_sums(x, fb, threads))


def test_sum_lanes_at_the_kernels_threads():
    """K10's 512 sums on the ingest's 224 x 224 image."""
    x = _x(1, 224, 224, seed=1)
    fb = np.array([1.17], F32)
    got = augment_sum_lanes(torch.from_numpy(x), torch.from_numpy(fb))
    np.testing.assert_array_equal(got.numpy(), emulate_sums(x, fb, 512))


CFGS = {"augment": AUG,
        "contrast_off": {"brightness_s": .2, "saturation_s": .2,
                         "cutout_size": 32},
        "brightness": {"brightness_s": .3}, "contrast": {"contrast_s": .3},
        "saturation": {"saturation_s": .3},
        "cutout": {"cutout_size": 9, "cutout_fill": 0.5}}


@pytest.mark.parametrize("cfg", list(CFGS))
@pytest.mark.parametrize("hw", [(29, 31), (224, 224)])
def test_chain_on_the_lanes_mean_against_plain(cfg, hw):
    """K10's bits (the plain chain on the lane model's mean) within 1e-6
    of the plain version; bit for bit with contrast off."""
    h, w = hw
    cfg = CFGS[cfg]
    x = torch.from_numpy(_x(4, h, w, seed=h))
    draws = _draws(4, h, w, cfg, seed=w)
    plain = augment_fused_plain(x, draws, cfg)
    got = augment_fused_lanes(x, draws, cfg, dict(threads=512))
    assert float((got - plain).abs().max()) <= 1e-6
    if draws.fc is None:
        assert torch.equal(got, plain)


def test_cutout_at_the_edges():
    """Corners past every edge, clipped at the borders."""
    cfg = {"cutout_size": 12, "cutout_fill": 0.25, "contrast_s": .2}
    x = torch.from_numpy(_x(4, 20, 30, seed=5))
    draws = AugmentDraws(None, torch.tensor([0.9, 1.1, 1.0, 1.2]), None,
                         torch.tensor([-6, 14, -20, 3], dtype=torch.int32),
                         torch.tensor([25, -5, 0, 31], dtype=torch.int32))
    got = augment_fused_lanes(x, draws, cfg, dict(threads=512))
    assert float((got - augment_fused_plain(x, draws, cfg)).abs().max()) \
        <= 1e-6
    assert (got[0, :6, 25:] == 0.25).all() and (got[0, 6:, :] != 0.25).any()
    assert (got[1, 14:, :7] == 0.25).all()
    assert not (got[2] == 0.25).all(dim=-1).any()
    assert not (got[3] == 0.25).all(dim=-1).any()


@pytest.mark.parametrize("contrast", [True, False])
def test_chain_on_the_lanes_mean_against_reference(contrast):
    """Within test_torch_training.py's 1e-5 of the reference's augment
    after the ingest's clip, with the draws of its keys."""
    from test_torch_training import SIZE, ref_augment_draws

    cfg = dict(AUG, cutout_fill=0.25)
    if not contrast:
        cfg.pop("contrast_s")
    key = jax.random.PRNGKey(7)
    x = _x(4, SIZE, SIZE, seed=9, lo=-0.1, hi=1.1)
    draws = ref_augment_draws(key, 4, cfg)
    want = np.asarray(ref_aug.augment(jnp.clip(jnp.asarray(x), 0.0, 1.0),
                                      key, **cfg))
    got = augment_fused_lanes(torch.from_numpy(x), draws, cfg,
                              dict(threads=512))
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5


def quads_model(n, h, w, cl, threads):
    """Each CTA (share r of image i) as the kernel walks it: the whole
    quads q in [ceil(p0 / 4), p1 // 4) by threads, each thread's first
    (row, column) by division and then stepped 4 * threads pixels at a
    time, the pixels outside the quads alone. Returns every pixel's
    visits and the coordinates it was given."""
    hw = h * w
    seen = np.zeros(n * hw, np.int64)
    coords = np.full((n * hw, 2), -1, np.int64)
    sy, sx = divmod(4 * threads, w)

    def visit(p, y, x):
        seen[p] += 1
        coords[p] = (y, x)

    for i in range(n):
        base = i * hw
        for r in range(cl):
            p0 = base + hw * r // cl
            p1 = base + hw * (r + 1) // cl
            q0, q1 = (p0 + 3) // 4, p1 // 4
            if q1 <= q0:
                for p in range(p0, p1):
                    visit(p, *divmod(p - base, w))
                continue
            for p in list(range(p0, 4 * q0)) + list(range(4 * q1, p1)):
                visit(p, *divmod(p - base, w))
            for t in range(threads):
                q = q0 + t
                if q >= q1:
                    break
                y, x = divmod(4 * q - base, w)
                while q < q1:
                    py, px = y, x
                    for k in range(4):
                        if k:
                            px += 1
                            while px >= w:
                                px -= w
                                py += 1
                        visit(4 * q + k, py, px)
                    q += threads
                    y, x = y + sy, x + sx
                    while x >= w:
                        x -= w
                        y += 1
    return seen, coords


@pytest.mark.parametrize("nhw", [(3, 7, 5), (2, 1, 1), (3, 3, 2), (2, 9, 1),
                                 (2, 224, 224), (3, 13, 3)])
@pytest.mark.parametrize("cl, threads", [(1, 32), (3, 32), (6, 512),
                                         (8, 64)])
def test_quads_cover_every_pixel_once(nhw, cl, threads):
    n, h, w = nhw
    seen, coords = quads_model(n, h, w, cl, threads)
    assert (seen == 1).all()
    p = np.arange(n * h * w) % (h * w)
    np.testing.assert_array_equal(coords, np.stack(divmod(p, w), 1))
