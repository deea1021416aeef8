"""Port separable resize (picha_tpu_torch/ops/resize.py) against
picha_tpu's `resize_f32` (JAX on the CPU): every filter, the dense plan
(source <= 512) and the banded plan (source > 512), downscale and
upscale. Both port forms, `resize_f32_plain` (the reference's dense and
banded contractions) and the windowed sum of K8's plain twin, stay
within 1e-6 of the reference on the 0-1 scale (f32 sums in another
order)."""
import numpy as np
import pytest
import torch

from picha_tpu.ops.resize import FILTERS
from picha_tpu.ops.resize import resize_f32 as ref_resize
from picha_tpu_torch.ops.resize import (INV255, resize_axis,
                                        resize_axis_windowed_plain,
                                        resize_f32, resize_f32_plain,
                                        resize_windowed, window_tensors)

TOL = 1e-6
# name -> (src_h, src_w, dst_h, dst_w)
SHAPES = {
    "dense_down": (37, 45, 23, 30),
    "dense_up": (20, 33, 41, 50),
    "banded_down_w": (24, 600, 15, 250),
    "banded_up_h": (520, 16, 700, 24),
}


def _image(shape, seed, c=3):
    src_h, src_w = shape[:2]
    return np.random.default_rng(seed).random((2, src_h, src_w, c),
                                              dtype=np.float32)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("filt", list(FILTERS))
def test_resize_matches_reference(filt, shape):
    _sh, _sw, dst_h, dst_w = SHAPES[shape]
    x = _image(SHAPES[shape], len(filt) + len(shape))
    fscale = 0.7 if filt == "cubic" else 1.0
    want = np.asarray(ref_resize(x, dst_w, dst_h, filt, fscale))
    for fn in (resize_f32_plain, resize_f32):
        got = fn(torch.as_tensor(x), dst_w, dst_h, filt, fscale)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        assert float(np.abs(got.numpy() - want).max()) <= TOL, fn.__name__


@pytest.mark.parametrize("c", [1, 3])
def test_uint8_input_unpacks_before_the_taps(c):
    """uint8 in: v * f32(1/255) before any tap, as the reference unpacks
    (jpeg_batch.py pixel_stages) before resize_f32."""
    u8 = np.random.default_rng(c).integers(0, 256, (1, 30, 530, c),
                                           np.uint8)
    want = np.asarray(ref_resize(u8.astype(np.float32) * np.float32(INV255),
                                 200, 17, "cubic", 0.7))
    got = resize_f32(torch.as_tensor(u8), 200, 17, "cubic", 0.7)
    assert float(np.abs(got.numpy() - want).max()) <= TOL
    f = torch.as_tensor(u8).to(torch.float32) * INV255
    assert torch.equal(got, resize_f32(f, 200, 17, "cubic", 0.7))


def test_out_scale_is_one_final_multiply():
    """out_scale scales the finished sum (K2 then packs f * 255 exactly as
    the reference's floor(clip(f * 255 + 0.5)) does)."""
    u8 = torch.as_tensor(np.random.default_rng(5).integers(
        0, 256, (2, 40, 60, 3), np.uint8))
    windows = (window_tensors(25, 60, "lanczos", 1.0, "cpu"),
               window_tensors(19, 40, "lanczos", 1.0, "cpu"))
    base = resize_windowed(u8, windows)
    assert torch.equal(resize_windowed(u8, windows, out_scale=255.0),
                       base * 255.0)


@pytest.mark.parametrize("axis", [-2, -3])
def test_resize_axis_is_the_windowed_twin_on_cpu(axis):
    """On CPU tensors the wrapper runs the plain twin itself, and the
    twin's windows are the reference's `resize_windows`."""
    x = torch.as_tensor(_image((31, 43), 9))
    src = x.shape[axis]
    starts, taps = window_tensors(12, src, "mitchel", 1.0, "cpu")
    got = resize_axis(x, starts, taps, axis)
    assert torch.equal(got, resize_axis_windowed_plain(x, starts, taps,
                                                       axis))
    dense = torch.zeros(12, src)
    for o in range(12):
        dense[o, starts[o]:starts[o] + taps.shape[1]] = taps[o]
    want = torch.einsum("os,nswc->nowc" if axis == -3 else "os,nhsc->nhoc",
                        dense.double(), x.double())
    assert float((got.double() - want).abs().max()) <= TOL


# -- K8's plans (ops/resize.py: resize_plan, axis_plan, tile_spans) -----------
# The card's numbers the plans read (an H100's limits; resize_2d's
# registers as a round figure), and cases over every filter: downscales,
# upscales and windows up to the axis length.
H100 = dict(smem_block=232448, smem_sm=233472, reserved=1024, registers=40)
PLAN_CASES = {  # name -> (src_h, src_w, dst_h, dst_w)
    "down2": (1088, 1920, 544, 960),
    "up": (192, 192, 224, 224),
    "config4": (224, 352, 112, 176),
    "down_far": (300, 2000, 7, 11),
    "to_one": (9, 13, 1, 1),
    "odd": (37, 45, 23, 30),
}


def _windows_np(case, filt):
    from picha_tpu_torch.ops.resize_weights import resize_windows

    src_h, src_w, dst_h, dst_w = PLAN_CASES[case]
    fscale = 0.7 if filt == "cubic" else 1.0
    return (resize_windows(dst_w, src_w, filt, fscale),
            resize_windows(dst_h, src_h, filt, fscale))


@pytest.mark.parametrize("eb", [1, 4])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("case", list(PLAN_CASES))
@pytest.mark.parametrize("filt", list(FILTERS))
def test_k8_tiles_hold_every_window(filt, case, c, eb):
    """Every output's window lies inside its tile's source span, and
    every tile's span inside what the plan staged for it: resize_2d's
    rows and columns, resize_rows's width span."""
    from picha_tpu_torch.ops.resize import (axis_plan, resize_plan,
                                            tile_rows, tile_spans)

    (sw, tw), (sh, th) = _windows_np(case, filt)
    kw, kh = tw.shape[1], th.shape[1]
    plan = resize_plan(sw, kw, sh, kh, c, H100, eb)
    tiles = [(sw, kw, tile_rows(c))]
    if plan["route"] == "one_launch":
        tiles += [(sw, kw, plan["tx"]), (sh, kh, plan["ty"])]
        xlo, xhi = tile_spans(sw, kw, plan["tx"])
        ylo, yhi = tile_spans(sh, kh, plan["ty"])
        assert (yhi - ylo).max() <= plan["rows_max"]
        assert 15 + (xhi - xlo).max() * c * eb <= 16 * plan["span_chunks"]
        assert plan["smem"] + 64 <= H100["smem_block"]
    for starts, k, tile in tiles:
        lo, hi = tile_spans(starts, k, tile)
        t = np.arange(len(starts)) // tile
        assert (lo[t] <= starts).all() and (starts + k <= hi[t]).all()
        assert (lo >= 0).all() and hi.max() <= max(starts) + k
    wp = axis_plan(sw, kw, c, H100, eb)
    if wp["span_chunks"]:
        lo, hi = tile_spans(sw, kw, wp["tile"])
        assert 15 + (hi - lo).max() * c * eb <= 16 * wp["span_chunks"]


@pytest.mark.parametrize("eb", [1, 4])
@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("case", ["down2", "up", "config4", "odd"])
def test_k8_route_follows_the_shared_memory(case, c, eb):
    """One launch exactly where the smallest tile fits the shared memory
    a block the plan is given; the per-axis kernels below it."""
    from picha_tpu_torch.ops.resize import STATIC_SMEM, resize_plan

    (sw, tw), (sh, th) = _windows_np(case, "lanczos")
    args = (sw, tw.shape[1], sh, th.shape[1], c)
    assert resize_plan(*args, H100, eb)["route"] == "one_launch"

    def plan_at(b):
        return resize_plan(*args, dict(H100, smem_block=b), eb)

    lo, hi = 0, H100["smem_block"]          # per_axis at lo, one launch at hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if plan_at(mid)["route"] == "one_launch" else \
            (mid, hi)
    fits, short = plan_at(hi), plan_at(hi - 1)
    assert fits["route"] == "one_launch" and short["route"] == "per_axis"
    assert fits["smem"] + STATIC_SMEM == hi     # the smallest tile, exactly
    assert all(plan_at(b)["route"] == "per_axis" for b in (0, 1024, hi // 2))
    # more shared memory never takes a smaller tile than a tighter card
    assert resize_plan(*args, H100, eb)["ty"] >= fits["ty"]
    # five channels: the per-axis kernels
    assert resize_plan(sw, tw.shape[1], sh, th.shape[1], 5,
                       H100)["route"] == "per_axis"


@pytest.mark.parametrize("c,dtype,base", [
    (3, np.uint8, 0), (3, np.uint8, 1), (1, np.uint8, 3), (2, np.float32, 2),
    (4, np.float32, 1), (4, np.uint8, 2), (3, np.float32, 3),
    (3, np.uint8, 13), (1, np.uint8, 15), (2, np.uint8, 7)])
@pytest.mark.parametrize("case,filt", [("odd", "cubic"), ("up", "lanczos"),
                                       ("to_one", "box"),
                                       ("down_far", "triangle")])
def test_k8_tile_model_is_the_twin(case, filt, c, dtype, base):
    """The numpy model of resize_2d's tiles (`torch_helpers.k8_tile_model`:
    staged words at every alignment, NaN past what a step may read) gives
    the windowed twin's bits, at the plan the card would take and at a
    plan squeezed to one output row a tile."""
    from picha_tpu_torch.ops.resize import resize_plan
    from torch_helpers import k8_tile_model

    src_h, src_w, dst_h, dst_w = PLAN_CASES[case]
    if case == "up":
        src_h, src_w, dst_h, dst_w = 24, 40, 29, 47
    if case == "down_far":
        src_h, src_w, dst_h, dst_w = 90, 200, 7, 11
    from picha_tpu_torch.ops.resize_weights import resize_windows
    windows = (resize_windows(dst_w, src_w, filt, 1.0),
               resize_windows(dst_h, src_h, filt, 1.0))
    rng = np.random.default_rng(c + base)
    x = rng.integers(0, 256, (2, src_h, src_w, c)).astype(dtype)
    if dtype == np.float32:
        x = x / np.float32(7.0)
    t = torch.as_tensor(x)
    (sw, tw), (sh, th) = windows
    ws = [(torch.as_tensor(a), torch.as_tensor(b)) for a, b in windows]
    in_scale = INV255 if dtype == np.uint8 else 1.0
    for out_scale in (1.0, 255.0):
        want = resize_axis_windowed_plain(resize_axis_windowed_plain(
            t, *ws[0], -2), *ws[1], -3, out_scale).numpy()
        for card in (H100, dict(H100, smem_block=None)):
            if card["smem_block"] is None:   # the smallest tile that fits
                plan = None
                for b in range(1024, 232449, 256):
                    plan = resize_plan(sw, tw.shape[1], sh, th.shape[1], c,
                                       dict(H100, smem_block=b), x.itemsize)
                    if plan["route"] == "one_launch":
                        break
            else:
                plan = resize_plan(sw, tw.shape[1], sh, th.shape[1], c, card,
                                   x.itemsize)
            assert plan["route"] == "one_launch"
            got = k8_tile_model(x, base, windows, plan, in_scale, out_scale)
            assert np.array_equal(got, want), (plan, out_scale)


def test_k8_plans_read_the_recorded_starts():
    """`window_tensors` records the starts it uploads, so a plan reads no
    device memory; starts from elsewhere or changed in place are read
    back once; an entry goes with its tensor."""
    import gc

    from picha_tpu_torch.ops import resize as rs
    from picha_tpu_torch.ops.resize_weights import resize_windows

    starts, _ = rs.window_tensors(25, 60, "lanczos", 1.0, "cpu")
    assert id(starts) in rs._HOSTS
    host, key = rs.starts_host(starts)
    want = resize_windows(25, 60, "lanczos", 1.0)[0]
    assert np.array_equal(host, want) and key == want.astype(np.int32) \
        .tobytes()
    other = starts.clone()                  # not from window_tensors
    assert id(other) not in rs._HOSTS
    assert np.array_equal(rs.starts_host(other)[0], want)
    other[3] += 1                           # changed in place
    host, key = rs.starts_host(other)
    assert host[3] == want[3] + 1 and key == other.numpy().tobytes()
    ids = id(starts), id(other)
    del starts, other
    gc.collect()
    assert not any(i in rs._HOSTS for i in ids)


def test_k8_plan_follows_the_windows_content(monkeypatch):
    """Windows made and freed in turn (so that new tensors take freed
    ids) each get the plan of their own starts: the cache is keyed by
    their content, never by a tensor's identity."""
    from picha_tpu_torch.ops import resize as rs

    monkeypatch.setattr(rs, "card_info", lambda *a, **k: H100)
    x = torch.zeros((1, 300, 400, 3), dtype=torch.uint8)
    for src in (400, 300, 400, 2000, 350, 2000, 300):
        windows = (rs.window_tensors(97, src, "lanczos", 1.0, "cpu"),
                   rs.window_tensors(61, src // 2, "lanczos", 1.0, "cpu"))
        (sw, tw), (sh, th) = windows
        want = rs.resize_plan(sw.numpy(), tw.shape[1], sh.numpy(),
                              th.shape[1], 3, H100, 1)
        assert rs.windowed_plan(x, windows) == want, src
        del windows, sw, tw, sh, th


# name -> (frame h, frame w, crop, size, filter): an upscale (the ingest's
# direction), a downscale with a long window, a crop that is the frame
K9_TILE_CASES = {"up": (40, 75, 24, 29, "cubic"),
                 "down": (52, 90, 40, 17, "lanczos"),
                 "whole_frame": (33, 33, 33, 20, "triangle")}


@pytest.mark.parametrize("case", list(K9_TILE_CASES))
def test_k9_crop_tile_model_is_the_plain_chain(case):
    """resize_2d's crop mode as numpy steps (`torch_helpers.k8_tile_model`
    with `crop`): mirrored spans read backwards, staged words at frame
    column offsets x0 * 3 of every remainder mod 16, corners on and past
    the frame's edges (clamped), flips on and off; bit for bit the plain
    chain (`crop_flip_resize_plain`: the flipped crops, then the twin on
    each axis), at the plan the card would take."""
    from picha_tpu_torch.ops.resize import (crop_flip_resize,
                                            crop_flip_resize_plain,
                                            resize_plan)
    from picha_tpu_torch.ops.resize_weights import resize_windows
    from torch_helpers import k8_tile_model

    h, w, crop, size, filt = K9_TILE_CASES[case]
    rng = np.random.default_rng(len(case))
    n = 20
    frames = rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)
    xs = np.concatenate([np.arange(16), [-7, w - crop, w, 2 * w]])
    xs = np.minimum(xs, w + 5).astype(np.int32)
    ys = rng.integers(-3, h - crop + 4, n).astype(np.int32)
    ys[:2] = [0, h - crop]
    flip = np.arange(n) % 3 != 1
    windows = (resize_windows(size, crop, filt, 1.0),) * 2
    (sw, tw), (sh, th) = windows
    plan = resize_plan(sw, tw.shape[1], sh, th.shape[1], 3, H100, 1)
    assert plan["route"] == "one_launch"
    got = k8_tile_model(frames, 0, windows, plan, INV255, 1.0,
                        crop=(xs, ys, flip, crop))
    args = (torch.as_tensor(frames), torch.as_tensor(xs),
            torch.as_tensor(ys), torch.as_tensor(flip), crop,
            tuple((torch.as_tensor(a), torch.as_tensor(b))
                  for a, b in windows))
    want = crop_flip_resize_plain(*args)
    assert np.array_equal(got, want.numpy())
    assert torch.equal(crop_flip_resize(*args), want)     # CPU: the plain


def test_k9_route_for_the_ingest_windows():
    """The ingest's windows (crop 192 -> 224, cubic 1.0, 3 channels of
    uint8) take resize_2d's crop mode in one launch; a window too long
    for any tile (crop 1024 -> 64) the per-axis route."""
    from picha_tpu_torch.ops.resize import resize_plan
    from picha_tpu_torch.ops.resize_weights import resize_windows

    sw, tw = resize_windows(224, 192, "cubic", 1.0)
    plan = resize_plan(sw, tw.shape[1], sw, tw.shape[1], 3, H100, 1)
    assert plan["route"] == "one_launch" and plan["tx"] == 84
    assert plan["smem"] + 64 <= H100["smem_block"]
    sw, tw = resize_windows(64, 1024, "cubic", 1.0)
    assert resize_plan(sw, tw.shape[1], sw, tw.shape[1], 3, H100,
                       1)["route"] == "per_axis"
