"""The port's pixel formats, pack/unpack and colour conversion (K11's
plain version on CPU tensors) against picha_tpu's on the same numpy
inputs: exact over all 56 format pairs, every uint8 and uint16 value,
given, NaN and zero luma weights; the single-image colorConvert sync and
async forms byte-identical to each other and to the reference's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import picha_tpu as ref
from picha_tpu.ops import colorconvert as ref_cc
from picha_tpu.pixels import PIXEL_FORMATS, jpack, junpack_f32

import picha_tpu_torch as port
from picha_tpu_torch.errors import InvalidImageError, InvalidOptionsError
from picha_tpu_torch.ops.colorconvert import convert_batch
from picha_tpu_torch.pixels import TORCH_DTYPE, pack_f32, unpack_f32

PAIRS = [(s, d) for s in PIXEL_FORMATS for d in PIXEL_FORMATS if s != d]


def _batch(pixel, seed, shape=(3, 6, 5)):
    fmt = PIXEL_FORMATS[pixel]
    rng = np.random.default_rng(seed)
    return rng.integers(0, fmt.max_value + 1, shape + (fmt.channels,),
                        dtype=fmt.dtype)


def test_there_are_56_pairs():
    assert len(PAIRS) == 56


@pytest.mark.parametrize("src,dst", PAIRS)
def test_convert_batch_matches_reference(src, dst):
    arr = _batch(src, len(src) * 10 + len(dst))
    want = np.asarray(ref_cc.convert_batch(arr, src, dst))
    got = convert_batch(arr, src, dst, device="cpu").numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pixel", list(PIXEL_FORMATS))
def test_same_format_convert_is_identity(pixel):
    arr = _batch(pixel, 3)
    np.testing.assert_array_equal(
        convert_batch(arr, pixel, pixel, device="cpu").numpy(),
        np.asarray(ref_cc.convert_batch(arr, pixel, pixel)))


@pytest.mark.parametrize("weights", [
    dict(red_weight=1, green_weight=0, blue_weight=0),
    dict(red_weight=0.2, green_weight=0.3, blue_weight=0.5),
    dict(red_weight=2, green_weight=5, blue_weight=1),
    dict(red_weight=float("nan"), green_weight=0.1),
    dict(blue_weight="0.7"),
])
@pytest.mark.parametrize("src,dst", [("rgb", "grey"), ("rgba", "greya"),
                                     ("r16g16b16a16", "r16")])
def test_weighted_luma_matches_reference(weights, src, dst):
    """Exactly the reference's host path (numpy, IEEE f32: unpack by
    division, products and sums rounded in order). The reference's
    jitted `convert_batch` is not bit-identical to its own host path
    for every weight triple: XLA:CPU rewrites the constant-weight
    products (with weights 2, 5, 1 it differs from numpy on 61 of 40,000
    rgb pixels, by 1), so against the jit the bound is 1 LSB on at most
    1 % of the values; with the default weights it is exact
    (`test_convert_batch_matches_reference`)."""
    arr = _batch(src, 11, (2, 40, 50))
    host = np.stack([ref_cc.convert_array(a, dst, **weights) for a in arr])
    jit = np.asarray(ref_cc.convert_batch(arr, src, dst, **weights))
    got = convert_batch(arr, src, dst, device="cpu", **weights).numpy()
    np.testing.assert_array_equal(got, host)
    d = np.abs(got.astype(np.int64) - jit)
    assert d.max() <= 1 and (d > 0).mean() <= 0.01


@pytest.mark.parametrize("weights", [
    dict(red_weight=0, green_weight=0, blue_weight=0),
    dict(red_weight="x"), dict(green_weight=[1])])
def test_bad_weights_raise_like_reference(weights):
    from picha_tpu.errors import InvalidOptionsError as RefError

    arr = _batch("rgb", 1)
    with pytest.raises(RefError) as want:
        ref_cc.convert_batch(arr, "rgb", "grey", **weights)
    with pytest.raises(InvalidOptionsError) as got:
        convert_batch(arr, "rgb", "grey", device="cpu", **weights)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_unpack_matches_reference_for_every_value(dtype):
    v = np.arange(np.iinfo(dtype).max + 1, dtype=dtype)
    want = np.asarray(junpack_f32(jnp.asarray(v)))
    got = unpack_f32(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_pack_matches_reference(dtype):
    """Every unpacked value (exact round trips), their neighbours one f32
    ulp away, the .5 boundaries, out-of-range values and noise."""
    maxv = np.iinfo(dtype).max
    exact = np.arange(maxv + 1, dtype=np.float32) / np.float32(maxv)
    halves = (np.arange(maxv, dtype=np.float32) + 0.5) / np.float32(maxv)
    rng = np.random.default_rng(2)
    f = np.concatenate([
        exact, np.nextafter(exact, 2), np.nextafter(exact, -1), halves,
        np.nextafter(halves, 2), np.nextafter(halves, -1),
        np.float32([-1, -1e-9, 0, 1, 1 + 1e-7, 2, 1e9]),
        rng.uniform(-0.1, 1.1, 50_000).astype(np.float32)])
    want = np.asarray(jpack(jnp.asarray(f), dtype))
    got = pack_f32(torch.from_numpy(f), TORCH_DTYPE[np.dtype(dtype)]).numpy()
    np.testing.assert_array_equal(got, want)


def test_convert_batch_rejects_pixels_of_another_format():
    with pytest.raises(InvalidImageError):
        convert_batch(_batch("rgba", 0), "rgb", "grey", device="cpu")
    with pytest.raises(InvalidImageError):
        convert_batch(_batch("r16", 0), "grey", "rgb", device="cpu")


@pytest.mark.parametrize("src,dst", [("rgba", "greya"), ("rgb", "r16"),
                                     ("r16g16", "rgba"), ("grey", "rgb")])
def test_color_convert_sync_async_and_reference(src, dst):
    """Sync and async forms byte-identical (the callback form too), and
    equal to the reference's colorConvertSync."""
    arr = _batch(src, 5, (13, 9))
    img = port.Image.from_array(arr, src)
    opts = {"pixel": dst, "redWeight": 0.25}
    sync = port.color_convert_sync(img, opts, device="cpu")
    fut = port.color_convert(img, opts, device="cpu")
    seen = {}
    cb_fut = port.colorConvert(img, opts, lambda e, r: seen.update(e=e, r=r),
                               device="cpu")
    assert fut.result(60).equal_pixels(sync)
    assert cb_fut.result(60).equal_pixels(sync) and seen["e"] is None
    assert seen["r"].equal_pixels(sync)
    want = ref.colorConvertSync(ref.Image.from_array(arr, src), opts)
    assert sync.pixel == want.pixel == dst
    np.testing.assert_array_equal(sync.to_array(), want.to_array())


def test_color_convert_same_format_copies_and_errors():
    img = port.Image.from_array(_batch("rgb", 1, (4, 4)), "rgb")
    same = port.color_convert_sync(img, {"pixel": "rgb"}, device="cpu")
    assert same.equal_pixels(img) and same.data is not img.data
    with pytest.raises(InvalidOptionsError):
        port.color_convert_sync(img, {}, device="cpu")
    with pytest.raises(InvalidOptionsError):
        port.color_convert_sync(img, {"pixel": "cmyk"}, device="cpu")
    err = port.color_convert(img, {}, device="cpu")
    with pytest.raises(InvalidOptionsError):
        err.result(60)
