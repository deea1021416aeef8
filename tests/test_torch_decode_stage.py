"""Port staged JPEG decode (picha_tpu_torch/ops/jpeg.py: the plain
versions of K6 `dequant_idct_plane` and K7 `upsample_color`, and
`build_decode_stage`) against picha_tpu's `ops/jpeg_tpu.py` (JAX on the
CPU) on the same coefficients.

Tolerances: a K6 sample may be off by one only where the port's value
before rounding lies within 1e-4 of a .5 tie (the IDCT's f32 sums run
in another order than XLA's; flat blocks put samples within f32
rounding of a tie, and both sides round half to even). K7 is integer
arithmetic: given the reference's own planes it must give the
reference's output exactly."""
import numpy as np
import pytest
import torch

from conftest import fixture_bytes
from torch_helpers import DECODE_CASES, synthetic_decode_case

from picha_tpu.native import lib as native
from picha_tpu.ops import jpeg_tpu as ref
from picha_tpu.ops.jpeg_tpu import CS_CMYK, CS_YCBCR, CS_YCCK, _idct_kron
from picha_tpu.pipeline.jpeg_batch import signature
from picha_tpu_torch.ops import jpeg as port

NEAR_TIE = 1e-4
KRON = torch.as_tensor(_idct_kron())


def _from_jpeg(buf):
    co = native.JpegCoefficients(buf)
    width, height, cs, comp_sig = signature(co)
    coefs = [c["coefs"][None] for c in co.comps]          # int16
    qtabs = [c["qtable"].astype(np.int32)[None, None, None, :]
             for c in co.comps]
    return width, height, cs, comp_sig, coefs, qtabs, False


def _case(name):
    if name == "cmyk_fixture":
        return _from_jpeg(fixture_bytes("test2cmyk.jpg"))
    if name == "libjpeg_420":
        from torch_helpers import smooth_rgb

        return _from_jpeg(native.jpeg_encode(smooth_rgb(61, 90, 4), 85))
    return synthetic_decode_case(name)


def _near_tie(pre):
    return (pre - pre.floor() - 0.5).abs() < NEAR_TIE


CASES = list(DECODE_CASES) + ["cmyk_fixture", "libjpeg_420"]


@pytest.mark.parametrize("name", CASES)
def test_decode_stage_matches_reference(name):
    width, height, cs, comp_sig, coefs, qtabs, force = _case(name)
    tc = [torch.as_tensor(c) for c in coefs]
    tq = [torch.as_tensor(q) for q in qtabs]
    geom = port.plane_geometry(comp_sig, width, height)

    ref_planes, port_planes = [], []
    for i, (dh, dw, _fx, _fy) in enumerate(geom):
        want = np.asarray(ref.dequant_idct_plane(coefs[i], qtabs[i], dh, dw))
        got = port.dequant_idct_plane(tc[i], tq[i], KRON, dh, dw)
        assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
        d = np.abs(got.numpy().astype(np.int32) - want)
        pre = port.idct_samples(tc[i], tq[i], KRON)[:, :dh, :dw]
        assert d.max() <= 1
        assert bool(_near_tie(pre)[torch.as_tensor(d > 0)].all())
        ref_planes.append(torch.as_tensor(want.astype(np.uint8)))
        port_planes.append(got)

    want = np.asarray(ref.build_decode_stage(comp_sig, cs, width, height,
                                             force)(coefs, qtabs))
    # K7's twin on the reference's planes: integer-exact
    k7 = port.upsample_color(ref_planes, comp_sig, cs, width, height, force)
    assert k7.dtype == torch.uint8 and tuple(k7.shape) == want.shape
    np.testing.assert_array_equal(k7.numpy(), want)
    # the whole port stage: equal wherever the planes are
    got = port.build_decode_stage(comp_sig, cs, width, height, force)(
        tc, tq, KRON)
    assert torch.equal(got, port.upsample_color(port_planes, comp_sig, cs,
                                                width, height, force))
    if all(torch.equal(a, b) for a, b in zip(port_planes, ref_planes)):
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert np.abs(got.numpy().astype(np.int32) - want).max() <= 2


def test_near_ties_are_exercised():
    """The synthetic flat blocks put IDCT samples within f32 rounding of
    a .5 tie (an odd DC step times a DC of 4 mod 8, over 8): the parity
    above holds the port to the reference's rounding where it is most
    fragile."""
    _w, _h, _cs, _sig, coefs, qtabs, _f = synthetic_decode_case("420")
    pre = port.idct_samples(torch.as_tensor(coefs[0]),
                            torch.as_tensor(qtabs[0]), KRON)
    assert int(_near_tie(pre).sum()) >= 64


@pytest.mark.parametrize("fn,args", [
    ("fancy_upsample_h", ()), ("fancy_upsample_v", ()),
    ("fancy_upsample_h2v2", ()),
    ("upsample_to", (2, 2, 9, 13)), ("upsample_to", (2, 1, 7, 12)),
    ("upsample_to", (1, 2, 13, 7)), ("upsample_to", (3, 2, 11, 20)),
])
def test_upsample_helpers_match_reference(fn, args):
    """The reference's helpers by name, on random int32 planes."""
    plane = np.random.default_rng(7).integers(0, 256, (2, 7, 7), np.int32)
    want = np.asarray(getattr(ref, fn)(plane, *args))
    got = getattr(port, fn)(torch.as_tensor(plane), *args)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fn", ["ycbcr_to_rgb_int", "cmyk_fold_to_rgb",
                                "ycck_to_cmyk"])
def test_colour_helpers_match_reference(fn):
    """Arithmetic shifts of negative sums floor, the fold floors: every
    input value is covered."""
    rng = np.random.default_rng(8)
    nargs = 3 if fn == "ycbcr_to_rgb_int" else 4
    planes = [rng.integers(0, 256, (4096,), np.int32) for _ in range(nargs)]
    planes[0][:256] = np.arange(256)
    want = getattr(ref, fn)(*planes)
    got = getattr(port, fn)(*(torch.as_tensor(p) for p in planes))
    if fn == "ycck_to_cmyk":
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fractional_sampling_raises():
    from picha_tpu_torch.errors import CodecError

    with pytest.raises(CodecError):
        port.build_decode_stage(((2, 3, 3, 1), (2, 2, 2, 1)), CS_YCBCR,
                                24, 16)


def test_cmyk_fixture_is_covered():
    """The CMYK fixture really takes the fold (4 components)."""
    _w, _h, cs, comp_sig, _c, _q, _f = _case("cmyk_fixture")
    assert len(comp_sig) == 4 and cs in (CS_CMYK, CS_YCCK)
