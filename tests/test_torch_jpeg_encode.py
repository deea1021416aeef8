"""Port encoder (picha_tpu_torch/ops/jpeg.py, ops/jpeg_huffman.py; plain
torch paths on the CPU) against picha_tpu's `_jit_encode` and
`build_scan_encoder` (JAX on the CPU) and against libjpeg's
`jpeg_coef_write`: coefficients equal (|diff| <= 1 allowed on at most
1e-4 of them, f32 summation order at exact .5 ties), scan bytes and
byte counts identical."""
import numpy as np
import pytest
import torch

from conftest import fixture_bytes
from torch_helpers import smooth_rgb

from picha_tpu.native import lib as native
from picha_tpu.ops import jpeg_huffman_tpu as H
from picha_tpu.ops import jpeg_tpu
from picha_tpu_torch.ops import jpeg as PJ
from picha_tpu_torch.ops import jpeg_huffman as PH


def _tables(quality=85):
    ql, qc = jpeg_tpu.quality_tables(quality)
    return (ql, qc, torch.as_tensor(ql.astype(np.int32)),
            torch.as_tensor(qc.astype(np.int32)),
            torch.as_tensor(jpeg_tpu._idct_kron()))


@pytest.mark.parametrize("n,h,w,c", [(2, 37, 45, 3), (3, 48, 64, 3),
                                     (2, 33, 31, 1)])
def test_encode_front_matches_jit_encode(n, h, w, c):
    rng = np.random.default_rng(h * w + c)
    f255 = rng.uniform(-30.0, 285.0, (n, h, w, c)).astype(np.float32)
    f255[0] = smooth_rgb(h, w, 1)[..., :c]       # a natural plane too
    ql, qc, tql, tqc, kron = _tables()
    img = np.floor(np.clip(f255 + 0.5, 0, 255)).astype(np.uint8)
    want = jpeg_tpu._jit_encode(h, w, c, c == 3)(img, ql, qc)
    got = PJ.encode_blocks(torch.as_tensor(f255), tql, tqc, kron)
    assert len(got) == len(want) == (3 if c == 3 else 1)
    for g, wnt in zip(got, want):
        wnt = np.asarray(wnt)
        assert g.dtype == torch.int16 and g.shape == wnt.shape
        d = np.abs(g.numpy().astype(np.int32) - wnt)
        assert d.max() <= 1 and (d > 0).sum() <= 1e-4 * d.size


def test_annex_k_tables_equal_libjpeg_tables():
    assert PH.ANNEX_K == H.std_huffman_tables()
    tabs = H._device_tables()
    want = np.zeros((4, 256), np.int32)
    for (cls, tid), (code, length) in tabs.items():
        want[cls * 2 + tid, :code.size] = (length << 16) | code
    np.testing.assert_array_equal(PH.code_table(), want)


@pytest.mark.parametrize("w,h,sig_kind,q", [
    (960, 544, "420", 85), (33, 31, "grey", 90), (17, 13, "420", 40)])
def test_header_matches_reference(w, h, sig_kind, q):
    from picha_tpu_torch.pipeline.jpeg_batch import resized_comp_sig

    sig = resized_comp_sig(h, w, 1 if sig_kind == "grey" else 3)
    assert PH.jpeg_header(w, h, sig, q) == H.jpeg_header(w, h, sig, q)


def _layout(comp_sig):
    return PH.ScanLayout(*(torch.as_tensor(np.asarray(a, np.int32))
                           for a in H._mcu_layout(comp_sig)))


def _coefs_of(co):
    sig = tuple((c["blocks_h"], c["blocks_w"], c["h_samp"], c["v_samp"])
                for c in co.comps)
    return sig, tuple(np.asarray(c["coefs"], np.int16)[None]
                      for c in co.comps)


def _libjpeg_scan(co):
    from test_huffman_tpu import libjpeg_encode_from_coefs, scan_of

    return scan_of(libjpeg_encode_from_coefs(co))


def _encode(coefs, sig, cap):
    return PH.scan_encode(tuple(torch.as_tensor(c) for c in coefs),
                          _layout(sig), torch.as_tensor(PH.code_table()),
                          cap)


@pytest.mark.parametrize("name", ["test2.jpg", "test2g.jpg", "test.jpeg"])
def test_scan_encode_matches_libjpeg(name):
    co = native.JpegCoefficients(fixture_bytes(name))
    sig, coefs = _coefs_of(co)
    out, nb = _encode(coefs, sig, 1 << 18)
    assert out[0, :int(nb[0])].numpy().tobytes() == _libjpeg_scan(co)


def test_scan_encode_matches_reference_and_signals_overflow():
    """A two-image batch, natural content at q90 and noise at q97 (odd
    dims: dummy blocks in partial MCUs), against the JAX encoder: the
    noise image overflows the buffer and must report the same
    nbytes > byte_cap, the other must fit; all bytes identical."""
    rng = np.random.default_rng(4)
    imgs = [(smooth_rgb(37, 45, 3), 90),
            (rng.integers(0, 256, (37, 45, 3), dtype=np.uint8), 97)]
    cos = [native.JpegCoefficients(native.jpeg_encode(a, q))
           for a, q in imgs]
    sig, _ = _coefs_of(cos[0])
    coefs = tuple(np.concatenate(parts) for parts in zip(
        *[_coefs_of(co)[1] for co in cos]))
    cap = 2048
    out, nb = _encode(coefs, sig, cap)
    want_scan, want_nb = H.build_scan_encoder(sig, cap)(
        tuple(c.astype(np.int32) for c in coefs))
    np.testing.assert_array_equal(nb.numpy(), np.asarray(want_nb))
    assert int(nb[0]) <= cap < int(nb[1])
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_scan))
    assert out[0, :int(nb[0])].numpy().tobytes() == _libjpeg_scan(cos[0])


def test_scan_encode_dense_content_matches_libjpeg():
    """Noise at q97 (~50 packets per block) with odd dims."""
    rng = np.random.default_rng(5)
    noisy = rng.integers(0, 256, (61, 83, 3), dtype=np.uint8)
    co = native.JpegCoefficients(native.jpeg_encode(noisy, 97))
    sig, coefs = _coefs_of(co)
    out, nb = _encode(coefs, sig, 1 << 16)
    assert out[0, :int(nb[0])].numpy().tobytes() == _libjpeg_scan(co)
