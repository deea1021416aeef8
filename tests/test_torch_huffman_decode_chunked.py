"""Port chunked speculative Huffman decoder (picha_tpu_torch/ops/
jpeg_huffman_decode.py, `decode_scan_chunked_plain` on the CPU) against
the JAX reference `build_decoder_core(single_pass=False)` on the CPU and
against libjpeg's coefficients, on the valid streams of
`torch_helpers.CHUNKED_STREAMS` (scans without usable restart markers;
the GPU tests hold K4 to the plain version on the same streams).
Entropy decode is lossless: every comparison is exact."""
import numpy as np
import pytest
import torch

from torch_helpers import (CHUNKED_STREAMS, N_FIXTURES, PORT_FIXTURES,
                           noisy, pil_jpeg)

from picha_tpu.native import lib as native
from picha_tpu.ops import jpeg_scan
from picha_tpu.ops.jpeg_huffman_decode_tpu import (MAX_PASSES, ScanBatch,
                                                   build_decoder,
                                                   split_indices)
from picha_tpu_torch.ops.jpeg_huffman_decode import (decode_scan,
                                                     decode_scan_chunked,
                                                     split_planes,
                                                     wire_unpack)


def _reference(sb, **kw):
    import jax.numpy as jnp

    out, ok = build_decoder(*sb.static_key(), **kw)(
        *[jnp.asarray(a) for a in sb.args()])
    return np.asarray(out), bool(np.asarray(ok))


def _port(sb, **kw):
    ks, wire = sb.wire()
    args, _q = wire_unpack(torch.from_numpy(wire), ks, len(sb.comp_sig))
    out, ok, passes = decode_scan_chunked(
        args, ks, torch.as_tensor(sb.comp_of, dtype=torch.int32), **kw)
    return out, bool(ok), int(passes)


def _planes(sb, out):
    idx = [torch.as_tensor(i, dtype=torch.int64)
           for i in split_indices(sb.comp_sig)]
    return split_planes(out, sb.comp_sig, idx)


@pytest.mark.parametrize("name", list(CHUNKED_STREAMS))
def test_chunked_matches_reference_and_libjpeg(name):
    make, chunk_bits = CHUNKED_STREAMS[name]
    bufs = [bytes(b) for b in make()]
    sb = ScanBatch([jpeg_scan.parse_baseline(b) for b in bufs],
                   chunk_bits=chunk_bits)
    assert not sb.single_pass
    out, ok, passes = _port(sb)
    want, ok_want = _reference(sb)
    assert ok and ok_want
    assert 1 <= passes <= MAX_PASSES
    np.testing.assert_array_equal(out.numpy(), want)
    planes = _planes(sb, out)
    for j, b in enumerate(bufs):
        co = native.JpegCoefficients(b)
        for ci, c in enumerate(co.comps):
            np.testing.assert_array_equal(planes[ci][j].numpy(),
                                          c["coefs"].astype(np.int32))


def test_decode_scan_dispatches_chunked_batches():
    """decode_scan takes a chunked batch through the chunked decoder and
    returns its coefficients and ok."""
    buf = pil_jpeg(noisy(6, 48, 64), quality=85)
    sb = ScanBatch([jpeg_scan.parse_baseline(buf)], chunk_bits=512)
    ks, wire = sb.wire()
    args, _q = wire_unpack(torch.from_numpy(wire), ks, 3)
    comp_of = torch.as_tensor(sb.comp_of, dtype=torch.int32)
    out, ok = decode_scan(args, ks, comp_of)
    want, ok_want, _p = decode_scan_chunked(args, ks, comp_of)
    assert bool(ok) and bool(ok_want)
    assert torch.equal(out, want)


def test_numpy_oracle_agrees():
    """The repo's numpy prototype of the algorithm (ops/jpeg_scan_chunked)
    decodes the same coefficients at the same chunk size."""
    from picha_tpu.ops.jpeg_scan_chunked import decode_chunked

    buf = pil_jpeg(noisy(2, 48, 64), quality=85)
    info = jpeg_scan.parse_baseline(buf)
    want, _passes = decode_chunked(info, C=256)
    sb = ScanBatch([info], chunk_bits=256)
    out, ok, _p = _port(sb)
    assert ok
    for ci, plane in enumerate(_planes(sb, out)):
        np.testing.assert_array_equal(plane[0].numpy(), want[ci])


def test_no_restart_fixtures_pin():
    """tests/fixtures/port/src_nr_<i>.jpg carry no DRI, take ScanBatch's
    chunked mode, and hold the coefficients of src_<i>.jpg, so
    ref_<i>.jpg is their strict-host output too."""
    for i in range(N_FIXTURES):
        flat = (PORT_FIXTURES / f"src_nr_{i}.jpg").read_bytes()
        rst = (PORT_FIXTURES / f"src_{i}.jpg").read_bytes()
        info = jpeg_scan.parse_baseline(flat)
        assert not info.restart_interval and len(info.segments) == 1
        assert jpeg_scan.parse_baseline(rst).restart_interval == 8
        assert not ScanBatch([info]).single_pass
        got, want = native.JpegCoefficients(flat), native.JpegCoefficients(rst)
        for a, b in zip(got.comps, want.comps):
            np.testing.assert_array_equal(a["coefs"], b["coefs"])
