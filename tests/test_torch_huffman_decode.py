"""Port Huffman decoder (picha_tpu_torch/ops/jpeg_huffman_decode.py,
plain torch path on the CPU) against the JAX reference decoder
`build_decoder_core` on the CPU and against libjpeg's coefficients:
restart single-pass batches, the dispatch of batches without restart
markers, and the chunked decoder on faulty streams and exhausted
budgets (valid chunked streams: test_torch_huffman_decode_chunked.py).
Entropy decode is lossless: every comparison is exact."""
import numpy as np
import pytest
import torch

from torch_helpers import (CHUNKED_FAULTS, chunked_fault_batch,
                           scan_batch_inputs, smooth_rgb)

from picha_tpu.native import lib as native
from picha_tpu.ops import jpeg_scan
from picha_tpu.ops.jpeg_huffman_decode_tpu import (ScanBatch, build_decoder,
                                                   split_indices)
from picha_tpu_torch.ops.jpeg_huffman_decode import (decode_scan,
                                                     scan_wire,
                                                     split_planes,
                                                     wire_unpack)


def _reference(sb, **kw):
    import jax.numpy as jnp

    out, ok = build_decoder(*sb.static_key(), **kw)(
        *[jnp.asarray(a) for a in sb.args()])
    return np.asarray(out), bool(np.asarray(ok))


def _port(bufs_or_infos):
    sb, ks, args, _q, comp_of = scan_batch_inputs(bufs_or_infos)
    out, ok = decode_scan(args, ks, comp_of)
    return sb, ks, out, bool(ok)


def _encode(h, w, channels, restart, seed, subsample=True):
    img = smooth_rgb(h, w, seed)
    if channels == 1:
        img = np.ascontiguousarray(img[..., :1])
    return bytes(native.jpeg_encode(img, 85, restart=restart,
                                    subsample=subsample))


@pytest.mark.parametrize("h,w,channels,subsample,restarts", [
    (64, 96, 3, True, (2, 5, 8)),       # 4:2:0, B=6
    (120, 160, 3, False, (3, 4)),       # 4:4:4, B=3
    (120, 160, 1, True, (2, 8)),        # grey, B=1
])
def test_decode_matches_reference_and_libjpeg(h, w, channels, subsample,
                                              restarts):
    bufs = [_encode(h, w, channels, r, seed, subsample)
            for seed, r in enumerate(restarts)]
    sb, _ks, out, ok = _port(bufs)
    assert sb.single_pass and ok
    want, ok_want = _reference(sb)
    assert ok_want
    np.testing.assert_array_equal(out.numpy(), want)
    idx = [torch.as_tensor(i, dtype=torch.int64)
           for i in split_indices(sb.comp_sig)]
    planes = split_planes(out, sb.comp_sig, idx)
    for j, b in enumerate(bufs):
        co = native.JpegCoefficients(b)
        for ci, c in enumerate(co.comps):
            np.testing.assert_array_equal(planes[ci][j].numpy(),
                                          c["coefs"].astype(np.int32))


def test_step_budget_exhaustion_flags_like_reference():
    """A lane that runs out of its `steps` symbol budget clears `ok` on
    exactly the streams the reference flags, and the partial decode
    (DC carried through the blocks never reached) matches too."""
    bufs = [_encode(64, 96, 3, 8, s) for s in range(2)]
    infos = [jpeg_scan.parse_baseline(b) for b in bufs]
    sb = ScanBatch(infos)
    sb.steps = 64                       # far below a segment's symbols
    want, ok_want = _reference(sb)
    ks, wire = sb.wire()
    args, _q = wire_unpack(torch.from_numpy(wire), ks, 3)
    out, ok = decode_scan(args, ks, torch.as_tensor(sb.comp_of))
    assert not ok_want and not bool(ok)
    np.testing.assert_array_equal(out.numpy(), want)


def test_chopped_segments_match_reference():
    """Segments cut short (bits end before the blocks do): same `ok`
    and the same coefficients as the reference."""
    info = jpeg_scan.parse_baseline(_encode(64, 96, 3, 4, 7))
    for k in range(0, len(info.segments), 3):
        info.segments[k] = info.segments[k][: len(info.segments[k]) // 2]
    sb, _ks, out, ok = _port([info])
    want, ok_want = _reference(sb)
    assert ok == ok_want
    np.testing.assert_array_equal(out.numpy(), want)


def test_wire_unpack_matches_scanbatch_args():
    bufs = [_encode(64, 96, 3, r, r) for r in (2, 3)]
    sb, _ks, args, qtabs, _c = scan_batch_inputs(bufs)
    for name, got, want in zip(args._fields, args, sb.args()):
        got = got.numpy()
        if name == "words":   # the wire pads words with 1-bits
            got = got.view(np.uint32)
            assert (got[want.size:] == 0xFFFFFFFF).all()
            got = got[: want.size]
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
    for q, want in zip(qtabs, sb.qtables):
        np.testing.assert_array_equal(q.numpy(), want.astype(np.int32))


def test_no_restart_batch_raises_not_implemented():
    """A batch without restart markers (once refused) now decodes
    through the chunked decoder: ok, and libjpeg's coefficients."""
    buf = _encode(64, 96, 3, 0, 1)
    info = jpeg_scan.parse_baseline(buf)
    sb = ScanBatch([info])
    assert not sb.single_pass
    ks, wire = sb.wire()
    args, _q = wire_unpack(torch.from_numpy(wire), ks, 3)
    out, ok = decode_scan(args, ks, torch.as_tensor(sb.comp_of))
    assert bool(ok)
    idx = [torch.as_tensor(i, dtype=torch.int64)
           for i in split_indices(sb.comp_sig)]
    planes = split_planes(out, sb.comp_sig, idx)
    co = native.JpegCoefficients(buf)
    for ci, c in enumerate(co.comps):
        np.testing.assert_array_equal(planes[ci][0].numpy(),
                                      c["coefs"].astype(np.int32))


def test_scan_wire_is_scanbatch_wire():
    """The port's host entry point gives ScanBatch's own key and wire,
    for a restart batch and for a batch without restart markers."""
    for restarts in ((2, 3), (0, 0)):
        infos = [jpeg_scan.parse_baseline(_encode(64, 96, 3, r, s))
                 for s, r in enumerate(restarts)]
        ks, wire = scan_wire(infos)
        ks_want, wire_want = ScanBatch(infos).wire()
        assert ks == ks_want and ks[9] == (restarts[0] > 0)
        np.testing.assert_array_equal(wire, wire_want)


# -- chunked decode of malformed streams and exhausted budgets ----------------

@pytest.mark.parametrize("case", CHUNKED_FAULTS)
def test_chunked_faults_flag_like_reference(case):
    """`ok` equals the reference's on every faulty stream and budget;
    coefficients equal wherever ok is true."""
    from picha_tpu_torch.ops.jpeg_huffman_decode import decode_scan_chunked

    sb, kw = chunked_fault_batch(case)
    assert sb is not None and not sb.single_pass
    ks, wire = sb.wire()
    args, _q = wire_unpack(torch.from_numpy(wire), ks, 3)
    out, ok, passes = decode_scan_chunked(
        args, ks, torch.as_tensor(sb.comp_of, dtype=torch.int32), **kw)
    want, ok_want = _reference(sb, **kw)
    assert bool(ok) == ok_want
    if case in ("max_passes_1", "tiny_steps"):
        assert not ok_want
    if case == "max_passes_1":
        assert int(passes) == 1
    if ok_want:
        np.testing.assert_array_equal(out.numpy(), want)
