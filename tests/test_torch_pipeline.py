"""The port's slices, JpegBatchPipeline(fused=True|False, upload="scan",
encode_backend="device") on device="cpu", against picha_tpu's same
configuration (JAX on the CPU) and the strict host path (libjpeg decode
-> native resize -> libjpeg encode), the decode-only and normalized
outputs of both pixel paths, plus the content fallbacks the reference
keeps, each through the port's Pillow host codec: decoder flag, capacity
gate or a file the device decoder does not take -> host pixel decode ->
the device pixel stages; encode overflow -> retry at twice the cap ->
the reference's raw420 fallback (upload gap4, the host writer)."""
import numpy as np
import pytest
import torch

from torch_helpers import smooth_rgb

from picha_tpu.native import lib as native
from picha_tpu_torch.codecs import jpeg_host
from picha_tpu_torch.pipeline import JpegBatchPipeline
from picha_tpu_torch.pipeline import jpeg_batch as port_jb

W, H = 64, 48
KW = dict(width=W, height=H, encode_quality=85, encode_backend="device",
          fused=True, upload="scan")
KW_STAGED = {**KW, "fused": False}


def _corpus(n=4, h=96, w=128, restart=2):
    return [bytes(native.jpeg_encode(smooth_rgb(h, w, i), 85,
                                     restart=restart + i % 3))
            for i in range(n)]


def _lsb(a, b, w=W, h=H):
    da = native.jpeg_decode(bytes(a), 3, w, h).astype(np.int32)
    db = native.jpeg_decode(bytes(b), 3, w, h).astype(np.int32)
    return float(np.abs(da - db).mean())


def _strict(bufs, w=W, h=H):
    from picha_tpu.pipeline import JpegBatchPipeline as Ref

    return Ref(width=w, height=h, encode_quality=85,
               encode_backend="host").host_encode_batch(bufs)


def _counters(p):
    return (p.scan_fallbacks, p.overflow_retries, p.overflow_fallbacks)


def test_slice_matches_reference_and_strict_host():
    from picha_tpu.pipeline import JpegBatchPipeline as Ref

    bufs = _corpus()
    port = JpegBatchPipeline(device="cpu", **KW)
    got = port(bufs)
    want = Ref(**KW)(bufs)
    assert _counters(port) == (0, 0, 0)
    for g, w, s in zip(got, want, _strict(bufs)):
        assert bytes(g) == bytes(w) or _lsb(g, w) <= 0.05
        assert _lsb(g, s) <= 1.0


def test_decode_only_matches_reference():
    from picha_tpu.pipeline import JpegBatchPipeline as Ref

    bufs = _corpus(2)
    got = JpegBatchPipeline(width=W, height=H, fused=True, upload="scan",
                            device="cpu")(bufs)
    want = np.asarray(Ref(width=W, height=H, fused=True,
                          upload="scan")(bufs))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    d = np.abs(got.numpy().astype(np.int32) - want)
    assert d.max() <= 1 and d.mean() <= 0.01


def test_flagged_decode_falls_back_to_host_decode(monkeypatch):
    """A batch whose lanes run out of the decoder's symbol budget (here
    forced by a tiny budget) is redone through the host pixel decode and
    the device pixel stages: within 1 LSB (mean) of the device path,
    counted once."""
    bufs = _corpus(2)
    want = JpegBatchPipeline(device="cpu", **KW)(bufs)

    from picha_tpu_torch.ops import jpeg_huffman_decode as port_dec

    class TinyBudget(port_dec.ScanBatch):
        def __init__(self, infos):
            super().__init__(infos)
            self.steps = 64

    monkeypatch.setattr(port_dec, "ScanBatch", TinyBudget)
    p = JpegBatchPipeline(device="cpu", **KW)
    got = p(bufs)
    assert _counters(p) == (1, 0, 0)
    assert max(_lsb(g, w) for g, w in zip(got, want)) <= 1.0


def test_no_restart_batch_decodes_on_device():
    """A batch without restart markers (once sent to host libjpeg) now
    decodes on the device through the chunked decoder: no fallback,
    picha_tpu's output for the same configuration, and <= 1 LSB from
    the strict host path."""
    from picha_tpu.pipeline import JpegBatchPipeline as Ref

    bufs = _corpus(2, restart=0)[:1] + [bytes(native.jpeg_encode(
        smooth_rgb(96, 128, 5), 85))]
    p = JpegBatchPipeline(device="cpu", **KW)
    got = p(bufs)
    assert _counters(p) == (0, 0, 0)
    want = Ref(**KW)(bufs)
    for g, w, s in zip(got, want, _strict(bufs)):
        # re-encoded coefficients: off by one only at f32 summation-
        # order .5 ties of the quantiser (as K2's own tests bound them)
        off, total = 0, 0
        for a, b in zip(native.JpegCoefficients(bytes(g)).comps,
                        native.JpegCoefficients(bytes(w)).comps):
            d = np.abs(a["coefs"].astype(np.int32) - b["coefs"])
            assert d.max() <= 1
            off, total = off + int((d > 0).sum()), total + d.size
        assert off <= 1e-3 * total
        assert _lsb(g, s) <= 1.0


def test_unconverged_chunked_batch_falls_back_to_host_decode(monkeypatch):
    """A chunked batch whose Jacobi passes cannot reach the fixpoint
    (here a pass budget of one) is redone through the host pixel decode
    and the device pixel stages: within 1 LSB (mean) of the device
    path, counted once."""
    bufs = _corpus(2, restart=0)
    want = JpegBatchPipeline(device="cpu", **KW)(bufs)
    decode = port_jb.decode_scan
    monkeypatch.setattr(port_jb, "decode_scan",
                        lambda *a: decode(*a, max_passes=1))
    p = JpegBatchPipeline(device="cpu", **KW)
    got = p(bufs)
    assert _counters(p) == (1, 0, 0)
    assert max(_lsb(g, w) for g, w in zip(got, want)) <= 1.0


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("case", ["capacity", "progressive"])
def test_host_fallbacks_match_device_path(monkeypatch, case, fused):
    """A batch past ScanBatch's capacity gate (forced: scan_wire raises
    ValueError) and a batch of progressive JPEGs take the host pixel
    decode, then the device pixel stages (K8 resize, K2, K3): within
    1 LSB (mean) of the device path on the same coefficients, counted
    once."""
    from torch_helpers import pil_jpeg

    bufs = _corpus(2)
    kw = {**KW, "fused": fused}
    if case == "progressive":
        # the same pixels and tables, so the same coefficients: the
        # baseline encode takes the device path, the progressive one
        # (which parse_baseline refuses) the host decode
        imgs = [smooth_rgb(96, 128, i) for i in range(2)]
        want = JpegBatchPipeline(device="cpu", **kw)(
            [pil_jpeg(a, quality=85) for a in imgs])
        bufs = [pil_jpeg(a, quality=85, progressive=True) for a in imgs]
    else:
        want = JpegBatchPipeline(device="cpu", **kw)(bufs)

        def full(_infos):
            raise ValueError("batch past the capacity gate")

        monkeypatch.setattr(port_jb, "scan_wire", full)
    p = JpegBatchPipeline(device="cpu", **kw)
    got = p(bufs)
    assert _counters(p) == (1, 0, 0)
    assert len(got) == len(bufs)
    assert max(_lsb(g, w) for g, w in zip(got, want)) <= 1.0


def _small_caps(pipe, second):
    """Patch the quality-derived cap: 256 bytes, then `second` after the
    boost."""
    pipe._scan_cap_for = lambda sig: 256 if pipe._cap_boost == 1 else second


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("second_fits", [True, False])
def test_encode_overflow_retries_then_host_encode(second_fits, fused):
    """Overflow of the quality-derived cap: one retry at twice the cap;
    if that overflows too, the reference's fallback: the batch redone
    through a clone with encode_backend="raw420" and upload "gap4" (the
    scans decoded on the host, the device pixels, the host writer). The
    same `_scan_cap_for` patched on both pipelines: the reference's
    bytes, or within 0.05 LSB of them (the fused matmuls' f32 order), and
    the port's own raw420 gap4 path's bytes exactly."""
    from picha_tpu.pipeline import JpegBatchPipeline as Ref

    bufs = _corpus(2)
    kw = {**KW, "fused": fused}
    small = 256 if not second_fits else 1 << 16
    p, ref = JpegBatchPipeline(device="cpu", **kw), Ref(**kw)
    _small_caps(p, small)
    _small_caps(ref, small)
    got, want = p(bufs), ref(bufs)
    for g, w in zip(got, want):
        assert bytes(g) == bytes(w) or _lsb(g, w) <= 0.05
    if second_fits:
        assert _counters(p) == (0, 1, 0)
        assert [bytes(g) for g in got] == [
            bytes(w) for w in JpegBatchPipeline(device="cpu", **kw)(bufs)]
    else:
        assert _counters(p) == (0, 1, 1)
        clone = p._overflow_clone
        assert (clone._encode_backend, clone._upload) == ("raw420", "gap4")
        raw = JpegBatchPipeline(device="cpu", **{
            **kw, "encode_backend": "raw420", "upload": "gap4"})(bufs)
        assert [bytes(g) for g in got] == [bytes(r) for r in raw]


def test_mixed_batch_keeps_input_order():
    a = _corpus(2)
    b = [bytes(native.jpeg_encode(smooth_rgb(80, 112, 9), 85, restart=3))]
    mixed = [a[0], b[0], a[1]]
    p = JpegBatchPipeline(device="cpu", **KW)
    got = p(mixed)
    same_a = JpegBatchPipeline(device="cpu", **KW)(a)
    same_b = JpegBatchPipeline(device="cpu", **KW)(b)
    assert [bytes(x) for x in got] == [bytes(same_a[0]), bytes(same_b[0]),
                                       bytes(same_a[1])]


def test_batching_helpers_match_reference():
    from picha_tpu.ops.jpeg_scan import parse_baseline as ref_parse
    from picha_tpu.pipeline import jpeg_batch as ref_jb
    from picha_tpu_torch.ops.jpeg_scan import parse_baseline

    bufs = _corpus(3) + [bytes(native.jpeg_encode(smooth_rgb(40, 56, 1),
                                                  85))]
    infos = [parse_baseline(b) for b in bufs]
    ref_infos = [ref_parse(b) for b in bufs]
    assert [port_jb.signature(x) for x in infos] == \
        [ref_jb.signature(x) for x in ref_infos]
    got = port_jb.bucket_by_signature(infos)
    want = ref_jb.bucket_by_signature(ref_infos)
    assert [(s, i) for s, i, _ in got] == [(s, i) for s, i, _ in want]
    for n in (1, 8, 9):
        assert port_jb.pad_group(list(range(n))) == \
            ref_jb.pad_group(list(range(n)))
    for h, w, c in ((544, 960, 3), (31, 33, 1), (13, 17, 3)):
        assert port_jb.resized_comp_sig(h, w, c) == \
            ref_jb._resized_comp_sig(h, w, c)


@pytest.mark.parametrize("upload", ["gap4", "dense"])
def test_host_coefficient_uploads_run(upload):
    """The uploads that once raised here now run (host decode, the wire,
    its restore): the scan upload's bytes on the same files, no fallback
    (tests/test_torch_uploads.py holds every upload to the reference)."""
    bufs = _corpus(2)
    want = JpegBatchPipeline(device="cpu", **KW)(bufs)
    port = JpegBatchPipeline(device="cpu", **{**KW, "upload": upload})
    got = port(bufs)
    assert _counters(port) == (0, 0, 0)
    assert [bytes(g) for g in got] == [bytes(w) for w in want]


@pytest.mark.parametrize("restart", [2, 0])
def test_staged_slice_matches_reference_and_strict_host(restart):
    """fused=False: staged decode (K6, K7 twins) -> windowed resize (K8
    twin) -> K2 -> K3, with and without restart markers, against
    picha_tpu's staged configuration and the strict host path."""
    from picha_tpu.pipeline import JpegBatchPipeline as Ref

    bufs = _corpus(restart=restart)
    port = JpegBatchPipeline(device="cpu", **KW_STAGED)
    got = port(bufs)
    want = Ref(**KW_STAGED)(bufs)
    assert _counters(port) == (0, 0, 0)
    for g, w, s in zip(got, want, _strict(bufs)):
        assert bytes(g) == bytes(w) or _lsb(g, w) <= 0.05
        assert _lsb(g, s) <= 1.0


@pytest.mark.parametrize("resize", [True, False])
def test_staged_decode_only_matches_reference(resize):
    """encode_quality=None, fused=False: uint8 images, with a resize
    target (pack of the resized floats) and without one (the staged
    decode's own bytes)."""
    from picha_tpu.pipeline import JpegBatchPipeline as Ref

    bufs = _corpus(2)
    kw = dict(width=W, height=H) if resize else {}
    got = JpegBatchPipeline(fused=False, upload="scan", device="cpu",
                            **kw)(bufs)
    want = np.asarray(Ref(fused=False, upload="scan", **kw)(bufs))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    d = np.abs(got.numpy().astype(np.int32) - want)
    assert d.max() <= 1 and d.mean() <= 0.01
    if not resize:   # the staged decode is libjpeg's within 1 LSB
        host = np.stack([native.jpeg_decode(b, 3, 128, 96) for b in bufs])
        assert np.abs(got.numpy().astype(np.int32) - host).mean() <= 0.1


@pytest.mark.parametrize("fused,resize", [(False, True), (False, False),
                                          (True, True)])
def test_normalize_matches_reference(fused, resize):
    """normalize=True: float32 images on the 0-1 scale. Staged within
    1e-6 of the reference (resize sums in another order); fused within
    the fused matmuls' own 2e-3 on the 0-255 scale."""
    from picha_tpu.pipeline import JpegBatchPipeline as Ref

    bufs = _corpus(2)
    kw = dict(width=W, height=H) if resize else {}
    got = JpegBatchPipeline(fused=fused, normalize=True, upload="scan",
                            device="cpu", **kw)(bufs)
    want = np.asarray(Ref(fused=fused, normalize=True, upload="scan",
                          **kw)(bufs))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    tol = 2e-3 / 255 if fused else 1e-6
    assert float(np.abs(got.numpy() - want).max()) <= tol
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


@pytest.mark.parametrize("fused", [False, True])
def test_normalize_takes_no_encode_quality(fused):
    """normalize=True with encode_quality set: the normalized float32
    images, which is what the reference's batch graph returns for the
    pair (its pixel stages return before the encode). Held to that
    graph's output on the same bytes."""
    from picha_tpu.pipeline import JpegBatchPipeline as Ref

    bufs = _corpus(2)
    kw = dict(width=W, height=H, normalize=True, encode_quality=85,
              fused=fused)
    got = JpegBatchPipeline(upload="scan", device="cpu", **kw)(bufs)
    ref = Ref(upload="scan", **kw)
    sig, ks, args = ref.stack_bucket(ref.entropy_decode(bufs))
    want, ok = ref.run_bucket(sig, args, scan_ks=ks)
    assert bool(np.asarray(ok))
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    tol = 2e-3 / 255 if fused else 1e-6
    assert float(np.abs(got.numpy() - want).max()) <= tol


def test_staged_overflow_host_encodes_staged_pixels():
    """A staged batch that overflows twice is redone from the staged
    path's own pixels, not the fused path's: the reference's fallback
    bytes (its clone is staged too), which the fused raw420 path does not
    give."""
    from picha_tpu.pipeline import JpegBatchPipeline as Ref

    bufs = _corpus(2)
    p, ref = JpegBatchPipeline(device="cpu", **KW_STAGED), Ref(**KW_STAGED)
    _small_caps(p, 256)
    _small_caps(ref, 256)
    got = p(bufs)
    assert _counters(p) == (0, 1, 1)
    assert [bytes(g) for g in got] == [bytes(w) for w in ref(bufs)]
    raw = {fused: JpegBatchPipeline(**{
        **KW, "fused": fused, "encode_backend": "raw420", "upload": "gap4"},
        device="cpu")(bufs) for fused in (False, True)}
    assert [bytes(g) for g in got] == [bytes(r) for r in raw[False]]
    assert [bytes(g) for g in got] != [bytes(r) for r in raw[True]]


def test_port_fixtures_are_the_strict_host_output():
    """tests/fixtures/port/ref_<i>.jpg is what the strict host path makes
    of src_<i>.jpg (the card-side parity anchor of chip_smoke.py)."""
    from torch_helpers import N_FIXTURES, port_corpus, port_refs

    srcs, refs = port_corpus(N_FIXTURES), port_refs(N_FIXTURES)
    assert [bytes(r) for r in _strict(srcs, 960, 544)] == refs


@pytest.mark.parametrize("quality", [50, 85, 95])
@pytest.mark.parametrize("channels", [3, 1])
def test_host_encode_is_native_encode(quality, channels):
    """jpeg_host.encode (Pillow's libjpeg) writes the same bytes as
    picha_tpu/native's encoder: baseline, 4:2:0, libjpeg quality
    scaling."""
    img = smooth_rgb(61, 90, quality)
    if channels == 1:
        img = np.ascontiguousarray(img[..., :1])
    assert jpeg_host.encode(img, quality) == bytes(
        native.jpeg_encode(img, quality))


@pytest.mark.parametrize("kind", ["420", "444", "grey", "cmyk"])
def test_host_decode_is_native_decode(kind):
    """jpeg_host.decode_rgb against picha_tpu/native's decode of the same
    bytes (CMYK folded as the reference folds it)."""
    from conftest import fixture_bytes

    img = smooth_rgb(61, 90, 7)
    if kind == "cmyk":
        buf = fixture_bytes("test2cmyk.jpg")
    elif kind == "grey":
        buf = native.jpeg_encode(np.ascontiguousarray(img[..., :1]), 85)
    else:
        buf = native.jpeg_encode(img, 85, subsample=(kind == "420"))
    got = jpeg_host.decode_rgb(buf)
    want = native.jpeg_decode(bytes(buf), got.shape[2], got.shape[1],
                              got.shape[0])
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want.reshape(got.shape))
