"""The raw420 and "tpu" encode backends on the CPU: the 4:2:0 pack (K31's
plain version, `ops/jpeg.py::yuv420_pack_plain`) against the reference
graph's `yuv420_out` branch (JAX on the CPU), the host JPEG writer's plain
version (`ops/jpeg_write.py`) byte for byte against libjpeg's
(`native.jpeg_encode_raw420`, `native.jpeg_coef_write`) at sizes that
leave dummy blocks and at qualities 50-100, the committed host-writer
fixtures, and `JpegBatchPipeline(encode_backend="raw420" | "tpu")`
against the reference's pipeline."""
import inspect
import pathlib
import sys

import numpy as np
import pytest
import torch

from torch_helpers import PORT_FIXTURES, smooth_rgb

from picha_tpu.native import lib as native
from picha_tpu.ops import jpeg_tpu
from picha_tpu.pipeline import JpegBatchPipeline as Ref
from picha_tpu.pipeline import jpeg_batch as ref_jb
from picha_tpu_torch.ops import jpeg as PJ
from picha_tpu_torch.ops import jpeg_write as JW
from picha_tpu_torch.pipeline import JpegBatchPipeline

SIZES = [(37, 45), (33, 31), (17, 100), (64, 48)]   # (h, w); the last aligned
QUALITIES = [50, 85, 95, 100]
W, H = 64, 48


def _planes(h, w, seed, noise=12.0):
    """Seeded padded 4:2:0 planes: waves plus noise."""
    rng = np.random.default_rng(seed)
    hp, wp = (h + 15) & ~15, (w + 15) & ~15
    out = []
    for ph, pw in ((hp, wp), (hp // 2, wp // 2), (hp // 2, wp // 2)):
        yy, xx = np.mgrid[0:ph, 0:pw]
        base = 128 + 80 * np.sin(xx / rng.uniform(2, 7) + yy / 4.0)
        out.append(np.clip(base + rng.normal(0, noise, (ph, pw)), 0,
                           255).astype(np.uint8))
    return out


def _coefs(sig, seed):
    """Seeded coefficient planes (a decaying spectrum of small ints)."""
    rng = np.random.default_rng(seed)
    scale = 80.0 / (1.0 + np.arange(64))
    return [np.round(rng.laplace(0, 1, (bh, bw, 64)) * scale).astype(np.int16)
            for bh, bw, _, _ in sig]


def _jpeg_of(img, **kw):
    return bytes(native.jpeg_encode(np.ascontiguousarray(img), 85, **kw))


# -- the 4:2:0 pack ------------------------------------------------------------

def _reference_pack(buf):
    """(the reference graph's yuv420_out planes, its decode-only image) of
    one JPEG: the staged decode-only graph with and without the branch."""
    ref = Ref(encode_quality=None, fused=False, upload="dense")
    sig, args = ref.stack_bucket(ref.entropy_decode([buf]))
    graph = [ref_jb._jit_batch_graph(sig, None, None, "cubic", 1.0, False,
                                     None, yuv420_out=yuv)
             for yuv in (True, False)]
    return tuple(np.asarray(g(*args)) for g in graph)


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("h,w", [(37, 45), (38, 44), (32, 48)])
def test_yuv420_pack_plain_matches_reference(h, w, channels):
    """Odd, even-but-unaligned and 16-aligned sizes, colour and grey:
    the branch's planes from the branch's own pixels, exactly."""
    img = smooth_rgb(h, w, h + w)[..., :channels]
    planes, pixels = _reference_pack(_jpeg_of(img))
    got = PJ.yuv420_pack_plain(torch.from_numpy(pixels.copy()))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), planes)
    hpad, wpad, ysz, csz = PJ.yuv420_sizes(h, w)
    assert planes.shape == (1, ysz + 2 * csz)
    if channels == 1:   # grey in, colour out: constant chroma
        assert (planes[:, ysz:] == 128).all()


def test_yuv420_pack_pads_before_the_downsample():
    """At an even width short of a 16-multiple the two orders differ:
    padding after the downsample (as the encoder front pads blocks) would
    repeat the last mixed chroma column; the pack pads the pixels
    first."""
    h, w = 16, 44
    img = torch.as_tensor(smooth_rgb(h, w, 3))[None]
    got = PJ.yuv420_pack_plain(img)
    _, wpad, ysz, csz = PJ.yuv420_sizes(h, w)
    cb = got[0, ysz:ysz + csz].view(h // 2, wpad // 2).to(torch.int32)
    _, cb_px, _ = PJ.rgb_to_ycbcr(img[0].to(torch.int32))
    after = PJ._edge_pad(PJ.box_downsample_2x2(cb_px), h // 2, wpad // 2)
    assert not torch.equal(cb, after)
    last = cb_px[:, -1]     # the padded columns' chroma: the last pixel's
    want = (last[0::2] + last[1::2] + last[0::2] + last[1::2] + 2) >> 2
    assert torch.equal(cb[:, -1], want)


@pytest.mark.parametrize("channels", [3, 1])
def test_yuv420_pack_float_is_the_packed_image(channels):
    """Float pixels (the fused and the resized staged path) are packed
    floor(clip(v + 0.5)) first, and the planes are then the reference
    functions' (rgb_to_ycbcr, edge pad, box_downsample_2x2) exactly."""
    import jax.numpy as jnp

    rng = np.random.default_rng(channels)
    f = rng.uniform(-20.0, 275.0, (2, 21, 35, channels)).astype(np.float32)
    got = PJ.yuv420_pack_plain(torch.as_tensor(f))
    img = np.floor(np.clip(f + 0.5, 0, 255)).astype(np.int32)
    assert torch.equal(got, PJ.yuv420_pack_plain(torch.as_tensor(
        img.astype(np.uint8))))
    hpad, wpad, _, _ = PJ.yuv420_sizes(21, 35)
    pad = ((0, 0), (0, hpad - 21), (0, wpad - 35))
    if channels == 1:
        y = np.pad(img[..., 0], pad, mode="edge")
        cb = cr = np.full((2, hpad // 2, wpad // 2), 128)
    else:
        y, cb, cr = (np.pad(np.asarray(p), pad, mode="edge")
                     for p in jpeg_tpu.rgb_to_ycbcr(jnp.asarray(img)))
        cb, cr = (np.asarray(jpeg_tpu.box_downsample_2x2(jnp.asarray(p)))
                  for p in (cb, cr))
    want = np.concatenate([p.astype(np.uint8).reshape(2, -1)
                           for p in (y, cb, cr)], 1)
    np.testing.assert_array_equal(got.numpy(), want)


# -- the host writer ---------------------------------------------------------

@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("h,w", SIZES)
def test_write_raw420_is_libjpeg(h, w, quality):
    """fdct_islow + quantize_libjpeg + the scan: libjpeg's raw-data
    write byte for byte (dummy blocks at the odd sizes; every table
    entry 1 at q = 100)."""
    y, cb, cr = _planes(h, w, h * w + quality)
    want = bytes(native.jpeg_encode_raw420(y, cb, cr, w, h, quality))
    assert JW.write_raw420(y, cb, cr, w, h, quality) == want
    # the coefficients are libjpeg's too
    co = native.JpegCoefficients(want)
    for got, c in zip(JW.raw420_coefficients(y, cb, cr, w, h, quality),
                      co.comps):
        np.testing.assert_array_equal(got, c["coefs"])


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("ncomp", [3, 1])
@pytest.mark.parametrize("h,w", [(37, 45), (17, 100)])
def test_write_coefficients_is_libjpeg(h, w, ncomp, quality):
    """write_coefficients: jpeg_coef_write's bytes for 1 and 3
    components (tables 0 / 1 / 1; at q = 100 the equal tables share slot
    0, as jpeg_coef_write shares them)."""
    sig = JW.resized_comp_sig(h, w, ncomp)
    planes = _coefs(sig, h + w + ncomp + quality)
    ql, qc = jpeg_tpu.quality_tables(quality)
    comps = [{"coefs": p, "qtable": ql if i == 0 else qc,
              "h_samp": s[2], "v_samp": s[3]}
             for i, (p, s) in enumerate(zip(planes, sig))]
    want = bytes(native.jpeg_coef_write(w, h, comps))
    assert JW.write_coefficients(planes, w, h, quality) == want


def test_write_raw420_has_no_budget():
    """Random-noise planes at q = 100 (the densest scans) encode: the
    buffer grows past its first guess."""
    rng = np.random.default_rng(5)
    y = rng.integers(0, 256, (256, 256), dtype=np.uint8)
    cb, cr = (rng.integers(0, 256, (128, 128), dtype=np.uint8)
              for _ in range(2))
    got = JW.write_raw420(y, cb, cr, 256, 256, 100)
    assert got == bytes(native.jpeg_encode_raw420(y, cb, cr, 256, 256, 100))
    assert len(got) > 32 * (256 * 256 * 6 // 4 // 64)


def test_writer_failure_names_and_dumps_what_it_was_given(tmp_path,
                                                          monkeypatch):
    """A failed host writer's error names each array's shape, range and
    digest and the code table's digest beside a fresh one; with
    $PICHA_JPEG_WRITER_DUMP set, the arrays and the table go into an
    .npz there, bit for bit."""
    y = np.arange(64, dtype=np.uint8).reshape(8, 8)
    q = np.full(64, 3, np.int32)
    monkeypatch.delenv("PICHA_JPEG_WRITER_DUMP", raising=False)
    err = JW._writer_failed(1, dict(y=y, qluma=q))
    assert str(err).startswith("host JPEG writer failed (1): y (8, 8) uint8 "
                               "[0, 63] ")
    table = str(err).split("code table ")[1]
    assert table[:16] == table[23:39] and "dumped" not in str(err)
    monkeypatch.setenv("PICHA_JPEG_WRITER_DUMP", str(tmp_path / "dump"))
    err = JW._writer_failed(1, dict(y=y, qluma=q))
    (path,) = (tmp_path / "dump").iterdir()
    assert str(path) in str(err)
    with np.load(path) as z:
        assert np.array_equal(z["y"], y) and np.array_equal(z["qluma"], q)
        assert np.array_equal(z["code_table"], JW._code_table())


def test_libjpeg_header_differs_from_the_device_header_in_order_only():
    """libjpeg's header orders the Huffman tables DC0, AC0, DC1, AC1 (and
    a grey one has no chroma tables); the device encode's header (the
    reference's jpeg_header) writes DC0, DC1, AC0, AC1: same length for
    colour, the same markers otherwise."""
    from picha_tpu_torch.ops.jpeg_huffman import jpeg_header

    sig = JW.resized_comp_sig(37, 45, 3)
    ql, qc = jpeg_tpu.quality_tables(85)
    lib = JW.libjpeg_header(45, 37, sig, (ql, qc, qc))
    dev = jpeg_header(45, 37, sig, 85)
    assert len(lib) == len(dev) and lib != dev
    assert sorted(lib) == sorted(dev)


def _fixture_cases():
    sys.path.insert(0, str(PORT_FIXTURES))
    import make_fixtures

    return make_fixtures


@pytest.mark.parametrize("name", ["planes_q50", "planes_q95", "coef3_q50",
                                  "coef1_q95"])
def test_host_writer_fixtures_rederive(name):
    """tests/fixtures/port/raw420_* (the card's anchor for the C++
    writer): the committed inputs are make_fixtures' seeded ones, the
    committed bytes libjpeg's of them, and the numpy writer gives the
    same bytes."""
    mf = _fixture_cases()
    kind, (h, w), q = mf.HOST_WRITER_CASES[name]
    made = mf.host_writer_inputs()[name]
    with np.load(PORT_FIXTURES / "raw420_inputs.npz") as z:
        stored = {k.split(".", 1)[1]: z[k] for k in z.files
                  if k.startswith(name + ".")}
    assert sorted(stored) == sorted(made)
    for k in made:
        np.testing.assert_array_equal(stored[k], made[k])
    want = (PORT_FIXTURES / f"raw420_{name}.jpg").read_bytes()
    assert mf.host_writer_jpeg(name, made) == want
    if kind == "raw420":
        got = JW.write_raw420(made["y"], made["cb"], made["cr"], w, h, q)
    else:
        got = JW.write_coefficients([made[f"c{i}"] for i in range(
            len(made))], w, h, q)
    assert got == want


def test_host_writer_fixtures_are_small():
    total = sum(p.stat().st_size for p in PORT_FIXTURES.glob("raw420_*"))
    assert total < 512 * 1024


# -- the pipelines -------------------------------------------------------------

def _corpus(n=4, h=96, w=128, grey=False):
    imgs = [smooth_rgb(h, w, i) for i in range(n)]
    if grey:
        imgs = [np.ascontiguousarray(a[..., :1]) for a in imgs]
    return [_jpeg_of(a, restart=2 + i % 3) for i, a in enumerate(imgs)]


def _lsb(a, b, w=W, h=H):
    da = native.jpeg_decode(bytes(a), 3, w, h).astype(np.int32)
    db = native.jpeg_decode(bytes(b), 3, w, h).astype(np.int32)
    return float(np.abs(da - db).mean())


@pytest.mark.parametrize("upload", ["scan", "dense"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("backend", ["raw420", "tpu"])
def test_backends_match_reference(backend, fused, upload):
    """Resized to 64x48: the reference's bytes, or within 0.05 LSB of
    them (the fused matmuls' f32 order), and within 1 LSB of the strict
    host path; decode-only (width=None): the reference's bytes."""
    bufs = _corpus()
    kw = dict(encode_quality=85, encode_backend=backend, fused=fused,
              upload=upload)
    port = JpegBatchPipeline(width=W, height=H, device="cpu", **kw)
    got = port(bufs)
    want = Ref(width=W, height=H, **kw)(bufs)
    strict = Ref(width=W, height=H, encode_quality=85,
                 encode_backend="host").host_encode_batch(bufs)
    assert (port.scan_fallbacks, port.overflow_fallbacks) == (0, 0)
    for g, w, s in zip(got, want, strict):
        assert bytes(g) == bytes(w) or _lsb(g, w) <= 0.05
        assert _lsb(g, s) <= 1.0
    got = JpegBatchPipeline(device="cpu", **kw)(bufs)
    want = Ref(**kw)(bufs)
    assert [bytes(g) for g in got] == [bytes(w) for w in want]


@pytest.mark.parametrize("backend", ["raw420", "tpu"])
def test_grey_corpus_matches_reference(backend):
    """Grey sources: raw420 writes a 3-component JPEG (constant chroma),
    "tpu" a 1-component one, both the reference's bytes."""
    bufs = _corpus(2, grey=True)
    kw = dict(encode_quality=85, encode_backend=backend, fused=False,
              upload="scan")
    got = JpegBatchPipeline(device="cpu", **kw)(bufs)
    want = Ref(**kw)(bufs)
    assert [bytes(g) for g in got] == [bytes(w) for w in want]
    ncomp = len(native.JpegCoefficients(bytes(got[0])).comps)
    assert ncomp == (3 if backend == "raw420" else 1)


def test_raw420_noise_q100_batch_encodes():
    """A batch of random-noise 256^2 images at q = 100 through raw420:
    no budget, the reference's bytes."""
    rng = np.random.default_rng(9)
    bufs = [_jpeg_of(rng.integers(0, 256, (256, 256, 3), dtype=np.uint8))
            for _ in range(2)]
    kw = dict(encode_quality=100, encode_backend="raw420", upload="scan")
    got = JpegBatchPipeline(device="cpu", **kw)(bufs)
    assert [bytes(g) for g in got] == [bytes(w) for w in Ref(**kw)(bufs)]


def test_tpu_is_device_with_libjpeg_header():
    """encode_backend="tpu" and "device" code the same K2 coefficients:
    the same scan bytes, behind libjpeg's header and the device encode's
    header respectively."""
    bufs = _corpus(2)
    kw = dict(width=W, height=H, encode_quality=85, fused=True,
              upload="scan", device="cpu")
    tpu = JpegBatchPipeline(encode_backend="tpu", **kw)(bufs)
    dev = JpegBatchPipeline(encode_backend="device", **kw)(bufs)
    ql, qc = jpeg_tpu.quality_tables(85)
    head = JW.libjpeg_header(W, H, JW.resized_comp_sig(H, W, 3), (ql, qc, qc))
    from picha_tpu_torch.ops.jpeg_huffman import jpeg_header

    dhead = jpeg_header(W, H, JW.resized_comp_sig(H, W, 3), 85)
    for t, d in zip(tpu, dev):
        assert t.startswith(head) and d.startswith(dhead)
        assert t[len(head):] == d[len(dhead):]


_REF_PARAMS = inspect.signature(Ref).parameters
_PORT_PARAMS = inspect.signature(JpegBatchPipeline).parameters
_SHARED = sorted(set(_REF_PARAMS) & set(_PORT_PARAMS))


def test_shared_parameters_cover_the_contract():
    assert {"encode_backend", "upload", "fused", "encode_quality",
            "normalize", "num_threads", "scan_byte_cap"} <= set(_SHARED)


@pytest.mark.parametrize("name", _SHARED)
def test_defaults_are_the_reference_defaults(name):
    """Every parameter both JpegBatchPipelines take has the reference's
    default (encode_backend "tpu", upload "dense", fused False, ...)."""
    assert _PORT_PARAMS[name].default == _REF_PARAMS[name].default


def test_every_public_method_of_the_reference_exists():
    """The port's class has every public method of the reference's."""
    public = {m for m in dir(Ref) if not m.startswith("_")
              and callable(getattr(Ref, m))}
    assert public <= {m for m in dir(JpegBatchPipeline)
                      if callable(getattr(JpegBatchPipeline, m))}


_NOT_PORTED = {"host_fast_scale": True, "host_raw": True, "host_draft": True,
               "fast_guard": 0.5}


@pytest.mark.parametrize("name", sorted(_NOT_PORTED))
def test_host_options_raise_naming_item_5(name):
    """The reference's libjpeg host options are queue 1 item 5: set, they
    raise NotImplementedError naming it (left at their defaults, they do
    not)."""
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        JpegBatchPipeline(device="cpu", **{name: _NOT_PORTED[name]})
    JpegBatchPipeline(device="cpu", **{name: _REF_PARAMS[name].default})


@pytest.mark.parametrize("name,args", [
    ("host_encode_batch", ([b""],)), ("host_encode_batch_staged",
                                      ([b""], None, 85)),
    ("stream_hybrid", ([[b""]],)), ("stream_host", ([[b""]],)),
    ("stream", ([[b""]],))])
def test_host_and_stream_methods_raise_naming_item_5(name, args):
    pipe = JpegBatchPipeline(width=W, height=H, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        getattr(pipe, name)(*args)


def test_default_pipeline_is_the_reference_default():
    """No backend or upload given: the same path as the reference's (the
    host decode, dense planes, staged pixels, K2, the host writer) and
    its bytes."""
    bufs = _corpus(2)
    got = JpegBatchPipeline(width=W, height=H, encode_quality=85,
                            device="cpu")(bufs)
    want = Ref(width=W, height=H, encode_quality=85)(bufs)
    assert [bytes(g) for g in got] == [bytes(w) for w in want]


def test_unknown_encode_backend_raises():
    with pytest.raises(ValueError):
        JpegBatchPipeline(encode_backend="gpu", device="cpu")


def test_writer_rejects_a_wrong_grid():
    sig = JW.resized_comp_sig(37, 45, 3)
    planes = _coefs(sig, 1)
    with pytest.raises(ValueError):
        JW.write_coefficients(planes, 60, 37, 85)
    with pytest.raises(ValueError):
        JW.write_raw420(*_planes(37, 45, 1)[:2], _planes(37, 45, 1)[0],
                        45, 37, 85)


if __name__ == "__main__":
    sys.exit(pytest.main([str(pathlib.Path(__file__)), "-q"]))
