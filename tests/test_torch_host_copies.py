"""The port's own copies of the reference's host code (header parse,
scan wire, decode tables, resize weights, fused folds, quantisation
tables, scan layout, pixel formats, luma weights, the Image model, the
TIFF orientation map, PNG chunks, the PNG decode's host stage and pixel
rules, the TIFF IFD parse and host stage, the EXIF orientation, the
parallel deflate, the numpy entropy decoder, the coefficient set and the
geometric bucketing of the host-coefficient uploads) against their
originals in picha_tpu on the same inputs, and the rule that the port
imports nothing of picha_tpu or jax. The uploads' wire packers, whose
originals are native code, are pinned through the reference's own JAX
restores in tests/test_torch_uploads.py.
Where an original calls picha_tpu/native (CRC-32, inflate, unfilter),
the test hands it the standard library's zlib and the port's plain
unfilter instead, so no test here builds the native library."""
import os
import pathlib
import re
import struct
import subprocess
import sys
import types
import zlib

import numpy as np
import pytest

from torch_helpers import PORT_FIXTURES, noisy, pil_jpeg

from picha_tpu.ops import jpeg_fused as ref_fused
from picha_tpu.ops import jpeg_huffman_decode_tpu as ref_dec
from picha_tpu.ops import jpeg_huffman_tpu as ref_huff
from picha_tpu.ops import jpeg_scan as ref_scan
from picha_tpu.ops import jpeg_tpu as ref_jpeg
from picha_tpu import image as ref_image
from picha_tpu import pixels as ref_pixels
from picha_tpu.codecs import jpeg_markers as ref_markers
from picha_tpu.codecs import png as ref_png
from picha_tpu.codecs import tiff as ref_tiff
from picha_tpu.pipeline import tiff_batch as ref_tiff_batch
from picha_tpu.ops import colorconvert as ref_cc
from picha_tpu.ops import resize as ref_resize
from picha_tpu_torch import image as port_image
from picha_tpu_torch import pixels as port_pixels
from picha_tpu_torch.codecs import image_host as port_image_host
from picha_tpu_torch.codecs import jpeg_markers as port_markers
from picha_tpu_torch.codecs import png_decode as port_png_decode
from picha_tpu_torch.codecs import png_host as port_png
from picha_tpu_torch.codecs import tiff_host as port_tiff
from picha_tpu_torch.ops import colorconvert as port_cc
from picha_tpu_torch.ops import jpeg as port_jpeg
from picha_tpu_torch.ops import jpeg_fused as port_fused
from picha_tpu_torch.ops import jpeg_huffman as port_huff
from picha_tpu_torch.ops import jpeg_scan as port_scan
from picha_tpu_torch.ops import resize_weights as port_resize
from picha_tpu_torch.ops import scan_batch as port_sb

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILTERS = sorted(ref_resize.FILTERS)


def _stream(kind):
    """JPEG bytes of one kind: the 1080p fixtures (restart-8, no restart)
    or small Pillow encodes of each sampling mode."""
    if kind == "restart":
        return (PORT_FIXTURES / "src_0.jpg").read_bytes()
    if kind == "no_restart":
        return (PORT_FIXTURES / "src_nr_0.jpg").read_bytes()
    if kind == "grey":
        return pil_jpeg(noisy(40, 37, 45, 1), quality=85)
    sub = {"420": 2, "422": 1, "444": 0}[kind]
    return pil_jpeg(noisy(41, 37, 45), quality=85, subsampling=sub)


SAMPLING = ["420", "422", "444", "grey"]
STREAMS = ["restart", "no_restart"] + SAMPLING


def _fields(info):
    return (info.width, info.height, info.ncomp,
            [(h, v, q.tolist()) for h, v, q in info.comps],
            info.scan_tables, info.huffman, info.restart_interval,
            info.segments, info.color_space, info.comp_sig, info.mcus)


@pytest.mark.parametrize("kind", STREAMS + ["progressive", "truncated"])
def test_parse_baseline_matches(kind):
    if kind == "progressive":
        buf = pil_jpeg(noisy(42, 37, 45), quality=85, progressive=True)
    elif kind == "truncated":
        buf = _stream("420")[:-200]
    else:
        buf = _stream(kind)
    got, want = port_scan.parse_baseline(buf), ref_scan.parse_baseline(buf)
    if want is None:
        assert got is None
        return
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("kind", ["restart", "no_restart"])
def test_scan_batch_wire_matches(kind):
    bufs = [(PORT_FIXTURES / f"src_{'nr_' if kind == 'no_restart' else ''}"
             f"{i}.jpg").read_bytes() for i in range(3)]
    got = port_sb.ScanBatch([port_scan.parse_baseline(b) for b in bufs])
    want = ref_dec.ScanBatch([ref_scan.parse_baseline(b) for b in bufs])
    (gks, gwire), (wks, wwire) = got.wire(), want.wire()
    assert gks == wks
    assert got.single_pass == (kind == "restart")
    np.testing.assert_array_equal(gwire, wwire)


@pytest.mark.parametrize("kind", SAMPLING)
def test_decode_reference_matches(kind):
    """The numpy entropy decoder (the plain version of the port's host C++
    decoder) against the reference's, bit for bit."""
    buf = _stream(kind)
    got = port_scan.decode_reference(port_scan.parse_baseline(buf))
    want = ref_scan.decode_reference(ref_scan.parse_baseline(buf))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int16
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", SAMPLING)
def test_coefficient_set_matches(kind):
    """The port's coefficient set of a decoded scan has the reference's
    fields (`JpegCoefficients.from_parts`, as `jpeg_entropy_decode` forms
    them), and both packages' signature and bucketing read it alike."""
    from picha_tpu.native.lib import JpegCoefficients as RefCoefficients
    from picha_tpu.pipeline import jpeg_batch as ref_jb
    from picha_tpu_torch.ops import coef_host
    from picha_tpu_torch.pipeline import jpeg_batch as port_jb

    info = port_scan.parse_baseline(_stream(kind))
    got = coef_host.decode_plain(info)
    planes = [c["coefs"] for c in got.comps]
    hmax = max(h for h, _, _ in info.comps)
    vmax = max(v for _, v, _ in info.comps)
    want = RefCoefficients.from_parts(info.width, info.height,
                                      info.color_space, [{
        "h_samp": h, "v_samp": v, "blocks_w": bw, "blocks_h": bh,
        "width": -(-info.width * h // hmax),
        "height": -(-info.height * v // vmax), "qtable": q,
        "coefs": planes[ci]} for ci, ((bh, bw, _, _), (h, v, q)) in
        enumerate(zip(info.comp_sig, info.comps))])
    for attr in ("width", "height", "ncomp", "color_space"):
        assert getattr(got, attr) == getattr(want, attr)
    for g, w in zip(got.comps, want.comps):
        assert g.keys() == w.keys()
        assert all(np.array_equal(g[k], w[k]) for k in g)
    assert port_jb.signature(got) == ref_jb.signature(want) == \
        ref_jb.signature(got)
    other = coef_host.decode_plain(port_scan.parse_baseline(_stream("grey")))
    assert [(s, i) for s, i, _ in port_jb.bucket_by_signature(
        [got, other, got])] == [(s, i) for s, i, _ in
                                ref_jb.bucket_by_signature([want, other, want])]


@pytest.mark.parametrize("granule", [1024, 4096, 8192])
def test_bucket_geometric_matches(granule):
    from picha_tpu.bucketing import bucket_geometric
    from picha_tpu_torch.ops.coef_host import bucket_geometric as port_bucket

    for k in (0, 1, 1000, 8191, 8192, 8193, 20000, 123457, 10**6):
        assert port_bucket(k, granule) == bucket_geometric(k, granule)


@pytest.mark.parametrize("kind", SAMPLING)
def test_prep_tables_matches(kind):
    buf = _stream(kind)
    got = port_sb.prep_tables(port_scan.parse_baseline(buf))
    want = ref_dec.prep_tables(ref_scan.parse_baseline(buf))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert port_sb.min_bits_per_symbol(port_scan.parse_baseline(buf)) == \
        ref_dec.min_bits_per_symbol(ref_scan.parse_baseline(buf))


@pytest.mark.parametrize("kind", SAMPLING)
def test_split_indices_matches(kind):
    sig = ref_scan.parse_baseline(_stream(kind)).comp_sig
    for g, w in zip(port_sb.split_indices(sig), ref_dec.split_indices(sig)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", SAMPLING)
def test_mcu_slot_tables_matches(kind):
    sig = ref_scan.parse_baseline(_stream(kind)).comp_sig
    np.testing.assert_array_equal(port_scan.mcu_slot_tables(sig),
                                  ref_scan.mcu_slot_tables(sig))
    for g, w in zip(port_scan.scatter_layout(sig),
                    ref_scan.scatter_layout(sig)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", SAMPLING)
def test_mcu_layout_matches(kind):
    sig = ref_scan.parse_baseline(_stream(kind)).comp_sig
    for g, w in zip(port_huff._mcu_layout(sig), ref_huff._mcu_layout(sig)):
        np.testing.assert_array_equal(g, w)


# (dst, src) pairs: downscale, upscale, the training crop, and a source
# past BANDED_THRESHOLD
_SIZES = [(17, 61), (90, 37), (224, 192), (960, 1920), (7, 7)]


def _same(name, *args):
    """port_resize.<name>(*args) against ref_resize.<name>(*args): equal
    arrays, or the same error (a degenerate window) from both."""
    try:
        want = getattr(ref_resize, name)(*args)
    except Exception as e:  # noqa: BLE001 - the same refusal, by name
        with pytest.raises(Exception) as got:
            getattr(port_resize, name)(*args)
        assert (type(got.value).__name__, str(got.value)) == \
            (type(e).__name__, str(e))
        return
    got = getattr(port_resize, name)(*args)
    if isinstance(want, np.ndarray):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("filt", FILTERS)
def test_resize_weights_matches(filt):
    for dst, src in _SIZES:
        for fscale in (1.0, 0.7):
            _same("resize_weights", dst, src, filt, fscale)


@pytest.mark.parametrize("filt", FILTERS)
def test_banded_resize_plan_matches(filt):
    for dst, src in _SIZES:
        _same("banded_resize_plan", dst, src, filt, 1.0)


@pytest.mark.parametrize("filt", FILTERS)
def test_resize_windows_matches(filt):
    for dst, src in _SIZES:
        for fscale in (1.0, 0.7):
            _same("resize_windows", dst, src, filt, fscale)


@pytest.mark.parametrize("opts", [{}, {"filter": "lanczos"},
                                  {"filter": "box", "filterScale": 2},
                                  {"filterScale": "0.5"}, {"filter": "nope"},
                                  {"filterScale": -1}])
def test_parse_resize_options_matches(opts):
    try:
        want = ref_resize.parse_resize_options(opts)
    except Exception as e:  # noqa: BLE001 - the same refusal, by name
        with pytest.raises(Exception) as got:
            port_resize.parse_resize_options(opts)
        assert type(got.value).__name__ == type(e).__name__
        assert str(got.value) == str(e)
        return
    assert port_resize.parse_resize_options(opts) == want


@pytest.mark.parametrize("args", [
    (45, 90, 45, 2, "cubic", 1.0, True), (30, 61, 31, 2, "lanczos", 0.7, True),
    (61, 61, 31, 2, "__identity__", 1.0, True), (20, 75, 19, 4, "box", 1.0,
                                                 False),
    (37, 45, 45, 1, "triangle", 1.0, True)])
def test_component_weights_matches(args):
    np.testing.assert_array_equal(port_fused.component_weights(*args),
                                  ref_fused.component_weights(*args))
    factor, n_in = args[3], args[2]
    np.testing.assert_array_equal(
        port_fused.upsample_matrix(factor, args[1], n_in, args[6]),
        ref_fused.upsample_matrix(factor, args[1], n_in, args[6]))


@pytest.mark.parametrize("quality", [50, 85, 95])
def test_quality_tables_matches(quality):
    for g, w in zip(port_jpeg.quality_tables(quality),
                    ref_jpeg.quality_tables(quality)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_idct_kron_matches():
    np.testing.assert_array_equal(port_jpeg._idct_kron(), ref_jpeg._idct_kron())
    np.testing.assert_array_equal(port_jpeg.idct_matrix(),
                                  ref_jpeg.idct_matrix())
    assert (port_jpeg.CS_GRAYSCALE, port_jpeg.CS_RGB, port_jpeg.CS_YCBCR,
            port_jpeg.CS_CMYK, port_jpeg.CS_YCCK) == (
        ref_jpeg.CS_GRAYSCALE, ref_jpeg.CS_RGB, ref_jpeg.CS_YCBCR,
        ref_jpeg.CS_CMYK, ref_jpeg.CS_YCCK)
    assert [port_jpeg.FIX(x) for x in (0.299, 1.402, 0.71414)] == \
        [ref_jpeg.FIX(x) for x in (0.299, 1.402, 0.71414)]


@pytest.mark.parametrize("nbytes", [0, 5, 64])
def test_assemble_matches(nbytes):
    scan = np.arange(64, dtype=np.uint8)
    header = port_huff.jpeg_header(32, 16, ((2, 4, 2, 2), (1, 2, 1, 1),
                                            (1, 2, 1, 1)), 85)
    assert port_huff.assemble(header, scan, nbytes) == \
        ref_huff.assemble(header, scan, nbytes)
    assert port_huff._dqt(port_jpeg.quality_tables(85)[0], 0) == \
        ref_huff._dqt(ref_jpeg.quality_tables(85)[0], 0)
    bits, vals = port_huff.ANNEX_K[(1, 0)]
    for g, w in zip(port_huff._code_arrays(bits, vals, 256),
                    ref_huff._code_arrays(bits, vals, 256)):
        np.testing.assert_array_equal(g, w)


def test_pixel_formats_match():
    assert port_pixels.PIXEL_FORMATS.keys() == ref_pixels.PIXEL_FORMATS.keys()
    for name, fmt in ref_pixels.PIXEL_FORMATS.items():
        got = port_pixels.PIXEL_FORMATS[name]
        assert (got.name, got.bytes_per_pixel, got.channels, got.dtype,
                got.max_value, got.is_deep, got.has_alpha, got.is_color) == (
            fmt.name, fmt.bytes_per_pixel, fmt.channels, fmt.dtype,
            fmt.max_value, fmt.is_deep, fmt.has_alpha, fmt.is_color)
        assert port_pixels.pixel_size(name) == ref_pixels.pixel_size(name)
    assert port_pixels.DEEP_OF == ref_pixels.DEEP_OF
    assert port_pixels.SHALLOW_OF == ref_pixels.SHALLOW_OF
    assert port_pixels.pixel_size("cmyk") == ref_pixels.pixel_size("cmyk")
    with pytest.raises(Exception) as got:
        port_pixels.pixel_format("cmyk")
    with pytest.raises(Exception) as want:
        ref_pixels.pixel_format("cmyk")
    assert (type(got.value).__name__, str(got.value)) == \
        (type(want.value).__name__, str(want.value))


@pytest.mark.parametrize("args", [
    (), (0.2, 0.3, 0.5), (1, 0, 0), (2, 5, 1), (float("nan"), 1, None),
    ("0.5", None, "2"), (0, 0, 0), ("x", 1, 1), (None, [1], None)])
def test_normalize_weights_matches(args):
    try:
        want = ref_cc.normalize_weights(*args)
    except Exception as e:  # noqa: BLE001 - the same refusal, by name
        with pytest.raises(Exception) as got:
            port_cc.normalize_weights(*args)
        assert (type(got.value).__name__, str(got.value)) == \
            (type(e).__name__, str(e))
        return
    got = port_cc.normalize_weights(*args)
    assert [type(g) for g in got] == [type(w) for w in want]
    assert got == want


def _image_pair(arr, pixel, **kw):
    return (port_image.Image.from_array(arr, pixel, **kw),
            ref_image.Image.from_array(arr, pixel, **kw))


@pytest.mark.parametrize("pixel", list(port_pixels.PIXEL_FORMATS))
def test_image_model_matches(pixel):
    """from_array, rows, stride, sub_view, clone, equal_pixels,
    avg_channel_diff and _infer_pixel on the same arrays."""
    fmt = ref_pixels.PIXEL_FORMATS[pixel]
    rng = np.random.default_rng(len(pixel))
    a = rng.integers(0, fmt.max_value + 1, (9, 7, fmt.channels),
                     dtype=fmt.dtype)
    b = a.copy()
    b[2:5, 1:3] ^= 1
    pa, ra = _image_pair(a, pixel)
    pb, rb = _image_pair(b, pixel)
    assert (pa.width, pa.height, pa.pixel, pa.stride) == \
        (ra.width, ra.height, ra.pixel, ra.stride)
    np.testing.assert_array_equal(pa.data, ra.data)
    np.testing.assert_array_equal(pa.to_array(), ra.to_array())
    assert pa.avg_channel_diff(pb) == ra.avg_channel_diff(rb)
    assert pa.equal_pixels(pb) == ra.equal_pixels(rb) is False
    assert pa.clone().equal_pixels(pa)
    for rect in ((1, 2, 4, 5), (0, 0, 7, 9), (6, 8, 1, 1)):
        ps, rs = pa.sub_view(*rect), ra.sub_view(*rect)
        assert (ps.width, ps.height, ps.stride) == \
            (rs.width, rs.height, rs.stride)
        np.testing.assert_array_equal(ps.to_array(), rs.to_array())
        assert ps.avg_channel_diff(pb.sub_view(*rect)) == \
            rs.avg_channel_diff(rb.sub_view(*rect))
    for rect in ((-1, 0, 2, 2), (0, 0, 8, 1), (0, 0, 0, 1)):
        with pytest.raises(port_image.InvalidImageError):
            pa.sub_view(*rect)
        with pytest.raises(ref_image.InvalidImageError):
            ra.sub_view(*rect)
    assert port_image._infer_pixel(a.dtype, fmt.channels) == \
        ref_image._infer_pixel(a.dtype, fmt.channels) == pixel
    assert pa.avg_channel_diff(port_image.Image(3, 3, pixel)) == \
        ra.avg_channel_diff(ref_image.Image(3, 3, pixel)) == 255.0


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation_matches(orientation):
    a = np.arange(4 * 6 * 4, dtype=np.uint8).reshape(4, 6, 4)
    np.testing.assert_array_equal(port_image_host._orient(a, orientation),
                                  ref_tiff._orient(a, orientation))


@pytest.mark.parametrize("name", ["test.png", "test2.png", "greytest.png",
                                  "test16.png"])
def test_png_chunks_rebuild_fixture_bytes(name):
    """Every chunk of the fixture PNGs (written by libpng), rebuilt by
    the port's `chunk` from its type and payload, is byte for byte the
    file's chunk (length, type, payload, CRC); the IHDR payload packs
    back from its fields. (The reference's `_chunk` computes its CRC in
    picha_tpu/native, which these tests do not call.)"""
    buf = (ROOT / "tests" / "fixtures" / name).read_bytes()
    assert buf[:8] == port_png.PNG_SIGNATURE
    pos = 8
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        ctype, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        assert port_png.chunk(ctype, data) == buf[pos:pos + 12 + n]
        if ctype == b"IHDR":
            w, h, depth, ct, comp, filt, lace = struct.unpack(">IIBBBBB",
                                                              data)
            if (comp, filt, lace) == (0, 0, 0):
                assert port_png.ihdr(w, h, depth, ct) == data
        pos += 12 + n


PNG_FIXTURES = ["test.png", "test2.png", "greytest.png", "test16.png"]


@pytest.fixture
def ref_png_zlib(monkeypatch):
    """picha_tpu/codecs/png.py with its native calls on zlib and the
    port's plain unfilter (no native build)."""
    import torch

    from picha_tpu_torch.ops.png_unfilter import png_unfilter_plain

    def unfilter(raw, height, rowbytes, bpp):
        rows = torch.from_numpy(np.ascontiguousarray(raw, np.uint8).reshape(
            1, height, rowbytes + 1))
        out, status = png_unfilter_plain(rows, bpp)
        if int(status.sum()):
            raise ref_png.CodecError("invalid PNG filter type")
        return out.numpy().reshape(-1)

    monkeypatch.setattr(ref_png, "native", types.SimpleNamespace(
        crc32=lambda data, crc=0: zlib.crc32(data, crc) & 0xFFFFFFFF,
        zlib_inflate=lambda data, expected, as_array=False: np.frombuffer(
            zlib.decompress(data), np.uint8),
        png_unfilter=unfilter))
    return ref_png


def _adam7_png():
    """An interlaced 16-bit rgba file (each pass filtered with Paeth)."""
    import test_torch_png_decode as T

    s = np.random.default_rng(4).integers(0, 65536, (11, 13, 4)).astype(
        np.uint16)
    return T._png_of(s, 16, 6, interlace=1, strategy=4)


def test_png_decode_tables_match():
    for name in ("CT_GREY", "CT_RGB", "CT_PALETTE", "CT_GREYA", "CT_RGBA",
                 "_CHANNELS", "_GREY_R", "_GREY_G", "_GREY_B", "_ADAM7"):
        assert getattr(port_png_decode, name) == getattr(ref_png, name)
    assert port_png_decode.PNG_SIGNATURE == ref_png.PNG_SIGNATURE


@pytest.mark.parametrize("name", PNG_FIXTURES + ["adam7"])
def test_png_decode_host_stage_matches(ref_png_zlib, name):
    """_parse_header, stat, the pixel rules over every request, and
    _decode_samples (Adam7 included) on the same files."""
    buf = _adam7_png() if name == "adam7" else \
        (ROOT / "tests" / "fixtures" / name).read_bytes()
    got, want = port_png_decode._parse_header(buf), ref_png._parse_header(buf)
    fields = ("width", "height", "bit_depth", "color_type", "interlace")
    assert [getattr(got, f) for f in fields] == \
        [getattr(want, f) for f in fields]
    assert port_png_decode.stat(buf) == ref_png.stat(buf)
    for deep in (False, True):
        assert port_png_decode._default_pixel(got, deep) == \
            ref_png._default_pixel(want, deep)
        for req in [None, *port_pixels.PIXEL_FORMATS]:
            assert port_png_decode._resolve_pixel(got, req, deep) == \
                ref_png._resolve_pixel(want, req, deep)
    gs, gp, gt = port_png_decode._decode_samples(buf, got)
    ws, wp, wt = ref_png._decode_samples(buf, want)
    assert gs.dtype == ws.dtype
    np.testing.assert_array_equal(gs, ws)
    assert (gt, None if gp is None else gp.tolist()) == \
        (wt, None if wp is None else wp.tolist())
    for target in port_pixels.PIXEL_FORMATS:
        try:
            w = ref_png._to_target(ws, want, wp, wt, target)
        except Exception as e:  # noqa: BLE001 - the same refusal, by name
            with pytest.raises(Exception) as err:
                port_png_decode._to_target(gs, got, gp, gt, target)
            assert (type(err.value).__name__, str(err.value)) == \
                (type(e).__name__, str(e))
            continue
        np.testing.assert_array_equal(
            port_png_decode._to_target(gs, got, gp, gt, target), w)


@pytest.mark.parametrize("depth", [1, 2, 4, 8, 16])
def test_png_expand_and_scale_match(depth):
    plane = np.random.default_rng(depth).integers(0, 256, (3, 12), np.uint8)
    ch = 1 if depth < 8 else 2
    width = 12 * 8 // (depth * ch)
    np.testing.assert_array_equal(
        port_png_decode._expand_bits(plane, width - 1, ch, depth),
        ref_png._expand_bits(plane, width - 1, ch, depth))
    if depth < 8:
        s = ref_png._expand_bits(plane, width, 1, depth)
        np.testing.assert_array_equal(
            port_png_decode._scale_sub_byte(s, depth),
            ref_png._scale_sub_byte(s, depth))
    assert port_png_decode._rowbytes(7, 3, depth) == \
        ref_png._rowbytes(7, 3, depth)


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("size", [1000, 700_000])
def test_deflate_parallel_matches(threads, size):
    data = (np.arange(size) * 7 % 251).astype(np.uint8).tobytes()
    assert port_png.deflate_parallel(data, 5, threads) == \
        ref_png.deflate_parallel(data, 5, threads)


def test_tiff_tables_match():
    for name in ("T_WIDTH", "T_BITS", "T_COMPRESSION", "T_PHOTOMETRIC",
                 "T_FILLORDER", "T_STRIP_OFFSETS", "T_ORIENTATION", "T_SPP",
                 "T_ROWS_PER_STRIP", "T_STRIP_COUNTS", "T_PLANAR",
                 "T_PREDICTOR", "T_COLORMAP", "T_TILE_OFFSETS",
                 "T_EXTRASAMPLES", "T_YCBCR_SUBSAMPLING", "C_NONE", "C_LZW",
                 "C_ADEFLATE", "C_DEFLATE", "C_PACKBITS", "_TYPE_SIZES",
                 "_TYPE_FMT"):
        assert getattr(port_tiff, name) == getattr(ref_tiff, name), name
    np.testing.assert_array_equal(port_tiff._BITREV, ref_tiff._BITREV)


def _tiff_cases():
    import test_torch_tiff_decode as T

    cases = dict(T.REF_CASES)
    cases["smallliz"] = [(ROOT / "tests" / "fixtures" /
                          "smallliz.tif").read_bytes()]
    return cases


@pytest.mark.parametrize("case", ["grey_o3", "predictor_rgb", "cmyk",
                                  "be16_predictor_extras", "palette4",
                                  "smallliz"])
def test_tiff_parse_and_host_stage_match(case):
    """_parse_ifds, and the batched host stage's signature, rows and
    colormap on uncompressed files (the reference's `_decompress` needs
    no native for those); a layout outside the device graph falls back
    in both."""
    buf = _tiff_cases()[case][0]
    ge, gifds = port_tiff._parse_ifds(buf)
    we, wifds = ref_tiff._parse_ifds(buf)
    assert ge == we and [i.tags for i in gifds] == [i.tags for i in wifds]
    got = port_tiff.host_stage(buf)
    if case == "smallliz":      # old-style JPEG strips: the fallback
        assert got[0] == "fallback"
        return
    want = ref_tiff_batch.host_stage(buf)
    assert got.sig == want[0] and got.strips == []
    np.testing.assert_array_equal(got.rows, want[1])
    if want[2] is None:
        assert got.cmap is None
    else:
        np.testing.assert_array_equal(got.cmap, want[2])


@pytest.mark.parametrize("orientation", [None, 1, 6, 8])
def test_exif_orientation_matches(orientation):
    import test_torch_options as O

    kw = {} if orientation is None else {"exif": O._exif(orientation)}
    buf = pil_jpeg(noisy(3, 16, 16), quality=80, **kw)
    assert port_markers.exif_orientation(buf) == \
        ref_markers.exif_orientation(buf)
    segs = list(port_markers.iter_segments(buf))
    assert segs == list(ref_markers.iter_segments(buf))
    for m, start, total in segs:
        seg = buf[start:start + total]
        assert port_markers._exif_payload(seg) == \
            ref_markers._exif_payload(seg)


def _port_modules():
    pkg = ROOT / "picha_tpu_torch"
    return sorted(
        "picha_tpu_torch" + "".join(
            "." + part for part in p.relative_to(pkg).with_suffix("").parts
            if part != "__init__")
        for p in pkg.rglob("*.py"))


def test_port_imports_nothing_of_the_reference():
    """Importing picha_tpu_torch and every one of its submodules loads
    neither jax nor picha_tpu nor any picha_tpu.* module."""
    mods = _port_modules()
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith('jax.') or m == 'picha_tpu'\n"
            "             or m.startswith('picha_tpu.'))\n"
            "assert not bad, bad\n"
            "print('clean', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
    assert {"picha_tpu_torch.pipeline.jpeg_batch",
            "picha_tpu_torch.pipeline.image_batch",
            "picha_tpu_torch.pipeline.png_batch",
            "picha_tpu_torch.pipeline.tiff_batch",
            "picha_tpu_torch.ops.colorconvert", "picha_tpu_torch.ops.png_filter",
            "picha_tpu_torch.ops.png_unfilter",
            "picha_tpu_torch.ops.png_transform", "picha_tpu_torch.ops.lzw",
            "picha_tpu_torch.ops.tiff_transform",
            "picha_tpu_torch.codecs.png_decode",
            "picha_tpu_torch.codecs.tiff_host",
            "picha_tpu_torch.codecs.jpeg_markers",
            "picha_tpu_torch.codecs.image_host",
            "picha_tpu_torch.codecs.png_host", "picha_tpu_torch.pixels",
            "picha_tpu_torch.image",
            "picha_tpu_torch.runtime.executor",
            "picha_tpu_torch.models.vit", "picha_tpu_torch.ops.layernorm",
            "picha_tpu_torch.ops.attention",
            "picha_tpu_torch.ops.moe", "picha_tpu_torch.models.checkpoint",
            "picha_tpu_torch.optim", "picha_tpu_torch.models.resnet",
            "picha_tpu_torch.models._tree",
            "picha_tpu_torch.ops.instance_norm",
            "picha_tpu_torch.ops.coef_host",
            "picha_tpu_torch.ops.coef_restore"} <= set(mods)


_REF_IMPORT = re.compile(
    r"^\s*(from\s+picha_tpu(\.|\s)|import\s+picha_tpu(\.|\s|$|,))",
    re.MULTILINE)


def test_port_sources_name_no_reference_import():
    """No file under picha_tpu_torch/ (nor chip_smoke.py) imports
    picha_tpu or a picha_tpu.* module."""
    files = sorted((ROOT / "picha_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = [str(f.relative_to(ROOT)) for f in files
           if _REF_IMPORT.search(f.read_text())]
    assert not bad, bad
    assert _REF_IMPORT.search("from picha_tpu.ops import x\n")
    assert _REF_IMPORT.search("import picha_tpu\n")
    assert not _REF_IMPORT.search("from picha_tpu_torch.ops import x\n")
