"""The port's pipeline defaults and codec options against the
reference's contract: `JpegBatchPipeline` takes the staged pixel path
(`fused=False`) by default, as the reference does; every decode and
encode option the reference honours is honoured with its semantics
(through Pillow), or raises NotImplementedError naming its ROADMAP item,
never ignored. Nothing here calls picha_tpu/native: the JPEG options are
checked on the files' own markers and against Pillow."""
import io
import struct
import zlib

import numpy as np
import pytest

from torch_helpers import pil_jpeg, port_corpus, smooth_rgb

from picha_tpu.codecs import jpeg_markers as ref_markers
from picha_tpu.codecs import png as ref_png

import picha_tpu_torch as port
from picha_tpu_torch.codecs import (CODECS, decode_sync, image_host,
                                    jpeg_markers)
from picha_tpu_torch.codecs.png_host import deflate_parallel
from picha_tpu_torch.errors import CodecError, InvalidOptionsError
from picha_tpu_torch.pipeline import ImageBatchPipeline, JpegBatchPipeline


def test_jpeg_pipeline_defaults_to_the_staged_path():
    """F1: the default equals fused=False byte for byte on the restart-8
    corpus, and differs from the fused matmuls."""
    bufs = port_corpus(3)
    kw = dict(encode_quality=85, encode_backend="device", upload="scan",
              device="cpu")
    default = JpegBatchPipeline(960, 544, **kw)
    staged = JpegBatchPipeline(960, 544, fused=False, **kw)
    fused = JpegBatchPipeline(960, 544, fused=True, **kw)
    got, want = default(bufs), staged(bufs)
    assert [bytes(g) for g in got] == [bytes(w) for w in want]
    assert [bytes(g) for g in got] != [bytes(f) for f in fused(bufs)]
    assert default._fused is False


def _markers(buf):
    """{marker: [payload]} of a JPEG's header segments (to SOS)."""
    out, i = {}, 2
    while i + 4 <= len(buf) and buf[i] == 0xFF:
        m = buf[i + 1]
        n = struct.unpack(">H", buf[i + 2:i + 4])[0]
        out.setdefault(m, []).append(buf[i + 4:i + 2 + n])
        if m == 0xDA:
            break
        i += 2 + n
    return out


def _jpeg(img, opts=None):
    return CODECS["image/jpeg"].encode_sync(img, opts or {})


RGB = port.Image.from_array(smooth_rgb(48, 64, 1), "rgb")


def test_jpeg_encode_restart_interval():
    buf = _jpeg(RGB, {"restartInterval": 2})
    dri = _markers(buf)[0xDD]
    assert struct.unpack(">H", dri[0])[0] == 2
    # 4x3 MCUs of 16x16 at 4:2:0: a marker every 2 MCUs, 5 in all
    assert sum(buf.count(bytes([0xFF, 0xD0 + k])) for k in range(8)) == 5
    assert 0xDD not in _markers(_jpeg(RGB))
    for bad in (-1, "x"):
        with pytest.raises(InvalidOptionsError):
            _jpeg(RGB, {"restartInterval": bad})


def test_jpeg_encode_progressive_optimize_subsample():
    base = _jpeg(RGB, {"quality": 90})
    assert 0xC0 in _markers(base) and 0xC2 not in _markers(base)
    prog = _jpeg(RGB, {"quality": 90, "progressive": True})
    assert 0xC2 in _markers(prog)
    opt = _jpeg(RGB, {"quality": 90, "optimize": True})
    assert len(opt) < len(base)
    for buf in (prog, opt):
        np.testing.assert_array_equal(decode_sync(buf).to_array(),
                                      decode_sync(base).to_array())
    sof = _markers(base)[0xC0][0]
    assert sof[7] == 0x22                      # 4:2:0 by default
    full = _markers(_jpeg(RGB, {"quality": 90, "subsample": False}))[0xC0][0]
    assert [full[7 + 3 * c] for c in range(3)] == [0x11] * 3


@pytest.mark.parametrize("denom", [1, 2, 4, 8])
def test_jpeg_decode_scale_denom(denom):
    """libjpeg's scaled decode to ceil(w/d) x ceil(h/d), close to a box
    reduction of the full decode (a different resampling: not equal)."""
    a = smooth_rgb(61, 83, 2)
    buf = pil_jpeg(a, quality=95)
    img = decode_sync(buf, {"scaleDenom": denom})
    assert (img.width, img.height, img.pixel) == (-(-83 // denom),
                                                  -(-61 // denom), "rgb")
    full = decode_sync(buf).to_array().astype(np.float64)
    h, w = 61 // denom * denom, 83 // denom * denom
    box = full[:h, :w].reshape(h // denom, denom, w // denom, denom,
                               3).mean((1, 3))
    got = img.to_array()[: h // denom, : w // denom]
    assert np.abs(got - box).mean() < 3


def test_jpeg_decode_scale_denom_validation():
    buf = pil_jpeg(smooth_rgb(16, 16, 3), quality=90)
    for bad in (3, 0, "x", None):
        with pytest.raises(InvalidOptionsError):
            decode_sync(buf, {"scaleDenom": bad})
    tiny = pil_jpeg(smooth_rgb(5, 9, 3), quality=90)
    with pytest.raises(NotImplementedError, match="item 11"):
        decode_sync(tiny, {"scaleDenom": 8})


def test_jpeg_decode_pixel():
    """grey is libjpeg's own grey output (the Y plane), within a level of
    Pillow's RGB -> L conversion of the colour decode; rgb from a grey
    file replicates it."""
    buf = pil_jpeg(smooth_rgb(40, 56, 4), quality=90)
    grey = decode_sync(buf, {"pixel": "grey"})
    assert grey.pixel == "grey" and grey.to_array().shape == (40, 56, 1)
    from PIL import Image

    want = np.asarray(Image.open(io.BytesIO(buf)).convert("L"))
    assert np.abs(grey.to_array()[..., 0].astype(int) - want).max() <= 2
    half = decode_sync(buf, {"pixel": "grey", "scaleDenom": 2})
    assert half.to_array().shape == (20, 28, 1)
    gbuf = pil_jpeg(smooth_rgb(40, 56, 4)[..., 0], quality=90)
    rgb = decode_sync(gbuf, {"pixel": "rgb"}).to_array()
    g = decode_sync(gbuf).to_array()
    np.testing.assert_array_equal(rgb, np.repeat(g, 3, -1))
    with pytest.raises(InvalidOptionsError):
        decode_sync(buf, {"pixel": "rgba"})


def _exif(orientation):
    """A little-endian EXIF payload with one Orientation entry."""
    tiff = (b"II*\x00" + struct.pack("<I", 8) + struct.pack("<H", 1)
            + struct.pack("<HHII", 0x0112, 3, 1, orientation)
            + struct.pack("<I", 0))
    return b"Exif\x00\x00" + tiff


@pytest.mark.parametrize("orientation", range(1, 9))
def test_jpeg_decode_auto_orient(orientation):
    a = smooth_rgb(24, 40, 5)
    buf = pil_jpeg(a, quality=95, exif=_exif(orientation))
    assert jpeg_markers.exif_orientation(buf) == \
        ref_markers.exif_orientation(buf) == orientation
    plain = decode_sync(buf).to_array()
    got = decode_sync(buf, {"autoOrient": True}).to_array()
    np.testing.assert_array_equal(got, image_host._orient(plain,
                                                          orientation))
    assert np.array_equal(decode_sync(buf, {"auto_orient": False})
                          .to_array(), plain)


def test_webp_segments_and_alpha_filtering_raise():
    img = port.Image.from_array(smooth_rgb(16, 16, 6), "rgb")
    for opt, ok, bad in (("segments", 2, 5), ("alphaFiltering", 1, 3)):
        with pytest.raises(NotImplementedError, match="item 7"):
            image_host.encode_webp(img, {opt: ok})
        with pytest.raises(InvalidOptionsError):
            image_host.encode_webp(img, {opt: bad})
    with pytest.raises(NotImplementedError, match="item 7"):
        image_host.encode_webp(img, {"preset": "photo"})


def test_png_deflate_threads():
    """Validated as the reference validates it; > 1 writes the parallel
    deflate's stream (the reference's construction, one zlib stream)
    that decodes to the image."""
    rng = np.random.default_rng(7)
    a = (rng.integers(0, 256, (300, 400, 4), np.uint8) // 32 * 32)
    img = port.Image.from_array(a, "rgba")
    for bad in (0, -1, 1.5, "2"):
        with pytest.raises(InvalidOptionsError):
            image_host.encode_png(img, {"deflateThreads": bad}, device="cpu")
    one = image_host.encode_png(img, {"filterStrategy": 2}, device="cpu")
    par = image_host.encode_png(img, {"filterStrategy": 2,
                                      "deflateThreads": 4}, device="cpu")
    assert par != one
    for buf in (one, par):
        np.testing.assert_array_equal(decode_sync(buf).to_array(), a)
    stream = zlib.decompress(_idat(par))
    assert _idat(par) == deflate_parallel(stream, 4, 4) == \
        ref_png.deflate_parallel(stream, 4, 4)


def _idat(png):
    pos, data = 8, b""
    while pos < len(png):
        (n,) = struct.unpack(">I", png[pos:pos + 4])
        if png[pos + 4:pos + 8] == b"IDAT":
            data += png[pos + 8:pos + 8 + n]
        pos += 12 + n
    return data


@pytest.mark.parametrize("convert", ["r16", "r16g16", "r16g16b16",
                                     "r16g16b16a16"])
def test_image_batch_encodes_16bit_png(convert):
    """ImageBatchPipeline(convert=<16-bit>, encode=PNG): 16-bit files
    (K12 on the big-endian bytes), which the port's decode reads back to
    the transform's pixels exactly."""
    rng = np.random.default_rng(len(convert))
    batch = rng.integers(0, 256, (3, 20, 24, 4), np.uint8)
    p = ImageBatchPipeline(convert=convert, encode=("image/png", {}),
                           device="cpu")
    files = p.encode_batch(p.transform(batch))
    assert all(f[24] == 16 for f in files)
    want = ImageBatchPipeline(convert=convert, device="cpu").transform(batch)
    for f, w in zip(files, want):
        back = decode_sync(f, {"deep": True}, device="cpu")
        assert back.pixel == convert
        np.testing.assert_array_equal(back.to_array(), w.numpy())


def test_image_batch_threads_the_device_to_the_png_decode():
    """A PNG pixel conversion inside ImageBatchPipeline runs the port's
    decode on the pipeline's device (here the CPU)."""
    a = np.random.default_rng(2).integers(0, 256, (2, 12, 10, 4), np.uint8)
    files = image_host.encode_png(port.Image.from_array(a[0], "rgba"), {},
                                  device="cpu")
    out = ImageBatchPipeline(device="cpu")([files], decode_opts={
        "pixel": "rgb"})
    np.testing.assert_array_equal(out[0], a[0, ..., :3])
    with pytest.raises(CodecError):
        ImageBatchPipeline(device="cpu")([files[:-20]],
                                         decode_opts={"pixel": "rgb"})


def test_tiff_16bit_encode_names_its_item():
    deep = port.Image.from_array(np.zeros((4, 4, 4), np.uint16),
                                 "r16g16b16a16")
    with pytest.raises(NotImplementedError, match="item 7"):
        image_host.encode_tiff(deep, {})
