"""The port's host codecs (`picha_tpu_torch/codecs/`, Pillow) against
picha_tpu's codecs, and the codec rules of the port.

This is the one module of the port's tests whose reference side decodes
and encodes through `picha_tpu/native` (zlib inflate, LZW, libwebp,
libdeflate): the tests whose docstring starts with "native" call it, the
others do not.

Measured here (`PYTHONPATH=. python tests/test_torch_codecs.py` prints
it): whether the port's PNG probe (zlib's level-1 estimates) picks the
same filter stream as the reference's (libdeflate's), on BASELINE
config 4's sources and their 176x112 crop + resize outputs.
"""
import io
import struct
import zlib

import numpy as np
import pytest

import picha_tpu as ref
from picha_tpu.codecs import png as ref_png

import picha_tpu_torch as port
from picha_tpu_torch.codecs import CODECS, decode_sync, image_host, sniff
from picha_tpu_torch.errors import (CodecError, InvalidOptionsError,
                                    UnsupportedFormatError)

from conftest import fixture_bytes


def config4_sources(n=8):
    """bench.py's config-4 recipe (seed 9): n RGBA 384x256 images."""
    w, h = 384, 256
    rng = np.random.default_rng(9)
    out = []
    for i in range(n):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        base = 127 + 70 * np.sin(xx / (11 + i)) + 40 * np.cos(yy / (7 + i))
        out.append(np.clip(np.stack(
            [base, 255 - base, base * 0.5 + 60,
             np.full_like(base, 255) - (xx + yy) % 17], -1)
            + rng.normal(0, 4, (h, w, 4)), 0, 255).astype(np.uint8))
    return out


def _idat(png: bytes) -> bytes:
    pos, data = 8, b""
    while pos < len(png):
        (n,) = struct.unpack(">I", png[pos:pos + 4])
        if png[pos + 4:pos + 8] == b"IDAT":
            data += png[pos + 8:pos + 8 + n]
        pos += 12 + n
    return zlib.decompress(data)


def probe_agreement():
    """{label: (images whose filtered stream equals the reference's, n,
    port bytes / reference bytes)} over config 4's sources and outputs."""
    from picha_tpu_torch.pipeline import ImageBatchPipeline

    srcs = np.stack(config4_sources())
    outs = ImageBatchPipeline(crop=(16, 16, 352, 224), resize=(176, 112),
                              device="cpu").transform(srcs).numpy()
    res = {}
    for label, batch in (("sources_384x256", srcs), ("outputs_176x112", outs)):
        same, pb, rb = 0, 0, 0
        for a in batch:
            r = ref_png.encode(ref.Image.from_array(a, "rgba"), {})
            p = image_host.encode_png(port.Image.from_array(a, "rgba"), {},
                                      device="cpu")
            same += _idat(r) == _idat(p)
            pb, rb = pb + len(p), rb + len(r)
        res[label] = (same, len(batch), pb / rb)
    return res


@pytest.mark.parametrize("name", ["test.png", "test2.png", "greytest.png",
                                  "test.webp", "smallliz.tif"])
def test_decode_fixtures_match_reference(name):
    """native: Pillow's decode against the reference's decodeSync: the
    same pixel format and pixels; smallliz.tif (YCbCr, old-style JPEG
    strips) within 1.5 LSB mean, the two JPEG strip decoders rounding
    differently (measured 1.13)."""
    buf = fixture_bytes(name)
    want = ref.decodeSync(buf)
    got = decode_sync(buf)
    assert (got.width, got.height, got.pixel) == (want.width, want.height,
                                                 want.pixel)
    d = np.abs(got.to_array().astype(int) - want.to_array())
    if name.endswith(".tif"):
        assert d.mean() <= 1.5
    else:
        assert d.max() == 0


@pytest.mark.parametrize("compression", ["lzw", "deflate", "none"])
@pytest.mark.parametrize("pixel", ["rgba", "rgb", "grey", "greya"])
def test_tiff_roundtrip_through_reference(compression, pixel):
    """native: the port's TIFFs decode in the reference to rgba pixels
    equal to the source's (as TIFFReadRGBAImage widens them), and the
    reference's TIFFs decode in the port to the same."""
    a = config4_sources(1)[0][:40, :56]
    img = port.Image.from_array(a, "rgba")
    if pixel != "rgba":
        img = port.color_convert_sync(img, {"pixel": pixel}, device="cpu")
    buf = image_host.encode_tiff(img, {"compression": compression})
    want = ref.decodeSync(buf)
    got = decode_sync(buf)
    assert got.pixel == want.pixel == "rgba"
    np.testing.assert_array_equal(got.to_array(), want.to_array())
    ref_buf = ref.encodeTiffSync(ref.Image.from_array(img.to_array(), pixel),
                                 {"compression": compression})
    np.testing.assert_array_equal(decode_sync(ref_buf).to_array(),
                                  want.to_array())


@pytest.mark.parametrize("pixel", ["rgba", "rgb", "grey", "greya"])
def test_png_roundtrip_through_reference(pixel):
    """native: the port's PNGs decode in the reference exactly, and the
    reference's decode in the port exactly."""
    a = config4_sources(1)[0][:70, :90]
    img = port.color_convert_sync(port.Image.from_array(a, "rgba"),
                                  {"pixel": pixel}, device="cpu") \
        if pixel != "rgba" else port.Image.from_array(a, "rgba")
    buf = image_host.encode_png(img, {}, device="cpu")
    assert ref.decodeSync(buf).equal_pixels(
        ref.Image.from_array(img.to_array(), pixel))
    ref_buf = ref.encodePngSync(ref.Image.from_array(img.to_array(), pixel))
    got = decode_sync(ref_buf)
    assert got.pixel == pixel
    np.testing.assert_array_equal(got.to_array(), img.to_array())


def test_webp_roundtrip_through_reference():
    """native: the port's lossy WebP (with alpha) decodes in the
    reference within its lossy oracle (< 8 LSB mean), alpha exact at
    alphaQuality 100."""
    a = config4_sources(1)[0][:112, :176]
    buf = image_host.encode_webp(port.Image.from_array(a, "rgba"),
                                 {"quality": 85})
    back = ref.decodeSync(buf).to_array()
    assert np.abs(back.astype(int) - a).mean() < 8
    np.testing.assert_array_equal(back[..., 3], a[..., 3])


def test_png_probe_agreement_with_reference():
    """native: the measurement of the module doc. Every stream decodes
    exactly either way (the round-trip tests); here the port's probe
    agrees with the reference's on the sources, and the port's files are
    within 10 % of the reference's size (zlib vs libdeflate)."""
    res = probe_agreement()
    same, n, ratio = res["sources_384x256"]
    assert same == n
    for same, n, ratio in res.values():
        assert 0.9 <= ratio <= 1.1


# -- the port's codec rules (no reference native calls) -------------------


@pytest.mark.parametrize("name,mime", [
    ("test.png", "image/png"), ("smallliz.tif", "image/tiff"),
    ("test.webp", "image/webp"), ("test.jpeg", "image/jpeg")])
def test_sniff(name, mime):
    assert sniff(fixture_bytes(name)) == mime
    assert set(CODECS) == {"image/jpeg", "image/png", "image/tiff",
                           "image/webp"}


def test_unknown_bytes_raise():
    with pytest.raises(UnsupportedFormatError):
        decode_sync(b"GIF89a" + b"\0" * 40)
    with pytest.raises(CodecError):
        decode_sync(b"\x89PNG\r\n\x1a\n" + b"\0" * 40)


def test_sixteen_bit_png_is_not_ported():
    """16-bit PNG decode and encode and the PNG pixel conversions go
    through the port's own stages now (on the CPU here); the 16-bit
    TIFF encode stays unported and names its ROADMAP item."""
    img = decode_sync(fixture_bytes("test16.png"), device="cpu")
    deep = decode_sync(fixture_bytes("test16.png"), {"deep": True},
                       device="cpu")
    assert (img.pixel, deep.pixel) == ("rgb", "r16g16b16")
    np.testing.assert_array_equal(deep.to_array() >> 8, img.to_array())
    assert decode_sync(fixture_bytes("test.png"), {"pixel": "grey"},
                       device="cpu").pixel == "grey"
    assert decode_sync(fixture_bytes("test.png"),
                       {"pixel": "r16g16b16a16"}).pixel == "rgba"
    with pytest.raises(InvalidOptionsError):
        decode_sync(fixture_bytes("test.png"), {"pixel": "cmyk"})
    deep_img = port.Image.from_array(
        np.arange(48, dtype=np.uint16).reshape(4, 4, 3) * 1361, "r16g16b16")
    back = decode_sync(image_host.encode_png(deep_img, {}, device="cpu"),
                       {"deep": True}, device="cpu")
    np.testing.assert_array_equal(back.to_array(), deep_img.to_array())
    with pytest.raises(NotImplementedError, match="item 7"):
        image_host.encode_tiff(deep_img, {})


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation_applied(orientation):
    """Pillow leaves the Orientation tag to the caller; the port turns the
    image to top-left as TIFFReadRGBAImageOriented does."""
    from PIL import Image as PILImage

    a = config4_sources(1)[0][:6, :10]
    out = io.BytesIO()
    PILImage.fromarray(a, "RGBA").save(out, "TIFF", compression="tiff_lzw",
                                       tiffinfo={274: orientation})
    got = decode_sync(out.getvalue(), mimetype="image/tiff").to_array()
    np.testing.assert_array_equal(got, image_host._orient(a, orientation))


def test_webp_options():
    img = port.Image.from_array(config4_sources(1)[0][:32, :48], "rgba")
    small = image_host.encode_webp(img, {"quality": 10, "method": 0})
    big = image_host.encode_webp(img, {"quality": 100})
    assert len(small) < len(big)
    lossless = image_host.encode_webp(img, {"preset": "lossless"})
    np.testing.assert_array_equal(decode_sync(lossless).to_array(),
                                  img.to_array())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        image_host.encode_webp(img, {"preset": "photo"})
    with pytest.raises(InvalidOptionsError):
        image_host.encode_webp(img, {"preset": "nope"})
    with pytest.raises(InvalidOptionsError):
        image_host.encode_webp(img, {"method": 7})
    with pytest.raises(InvalidOptionsError):
        image_host.encode_webp(
            port.Image.from_array(np.zeros((4, 4, 1), np.uint8), "grey"), {})


def test_jpeg_through_the_dispatch():
    a = config4_sources(1)[0][:32, :48, :3]
    buf = CODECS["image/jpeg"].encode_sync(port.Image.from_array(a, "rgb"),
                                           {"quality": 90})
    img = decode_sync(buf)
    assert img.pixel == "rgb" and (img.width, img.height) == (48, 32)
    assert np.abs(img.to_array().astype(int) - a).mean() < 4
    with pytest.raises(InvalidOptionsError):
        CODECS["image/jpeg"].encode_sync(
            port.Image.from_array(np.zeros((4, 4, 4), np.uint8), "rgba"), {})


if __name__ == "__main__":
    for label, (same, n, ratio) in probe_agreement().items():
        print(f"{label}: the port's probe picks the reference's stream on "
              f"{same} of {n} images; port bytes / reference bytes "
              f"{ratio:.4f}")
