"""The port's batched PNG decode on CPU tensors against picha_tpu and
Pillow on the same numpy inputs: K13's plain version (the unfilter)
inverts the reference's JAX `filter_batch` for every strategy and bpp;
K14's plain version (the spec transforms) equals the reference's
`png_batch._jit_transform` (JAX on the CPU) for every colour type, depth,
target and tRNS case it accepts, and at config 4's buckets at full width
(also on samples and tables at an odd byte offset); `PngBatchPipeline(device="cpu")` equals
Pillow's decode of Pillow-written files, and of interlaced files from a
writer here (Pillow writes no Adam7); the 16-bit rgb fixture against the
reference's `_to_target`; 16-bit round trips through the port's encode;
the decode errors. Nothing here calls picha_tpu/native."""
import io
import struct
import zlib

import numpy as np
import pytest
import torch

from conftest import fixture_bytes

from picha_tpu.codecs import png as ref_png
from picha_tpu.ops.png_filter_tpu import filter_batch as ref_filter_batch
from picha_tpu.pipeline.png_batch import _jit_transform as ref_transform

from picha_tpu_torch.codecs import png_decode as P
from picha_tpu_torch.codecs.png_host import chunk, PNG_SIGNATURE
from picha_tpu_torch.errors import CodecError
from picha_tpu_torch.ops.png_transform import png_transform
from picha_tpu_torch.ops.png_unfilter import check_status, png_unfilter
from picha_tpu_torch.pipeline import PngBatchPipeline, encode_filtered
from picha_tpu_torch.pixels import PIXEL_FORMATS

# (h, rb) per bpp: one row; rows no wider than bpp (a and c are 0
# throughout); a row exactly bpp wide; a taller image
def _shapes(bpp):
    return [(1, 5 * bpp), (4, max(1, bpp - 1)), (5, bpp), (9, 7 * bpp + 2)]


@pytest.mark.parametrize("strategy", [-1, 0, 1, 2, 3, 4])
@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_unfilter_inverts_reference_filter(strategy, bpp):
    rng = np.random.default_rng(bpp * 10 + strategy + 1)
    for h, rb in _shapes(bpp):
        rows = rng.integers(0, 256, (3, h, rb), np.uint8)
        rows[1] = (np.arange(rb)[None, :] * 7 % 256).astype(np.uint8)
        rows[2] = rows[0] // 16 * 16           # ties in the predictors
        filt = np.array(ref_filter_batch(rows, bpp, strategy))
        got, status = png_unfilter(torch.from_numpy(filt), bpp)
        assert got.dtype == torch.uint8 and int(status.sum()) == 0
        np.testing.assert_array_equal(got.numpy(), rows)


def test_unfilter_refuses_a_bad_filter_type():
    rows = np.zeros((2, 3, 9), np.uint8)
    rows[1, 2, 0] = 5
    got, status = png_unfilter(torch.from_numpy(rows), 2)
    assert status.tolist() == [0, 1]
    with pytest.raises(CodecError, match="invalid PNG filter type"):
        check_status(status)
    check_status(torch.zeros(2, dtype=torch.int32))


# every (colour type, depth) the reference accepts
COMBOS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
          (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


def _header(ct, depth, w=7, h=5, interlace=0):
    hd = P._Header()
    hd.width, hd.height, hd.bit_depth, hd.color_type = w, h, depth, ct
    hd.interlace = interlace
    return hd


def _samples(rng, n, ct, depth, h=5, w=7):
    hi = (1 << depth) if ct != 3 else min(256, 1 << depth)
    return rng.integers(0, hi, (n, h, w, P._CHANNELS[ct])).astype(
        np.uint16 if depth == 16 else np.uint8)


def _sample_bytes(s, depth):
    """(N, H, W, C) samples -> the (N, H, W, C*bps) bytes K14 takes."""
    if depth != 16:
        return torch.from_numpy(s.astype(np.uint8))
    be = np.stack([s >> 8, s & 0xFF], -1).astype(np.uint8)
    return torch.from_numpy(be.reshape(*s.shape[:3], -1))


@pytest.mark.parametrize("ct,depth", COMBOS)
def test_transform_matches_reference_jit(ct, depth):
    """K14's plain version equals `_jit_transform` for every target the
    reference resolves from this source (the eight pixel formats,
    through `_resolve_pixel`), and, for a palette, with and without
    tRNS alpha and with indices past a short PLTE."""
    rng = np.random.default_rng(ct * 100 + depth)
    n = 3
    s = _samples(rng, n, ct, depth)
    hd = _header(ct, depth)
    targets = sorted({P._resolve_pixel(hd, t, False) for t in PIXEL_FORMATS}
                     | {P._default_pixel(hd, True)})
    sig = (7, 5, depth, ct)
    for target in targets:
        for has_trns in ((False, True) if ct == 3 else (False,)):
            if ct == 3:
                pal = np.zeros((n, 256, 3), np.uint8)
                pal[:, :9] = rng.integers(0, 256, (n, 9, 3))  # short PLTE
                ta = np.full((n, 256), 255, np.uint8)
                ta[:, :4] = rng.integers(0, 256, (n, 4))
                offs = (np.arange(n, dtype=np.int32) * 256)[:, None, None]
                idx = s[..., 0].astype(np.int32) + offs
                want = np.asarray(ref_transform(sig, target, has_trns)(
                    idx[..., None], pal.reshape(-1, 3), ta.reshape(-1)))
                got = png_transform(_sample_bytes(s, depth), ct, depth,
                                    target, torch.from_numpy(pal),
                                    torch.from_numpy(ta) if has_trns
                                    else None)
            else:
                want = np.asarray(ref_transform(sig, target, False)(
                    s, np.zeros((1, 3), np.uint8), np.zeros((1,), np.uint8)))
                got = png_transform(_sample_bytes(s, depth), ct, depth,
                                    target)
            assert str(got.dtype).endswith(str(want.dtype)), (target,
                                                               got.dtype)
            np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                          want.astype(np.int64))


# BASELINE config 4's PNG buckets at full width (384x256): its rgba
# sources, as palette + tRNS files, and as 16-bit rgb decoded deep; K14
# times its kernel on these
CONFIG4_PNG = {"rgba8": (6, 8, "rgba"), "palette_trns": (3, 8, "rgba"),
               "rgb16_deep": (2, 16, "r16g16b16")}


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("bucket", list(CONFIG4_PNG))
def test_transform_matches_reference_at_config4_buckets(bucket, offset):
    """K14's plain version, the card's yardstick, equals `_jit_transform`
    on config 4's buckets at full width (3 images), also on samples and
    palette / tRNS tables that start at an odd byte offset of a larger
    buffer, as the pipeline slices its upload buffer."""
    ct, depth, target = CONFIG4_PNG[bucket]
    n, h, w = 3, 256, 384
    rng = np.random.default_rng(50 + offset)
    s = _samples(rng, n, ct, depth, h, w)
    sb = _sample_bytes(s, depth).reshape(-1)
    flat = torch.zeros(sb.numel() + offset + 16, dtype=torch.uint8)
    flat[offset:offset + sb.numel()] = sb
    view = flat[offset:offset + sb.numel()].view(n, h, w, -1)
    sig = (w, h, depth, ct)
    if ct == 3:
        pal = rng.integers(0, 256, (n, 256, 3), np.uint8)
        ta = np.full((n, 256), 255, np.uint8)
        ta[:, :200] = rng.integers(0, 256, (n, 200))
        tab = torch.zeros(n * 1024 + 2 * offset + 16, dtype=torch.uint8)
        tab[offset:offset + n * 768] = torch.from_numpy(pal.reshape(-1))
        t0 = offset + n * 768 + offset + 1
        tab[t0:t0 + n * 256] = torch.from_numpy(ta.reshape(-1))
        offs = (np.arange(n, dtype=np.int32) * 256)[:, None, None]
        want = np.asarray(ref_transform(sig, target, True)(
            s[..., 0].astype(np.int32)[..., None] + offs[..., None],
            pal.reshape(-1, 3), ta.reshape(-1)))
        got = png_transform(view, ct, depth, target,
                            tab[offset:offset + n * 768].view(n, 256, 3),
                            tab[t0:t0 + n * 256].view(n, 256))
    else:
        want = np.asarray(ref_transform(sig, target, False)(
            s, np.zeros((1, 3), np.uint8), np.zeros((1,), np.uint8)))
        got = png_transform(view, ct, depth, target)
    assert str(got.dtype).endswith(str(want.dtype)) and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  want.astype(np.int64))


def _pil_png(arr, mode, **kw):
    from PIL import Image

    out = io.BytesIO()
    Image.fromarray(arr, mode).save(out, "PNG", **kw)
    return out.getvalue()


def _pil_decode(buf, mode):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(buf)).convert(mode))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_pipeline_matches_pillow(mode):
    rng = np.random.default_rng(len(mode))
    ch = len(mode)
    bufs = []
    for i in range(3):
        a = rng.integers(0, 256, (11, 19, ch), np.uint8)
        a[:, : 5 + i] //= 8                 # smooth part: other filters
        bufs.append(_pil_png(a[..., 0] if ch == 1 else a, mode))
    out = PngBatchPipeline(device="cpu")(bufs)
    want = np.stack([_pil_decode(b, mode).reshape(11, 19, ch) for b in bufs])
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), want)


def _palette_png(rng, bits, trns=None, h=9, w=13):
    from PIL import Image

    a = rng.integers(0, 1 << bits, (h, w), np.uint8)
    im = Image.fromarray(a, "P")
    im.putpalette(rng.integers(0, 256, 3 << bits).tolist())
    out = io.BytesIO()
    kw = {"bits": bits} if bits < 8 else {}
    if trns is not None:
        kw["transparency"] = trns
    im.save(out, "PNG", **kw)
    return out.getvalue()


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_palette_and_trns_match_pillow(bits):
    rng = np.random.default_rng(bits)
    bufs = [_palette_png(rng, bits, trns=bytes([0, 90, 200])[: 1 << bits])
            for _ in range(2)]
    assert all(b[24] == bits and b[25] == 3 for b in bufs)
    rgba = PngBatchPipeline(pixel="rgba", device="cpu")(bufs)
    rgb = PngBatchPipeline(device="cpu")(bufs)
    grey = PngBatchPipeline(pixel="grey", device="cpu")(bufs)
    for i, b in enumerate(bufs):
        np.testing.assert_array_equal(rgba[i].numpy(), _pil_decode(b, "RGBA"))
        np.testing.assert_array_equal(rgb[i].numpy(), _pil_decode(b, "RGB"))
        hd = P._parse_header(b)
        samples, pal, t = P._decode_samples(b, hd)
        want = ref_png._to_target(samples, hd, pal, t, "grey")
        np.testing.assert_array_equal(grey[i].numpy(), want)


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_sub_byte_grey_matches_pillow(bits):
    from PIL import Image

    rng = np.random.default_rng(40 + bits)
    a = rng.integers(0, 1 << bits, (10, 21), np.uint8)
    # Pillow writes 1-bit from mode "1"; 2- and 4-bit grey through the
    # test-side writer below
    if bits == 1:
        out = io.BytesIO()
        Image.fromarray(a.astype(bool)).save(out, "PNG")
        buf = out.getvalue()
    else:
        buf = _png_of(a[..., None], bits, 0)
    assert buf[24] == bits and buf[25] == 0
    got = PngBatchPipeline(device="cpu")([buf, buf])
    np.testing.assert_array_equal(got[0, ..., 0].numpy(),
                                  _pil_decode(buf, "L"))


def _pack_rows(samples, depth):
    """(h, w, c) sample values -> (h, rowbytes) bytes as PNG packs them."""
    h, w, c = samples.shape
    if depth == 16:
        return np.stack([samples >> 8, samples & 0xFF], -1).astype(
            np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    per = 8 // depth
    flat = samples.reshape(h, -1).astype(np.uint8)
    pad = (-flat.shape[1]) % per
    flat = np.pad(flat, ((0, 0), (0, pad)))
    out = np.zeros((h, flat.shape[1] // per), np.uint8)
    for k in range(per):
        out |= flat[:, k::per] << (depth * (per - 1 - k))
    return out


def _png_of(samples, depth, ct, interlace=0, strategy=-1, extra=b""):
    """A PNG written here: each (Adam7) pass filtered by the reference's
    `filter_batch`, zlib, an IHDR with the interlace flag."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    geo = P._ADAM7 if interlace else [(0, 0, 1, 1)]
    stream = b""
    for x0, y0, dx, dy in geo:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack_rows(sub, depth)
        stream += np.asarray(ref_filter_batch(rows[None], bpp, strategy)
                             ).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ct, 0, 0, interlace)
    return (PNG_SIGNATURE + chunk(b"IHDR", ihdr) + extra
            + chunk(b"IDAT", zlib.compress(stream)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ct,depth", [(0, 1), (0, 4), (0, 8), (2, 8),
                                      (4, 8), (6, 8), (6, 16), (0, 16)])
def test_adam7_matches_pillow(ct, depth):
    """Interlaced files (passes of zero width or height skipped: 1x1,
    3x2 and 5x9 images), next to a plain one of the same signature in
    one batch, against Pillow's decode (16-bit: against the samples)."""
    rng = np.random.default_rng(ct * 7 + depth)
    c = P._CHANNELS[ct]
    for h, w in ((1, 1), (2, 3), (9, 5), (12, 17)):
        s = rng.integers(0, 1 << depth, (h, w, c)).astype(
            np.uint16 if depth == 16 else np.uint8)
        bufs = [_png_of(s, depth, ct, interlace=1, strategy=4),
                _png_of(s, depth, ct, interlace=0, strategy=-1)]
        out = PngBatchPipeline(deep=True, device="cpu")(bufs)
        if depth == 16:
            want = s
        else:
            mode = {0: "L", 2: "RGB", 4: "LA", 6: "RGBA"}[ct]
            want = _pil_decode(bufs[0], mode).reshape(h, w, c)
        for i in range(2):
            np.testing.assert_array_equal(out[i].numpy().astype(np.int64),
                                          want.astype(np.int64))


def test_16bit_fixture_matches_reference_to_target():
    """tests/fixtures/test16.png (16-bit rgb): the port's samples through
    the reference's `_to_target` (numpy) give the pipeline's output for
    every target, deep and shallow."""
    buf = fixture_bytes("test16.png")
    h = P._parse_header(buf)
    assert (h.bit_depth, h.color_type) == (16, 2)
    samples, palette, trns = P._decode_samples(buf, h)
    for target in PIXEL_FORMATS:
        want = ref_png._to_target(samples, h, palette, trns, target)
        got = PngBatchPipeline(pixel=target, device="cpu")([buf])[0]
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            P._to_target(samples, h, palette, trns, target), want)


@pytest.mark.parametrize("ct,depth,trns", [
    (0, 8, b"\x00\x07"), (0, 16, b"\x12\x34"), (2, 8, b"\x00\x01\x00\x02\x00\x03"),
    (0, 2, b"\x00\x01")])
def test_colour_key_trns_takes_to_target(ct, depth, trns):
    rng = np.random.default_rng(depth)
    c = P._CHANNELS[ct]
    s = rng.integers(0, 1 << min(depth, 3), (6, 7, c)).astype(
        np.uint16 if depth == 16 else np.uint8)
    s[0, 0] = np.frombuffer(trns, ">u2")[:c].astype(s.dtype) & (
        (1 << depth) - 1)
    buf = _png_of(s, depth, ct, extra=chunk(b"tRNS", trns))
    h = P._parse_header(buf)
    target = "rgba"
    got = PngBatchPipeline(pixel=target, device="cpu")([buf, buf])
    samples, palette, t = P._decode_samples(buf, h)
    want = ref_png._to_target(samples, h, palette, t, target)
    assert want[0, 0, 3] == 0
    for i in range(2):
        np.testing.assert_array_equal(got[i].numpy(), want)


@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_16bit_round_trip(ch):
    rng = np.random.default_rng(ch)
    x = rng.integers(0, 65536, (2, 19, 23, ch)).astype(np.uint16)
    files = encode_filtered(x, 4, None, device="cpu")
    assert all(f[24] == 16 for f in files)
    deep = PngBatchPipeline(deep=True, device="cpu")(files)
    assert deep.dtype == torch.uint16
    np.testing.assert_array_equal(deep.numpy(), x)
    shallow = PngBatchPipeline(device="cpu")(files)
    np.testing.assert_array_equal(shallow.numpy(), (x >> 8).astype(np.uint8))


def test_decode_errors():
    rng = np.random.default_rng(3)
    s = rng.integers(0, 256, (4, 5, 3), np.uint8)
    good = _png_of(s, 8, 2, strategy=1)
    p = PngBatchPipeline(device="cpu")
    np.testing.assert_array_equal(p([good])[0].numpy(), s)
    # a bad filter type byte (recompressed, valid CRCs)
    stream = bytearray(zlib.decompress(good[41:41 + struct.unpack(
        ">I", good[33:37])[0]]))
    stream[16] = 7
    ihdr = good[16:29]
    bad = (PNG_SIGNATURE + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(bytes(stream)))
           + chunk(b"IEND", b""))
    with pytest.raises(CodecError, match="invalid PNG filter type"):
        p([good, bad])
    # a bad CRC in a critical chunk
    crc = bytearray(good)
    crc[30] ^= 0xFF
    with pytest.raises(CodecError, match="CRC"):
        p([bytes(crc)])
    # an IDAT one row short
    short = (PNG_SIGNATURE + chunk(b"IHDR", ihdr)
             + chunk(b"IDAT", zlib.compress(bytes(stream[:-16])))
             + chunk(b"IEND", b""))
    with pytest.raises(CodecError, match="truncated"):
        p([short])
    with pytest.raises(ValueError, match="mixed"):
        p([good, _png_of(s[:, :4], 8, 2)])


def test_decode_parts_marks_each_stage():
    from picha_tpu_torch.pipeline import png_batch

    a = np.random.default_rng(4).integers(0, 256, (7, 9, 3), np.uint8)
    buf = _pil_png(a, "RGB")
    stages = []
    out = png_batch.decode_parts([png_batch.host_stage(buf)], None, False,
                                 torch.device("cpu"), stages.append)
    assert stages == ["pack", "upload", "unfilter", "transform", "status"]
    np.testing.assert_array_equal(out[0].numpy(), a)


def test_decode_pipelines_share_host_pools():
    from picha_tpu_torch.pipeline import TiffBatchPipeline, png_batch

    png = PngBatchPipeline(device="cpu")
    assert png._pool is TiffBatchPipeline(device="cpu")._pool
    assert png._pool is PngBatchPipeline(device="cpu")._pool
    assert png._pool is png_batch.host_pool(8)
    assert PngBatchPipeline(num_threads=3, device="cpu")._pool is \
        png_batch.host_pool(3)
