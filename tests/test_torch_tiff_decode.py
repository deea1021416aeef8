"""The port's batched TIFF decode on CPU tensors against picha_tpu and
Pillow on the same inputs: K15's plain version (the LZW strip decode) on
Pillow-written strips against Pillow's decode, and on streams from the
libtiff-style encoder here (validated through Pillow) for KwKwK, a table
clear, each code-width boundary at the end of a strip, the cap and the
errors; K16's plain version (the sample transforms) equals the
reference's `tiff_batch._jit_transform` (JAX on the CPU) for every bits,
byte order, predictor, photometric, extras and orientation, and at
config 4's bucket signatures at full width (also on rows at an odd
byte offset);
`TiffBatchPipeline(device="cpu")` equals the reference's on uncompressed
files (the struct-only builders of tests/test_tiff.py), Pillow's decode
on LZW, deflate and PackBits files, and refuses the crafted tags the
reference refuses. Nothing here calls picha_tpu/native."""
import io
import struct

import numpy as np
import pytest
import torch

from test_tiff import _craft_tiff, _grey_tiff

import picha_tpu as ref
from picha_tpu.pipeline import TiffBatchPipeline as RefPipeline
from picha_tpu.pipeline.tiff_batch import _jit_transform as ref_transform

from picha_tpu_torch.codecs import image_host, tiff_host
from picha_tpu_torch.errors import CodecError
from picha_tpu_torch.ops.lzw import check_strips, lzw_decode, lzw_decode_plain
from picha_tpu_torch.ops.tiff_transform import tiff_transform
from picha_tpu_torch.pipeline import TiffBatchPipeline


def _lzw_encode(data: bytes):
    """libtiff's LZW encode (tif_lzw.c LZWEncode / LZWPostEncode): a
    Clear first, widen when the next free code passes (1 << width) - 1,
    a Clear when it reaches 4094, one phantom entry for the last code
    before EOI. Returns (stream, the final next-free code)."""
    out = bytearray()
    acc = nb = 0

    def put(code, width):
        nonlocal acc, nb
        acc = (acc << width) | code
        nb += width
        while nb >= 8:
            out.append((acc >> (nb - 8)) & 0xFF)
            nb -= 8
            acc &= (1 << nb) - 1

    width, free, table, ent = 9, 258, {}, -1
    put(256, 9)

    def added():
        nonlocal width, free, table
        free += 1
        if free == 4094:
            put(256, width)
            width, free, table = 9, 258, {}
        elif free > (1 << width) - 1:
            width += 1

    for c in data:
        if ent < 0:
            ent = c
            continue
        if (ent, c) in table:
            ent = table[(ent, c)]
            continue
        put(ent, width)
        table[(ent, c)] = free
        added()
        ent = c
    if ent >= 0:
        put(ent, width)
        added()
    put(257, width)
    if nb:
        out.append((acc << (8 - nb)) & 0xFF)
    return bytes(out), free


def _lzw_tiff(data: bytes, w: int):
    """A one-strip grey 8-bit LZW TIFF of `data` (w columns)."""
    seg, _ = _lzw_encode(data)
    h = len(data) // w
    off = 8 + 2 + 8 * 12 + 4
    tags = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 1, 8), (259, 3, 1, 5),
            (262, 3, 1, 1), (273, 4, 1, off), (278, 4, 1, h),
            (279, 4, 1, len(seg))]
    return _craft_tiff(tags, seg)


def _pil_rgba(buf):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(buf)).convert("RGBA"))


def _prefix_with_final_free(rnd: bytes, target: int) -> bytes:
    """The shortest prefix of `rnd` whose encode ends with the next free
    code at `target` (monotonic in the length before the first clear)."""
    lo, hi = 1, len(rnd)
    while lo < hi:
        mid = (lo + hi) // 2
        if _lzw_encode(rnd[:mid])[1] < target:
            lo = mid + 1
        else:
            hi = mid
    assert _lzw_encode(rnd[:lo])[1] == target
    return rnd[:lo]


RND = np.random.default_rng(5).integers(0, 256, 6000, np.uint8).tobytes()


@pytest.mark.parametrize("boundary", [511, 1023, 2047])
@pytest.mark.parametrize("past", [-1, 0, 1])
def test_lzw_strip_ending_at_each_width_boundary(boundary, past):
    """The decoder's next free code is boundary + past when it reads the
    last code: at boundary it adds the last entry, widens, and reads EOI
    one bit wider (the encoder wrote it so)."""
    data = _prefix_with_final_free(RND, boundary + 1 + past)
    seg, _ = _lzw_encode(data)
    got, ok = lzw_decode_plain(seg, len(data))
    assert ok and got == data
    w = 4
    data = data[: len(data) // w * w]
    buf = _lzw_tiff(data, w)
    np.testing.assert_array_equal(_pil_rgba(buf)[..., 0].reshape(-1),
                                  np.frombuffer(data, np.uint8))


@pytest.mark.parametrize("case", ["kwkwk", "clear", "cap", "cap_inside",
                                  "no_eoi", "empty"])
def test_lzw_streams(case):
    data = {"kwkwk": b"a" * 300 + b"ab" * 40,
            "clear": RND + RND[:1500],
            "cap": RND[:900], "cap_inside": b"xyz" * 200,
            "no_eoi": RND[:700], "empty": b""}[case]
    seg, _ = _lzw_encode(data)
    cap = {"cap": 500, "cap_inside": 301}.get(case, len(data))
    if case == "no_eoi":
        seg = seg[:-3]
    got, ok = lzw_decode_plain(seg, cap)
    assert ok
    if case == "no_eoi":
        assert data.startswith(got) and len(got) > 600
    else:
        assert got == data[:cap]


def _codes(codes, width=9):
    acc = nb = 0
    out = bytearray()
    for c in codes:
        acc = (acc << width) | c
        nb += width
        while nb >= 8:
            out.append((acc >> (nb - 8)) & 0xFF)
            nb -= 8
            acc &= (1 << nb) - 1
    if nb:
        out.append((acc << (8 - nb)) & 0xFF)
    return bytes(out)


@pytest.mark.parametrize("codes", [[256, 65, 300, 257], [256, 258, 257],
                                   [256, 65, 66, 261, 257]])
def test_lzw_undefined_codes_fail(codes):
    got, ok = lzw_decode_plain(_codes(codes), 100)
    assert not ok
    segs = torch.from_numpy(np.frombuffer(_codes(codes), np.uint8).copy())
    table = torch.tensor([[0], [len(segs)], [0], [100]], dtype=torch.int64)
    out = torch.zeros(100, dtype=torch.uint8)
    n, status = lzw_decode(segs, table[0], table[1], out, table[2], table[3])
    assert status.tolist() == [1]
    with pytest.raises(CodecError, match="LZW decode failed"):
        check_strips(n, status, table[3])


def test_lzw_batch_on_pillow_strips_and_short_strips():
    """Every strip of Pillow-written LZW TIFFs (several strips each),
    decoded by the batched call, is Pillow's decode of those rows; a
    strip whose data ends early raises "TIFF strip too short"."""
    from PIL import Image

    rng = np.random.default_rng(9)
    bufs = []
    for i in range(2):
        a = rng.integers(0, 256, (300, 90, 3), np.uint8) // (1 + 40 * i)
        out = io.BytesIO()
        Image.fromarray(a).save(out, "TIFF", compression="tiff_lzw")
        bufs.append(out.getvalue())
    items = [tiff_host.host_stage(b) for b in bufs]
    assert all(len(it.strips) > 1 for it in items)
    got = TiffBatchPipeline(device="cpu")(bufs)
    for i, b in enumerate(bufs):
        np.testing.assert_array_equal(got[i].numpy(), _pil_rgba(b))
        rows = _pil_rgba(b)[..., :3].reshape(300, -1)
        for seg, y0, cap in items[i].strips:
            data, ok = lzw_decode_plain(seg, cap)
            assert ok and data == rows[y0:y0 + cap // 270].tobytes()
    data = RND[:400]
    seg, _ = _lzw_encode(data)
    segs = torch.from_numpy(np.frombuffer(seg, np.uint8).copy())
    table = torch.tensor([[0], [len(seg)], [0], [500]], dtype=torch.int64)
    n, status = lzw_decode(segs, table[0], table[1],
                           torch.zeros(500, dtype=torch.uint8), table[2],
                           table[3])
    assert n.tolist() == [400] and status.tolist() == [0]
    with pytest.raises(CodecError, match="too short"):
        check_strips(n, status, table[3])
    short = _lzw_tiff(data, 20).replace(struct.pack("<HHII", 257, 4, 1, 20),
                                        struct.pack("<HHII", 257, 4, 1, 25))
    with pytest.raises(CodecError, match="too short"):
        TiffBatchPipeline(device="cpu")([short])


def _tiff_signatures():
    """(bits, photometric, spp, extras) over every bits and photometric,
    each with and without extra samples where the photometric reads
    them."""
    out = []
    for bits in (1, 2, 4, 8, 16):
        for ph, spps in ((0, (1, 2)), (1, (1, 2)), (2, (3, 4)), (3, (1,)),
                         (5, (4, 5)), (6, (3,))):
            for spp in spps:
                out.append((bits, ph, spp))
    return out


@pytest.mark.parametrize("bits,ph,spp", _tiff_signatures())
def test_transform_matches_reference_jit(bits, ph, spp):
    """K16's plain version equals `_jit_transform` for orientations 1-8
    spread over the cases, both byte orders, predictor 1 and 2 (8 and 16
    bits) and the extras flag."""
    h, w = 5, 7
    rowbytes = (w * spp * bits + 7) // 8
    k = _tiff_signatures().index((bits, ph, spp))
    rng = np.random.default_rng(k)
    n = 2
    rows = rng.integers(0, 256, (n, h, rowbytes), np.uint8)
    cmaps = rng.integers(0, 256, (n, 1 << bits, 3), np.uint8) \
        if ph == 3 else None
    for j in range(4):
        orientation = (k * 3 + j) % 8 + 1
        endian = "<>"[(k + j) % 2]
        predictor = 2 if bits >= 8 and j % 2 else 1
        extras = bool((k + j // 2) % 2)
        sig = (w, h, spp, bits, ph, predictor, orientation, endian, extras)
        want = np.asarray(ref_transform(sig)(
            rows, cmaps if cmaps is not None else np.zeros((n, 1, 3),
                                                           np.uint8)))
        got = tiff_transform(torch.from_numpy(rows), sig,
                             None if cmaps is None
                             else torch.from_numpy(cmaps))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)


# BASELINE config 4's TIFF buckets at full width (384x256 rgba8, alpha as
# an extra sample, as Pillow writes them); K16 times its kernel on these
CONFIG4_TIFF = {"p1_o1": (384, 256, 4, 8, 2, 1, 1, "<", True),
                "p2_o6": (384, 256, 4, 8, 2, 2, 6, "<", True)}


@pytest.mark.parametrize("offset", [0, 7])
@pytest.mark.parametrize("bucket", list(CONFIG4_TIFF))
def test_transform_matches_reference_at_config4_buckets(bucket, offset):
    """K16's plain version, the card's yardstick, equals `_jit_transform`
    on config 4's bucket signatures at full width (3 images), also on rows
    that start at an odd byte offset of a larger buffer, as the pipeline
    slices its upload buffer."""
    sig = CONFIG4_TIFF[bucket]
    n, (w, h), rb = 3, sig[:2], sig[0] * 4
    flat = np.random.default_rng(40 + offset).integers(
        0, 256, n * h * rb + offset + 16, np.uint8)
    rows = flat[offset:offset + n * h * rb].reshape(n, h, rb)
    want = np.asarray(ref_transform(sig)(rows, np.zeros((n, 1, 3), np.uint8)))
    view = torch.from_numpy(flat)[offset:offset + n * h * rb].view(n, h, rb)
    got = tiff_transform(view, sig)
    assert got.shape == ((n, h, w, 4) if sig[6] < 5 else (n, w, h, 4))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sub_byte_predictor_raises_like_reference():
    sig = (7, 5, 1, 4, 1, 2, 1, "<", False)
    rows = np.zeros((1, 5, 4), np.uint8)
    with pytest.raises(Exception) as want:
        ref_transform(sig)(rows, np.zeros((1, 1, 3), np.uint8))
    with pytest.raises(CodecError) as got:
        tiff_transform(torch.from_numpy(rows), sig)
    assert str(got.value) == str(want.value)


def _palette_tiff(idx, bits, cmap):
    """An uncompressed palette TIFF, the colormap after the IFD."""
    h, w = idx.shape
    per = 8 // bits
    packed = np.zeros((h, -(-w // per)), np.uint8)
    for x in range(w):
        packed[:, x // per] |= idx[:, x] << (bits * (per - 1 - x % per))
    n_tags = 9
    cmap_off = 8 + 2 + n_tags * 12 + 4
    data_off = cmap_off + cmap.size * 2
    tags = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 1, bits),
            (259, 3, 1, 1), (262, 3, 1, 3), (273, 4, 1, data_off),
            (279, 4, 1, packed.size), (320, 3, cmap.size, cmap_off),
            (278, 4, 1, h)]
    cm = struct.pack("<" + "H" * cmap.size, *cmap.T.reshape(-1))
    return _craft_tiff(tags, cm + packed.tobytes())


def _reference_cases():
    rng = np.random.default_rng(23)
    base = rng.integers(0, 256, (5, 9), np.uint8)
    cases = {f"grey_o{o}": [_grey_tiff(base, o)] * 2 for o in range(1, 9)}
    # horizontal-predictor rgb and CMYK (tests/test_pipeline.py:672)
    h, w = 6, 11
    arr = rng.integers(0, 256, (h, w, 3), np.uint8)
    diff = arr.astype(np.int16)
    diff[:, 1:] = diff[:, 1:] - diff[:, :-1]
    data = (diff % 256).astype(np.uint8).tobytes()
    off = 8 + 2 + 9 * 12 + 4
    tags = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 1, 8), (259, 3, 1, 1),
            (262, 3, 1, 2), (273, 4, 1, off), (277, 3, 1, 3),
            (279, 4, 1, len(data)), (317, 3, 1, 2)]
    cases["predictor_rgb"] = [_craft_tiff(tags, data)] * 2
    cmyk = rng.integers(0, 256, (h, w, 4), np.uint8)
    tags = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 1, 8), (259, 3, 1, 1),
            (262, 3, 1, 5), (273, 4, 1, 8 + 2 + 8 * 12 + 4), (277, 3, 1, 4),
            (279, 4, 1, cmyk.size)]
    cases["cmyk"] = [_craft_tiff(tags, cmyk.tobytes())]
    # 16-bit big-endian grey + alpha with predictor 2, in two strips
    v = rng.integers(0, 65536, (7, 5, 2)).astype(np.uint16)
    d = v.astype(np.int64)
    d[:, 1:] = d[:, 1:] - d[:, :-1]
    data = (d % 65536).astype(">u2").tobytes()
    off = 8 + 2 + 11 * 12 + 4
    half = 4 * 5 * 2 * 2                     # RowsPerStrip 4
    tags = [(256, 4, 1, 5), (257, 4, 1, 7), (258, 3, 1, 16), (259, 3, 1, 1),
            (262, 3, 1, 1), (273, 4, 2, off), (277, 3, 1, 2),
            (278, 4, 1, 4), (279, 4, 2, off + 8), (317, 3, 1, 2),
            (338, 3, 1, 2)]
    tables = struct.pack(">IIII", off + 16, off + 16 + half, half,
                         len(data) - half)
    cases["be16_predictor_extras"] = [_craft_tiff(tags, tables + data,
                                                  endian=">")]
    for bits in (1, 4, 8):
        idx = rng.integers(0, 1 << bits, (6, 10)).astype(np.uint8)
        cmap = rng.integers(0, 65536, (1 << bits, 3)).astype(np.uint16)
        cases[f"palette{bits}"] = [_palette_tiff(idx, bits, cmap)] * 2
    return cases


REF_CASES = _reference_cases()


@pytest.mark.parametrize("case", list(REF_CASES))
def test_pipeline_matches_reference_on_uncompressed(case):
    bufs = REF_CASES[case]
    got = TiffBatchPipeline(device="cpu")(bufs)
    want = np.asarray(RefPipeline()(bufs))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    # the single-image decode: Pillow, or the port's stages (16-bit,
    # predictor 2, CMYK)
    np.testing.assert_array_equal(
        image_host.decode_tiff(bufs[0], device="cpu").to_array(),
        ref.decodeTiffSync(bufs[0]).to_array())


@pytest.mark.parametrize("comp", ["tiff_lzw", "tiff_adobe_deflate",
                                  "packbits"])
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "1",
                                  "CMYK"])
def test_pipeline_matches_pillow(comp, mode):
    from PIL import Image

    rng = np.random.default_rng(len(mode) + len(comp))
    bufs = []
    for i in range(2):
        a = rng.integers(0, 256, (37, 29, 4), np.uint8)
        a[:, : 9 + i] //= 16
        im = Image.fromarray(a, "RGBA").convert(mode) if mode != "RGBA" \
            else Image.fromarray(a, "RGBA")
        out = io.BytesIO()
        im.save(out, "TIFF", compression=comp)
        bufs.append(out.getvalue())
    p = TiffBatchPipeline(device="cpu")
    got = p(bufs)
    assert p.fallbacks == 0
    for i, b in enumerate(bufs):
        if mode == "CMYK":
            # libtiff's fold (the reference's), not Pillow's rounded one
            c = np.asarray(Image.open(io.BytesIO(b))).astype(np.int32)
            want = np.concatenate([(255 - c[..., :3]) * (255 - c[..., 3:])
                                   // 255, np.full_like(c[..., :1], 255)],
                                  -1).astype(np.uint8)
        else:
            want = _pil_rgba(b)
        np.testing.assert_array_equal(got[i].numpy(), want)


def test_fallback_layouts_take_the_whole_file_decode():
    from test_tiff import _pil_bilevel_tiff

    arr = (np.add.outer(np.arange(10), np.arange(30)) // 3) % 2 == 0
    bufs = [_pil_bilevel_tiff(arr, "group4")] * 2
    p = TiffBatchPipeline(device="cpu")
    got = p(bufs)
    assert p.fallbacks == 2
    np.testing.assert_array_equal(got[0].numpy(), _pil_rgba(bufs[0]))
    with pytest.raises(ValueError, match="mixed"):
        p([bufs[0], _grey_tiff(np.zeros((4, 4), np.uint8))])


def test_crafted_tags_route_or_raise():
    """tests/test_pipeline.py:1050: predictor 3 routes to the whole-file
    decode's typed error, giant dimensions and a negative RowsPerStrip
    fail before any allocation."""
    base = np.arange(16, dtype=np.uint8).reshape(4, 4)

    def craft(extra):
        data_off = 8 + 2 + (7 + len(extra)) * 12 + 4
        tags = [(256, 4, 1, 4), (257, 4, 1, 4), (258, 3, 1, 8),
                (259, 3, 1, 1), (262, 3, 1, 1), (273, 4, 1, data_off),
                (279, 4, 1, base.size)] + extra
        return _craft_tiff(tags, base.tobytes())

    p = TiffBatchPipeline(device="cpu")
    for extra in ([(317, 3, 1, 3)], [(278, 9, 1, 0xFFFFFFFB)],
                  [(277, 3, 1, 60000)]):
        with pytest.raises(CodecError):
            p([craft(extra)])
        with pytest.raises(ref.CodecError):
            RefPipeline()([craft(extra)])


def test_16bit_decode_outside_the_device_layouts_raises():
    v = np.arange(2 * 3 * 4, dtype=np.uint16).reshape(2, 3, 4)
    data = v.transpose(2, 0, 1).astype("<u2").tobytes()   # planar
    off = 8 + 2 + 10 * 12 + 4
    tags = [(256, 4, 1, 3), (257, 4, 1, 2), (258, 3, 1, 16), (259, 3, 1, 1),
            (262, 3, 1, 2), (273, 4, 1, off), (277, 3, 1, 4),
            (279, 4, 1, len(data)), (284, 3, 1, 2), (338, 3, 1, 2)]
    with pytest.raises(NotImplementedError, match="item 7"):
        image_host.decode_tiff(_craft_tiff(tags, data), device="cpu")


def _tiled_tiff(src, comp, tile=16):
    """A grey 8-bit TIFF of `src` in `tile`-square tiles with predictor 2,
    each tile LZW-compressed by the encoder above (comp 5) or stored
    (comp 1)."""
    h, w = src.shape
    ty, tx = -(-h // tile), -(-w // tile)
    pad = np.zeros((ty * tile, tx * tile), np.int32)
    pad[:h, :w] = src
    segs = []
    for j in range(ty):
        for i in range(tx):
            t = pad[j * tile:(j + 1) * tile, i * tile:(i + 1) * tile]
            raw = (np.diff(t, axis=1, prepend=0) % 256).astype(
                np.uint8).tobytes()
            segs.append(_lzw_encode(raw)[0] if comp == 5 else raw)
    k = len(segs)
    offs_at = 8 + 2 + 10 * 12 + 4
    pos = offs_at + 8 * k
    offs = list(np.cumsum([pos] + [len(s) for s in segs[:-1]]))
    data = struct.pack(f"<{k}I", *offs) + \
        struct.pack(f"<{k}I", *map(len, segs)) + b"".join(segs)
    tags = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 1, 8),
            (259, 3, 1, comp), (262, 3, 1, 1), (317, 3, 1, 2),
            (322, 3, 1, tile), (323, 3, 1, tile), (324, 4, k, offs_at),
            (325, 4, k, offs_at + 4 * k)]
    return _craft_tiff(tags, data)


def test_tiled_lzw_predictor_2_keeps_pillow():
    """Outside the device layouts a compressed predictor-2 file stays
    with Pillow, whose libtiff undoes the predictor of tiles."""
    from picha_tpu_torch.codecs import decode_sync

    src = np.random.default_rng(8).integers(0, 256, (24, 40), np.uint8)
    buf = _tiled_tiff(src, 5)
    assert tiff_host.host_stage(buf)[0] == "fallback"
    want = np.concatenate([np.repeat(src[..., None], 3, -1),
                           np.full_like(src[..., None], 255)], -1)
    np.testing.assert_array_equal(_pil_rgba(buf), want)
    np.testing.assert_array_equal(
        decode_sync(buf, device="cpu").to_array(), want)
    p = TiffBatchPipeline(device="cpu")
    got = p([buf, buf])
    assert p.fallbacks == 2
    np.testing.assert_array_equal(got.numpy(), np.stack([want, want]))


def test_uncompressed_tiled_predictor_2_raises():
    """Pillow skips the predictor of uncompressed data: outside the
    device layouts that raises rather than return the residuals."""
    src = np.random.default_rng(9).integers(0, 256, (24, 40), np.uint8)
    with pytest.raises(NotImplementedError, match="item 7"):
        image_host.decode_tiff(_tiled_tiff(src, 1), device="cpu")


def test_bigtiff_keeps_pillow():
    from PIL import Image

    src = np.random.default_rng(10).integers(0, 256, (12, 20, 3), np.uint8)
    out = io.BytesIO()
    Image.fromarray(src).save(out, "TIFF", big_tiff=True)
    buf = out.getvalue()
    assert buf[2] == 43
    np.testing.assert_array_equal(
        image_host.decode_tiff(buf, device="cpu").to_array(), _pil_rgba(buf))


def test_decode_items_marks_each_stage():
    from picha_tpu_torch.pipeline import tiff_batch

    buf = _lzw_tiff(RND[:600], 40)
    stages = []
    out = tiff_batch.decode_items([tiff_host.host_stage(buf)],
                                  torch.device("cpu"), stages.append)
    assert stages == ["pack", "upload", "lzw", "transform", "status"]
    np.testing.assert_array_equal(out[0].numpy(), _pil_rgba(buf))
