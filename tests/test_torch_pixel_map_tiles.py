"""A numpy model of K11's design (`csrc/pixel_map.cu`: pixel_map_rows)
held bit for bit to the port's plain `pixel_map_plain` (itself held to
the reference by tests/test_torch_pixels.py) and to the reference's
`_jit_convert`, `junpack_f32` and `jpack` on JAX-CPU.

The model runs the kernel's decomposition on byte buffers: the host plan
(`colorconvert.map_plan`: the window cut into segments, chunks of a
segment or several whole segments an item), each item's rows staged from
the aligned 16-byte words that cover them (the input at any byte offset
in a buffer whose other bytes are garbage), a pixel a thread from the
staged bytes (uint8 and uint16 by the reciprocal of 255 or 65535 with
one FMA correction, emulated exactly here), the
output staged and stored as the bytes before the first whole word, whole
16-byte words and the bytes after the last, into an output buffer of
sentinel bytes at any offset: every output byte must be written exactly
once and no other byte touched. The threads' walk (row and column
advanced by increments, no division a pixel) is checked against the
division it replaces. Nothing here calls picha_tpu/native."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picha_tpu.ops import colorconvert as ref_cc
from picha_tpu.pixels import jpack, junpack_f32
from picha_tpu_torch.ops.colorconvert import (map_plan, normalize_weights,
                                              pixel_map_plain, row_words)
from picha_tpu_torch.pixels import unpack_f32
from torch_helpers import K11_LIMITS

THREADS = 256
SENTINEL = 0xA5
# limits smaller than the kernel's: 1 KB chunks, 8 segments an item
SMALL_LIMITS = (1280, 1040, 8, 1024)


# --- the model ------------------------------------------------------------------

def fma32(a, b, c):
    """float32 fma(a, b, c) on arrays: a * b is exact in float64, and the
    float64 sum's error (TwoSum) decides the float32 rounding where the
    float64 sum lies exactly halfway between two floats."""
    p = a.astype(np.float64) * b.astype(np.float64)
    s = p + c.astype(np.float64)
    bb = s - p
    err = (p - (s - bb)) + (c.astype(np.float64) - bb)
    r = s.astype(np.float32)
    up = np.nextafter(r, np.float32(np.inf))
    down = np.nextafter(r, np.float32(-np.inf))
    other = np.where(s > r, up, down)
    mid = (r.astype(np.float64) + other.astype(np.float64)) / 2 == s
    toward = np.where((err > 0) == (other > r), other, r)
    return np.where(mid & (err != 0), toward, r)


def unpack_int(v):
    """The kernel's uint8 / uint16 unpack: q = v * r, then q + (v - q *
    MAX) * r by two FMAs (r = 1 / MAX rounded)."""
    m = np.float32(np.iinfo(v.dtype).max)
    r = np.float32(1) / m
    f = v.astype(np.float32)
    q = f * r
    rem = fma32(-q, np.full_like(q, m), f)
    return fma32(rem, np.full_like(q, r), q)


def map_np(t, sc, dc, weights):
    """The reference's channel table on float32 (..., sc), in its order."""
    if sc == dc:
        return t
    wr, wg, wb = (np.float32(w) for w in weights)
    one = np.ones_like(t[..., :1])
    if sc <= 2:
        a = t[..., 1:2] if sc == 2 else one
        g = t[..., :1]
        parts = {1: [g], 2: [g, a], 3: [g, g, g], 4: [g, g, g, a]}[dc]
    else:
        a = t[..., 3:4] if sc == 4 else one
        y = ((t[..., 0] * wr + t[..., 1] * wg) + t[..., 2] * wb)[..., None]
        parts = {1: [y], 2: [y, a], 3: [t[..., :3]],
                 4: [t[..., :3], a]}[dc]
    return np.concatenate(parts, -1)


def store_np(o, out_dtype, clip):
    if out_dtype == np.float32:
        return np.fmin(np.fmax(o, np.float32(0)), np.float32(1)) if clip \
            else o
    m = np.float32(np.iinfo(out_dtype).max)
    s = np.fmin(np.fmax(o * m + np.float32(0.5), np.float32(0)), m)
    return np.floor(s).astype(out_dtype)


def item_of(p, item):
    q = item // p["cps"]
    s = q * p["rows"]
    c = (item - q * p["cps"]) * p["chunk"]
    return s, c, min(p["rows"], p["segs"] - s), min(p["chunk"],
                                                     p["seg_len"] - c)


def k11_model(x, dc, out_dtype, crop=None, clip=False, weights=None,
              in_off=0, out_off=0, limits=K11_LIMITS):
    """pixel_map_rows on numpy: x (n, h, w, sc) placed `in_off` bytes into
    a buffer of garbage whose start is a 16-byte word, the output `out_off`
    bytes into a buffer of SENTINEL bytes, planned within `limits` ->
    (output array, bytes written a byte of the output buffer, the output
    buffer)."""
    n, h, w, sc = x.shape
    x0, y0, ow, oh = crop or (0, 0, w, h)
    weights = weights or normalize_weights()
    ein, eout = x.dtype.itemsize, np.dtype(out_dtype).itemsize
    bpi, bpo = sc * ein, dc * eout
    stage_in, stage_out, max_rows, _ = limits
    p = map_plan(n, h, w, sc, y0, x0, oh, ow, dc, ein, eout, limits)
    raw = x.reshape(-1).view(np.uint8)
    rng = np.random.default_rng(in_off)
    ibuf = rng.integers(0, 256, -(-(in_off + raw.size) // 16) * 16 + 16,
                        dtype=np.uint8)
    ibuf[in_off:in_off + raw.size] = raw
    nout = n * oh * ow * bpo
    obuf = np.full(out_off + nout + 32, SENTINEL, np.uint8)
    writes = np.zeros(obuf.size, np.int64)
    for item in range(p["items"]):
        s, c, rows, span = item_of(p, item)
        rw = row_words(span, bpi)
        assert rows * rw * 16 <= stage_in and rows <= max_rows
        sin = np.full(rows * rw * 16, 0xEE, np.uint8)
        shifts = []
        for r in range(rows):
            seg = s + r
            img = seg // p["segs_per_img"]
            off = (p["base"] + img * p["img_stride"] + (seg - img *
                   p["segs_per_img"]) * p["row_stride"] + c * sc)
            a = in_off + off * ein
            sh = a & 15
            words = (sh + span * bpi + 15) >> 4
            assert words <= rw
            sin[r * rw * 16:(r * rw + words) * 16] = ibuf[a - sh:
                                                          a - sh + 16 * words]
            shifts.append(sh)
        # a pixel a thread from the staged bytes
        px_bytes = np.stack([sin[r * rw * 16 + shifts[r]:
                                 r * rw * 16 + shifts[r] + span * bpi]
                             for r in range(rows)]).reshape(-1)
        v = px_bytes.view(x.dtype).reshape(rows * span, sc)
        t = v if x.dtype == np.float32 else unpack_int(v)
        o = store_np(map_np(t, sc, dc, weights), out_dtype, clip)
        ob = out_off + (s * p["seg_len"] + c) * bpo
        oshift = ob & 15
        nb = rows * span * bpo
        assert oshift + nb <= stage_out
        sout = np.full(stage_out, 0xEE, np.uint8)
        sout[oshift:oshift + nb] = np.ascontiguousarray(o).reshape(
            -1).view(np.uint8)
        # head bytes, whole words, tail bytes
        a = ob + ((16 - oshift) & 15)
        e = (ob + nb) & ~15
        if a >= e:
            a = e = ob + nb
        head, tail = a - ob, ob + nb - e
        assert head <= 30 and tail <= 15
        obuf[ob:a] = sout[oshift:oshift + head]
        writes[ob:a] += 1
        for q in range(a, e, 16):
            assert q % 16 == 0
            obuf[q:q + 16] = sout[oshift + q - ob:oshift + q - ob + 16]
            writes[q:q + 16] += 1
        obuf[e:ob + nb] = sout[oshift + e - ob:oshift + nb]
        writes[e:ob + nb] += 1
    got = obuf[out_off:out_off + nout].copy().view(out_dtype).reshape(
        n, oh, ow, dc)
    return got, writes, obuf


def plain(x, dc, out_dtype, crop=None, clip=False, weights=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    odt = {np.uint8: torch.uint8, np.uint16: torch.uint16,
           np.float32: torch.float32}[out_dtype]
    return pixel_map_plain(t, dc, odt, crop, clip, weights).numpy()


def check(x, dc, out_dtype, crop=None, clip=False, weights=None, in_off=0,
          out_off=0, limits=K11_LIMITS):
    got, writes, obuf = k11_model(x, dc, out_dtype, crop, clip, weights,
                                  in_off, out_off, limits)
    nout = got.nbytes
    assert (writes[out_off:out_off + nout] == 1).all(), \
        "an output byte not written exactly once"
    assert not writes[:out_off].any() and not writes[out_off + nout:].any()
    assert (obuf[:out_off] == SENTINEL).all()
    assert (obuf[out_off + nout:] == SENTINEL).all()
    want = plain(x, dc, out_dtype, crop, clip, weights)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    return got


def pixels(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return (rng.random(shape, dtype=np.float32) * np.float32(1.3)
                - np.float32(0.15))
    return rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)


# --- the tests ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_reciprocal_is_unpack_f32_on_every_value(dtype):
    """The kernel's unpack equals the plain version's and the reference's
    IEEE v / MAX on every uint8 and uint16 value, where the product by the
    reciprocal alone does not."""
    v = np.arange(np.iinfo(dtype).max + 1).astype(dtype)
    want = unpack_f32(torch.from_numpy(v)).numpy()
    got = unpack_int(v)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    ref = np.asarray(junpack_f32(jnp.asarray(v)))
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))
    r = np.float32(1) / np.float32(np.iinfo(dtype).max)
    assert not np.array_equal((v.astype(np.float32) * r).view(np.int32),
                              want.view(np.int32)), \
        "the product alone is already exact: the correction is untested"


@pytest.mark.parametrize("rows", [1, 2, 7, 64])
@pytest.mark.parametrize("span", [1, 2, 3, 5, 9, 31, 255, 256, 257, 352,
                                  1000, 4096])
def test_thread_walk_is_the_division(rows, span):
    """Each thread's (row, column) advanced by 256 pixels a step through
    the increments the kernel uses equals divmod(pixel, span): every
    pixel of an item once, in the thread the division names."""
    total = rows * span
    seen = np.zeros(total, np.int64)
    dr, dp = THREADS // span, THREADS % span
    for t in range(min(THREADS, total)):
        r, px = t // span, t % span
        for q in range(t, total, THREADS):
            assert (r, px) == divmod(q, span)
            seen[q] += 1
            px += dp
            r += dr
            if px >= span:
                px -= span
                r += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("shape,crop", [
    ((16, 1088, 1920, 4), None), ((256, 256, 384, 4), (16, 16, 352, 224)),
    ((256, 112, 176, 4), None), ((16, 1088, 1920, 3), None),
    ((3, 37, 45, 2), (3, 5, 9, 7)), ((2, 9, 4000, 1), (1, 2, 3999, 3)),
    ((2, 30, 50, 4), (0, 4, 50, 20)), ((1, 1, 1, 1), None)])
@pytest.mark.parametrize("sizes", [(1, 1, 2), (2, 2, 1), (1, 4, 4), (4, 1, 4),
                                   (2, 4, 3)])
@pytest.mark.parametrize("limits", [K11_LIMITS, SMALL_LIMITS],
                         ids=["kernel", "small"])
def test_plan_covers_the_window(shape, crop, sizes, limits):
    """map_plan's items cover every window pixel once, in segments whose
    input offsets are the window's rows, within the staged buffers: the
    kernel's and smaller ones."""
    n, h, w, sc = shape
    x0, y0, ow, oh = crop or (0, 0, w, h)
    ein, eout, dc = sizes
    stage_in, stage_out, max_rows, chunk_bytes = limits
    p = map_plan(n, h, w, sc, y0, x0, oh, ow, dc, ein, eout, limits)
    assert p["chunk"] % 16 == 0 and p["rows"] <= max_rows
    assert p["chunk"] * max(sc * ein, dc * eout) <= chunk_bytes
    count = 0
    for item in range(p["items"]):
        s, c, rows, span = item_of(p, item)
        assert rows >= 1 and span >= 1 and c + span <= p["seg_len"]
        assert rows * row_words(span, sc * ein) * 16 <= stage_in
        assert rows * span * dc * eout + 15 <= stage_out
        count += rows * span
        if p["items"] > 4096 and item > 64:
            break
    if p["items"] <= 4096:
        assert count == n * oh * ow
    assert p["seg_len"] * p["segs"] == n * oh * ow
    # the segments' first pixels are the window's rows' (or images')
    for seg in (0, p["segs"] - 1):
        img = seg // p["segs_per_img"]
        off = p["base"] + img * p["img_stride"] + (
            seg - img * p["segs_per_img"]) * p["row_stride"]
        first = seg * p["seg_len"]
        i, rest = divmod(first, oh * ow)
        yy, xx = divmod(rest, ow)
        assert off == ((i * h + y0 + yy) * w + x0 + xx) * sc


DTYPES = [np.uint8, np.uint16, np.float32]


def outputs_of(in_dtype):
    """(out dtype, clip) K11 writes from an input type."""
    if in_dtype == np.float32:
        return [(np.uint8, False), (np.uint16, False), (np.float32, False),
                (np.float32, True)]
    return [(np.uint8, False), (np.uint16, False), (np.float32, False)]


@pytest.mark.parametrize("dc", [1, 2, 3, 4])
@pytest.mark.parametrize("sc", [1, 2, 3, 4])
@pytest.mark.parametrize("in_dtype", DTYPES)
def test_model_matches_plain(in_dtype, sc, dc):
    """Every channel pair from uint8, uint16 and float32 to every output
    (pack, raw, clip): a crop at odd x0 (short rows, several an item),
    the whole frame (one segment in chunks), full rows (a segment an
    image), each at input and output byte offsets."""
    x = pixels(in_dtype, (2, 9, 37, sc), seed=sc * 10 + dc)
    ein = np.dtype(in_dtype).itemsize
    for j, (odt, clip) in enumerate(outputs_of(in_dtype)):
        eout = np.dtype(odt).itemsize
        for k, crop in enumerate([(3, 1, 29, 6), None, (0, 2, 37, 5)]):
            check(x, dc, odt, crop, clip, in_off=ein * ((j + k + sc) % 7),
                  out_off=eout * ((j * 3 + k + dc) % 9))


@pytest.mark.parametrize("offset", range(16))
def test_covering_words_at_every_byte_offset(offset):
    """rgba uint8 at input byte offsets 0-15 and greya written at output
    offsets 15-0, a crop at odd x0: the covering words and the stores
    at every shift."""
    x = pixels(np.uint8, (3, 11, 41, 4), seed=offset)
    check(x, 2, np.uint8, (5, 3, 33, 7), in_off=offset,
          out_off=15 - offset)
    check(x, 4, np.float32, (1, 0, 40, 11), in_off=offset,
          out_off=4 * (offset % 4))


@pytest.mark.parametrize("case", ["one_pixel", "short_row", "one_word",
                                  "word_and_a_byte"])
def test_tails_shorter_than_a_word(case):
    """Outputs of 2-17 bytes: no whole word (every byte stored singly),
    one word, a word and a byte, at odd offsets."""
    shape, dc, crop, out_off = {
        "one_pixel": ((1, 1, 1, 4), 2, None, 5),
        "short_row": ((1, 2, 9, 3), 1, (2, 1, 5, 1), 7),
        "one_word": ((1, 1, 8, 4), 2, None, 0),
        "word_and_a_byte": ((1, 3, 17, 1), 1, (0, 2, 17, 1), 3)}[case]
    x = pixels(np.uint8, shape, seed=len(case))
    check(x, dc, np.uint8, crop, out_off=out_off)


def test_chunks_of_one_segment_and_many_rows_an_item():
    """The whole frame past a chunk (two chunks of one segment, the last
    shorter), and 9-pixel crop rows, 64 a item."""
    x = pixels(np.uint8, (2, 40, 60, 4), seed=3)
    p = map_plan(2, 40, 60, 4, 0, 0, 40, 60, 2, 1, 1, K11_LIMITS)
    assert p["rows"] == 1 and p["cps"] == 2
    check(x, 2, np.uint8, in_off=3, out_off=1)
    y = pixels(np.uint16, (3, 40, 30, 3), seed=4)
    p = map_plan(3, 40, 30, 3, 1, 7, 38, 9, 1, 2, 2, K11_LIMITS)
    assert p["rows"] == K11_LIMITS[2] and p["items"] == 2
    check(y, 1, np.uint16, (7, 1, 9, 38), in_off=2, out_off=6)
    # smaller limits: 1 KB chunks (rows of 60 rgba pixels past one), 8
    # crop rows an item
    check(x, 2, np.uint8, in_off=5, out_off=3, limits=SMALL_LIMITS)
    p = map_plan(3, 40, 30, 3, 1, 7, 38, 9, 1, 2, 2, SMALL_LIMITS)
    assert p["rows"] == SMALL_LIMITS[2] and p["items"] == 15
    check(y, 1, np.uint16, (7, 1, 9, 38), in_off=2, out_off=6,
          limits=SMALL_LIMITS)


def test_given_weights():
    x = pixels(np.uint8, (2, 6, 20, 3), seed=9)
    w = normalize_weights(2, 5, 1)
    check(x, 1, np.uint8, (1, 1, 17, 4), weights=w, in_off=1)


@pytest.mark.parametrize("src,dst", [("rgba", "greya"), ("r16g16b16a16", "r16"),
                                     ("rgb", "r16g16b16a16"), ("greya", "rgb"),
                                     ("r16g16", "rgba")])
def test_model_matches_reference_convert(src, dst):
    """The reference's jitted `convert_batch` (`_jit_convert`) on the same
    pixels: exact at the default weights."""
    from picha_tpu.pixels import PIXEL_FORMATS

    sf, df = PIXEL_FORMATS[src], PIXEL_FORMATS[dst]
    x = pixels(np.dtype(sf.dtype).type, (2, 7, 19, sf.channels),
               seed=len(src + dst))
    got = check(x, df.channels, np.dtype(df.dtype).type, in_off=3,
                out_off=5)
    want = np.asarray(ref_cc.convert_batch(x, src, dst))
    np.testing.assert_array_equal(got, want)


def test_model_matches_reference_head_and_tail():
    """Config 4's head (junpack_f32 of the crop window) and tail (jpack of
    overshooting floats) on JAX-CPU."""
    x = pixels(np.uint8, (2, 16, 24, 4), seed=21)
    head = check(x, 4, np.float32, (3, 2, 17, 9), in_off=9, out_off=4)
    want = np.asarray(junpack_f32(jnp.asarray(x[:, 2:11, 3:20])))
    assert np.array_equal(head.view(np.int32), want.view(np.int32))
    f = pixels(np.float32, (2, 5, 13, 4), seed=22)
    tail = check(f, 4, np.uint8, in_off=4, out_off=3)
    np.testing.assert_array_equal(tail, np.asarray(jpack(jnp.asarray(f),
                                                         np.uint8)))
    deep = pixels(np.uint16, (1, 4, 9, 3), seed=23)
    got = check(deep, 3, np.float32, in_off=6, out_off=8)
    want = np.asarray(junpack_f32(jnp.asarray(deep)))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
