"""K12's design (`csrc/png_filter.cu`) as a numpy model of its word
arithmetic and its decomposition, held bit for bit to the port's plain
version (`filter_batch_plain`) and to the reference's `filter_batch`
(JAX on the CPU).

The model follows the kernel step by step: SWAR on 32-bit words (the
borrow-free byte subtraction `sub_bytes` and compare `ge_top`,
`__vabsdiffu4`, the byte mask of PRMT 0xba98, the floor average,
`__funnelshift_r[c]`),
each checked against its definition over every byte pair or on random
words; Paeth without a 9-bit |a + b - 2c| (same signs of a - c and b - c:
a where |b - c| <= |a - c|, else b; opposite: a where 2|b - c| <= |a - c|,
b where 2|a - c| <= |b - c|, else c), checked over every byte triple;
the |int8| cost as `__vsadu4` of the bytes' magnitudes; the plan (`plan_of`, the
host planner's rule); each band of 8 rows and the row above it staged as
the aligned 16-byte words that cover them, at the rows' own byte shifts,
into slots whose other bytes are garbage; column chunks with their
16-byte halo; a lane per 32-bit word, lanes past a chunk reading the
chunk's last word; the previous word by a shuffle, recomputed before a
chunk; each residual word stored at its stream row's alignment, whole
words as 32-bit stores and the row's edge bytes and type byte one by
one, into output memory poisoned with a sentinel where every byte's
stores are counted (each exactly once).
"""
import numpy as np
import pytest
import torch

from picha_tpu.ops.png_filter_tpu import filter_batch as ref_filter_batch

from picha_tpu_torch.ops.png_filter import filter_batch_plain, filter_streams

FULL = np.uint32(0xFFFFFFFF)
HALO, PAD, BAND = 16, 64, 8
BUDGET = (BAND + 1) * 1408 + 16        # bytes a block stages at most


# -- the intrinsics ----------------------------------------------------------

def _b(w):
    w = np.asarray(w, np.uint32)
    return np.stack([(w >> np.uint32(8 * t)) & np.uint32(0xFF)
                     for t in range(4)], -1).astype(np.int64)


def _w(b):
    b = np.asarray(b, np.int64) & 0xFF
    return (b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
            | (b[..., 3] << 24)).astype(np.uint32)


def vabsdiffu4(a, b):
    return _w(np.abs(_b(a) - _b(b)))


def funnelshift_r(lo, hi, sh, clamp=False):
    sh = np.asarray(sh, np.int64)
    sh = np.minimum(sh, 32) if clamp else sh & 31
    v = (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo,
                                                                  np.uint64)
    return ((v >> sh.astype(np.uint64)) & np.uint64(0xFFFFFFFF)).astype(
        np.uint32)


HI = np.uint32(0x80808080)
LOW7 = np.uint32(0x7F7F7F7F)


def ge_top(y, x):
    """The kernel's borrow-free byte compare: each byte's top bit set
    where y >= x (unsigned)."""
    y, x = np.asarray(y, np.uint32), np.asarray(x, np.uint32)
    t = ((y | HI).astype(np.uint64) - (x & ~HI).astype(np.uint64)).astype(
        np.uint32)
    return ((y & ~x) | (~(x ^ y) & t)) & HI


def byte_mask(top):
    """PRMT 0xba98 against 0: each byte's top bit spread over the byte."""
    return _w(np.where(_b(top) & 0x80, 0xFF, 0))


def paeth(a, b, c):
    pa = vabsdiffu4(b, c)
    pb = vabsdiffu4(a, c)
    same = ~(ge_top(a, c) ^ ge_top(b, c)) & HI
    c1 = ge_top(pb, pa)
    c2 = ge_top((pb >> np.uint32(1)) & LOW7, pa)
    c3 = ge_top((pa >> np.uint32(1)) & LOW7, pb)
    ma = byte_mask((same & c1) | (~same & c2))
    mb = byte_mask((same & ~c1 & HI) | (~same & c3))
    return (a & ma) | (b & mb) | (c & ~(ma | mb))


def average(a, b):
    return (a & b) + (((a ^ b) >> np.uint32(1)) & LOW7)


def predict(f, a, b, c):
    return [lambda: np.zeros_like(a), lambda: a, lambda: b,
            lambda: average(a, b), lambda: paeth(a, b, c)][f]()


def sub_bytes(x, y):
    """(x - y) & 0xff a byte: a borrow-free subtraction of the low 7 bits,
    the top bit fixed up."""
    x, y = np.asarray(x, np.uint32), np.asarray(y, np.uint32)
    t = ((x | HI).astype(np.uint64) - (y & LOW7).astype(np.uint64)).astype(
        np.uint32)
    return t ^ ((x ^ ~y) & HI)


def cost_of(r, valid):
    """__vsadu4 of the bytes' magnitudes min(v, 256 - v) that `valid`
    keeps: the |int8| sum."""
    r = np.asarray(r, np.uint32)
    neg = byte_mask(r & HI)
    mag = (sub_bytes(np.uint32(0), r) & neg) | (r & ~neg)
    return _b(mag & valid).sum(-1).astype(np.uint32)


# -- the plan ----------------------------------------------------------------

def plan_of(rb, budget=BUDGET):
    """The host planner's rule (`plan_of` in csrc/png_filter.cu): bands of
    8 rows, the chunk from the `budget` bytes a block stages."""
    words = (rb + 2) // 4 + 1
    need = -(-4 * words // 128) * 128
    slots = BAND + 1
    if slots * (need + PAD) + 16 <= budget:
        chunk, nchunks = need, 1
    else:
        cmax = ((budget - 16) // slots - PAD) // 128 * 128
        nchunks = -(-need // cmax)
        chunk = -(-(-(-need // nchunks)) // 128) * 128
    pitch = chunk + PAD
    return dict(band=BAND, chunk=chunk, nchunks=nchunks, pitch=pitch,
                smem=slots * pitch + 16, words=words)


# -- the kernel --------------------------------------------------------------

class Memory:
    """Global memory as a byte array: the rows at byte `src_off`, the
    streams at `out_off`, `stride` bytes apart; the output poisoned with
    a sentinel and every byte's stores counted."""

    def __init__(self, rows, streams, src_off, out_off, gap, seed):
        n, h, rb = rows.shape
        self.src = np.zeros(src_off + rows.size + 32, np.uint8)
        self.src[src_off:src_off + rows.size] = rows.reshape(-1)
        self.src_off = src_off
        self.stride = n * h * (rb + 1) + gap
        self.out_off = out_off
        size = out_off + streams * self.stride + 32
        self.out = np.random.default_rng(seed).integers(0, 256, size,
                                                        np.uint8)
        self.stores = np.zeros(size, np.int64)

    def store(self, addr, values):
        addr = np.asarray(addr, np.int64)
        self.out[addr] = np.asarray(values, np.int64) & 0xFF
        np.add.at(self.stores, addr, 1)

    def stream(self, j, shape):
        n, h, rb = shape
        a = self.out_off + j * self.stride
        return (self.out[a:a + n * h * (rb + 1)].reshape(n, h, rb + 1),
                self.stores[a:a + n * h * (rb + 1)].reshape(n, h, rb + 1))


def ld_word(smem, q):
    q = np.asarray(q, np.int64)
    w = smem.view(np.uint32)
    return funnelshift_r(w[(q & ~3) // 4], w[(q & ~3) // 4 + 1],
                         (q & 3) * 8)


def stage(mem, smem, r0, nr, rb, c0, pl, rng):
    smem[:] = rng.integers(0, 256, smem.size, np.uint8)    # stale bytes
    off0 = max(c0 - HALO, 0)
    end = min(c0 + pl["chunk"], rb)
    wpr = (end - off0 + 15) // 16 + 1
    for t in range(0 if r0 > 0 else 1, nr + 1):
        g = mem.src_off + (r0 - 1 + t) * rb + off0
        d = g & 15
        for w in range(wpr):
            if 16 * w < d + (end - off0):
                dst = 16 + t * pl["pitch"] + 16 * w
                smem[dst:dst + 16] = mem.src[g - d + 16 * w:g - d + 16 * w
                                             + 16]


class Row:
    """One band row's view of the staged chunk (`view_of`, `RowView`)."""

    def __init__(self, smem, mem, r0, i, h, rb, bpp, c0, pl):
        off0 = max(c0 - HALO, 0)
        gr = r0 + i
        d = (mem.src_off + gr * rb + off0) & 15
        du = (mem.src_off + (gr - 1) * rb + off0) & 15
        self.smem, self.bpp = smem, bpp
        self.base = 16 + (i + 1) * pl["pitch"] + d - off0
        self.up_base = 16 + i * pl["pitch"] + du - off0
        self.up = np.uint32(0) if gr % h == 0 else FULL

    def words(self, col):
        col = np.asarray(col, np.int64)
        k = self.bpp - col
        left = np.where(k <= 0, FULL, np.where(
            k >= 4, np.uint32(0),
            (np.uint64(0xFFFFFFFF) << (8 * np.clip(k, 0, 3)).astype(
                np.uint64)).astype(np.uint32)))
        x = ld_word(self.smem, self.base + col)
        a = ld_word(self.smem, self.base + col - self.bpp) & left
        b = ld_word(self.smem, self.up_base + col) & self.up
        c = ld_word(self.smem, self.up_base + col - self.bpp) & left & self.up
        return x, a, b, c

    def residual(self, f, col):
        x, a, b, c = self.words(col)
        return sub_bytes(x, predict(f, a, b, c))


def emit(mem, dst, m, rb, prev, r):
    """Residual words m (lanes) of a row whose first residual byte is at
    address dst."""
    s = dst & 3
    v = funnelshift_r(prev, r, 8 * (4 - s), clamp=True)
    vb = _b(v)
    for lane in range(len(m)):
        i0 = 4 * int(m[lane]) - s
        t = np.arange(4)
        keep = (i0 + t >= 0) & (i0 + t < rb)
        if keep.all():
            assert (dst + i0) % 4 == 0     # an aligned 32-bit store
        mem.store(dst + i0 + t[keep], vb[lane][keep])


def k12_model(rows, bpp, strategies, pl, src_off=0, out_off=0, gap=0,
              seed=0):
    """K12's launch over (n, h, rb) rows: the streams as the kernel
    writes them, and each output byte's store count."""
    n, h, rb = rows.shape
    total = n * h
    mem = Memory(rows, len(strategies), src_off, out_off, gap, seed)
    rng = np.random.default_rng(seed + 1)
    smem = np.zeros(pl["smem"] + 8, np.uint8)
    cw = pl["chunk"] // 4
    adaptive = -1 in strategies
    lanes = np.arange(32)
    for r0 in range(0, total, pl["band"]):
        nr = min(pl["band"], total - r0)
        costs = np.zeros((nr, 5), np.int64)

        def row_dst(j, i):
            return (mem.out_off + j * mem.stride + (r0 + i) * (rb + 1))

        for ch in range(pl["nchunks"]):
            c0 = ch * pl["chunk"]
            stage(mem, smem, r0, nr, rb, c0, pl, rng)
            k0, k1 = ch * cw, min(ch * cw + cw, pl["words"])
            for i in range(nr):
                v = Row(smem, mem, r0, i, h, rb, bpp, c0, pl)
                carry = [v.residual(f, 4 * (k0 - 1)) if f >= 0 and k0 > 0
                         else np.uint32(0) for f in strategies]
                cost = np.zeros(5, np.int64)
                for kb in range(k0, k1, 32):
                    k = kb + lanes
                    x, a, b, c = v.words(4 * np.minimum(k, k1 - 1))
                    res = [sub_bytes(x, predict(f, a, b, c)) for f in range(5)]
                    left = np.where(k < k1, rb - 4 * k, 0)
                    valid = np.where(
                        left >= 4, FULL, np.where(
                            left <= 0, np.uint32(0),
                            (np.uint64(0xFFFFFFFF) >> (8 * (4 - np.clip(
                                left, 1, 3))).astype(np.uint64)).astype(
                                np.uint32)))
                    if adaptive:
                        cost += [int(cost_of(res[f], valid).sum())
                                 for f in range(5)]
                    for j, f in enumerate(strategies):
                        if f < 0:
                            continue
                        r = res[f]
                        prev = np.roll(r, 1)
                        prev[0] = carry[j]
                        carry[j] = r[31]
                        emit(mem, row_dst(j, i) + 1, k[k < k1], rb,
                             prev[k < k1], r[k < k1])
                        if kb == 0:
                            mem.store([row_dst(j, i)], [f])
                costs[i] += cost
        if not adaptive:
            continue
        for ch in range(pl["nchunks"]):
            c0 = ch * pl["chunk"]
            if pl["nchunks"] > 1:
                stage(mem, smem, r0, nr, rb, c0, pl, rng)
            k0, k1 = ch * cw, min(ch * cw + cw, pl["words"])
            for i in range(nr):
                best = int(np.argmin(costs[i]))     # the first minimum
                v = Row(smem, mem, r0, i, h, rb, bpp, c0, pl)
                carry = v.residual(best, 4 * (k0 - 1)) if k0 > 0 else \
                    np.uint32(0)
                for kb in range(k0, k1, 32):
                    k = kb + lanes
                    r = v.residual(best, 4 * np.minimum(k, k1 - 1))
                    prev = np.roll(r, 1)
                    prev[0] = carry
                    carry = r[31]
                    for j, f in enumerate(strategies):
                        if f != -1:
                            continue
                        emit(mem, row_dst(j, i) + 1, k[k < k1], rb,
                             prev[k < k1], r[k < k1])
                        if kb == 0:
                            mem.store([row_dst(j, i)], [best])
    outs = [mem.stream(j, rows.shape) for j in range(len(strategies))]
    return (np.stack([o for o, _ in outs]), np.stack([c for _, c in outs]))


def _rows(n, h, rb, seed, kind="random"):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, (n, h, rb), np.uint8)
    if kind == "ties":          # a small alphabet: many equal costs
        return rng.choice(np.array([0, 1, 128, 255], np.uint8), (n, h, rb))
    # photo-like: slow waves with a little noise
    yy, xx = np.mgrid[0:h, 0:rb].astype(np.float32)
    img = 128 + 60 * np.sin(xx / 11 + yy / 7)[None] + rng.normal(
        0, 2, (n, h, rb))
    return np.clip(img, 0, 255).astype(np.uint8)


def _check(rows, bpp, strategies, pl, **kw):
    got, stores = k12_model(rows, bpp, strategies, pl, **kw)
    want = filter_streams(torch.from_numpy(rows), bpp, strategies).numpy()
    np.testing.assert_array_equal(got, want)
    assert (stores == 1).all()
    for j, s in enumerate(strategies):
        np.testing.assert_array_equal(
            want[j], filter_batch_plain(torch.from_numpy(rows), bpp,
                                        s).numpy())
    return got


# -- the word arithmetic -----------------------------------------------------

def _paeth_bytes(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def test_byte_subtraction_every_pair():
    """sub_bytes: (x - y) & 0xff in every byte, for every byte pair in
    every byte position of a word (the other bytes random)."""
    x, y = (v.reshape(-1) for v in np.meshgrid(np.arange(256),
                                               np.arange(256),
                                               indexing="ij"))
    rng = np.random.default_rng(3)
    for pos in range(4):
        xb = rng.integers(0, 256, (x.size, 4))
        yb = rng.integers(0, 256, (x.size, 4))
        xb[:, pos], yb[:, pos] = x, y
        np.testing.assert_array_equal(_b(sub_bytes(_w(xb), _w(yb))),
                                      (xb - yb) & 0xFF)


def test_byte_compare_every_pair():
    """ge_top and byte_mask: 0xff exactly where y >= x, for every byte
    pair in every byte position of a word (the other bytes random)."""
    y, x = (v.reshape(-1) for v in np.meshgrid(np.arange(256),
                                               np.arange(256),
                                               indexing="ij"))
    rng = np.random.default_rng(2)
    for pos in range(4):
        yb = rng.integers(0, 256, (y.size, 4))
        xb = rng.integers(0, 256, (y.size, 4))
        yb[:, pos], xb[:, pos] = y, x
        got = _b(byte_mask(ge_top(_w(yb), _w(xb))))
        np.testing.assert_array_equal(got, np.where(yb >= xb, 0xFF, 0))


def test_paeth_rule_every_byte_triple():
    """The kernel's rule on bytes: with u = a - c and v = b - c, a where
    |v| <= |u| and b otherwise when they share a sign (a >= c and b >= c
    alike); else a where 2|v| <= |u|, b where 2|u| <= |v|, else c; for
    all 256^3 (a, b, c)."""
    a, b, c = (v.reshape(-1).astype(np.int16) for v in np.meshgrid(
        np.arange(256), np.arange(256), np.arange(256), indexing="ij"))
    pa, pb = np.abs(b - c), np.abs(a - c)
    same = (a >= c) == (b >= c)
    sa = np.where(same, pa <= pb, pa <= pb // 2)
    sb = np.where(same, pa > pb, pb <= pa // 2)
    got = np.where(sa, a, np.where(sb, b, c))
    np.testing.assert_array_equal(got, _paeth_bytes(a, b, c))


def test_paeth_words():
    """Paeth on 32-bit words equals the byte rule in every byte position:
    random triples and the extremes."""
    rng = np.random.default_rng(1)
    trip = rng.integers(0, 256, (3, 1 << 18, 4))
    ext = np.array([0, 1, 2, 127, 128, 129, 254, 255])
    grid = np.stack(np.meshgrid(ext, ext, ext, indexing="ij")).reshape(3, -1)
    grid = np.pad(grid, ((0, 0), (0, (-grid.shape[1]) % 4))).reshape(3, -1,
                                                                      4)
    for a, b, c in (trip, grid, np.roll(grid, 1, -1)):
        got = _b(paeth(_w(a), _w(b), _w(c)))
        np.testing.assert_array_equal(got, _paeth_bytes(a, b, c))


def test_average_sub_and_cost_words():
    rng = np.random.default_rng(0)
    x, a, b = (rng.integers(0, 2**32, 4096, np.uint64).astype(np.uint32)
               for _ in range(3))
    np.testing.assert_array_equal(_b(average(a, b)), (_b(a) + _b(b)) >> 1)
    np.testing.assert_array_equal(_b(sub_bytes(x, a)), (_b(x) - _b(a)) & 0xFF)
    v = _b(x)
    np.testing.assert_array_equal(cost_of(x, FULL),
                                  np.minimum(v, 256 - v).sum(-1))
    # -128 costs 128, 0 costs 0, and the mask drops bytes past the row
    assert int(cost_of(np.uint32(0x80808080), FULL)) == 4 * 128
    assert int(cost_of(np.uint32(0x00000080), FULL)) == 128
    assert int(cost_of(np.uint32(0x80FF0101), np.uint32(0x0000FFFF))) == 2
    assert int(cost_of(np.uint32(0), FULL)) == 0


def test_funnel_shift_of_the_stored_word():
    """The stored word at alignment s: the top s bytes of the previous
    residual word, then the low 4 - s bytes of this one (s = 0: this
    word, through the clamped shift)."""
    prev, r = np.uint32(0x44332211), np.uint32(0x88776655)
    assert funnelshift_r(prev, r, 32, clamp=True) == r
    assert funnelshift_r(prev, r, 24, clamp=True) == 0x77665544
    assert funnelshift_r(prev, r, 16, clamp=True) == 0x66554433
    assert funnelshift_r(prev, r, 8, clamp=True) == 0x55443322


# -- the plan ----------------------------------------------------------------

@pytest.mark.parametrize("rb, want", [
    (704, dict(chunk=768, nchunks=1)),       # config 4
    (5760, dict(chunk=1280, nchunks=5)),     # 1080p RGB8
    (15360, dict(chunk=1280, nchunks=13)),   # 16-bit RGBA 1920 wide
    (10, dict(chunk=128, nchunks=1)),
])
def test_plan(rb, want):
    """Bands of 8 rows, one chunk while nine rows fit the staging."""
    pl = plan_of(rb)
    assert {k: pl[k] for k in want} == want
    assert pl["nchunks"] * pl["chunk"] >= 4 * pl["words"]
    assert pl["smem"] <= BUDGET


# -- the decomposition against the plain version and the reference -----------

@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_bands_every_bpp(bpp):
    """Odd widths (rb no multiple of 4 or 16), three images of 5 rows in
    bands of 8 (bands across image boundaries), rows at byte offset 3,
    streams at offsets 1 and a stride that shifts each stream's
    alignment."""
    rows = _rows(3, 5, 7 * bpp + 3, seed=bpp)
    pl = plan_of(rows.shape[2])
    got = _check(rows, bpp, (2, 1, -1, 0, 3, 4), pl, src_off=3, out_off=1,
                 gap=3)
    want = [np.asarray(ref_filter_batch(rows, bpp, s)) for s in
            (2, 1, -1, 0, 3, 4)]
    np.testing.assert_array_equal(got, np.stack(want))


@pytest.mark.parametrize("rb", [1, 2, 3, 4, 5, 8])
def test_rows_no_wider_than_bpp_and_one_row_images(rb):
    """Rows of at most bpp bytes take a = c = 0 throughout; h = 1 takes
    b = c = 0 on every row."""
    rows = _rows(4, 1, rb, seed=rb)
    pl = plan_of(rb)
    _check(rows, 8 if rb <= 8 else 4, (-1, 2, 4), pl, src_off=5, out_off=2)
    rows = _rows(2, 3, rb, seed=rb + 10)
    _check(rows, max(rb, 1), (-1, 1), pl, src_off=15)


@pytest.mark.parametrize("kind", ["ties", "random"])
def test_cost_ties_and_minus_128(kind):
    """A small alphabet (0, 1, 128, 255): rows whose costs tie (the first
    minimum in type order wins) and residuals of exactly -128."""
    rows = _rows(2, 9, 37, seed=5, kind=kind)
    rows[0, 2] = 0                                  # every filter costs 0
    rows[1, 4] = 128                                # 128 - 0: cost 128
    pl = plan_of(37)
    got = _check(rows, 4, (-1,), pl, src_off=1, out_off=3)
    costs = np.stack([np.minimum(v, 256 - v).sum(-1) for v in (
        filter_batch_plain(torch.from_numpy(rows), 4, f).numpy()[..., 1:]
        .astype(np.int64) for f in range(5))])
    ties = (costs == costs.min(0)).sum(0) > 1
    assert ties.any()
    np.testing.assert_array_equal(got[0, ..., 0], costs.argmin(0))
    if kind == "ties":
        assert (filter_batch_plain(torch.from_numpy(rows), 4, 0).numpy()[
            ..., 1:] == 128).any()


def test_chunked_wide_rows():
    """Rows wider than the staging go in column chunks: the adaptive
    costs summed over the chunks, the fixed streams and the adaptive
    pass each crossing the chunks with the previous word recomputed (a
    small budget forces 3 chunks of 128 bytes on 330-byte rows)."""
    rows = _rows(2, 6, 330, seed=9, kind="photo")
    pl = plan_of(330, budget=9 * (128 + PAD) + 16)
    assert pl["nchunks"] == 3 and pl["chunk"] == 128
    _check(rows, 6, (2, 1, -1), pl, src_off=7, out_off=3, gap=1)
    _check(rows, 3, (-1, 4), pl, src_off=0, out_off=0)


def test_config4_like_plan():
    """Config 4's rows (704 bytes, bpp 4) on the card's plan: bands of 8,
    one chunk, 16-byte aligned rows and streams."""
    rows = _rows(2, 20, 704, seed=4, kind="photo")
    pl = plan_of(704)
    got = _check(rows, 4, (2, 1, -1), pl)
    np.testing.assert_array_equal(
        got[2], np.asarray(ref_filter_batch(rows, 4, -1)))
