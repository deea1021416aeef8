"""A numpy model of K13's schedule (`csrc/png_unfilter.cu`, the skewed row
wavefront) held bit for bit to the port's plain unfilter and to the
inverse of the reference's `filter_batch` (JAX on the CPU).

The model runs what the kernel runs, in its order, under plans (chunk
width, warps a block) of the range the kernel's occupancy-driven plan
picks from: block-wide phases in which group g of r = 32 // bpp rows
takes column chunk p - g on warp g mod warps, the staging of each
chunk's residuals and of the row above, a thread (row j, byte lane l) a
byte lane, row j reconstructing pixel s - j at step s with b from row
j - 1's value of the step before (a shuffle up by bpp lanes), c the
previous b, a its own previous value; a group whose rows share one
filter type takes that type's chain (none: no steps; sub: no b), any
other the branch-free predictor; a type byte > 4 sets the status and
runs as type 0. It checks every read
against the writes: a value read from device memory was written in an
earlier phase (a __syncthreads() lies between), no location is read and
written in one phase, a shuffled value is the source lane's pixel of the
step before, every output byte is written exactly once, and the output
starts as a sentinel so that a byte no step writes shows.
Nothing here calls picha_tpu/native."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from picha_tpu.ops.png_filter_tpu import filter_batch as ref_filter_batch

from picha_tpu_torch.ops.png_filter import filter_batch_plain
from picha_tpu_torch.ops.png_unfilter import png_unfilter_plain

MAX_WARPS, CHUNKS = 32, (8, 16, 32, 64)      # csrc/png_unfilter.cu
SENTINEL = -1
# (warps a block, chunk width): the kernel's plan picks among these by
# the card's occupancy; 1 and 2 warps make tall images wrap around
PLANS = [(1, 8), (2, 8), (4, 16), (MAX_WARPS, 64)]


def _predict(t, a, b, c):
    """The kernel's branch-free predictor, elementwise."""
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pp = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    ma = np.where((t == 1) | (t == 3), -1, 0)
    mb = np.where((t == 2) | (t == 3), -1, 0)
    lin = ((a & ma) + (b & mb)) >> (t == 3).astype(np.int64)
    return np.where(t == 4, pp, lin)


def wavefront_unfilter(rows, bpp, warps, chunk):
    """(N, H, RB+1) uint8 filtered rows -> ((N, H, RB) uint8, (N,) int32
    status) by K13's schedule with `warps` a block and `chunk` pixels a
    chunk, checking every read against the writes."""
    rows = np.asarray(rows)
    n, h, rb1 = rows.shape
    if n > 1:          # a block an image: the schedule is per image
        got = [wavefront_unfilter(rows[i:i + 1], bpp, warps, chunk)
               for i in range(n)]
        return (np.concatenate([g[0] for g in got]),
                np.concatenate([g[1] for g in got]))
    rb = rb1 - 1
    nw, k = warps, chunk
    r = 32 // bpp
    lane = np.arange(32)
    j, l = lane // bpp, lane % bpp
    lane_live = j < r
    pitch = k * bpp
    npix = -(-rb // bpp)
    chunks, groups = -(-npix // k), -(-h // r)
    types = rows[:, :, 0].astype(np.int64)
    res = rows[:, :, 1:].astype(np.int64)
    out = np.full((n, h, rb), SENTINEL, np.int64)
    stamp = np.full((h, rb), -1)          # the phase that wrote a byte
    bad = np.zeros(n, bool)

    for p in range(groups + chunks - 1):
        reads, writes = set(), set()

        def read(y, x):
            assert 0 <= stamp[y, x] < p, (y, x, stamp[y, x], p)
            reads.add((y, x))
            return out[:, y, x]

        for w in range(nw):
            for g in range(w, groups, nw):
                c = p - g
                if c < 0:
                    break
                if c >= chunks:
                    continue
                y0, x0 = g * r, c * pitch
                kb = min(pitch, rb - x0)
                kpix = -(-kb // bpp)
                nrows = min(r, h - y0)
                shared = np.full((n, r, pitch), SENTINEL, np.int64)
                shared[:, :nrows, :kb] = res[:, y0:y0 + nrows, x0:x0 + kb]
                above = np.zeros((n, kb + bpp), np.int64)
                for x in range(kb + bpp):
                    if y0 > 0 and x0 - bpp + x >= 0:
                        above[:, x] = read(y0 - 1, x0 - bpp + x)
                row_live = lane_live & (j < nrows)
                t = np.zeros((n, 32), np.int64)
                a = np.zeros((n, 32), np.int64)
                cc = np.zeros((n, 32), np.int64)
                for ln in np.flatnonzero(row_live):
                    y = y0 + j[ln]
                    t[:, ln] = types[:, y]
                    if x0 > 0:
                        a[:, ln] = read(y, x0 - bpp + l[ln])
                        if y > 0:
                            cc[:, ln] = read(y - 1, x0 - bpp + l[ln])
                bad |= (t > 4).any(axis=1)
                t = np.where(t > 4, 0, t)
                # the group's filter type where every row has it, else 5
                live_t = t[0, row_live]
                kind = live_t[0] if (live_t == live_t[0]).all() else 5
                prev = np.zeros((n, 32), np.int64)
                prev_at = np.full((32, 2), -1)        # (row, pixel) of prev
                written = np.zeros((r, pitch), bool)
                if kind == 0:
                    # none throughout: the residuals are the bytes
                    written[:nrows, :kb] = True
                for s in range(0 if kind == 0 else kpix + nrows - 1):
                    src = np.where(lane >= bpp, lane - bpp, lane)
                    up, up_at = prev[:, src], prev_at[src]
                    i = s - j
                    xi = i * bpp + l
                    act = row_live & (i >= 0) & (i < kpix) & (xi < kb)
                    L = np.flatnonzero(act)
                    first = j[L] == 0
                    if kind == 1:
                        b = np.zeros((n, L.size), np.int64)  # sub reads no b
                    else:
                        # a shuffled b is row j - 1's pixel i, of the step
                        # before
                        sh = L[~first]
                        assert (up_at[sh, 0] == j[sh] - 1).all()
                        assert (up_at[sh, 1] == i[sh]).all()
                        b = np.where(first, above[:, bpp + np.where(
                            first, xi[L], 0)], up[:, L])
                    cur = shared[:, j[L], xi[L]]
                    assert (cur != SENTINEL).all()
                    assert not written[j[L], xi[L]].any()
                    v = (cur + _predict(t[:, L], a[:, L], b, cc[:, L])) & 0xFF
                    written[j[L], xi[L]] = True
                    shared[:, j[L], xi[L]] = v
                    a[:, L], cc[:, L], prev[:, L] = v, b, v
                    prev_at[L] = np.stack([j[L], i[L]], 1)
                assert written[:nrows, :kb].all()
                for jj in range(nrows):
                    for x in range(kb):
                        y = y0 + jj
                        assert stamp[y, x0 + x] == -1
                        out[:, y, x0 + x] = shared[:, jj, x]
                        stamp[y, x0 + x] = p
                        writes.add((y, x0 + x))
        assert not reads & writes, "read and written in one phase"
    assert (stamp >= 0).all() and (out != SENTINEL).all()
    return out.astype(np.uint8), bad.astype(np.int32)


def _filtered(src, bpp, kinds, rng):
    """Rows of src filtered with a type per row drawn from kinds, through
    the port's plain filters (each candidate is the reference's)."""
    src_t = torch.from_numpy(src)
    cands = torch.stack([filter_batch_plain(src_t, bpp, s)
                         for s in range(5)]).numpy()
    n, h = src.shape[:2]
    pick = rng.choice(kinds, (n, h))
    return np.take_along_axis(cands, pick[None, :, :, None], 0)[0]


def _check(rows, bpp, src, **kw):
    got, status = wavefront_unfilter(rows, bpp, **kw)
    want, want_status = png_unfilter_plain(torch.from_numpy(rows), bpp)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got, src)
    assert status.tolist() == want_status.tolist() == [0] * len(src)


@pytest.mark.parametrize("strategy", [-1, 0, 1, 2, 3, 4])
@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_model_inverts_reference_filter(strategy, bpp):
    """The reference's JAX filter_batch, every strategy and bpp, at a
    height past one block's rows (2 warps of r rows, so the groups wrap
    around the warps) and chunks of 8 pixels."""
    r = 32 // bpp
    h, rb = 2 * r + 3, 13 * bpp + (bpp > 1)
    rng = np.random.default_rng(bpp * 7 + strategy)
    src = rng.integers(0, 256, (2, h, rb), np.uint8)
    src[1] //= 16                                  # ties in the predictors
    rows = np.array(ref_filter_batch(src, bpp, strategy))
    _check(rows, bpp, src, warps=2, chunk=8)


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_model_heights(bpp, plan):
    """Heights of 1, r - 1, r + 1 and past a block's rows, every filter
    type mixed within an image, under each plan."""
    r = 32 // bpp
    rng = np.random.default_rng(bpp)
    for h in sorted({1, max(1, r - 1), r + 1, 3 * r + 2}):
        rb = 11 * bpp
        src = rng.integers(0, 256, (2, h, rb), np.uint8)
        rows = _filtered(src, bpp, [0, 1, 2, 3, 4], rng)
        _check(rows, bpp, src, warps=plan[0], chunk=plan[1])


@pytest.mark.parametrize("bpp", [1, 3, 4, 8])
def test_model_rows_narrower_than_a_pixel_and_ragged_chunks(bpp):
    """Rows of fewer bytes than bpp (a and c stay 0), and rows whose last
    chunk is short of a whole pixel."""
    rng = np.random.default_rng(40 + bpp)
    for rb in sorted({max(1, bpp - 1), 8 * bpp + 1}):
        src = rng.integers(0, 256, (2, 5, rb), np.uint8)
        rows = _filtered(src, bpp, [0, 1, 2, 3, 4], rng)
        _check(rows, bpp, src, warps=2, chunk=8)


def test_model_bad_type_byte():
    """A type byte > 4 in the first, a middle and the last row group sets
    that image's status only; the other images stay exact."""
    bpp, h, rb = 4, 20, 24                  # r = 8: three row groups
    rng = np.random.default_rng(7)
    src = rng.integers(0, 256, (4, h, rb), np.uint8)
    rows = _filtered(src, bpp, [0, 1, 2, 3, 4], rng)
    rows[1, 0, 0] = 5
    rows[2, 11, 0] = 200
    rows[3, h - 1, 0] = 9
    got, status = wavefront_unfilter(rows, bpp, warps=2, chunk=8)
    _, want_status = png_unfilter_plain(torch.from_numpy(rows), bpp)
    assert status.tolist() == want_status.tolist() == [0, 1, 1, 1]
    np.testing.assert_array_equal(got[0], src[0])


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 8).filter(lambda b: b in (1, 2, 3, 4, 6, 8)),
       st.integers(1, 20), st.integers(1, 40),
       st.lists(st.integers(0, 4), min_size=1, max_size=20),
       st.integers(0, 2**31 - 1))
def test_model_hypothesis_type_sequences(bpp, h, rb, kinds, seed):
    """Drawn shapes and per-row filter type sequences, with a plan of 2
    warps and 8-pixel chunks."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (1, h, rb), np.uint8)
    src_t = torch.from_numpy(src)
    cands = torch.stack([filter_batch_plain(src_t, bpp, s)
                         for s in range(5)]).numpy()
    pick = np.array([kinds[y % len(kinds)] for y in range(h)])
    rows = cands[pick, 0, np.arange(h)][None]
    _check(rows, bpp, src, warps=2, chunk=8)
