"""A numpy model of K4's chunked decode
(`picha_tpu_torch/csrc/huffman_decode_chunked.cu`), phase by phase, held
bit for bit to the port's plain decoder (`decode_scan_chunked_plain`,
itself pinned to the JAX reference by
tests/test_torch_huffman_decode_chunked.py). No JAX compile here.

The model follows the kernel: the two-level lookup table built from each
table row (a 10-bit first level whose entries pack the bits a symbol
takes, its code length, its AC index step and its byte; 64-entry second
levels for up to 16 long prefixes; the 16-compare rule past that); the
Jacobi passes a lane at a time, each decode recording its state where it
first reaches each of `windows` equal bit offsets of the lane
(checkpoints), stopping at `steps` symbols or bit_end, words outside the
lane's window read as 0, and after the first pass taking over the rest of
the lane's previous decode where a checkpoint meets it; settle and block
starts; the rows the emission
does not write whole zeroed (a window's first and last block when it
shares them, the rows past a segment's decode; all rows without
convergence); then the emission, a window at a time from its checkpoint,
replaying its share of the lane's symbols, storing the blocks it starts
and ends whole and the others cell by cell. The output starts as a
sentinel, so a row no rule writes shows.

Held to the plain version: the lookup table against the exact rule for
every 16-bit window of every table row of the corpora; per lane, the
exits and block counts of the serial decode (`_decode_lanes`) on the
port corpus's lanes from guessed and propagated entries, each window's
replay ending on the next checkpoint; whole decodes (coefficients, ok,
passes) of `CHUNKED_STREAMS` at 512-bit chunks and 1, 8 and 32 windows,
of `CHUNKED_FAULTS`, of symbol budgets that cut lanes inside their
windows, and of a stream no guessed entry synchronises with
(`torch_helpers.desync_jpeg`).

The kernel compiles in 8 windows a lane (`kWindows`); the model takes
the count as a parameter, and 1 and 32 windows of a 512-bit chunk are
the 512- and 16-bit windows the kernel has at 4096- and 128-bit chunks.
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_helpers import (CHUNKED_FAULTS, CHUNKED_STREAMS,
                           chunked_fault_batch, desync_jpeg, port_corpus,
                           scan_batch_inputs)

from picha_tpu_torch.ops import jpeg_huffman_decode as hd
from picha_tpu_torch.ops.jpeg_scan import ZIGZAG
from picha_tpu_torch.ops.scan_batch import MAX_PASSES

LUT_BITS, SUB_BITS, SUB_TABLES = 10, 6, 16
M32 = 0xFFFFFFFF
SENTINEL = -0x5A5A5A5A


# -- the symbol: lookup tables, exact rule -------------------------------------

def pack_entry(clen, sym):
    """The kernel's table entry: bits taken (code + value), code length,
    the AC index step (run + 1, 16 for ZRL, 64 for EOB) and the symbol
    byte."""
    size, run = sym & 15, sym >> 4
    zadd = np.where(size > 0, run + 1, np.where(run == 15, 16, 64))
    return (clen + size) | (clen << 5) | (zadd << 10) | (sym << 24)


def exact_rule(P, u, limit, delta, hv):
    """The 16-compare rule (huffman_symbol.cuh::table_symbol): (code
    length, symbol) of the 16-bit windows P under table rows u."""
    cnt = (P[:, None] >= limit[u].astype(np.int64)).sum(1)
    clen = np.minimum(1 + cnt, 16)
    idx = np.clip((P >> (16 - clen)) + delta[u, clen].astype(np.int64), 0,
                  255)
    return clen, hv[u, idx].astype(np.int64)


def lut_model(limit, delta, hv):
    """lut_build_kernel: (U, 2^10 + 16 * 2^6) entries a row: the first
    level where the exact rule fixes one length <= 10 for every P with
    these first bits (the count at both ends of the range agrees), a
    pointer (bit 5, index in bits 6-9) to a second level of the next 6
    bits for the first 16 other prefixes, else 0."""
    U = limit.shape[0]
    q = np.arange(1 << LUT_BITS, dtype=np.int64)
    lo = q << (16 - LUT_BITS)
    hi = lo | ((1 << (16 - LUT_BITS)) - 1)
    lim = limit.astype(np.int64)[:, None, :]
    c_lo = (lo[None, :, None] >= lim).sum(2)
    c_hi = (hi[None, :, None] >= lim).sum(2)
    clen = np.minimum(1 + c_lo, 16)
    idx = np.clip((lo[None, :] >> (16 - clen))
                  + np.take_along_axis(delta.astype(np.int64), clen, 1), 0,
                  255)
    sym = np.take_along_axis(hv.astype(np.int64), idx, 1)
    fast = (c_lo == c_hi) & (clen <= LUT_BITS) & (sym >= 0) & (sym < 256)
    out = np.zeros((U, (1 << LUT_BITS) + (SUB_TABLES << SUB_BITS)), np.int64)
    out[:, :1 << LUT_BITS] = np.where(fast, pack_entry(clen, sym & 255), 0)
    for u in range(U):
        for rank, pre in enumerate(np.nonzero(~fast[u])[0][:SUB_TABLES]):
            out[u, pre] = (1 << 5) | (rank << 6)
            P = (pre << SUB_BITS) + np.arange(1 << SUB_BITS)
            c, s = exact_rule(P, np.full(P.size, u), limit, delta, hv)
            base = (1 << LUT_BITS) + (rank << SUB_BITS)
            out[u, base:base + (1 << SUB_BITS)] = pack_entry(c, s & 255)
    return out


def lookup(lut, u, w32, limit, delta, hv):
    """The kernel's `lookup`: the entry of the 32 stream bits under rows
    u, through the second level or the exact rule."""
    e = lut[u, w32 >> (32 - LUT_BITS)]
    sub = ((e & 31) == 0) & (e != 0)
    if sub.any():
        e[sub] = lut[u[sub], (1 << LUT_BITS)
                     + (((e[sub] >> 6) & 15) << SUB_BITS)
                     + ((w32[sub] >> (32 - LUT_BITS - SUB_BITS))
                        & ((1 << SUB_BITS) - 1))]
    slow = e == 0
    if slow.any():
        c, s = exact_rule(w32[slow] >> 16, u[slow], limit, delta, hv)
        e[slow] = pack_entry(c, s & 255)
    return e


def tables(a, ks, comp_of, windows):
    """The wire's tables and lane arrays as int64 numpy, with the
    lookup tables."""
    n = lambda t: t.cpu().numpy().astype(np.int64)  # noqa: E731
    limit, delta, hv = n(a.limit), n(a.delta), n(a.hv)
    return SimpleNamespace(
        words=n(a.words) & M32, base=n(a.lane_word_base), bits=n(a.lane_bits),
        pinned=a.lane_pinned.cpu().numpy(), seg_first=n(a.lane_seg_first),
        blk_base=n(a.lane_blk_base), blk_limit=n(a.lane_blk_limit),
        uid6=n(a.lane_uid6), comp_of=n(comp_of), limit=limit, delta=delta,
        hv=hv, lut=lut_model(limit, delta, hv), C=ks[0], L=ks[1],
        steps=ks[2], B=ks[3], W=ks[0] // 32 + 2, windows=windows,
        rows=ks[6] * ks[5] * ks[3])


def word(tb, lanes, i):
    rel = i - tb.base[lanes]
    inside = (rel >= 0) & (rel < tb.W)
    return np.where(inside, tb.words[np.clip(i, 0, tb.words.size - 1)], 0)


def step(tb, lanes, pos, slot, z):
    """`step` + `symbol_value` for each (lane, pos, slot, z): (bits taken,
    has a value, its zigzag position, the value, the next z)."""
    wl = pos >> 5
    b = pos - wl * 32
    w0, w1 = word(tb, lanes, wl), word(tb, lanes, wl + 1)
    w32 = np.where(b > 0, ((w0 << b) | (w1 >> (32 - b))) & M32, w0)
    u = tb.uid6[lanes, tb.comp_of[slot] * 2 + (z > 0)]
    e = lookup(tb.lut, u, w32, tb.limit, tb.delta, tb.hv)
    clen, sym = (e >> 5) & 31, e >> 24
    size = sym & 15
    val = ((w32 << clen) & M32) >> (32 - np.maximum(size, 1))
    val = np.where(size > 0, val, 0)
    val = np.where((size > 0) & (val < (1 << np.maximum(size - 1, 0))),
                   val - (1 << size) + 1, val)
    zc = np.where(z > 0, z + (sym >> 4), 0)
    has = ((z == 0) | (size > 0)) & (zc < 64)
    zn = np.where(z > 0, z + ((e >> 10) & 127), 1)
    return e & 31, has, zc, val, zn


# -- the passes: a lane at a time, with checkpoints ----------------------------

def lane_pass(tb, lanes, entry, steps=None, old=None):
    """lane_pass for `lanes` (n,) from entries (3, n) (off, slot, z): the
    exit states (3, n) (absolute pos), nblk (n,) and the checkpoints
    (n, windows + 1, 5): (pos - start, slot, z, symbols, blocks) where
    the decode first reached each window's first bit, then its end.
    `old`: the lanes' previous checkpoints; where a new one's (pos, slot,
    z) is the old one's, the rest is the old decode's with the counts
    shifted (unless the old decode stopped short of bit_end or the shift
    takes the symbols past `steps`)."""
    steps = tb.steps if steps is None else steps
    S = tb.C // tb.windows
    start = tb.base[lanes] * 32
    bit_end = start + tb.bits[lanes]
    pos = start + entry[0]
    slot, z = entry[1].copy(), entry[2].copy()
    cnt = np.zeros_like(pos)
    nb = np.zeros_like(pos)
    cp = np.zeros((lanes.size, tb.windows + 1, 5), np.int64)
    t = np.ones_like(pos)
    done = np.zeros(lanes.size, bool)
    may = (np.zeros(lanes.size, bool) if old is None
           else start + old[:, -1, 0] >= bit_end)

    def record(mask):
        idx = np.nonzero(mask)[0]
        now = np.stack([pos[idx] - start[idx], slot[idx], z[idx], cnt[idx],
                        nb[idx]], 1)
        if old is not None:
            was = old[idx, t[idx]]
            shift = now[:, 3:] - was[:, 3:]
            m = (may[idx] & (was[:, :3] == now[:, :3]).all(1)
                 & (old[idx, -1, 3] + shift[:, 0] <= steps))
            for j in np.nonzero(m)[0]:
                i = idx[j]
                cp[i, t[i]:] = old[i, t[i]:]
                cp[i, t[i]:, 3:] += shift[j]
                pos[i] = start[i] + cp[i, -1, 0]
                slot[i], z[i], cnt[i], nb[i] = cp[i, -1, 1:]
                done[i] = True
            idx, now = idx[~m], now[~m]
        cp[idx, t[idx]] = now
        t[idx] += 1

    cp[:, 0] = np.stack([pos - start, slot, z, cnt, nb], 1)
    while True:
        act = ~done & (cnt < steps) & (pos < bit_end)
        while True:
            m = act & ~done & (t < tb.windows) & (pos >= start + t * S)
            if not m.any():
                break
            record(m)
        ai = np.nonzero(act & ~done)[0]
        if not ai.size:
            break
        adv, _has, _zc, _v, zn = step(tb, lanes[ai], pos[ai], slot[ai], z[ai])
        pos[ai] += adv
        cnt[ai] += 1
        end = zn >= 64
        nb[ai] += end
        slot[ai] = np.where(end, (slot[ai] + 1) % tb.B, slot[ai])
        z[ai] = np.where(end, 0, zn)
    fill = ~done
    cp[fill, -1] = np.stack([pos - start, slot, z, cnt, nb], 1)[fill]
    for i in np.nonzero(fill)[0]:
        cp[i, t[i]:-1] = cp[i, -1]
    lane_pass.merged = int(done.sum())
    return np.stack([pos, slot, z]), nb, cp


def replay(tb, lanes, cp0, n, blk0=None, out=None, whole=True):
    """The emission of windows (lanes, checkpoints cp0 (k, 5), symbols n):
    returns their end states (k, 5) like checkpoints. With `out`, each
    block a window starts and ends is stored whole (zeros included), the
    others cell by cell, below the lane's blk_limit."""
    start = tb.base[lanes] * 32
    pos = start + cp0[:, 0]
    slot, z = cp0[:, 1].copy(), cp0[:, 2].copy()
    cnt = np.zeros_like(pos)
    nb = np.zeros_like(pos)
    k = lanes.size
    buf = np.zeros((k, 64), np.int64)
    setm = np.zeros((k, 64), bool)
    shared = (z > 0) | (not whole)
    limit = tb.blk_limit[lanes]
    while True:
        ai = np.nonzero(cnt < n)[0]
        if not ai.size:
            break
        adv, has, zc, val, zn = step(tb, lanes[ai], pos[ai], slot[ai], z[ai])
        hi = ai[has]
        buf[hi, ZIGZAG[zc[has]]] = val[has]
        setm[hi, ZIGZAG[zc[has]]] = True
        end = zn >= 64
        if out is not None:
            for r in ai[end]:
                b = blk0[r] + nb[r]
                if b < limit[r]:
                    if shared[r]:
                        out[b][setm[r]] = buf[r][setm[r]]
                    else:
                        out[b] = buf[r]
                buf[r] = 0
                setm[r] = False
                shared[r] = not whole
        pos[ai] += adv
        cnt[ai] += 1
        nb[ai] += end
        slot[ai] = np.where(end, (slot[ai] + 1) % tb.B, slot[ai])
        z[ai] = np.where(end, 0, zn)
    if out is not None:      # the block each window leaves unfinished
        for r in np.nonzero(setm.any(1))[0]:
            b = blk0[r] + nb[r]
            if b < limit[r]:
                out[b][setm[r]] = buf[r][setm[r]]
    return np.stack([pos - start, slot, z, cp0[:, 3] + cnt, cp0[:, 4] + nb],
                    1)


def decode_model(a, ks, comp_of, windows=8, max_passes=MAX_PASSES):
    """chunk_pass_kernel + chunk_emit_kernel, then K5's plain version:
    (coefficients (N, mcus*B, 64) int32, ok, passes)."""
    tb = tables(a, ks, comp_of, windows)
    L, C = tb.L, tb.C
    start = tb.base * 32
    bit_end = start + tb.bits
    ent = np.zeros((3, L), np.int64)
    ex = np.zeros((2, 3, L), np.int64)
    nblk = np.zeros(L, np.int64)
    over = np.zeros(L, bool)
    cps = np.zeros((L, windows + 1, 5), np.int64)
    chg = np.zeros(max_passes, bool)

    def propagated(p):
        e = np.zeros((3, L), np.int64)
        e[:, 1:] = ex[(p - 1) & 1][:, :-1]
        e[:, tb.pinned] = 0
        return e

    p = 0
    while p < max_passes:
        if p >= 2 and not chg[p - 2]:
            break
        if p == 0:
            e, run = np.zeros((3, L), np.int64), np.ones(L, bool)
        else:
            e = propagated(p)
            run = (e != ent).any(0)
            ex[p & 1][:, ~run] = ex[(p & 1) ^ 1][:, ~run]
            chg[p - 1] = run.any()
        lanes = np.nonzero(run)[0]
        ent[:, lanes] = e[:, lanes]
        if lanes.size:
            x, nb, cp = lane_pass(tb, lanes, e[:, lanes],
                                  old=cps[lanes] if p else None)
            ex[p & 1][:, lanes] = [x[0] - (start[lanes] + C), x[1], x[2]]
            nblk[lanes] = nb
            over[lanes] = x[0] < bit_end[lanes]
            cps[lanes] = cp
        p += 1
    all_changed = p == max_passes and (max_passes < 2 or chg[max_passes - 2])
    if all_changed and (propagated(max_passes) != ent).any():
        chg[max_passes - 1] = True
    done = np.nonzero(~chg)[0]
    passes = int(done[0]) + 1 if done.size else max_passes
    converged = bool(done.size)
    ok = converged and not over.any()
    prev = nblk.cumsum() - nblk
    blk_start = tb.blk_base + prev - prev[np.clip(tb.seg_first, 0, L - 1)]
    out = np.full((tb.rows, 64), SENTINEL, np.int64)
    c0, c1 = cps[:, :-1], cps[:, 1:]
    n = c1[..., 3] - c0[..., 3]
    b0 = blk_start[:, None] + c0[..., 4]
    b1 = blk_start[:, None] + c1[..., 4]
    limit = tb.blk_limit[:, None]
    if not converged:
        out[:] = 0
    else:   # the rows the emission does not write whole
        for rows, shared in ((b0, c0[..., 2] > 0), (b1, c1[..., 2] > 0)):
            sel = (n > 0) & shared & (rows < limit)
            out[rows[sel]] = 0
        last = np.append(tb.pinned[1:], True)
        for lane in np.nonzero(last)[0]:
            end = cps[lane, -1]
            out[blk_start[lane] + end[4] + (end[2] > 0):
                max(tb.blk_limit[lane], 0)] = 0
    w = n > 0
    lanes = np.broadcast_to(np.arange(L)[:, None], w.shape)[w]
    ends = replay(tb, lanes, c0[w], n[w], b0[w], out, whole=converged)
    assert np.array_equal(ends, c1[w])   # each window ends on the next one
    coefs = torch.as_tensor(out.astype(np.int32)).view(ks[6], ks[5] * ks[3],
                                                       64)
    coefs = hd.dc_integrate_plain(coefs, comp_of, a.ri_blk, ks[5])
    return coefs, ok, passes


def plain(a, ks, comp_of, **kw):
    out, ok, passes = hd.decode_scan_chunked_plain(a, ks, comp_of, **kw)
    return out, bool(ok), int(passes)


def serial(a, ks, comp_of, lanes, entry, steps=None):
    """The plain version's serial decode of `lanes` from entries (3, n):
    (exit states (3, n), nblk)."""
    t = hd._plain_tables(a, comp_of)
    ln = torch.as_tensor(lanes)
    base = a.lane_word_base.to(torch.int64)[ln]
    start = base * 32
    bit_end = start + a.lane_bits.to(torch.int64)[ln]
    e = torch.as_tensor(entry)
    pos, slot, z, nb = hd._decode_lanes(
        t, ln, start + e[0], e[1], e[2], bit_end,
        ks[2] if steps is None else steps, ks[3],
        window=(base, ks[0] // 32 + 2))
    return torch.stack([pos, slot, z]).numpy(), nb.numpy()


@functools.lru_cache(maxsize=None)
def stream(name):
    """A CHUNKED_STREAMS batch (or the desync stream) at 512-bit chunks:
    (decoder args, key, comp_of, the plain decode)."""
    bufs = [desync_jpeg()] if name == "desync" else CHUNKED_STREAMS[name][0]()
    _sb, ks, a, _q, comp_of = scan_batch_inputs(bufs, chunk_bits=512)
    return a, ks, comp_of, plain(a, ks, comp_of)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain decoder's lockstep loops over small tensors run several
    times faster on one torch thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- tests ---------------------------------------------------------------------

def _corpus_tables():
    for bufs in (port_corpus(1, restart=False), port_corpus(3)[2:],
                 [make()[0] for make, _c in CHUNKED_STREAMS.values()],
                 [desync_jpeg()]):
        for buf in bufs:
            _sb, _ks, a, _q, _c = scan_batch_inputs([buf])
            yield a.limit.numpy(), a.delta.numpy(), a.hv.numpy()


def test_lookup_tables_are_the_exact_rule():
    """Every 16-bit window of every table row of the corpora, through
    the first level, a second level or the exact rule: the packed entry
    of the 16-compare rule's (length, symbol)."""
    P = np.arange(1 << 16, dtype=np.int64)
    w32 = P << 16
    second = 0
    for limit, delta, hv in _corpus_tables():
        lut = lut_model(limit, delta, hv)
        for u in range(limit.shape[0]):
            us = np.full(P.size, u)
            got = lookup(lut, us, w32, limit, delta, hv)
            clen, sym = exact_rule(P, us, limit, delta, hv)
            assert np.array_equal(got, pack_entry(clen, sym & 255))
            if limit[u].any():
                e = lut[u, :1 << LUT_BITS]
                assert ((e & 31) > 0).mean() > 0.9
                second += int(((e & 31) == 0).sum())
    assert second > 0       # long codes take the second level


@pytest.mark.parametrize("windows", [1, 8, 32])
def test_lane_decode_and_checkpoints_on_corpus_lanes(windows):
    """The first 32 lanes of a 1080p no-restart image, from guessed
    (0, 0, 0) entries and from the entries the first pass propagates
    (taking over the first decode where a checkpoint meets it): each
    lane's exit and block count equal the plain serial decode's, and
    replaying each window from its checkpoint ends on the next."""
    _sb, ks, a, _q, comp_of = scan_batch_inputs(port_corpus(1, False))
    tb = tables(a, ks, comp_of, windows)
    lanes = np.arange(32)
    e = np.zeros((3, lanes.size), np.int64)
    cp = None
    for _ in range(2):
        x, nb, cp = lane_pass(tb, lanes, e, old=cp)
        want, wnb = serial(a, ks, comp_of, lanes, e)
        assert np.array_equal(x, want)
        assert np.array_equal(nb, wnb)
        n = cp[:, 1:, 3] - cp[:, :-1, 3]
        w = n > 0
        ln = np.broadcast_to(lanes[:, None], w.shape)[w]
        assert np.array_equal(replay(tb, ln, cp[:, :-1][w], n[w]),
                              cp[:, 1:][w])
        e = np.zeros_like(e)     # lane 0 starts the segment (pinned)
        e[0, 1:] = x[0, :-1] - (tb.base[lanes[:-1]] * 32 + tb.C)
        e[1:, 1:] = x[1:, :-1]
    if windows > 1:   # most new decodes take over the old one's rest
        assert lane_pass.merged > lanes.size // 2


@pytest.mark.parametrize("windows", [1, 8, 32])
@pytest.mark.parametrize("name", ["batch", "grey", "422",
                                  "dri_exceeds_mcus"])
def test_model_decode_matches_plain(name, windows):
    a, ks, comp_of, (want, ok_w, passes_w) = stream(name)
    got, ok, passes = decode_model(a, ks, comp_of, windows)
    assert (ok, passes) == (ok_w, passes_w) and ok
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", CHUNKED_FAULTS)
def test_model_faults_match_plain(case):
    """Truncated and bit-flipped scans, a pass budget of 1, a symbol
    budget of 16: the same ok and passes, the same coefficients where ok
    is true."""
    sb, kw = chunked_fault_batch(case)
    ks, wire = sb.wire()
    a, _q = hd.wire_unpack(torch.from_numpy(wire), ks, 3)
    comp_of = torch.as_tensor(sb.comp_of, dtype=torch.int32)
    got, ok, passes = decode_model(a, ks, comp_of, 8, **kw)
    want, ok_w, passes_w = plain(a, ks, comp_of, **kw)
    assert (ok, passes) == (ok_w, passes_w)
    if ok:
        assert torch.equal(got, want)


@pytest.mark.parametrize("steps", [9, 23, 40, 61, 77])
def test_symbol_budget_inside_the_windows(steps):
    """Symbol budgets that stop lanes of 4:2:0 noise (60-100 symbols a
    lane of 512 bits) inside their windows, at 8 windows a lane: each
    lane's symbols end where the plain serial decode's do, and the whole
    decode has the plain version's ok and passes (and coefficients where
    ok)."""
    _sb, ks, a, _q, comp_of = scan_batch_inputs(CHUNKED_STREAMS["420"][0](),
                                                chunk_bits=512)
    ks = ks[:2] + (steps,) + ks[3:]
    tb = tables(a, ks, comp_of, 8)
    lanes = np.arange(1, 9)
    e = np.zeros((3, lanes.size), np.int64)
    x, nb, cp = lane_pass(tb, lanes, e)
    want, wnb = serial(a, ks, comp_of, lanes, e, steps=steps)
    assert np.array_equal(x, want) and np.array_equal(nb, wnb)
    assert (cp[:, -1, 3] == steps).all()
    got, ok, passes = decode_model(a, ks, comp_of, 8, max_passes=3)
    want, ok_w, passes_w = plain(a, ks, comp_of, max_passes=3)
    assert (ok, passes) == (ok_w, passes_w)
    if ok:
        assert torch.equal(got, want)


def test_symbol_budget_on_every_window():
    """For each of a lane's 8 windows, the budget that ends the lane on
    that window's first symbol: the lane stops where the plain serial
    decode stops, its last checkpoints hold the capped end, and the
    whole decode has the plain version's ok, passes and (where ok)
    coefficients."""
    _sb, ks, a, _q, comp_of = scan_batch_inputs(CHUNKED_STREAMS["420"][0](),
                                                chunk_bits=512)
    lanes = np.arange(1, 9)
    e = np.zeros((3, lanes.size), np.int64)
    _x, _nb, cp = lane_pass(tables(a, ks, comp_of, 8), lanes, e)
    budgets = cp[0, :-1, 3] + 1
    assert len(set(budgets.tolist())) == 8    # a budget a window
    for steps in budgets.tolist():
        kc = ks[:2] + (steps,) + ks[3:]
        tb = tables(a, kc, comp_of, 8)
        x, nb, cpc = lane_pass(tb, lanes, e)
        want, wnb = serial(a, kc, comp_of, lanes, e, steps=steps)
        assert np.array_equal(x, want) and np.array_equal(nb, wnb)
        assert (cpc[:, -1, 3] <= steps).all() and cpc[0, -1, 3] == steps
        got, ok, passes = decode_model(a, kc, comp_of, 8, max_passes=3)
        want, ok_w, passes_w = plain(a, kc, comp_of, max_passes=3)
        assert (ok, passes) == (ok_w, passes_w)
        if ok:
            assert torch.equal(got, want)


@pytest.mark.parametrize("windows", [4, 16])
def test_stream_that_never_synchronises(windows):
    """desync_jpeg: no guessed entry ever meets the true path, so the
    lanes take a pass a chunk; the decode still equals the plain
    version's."""
    a, ks, comp_of, (want, ok_w, passes_w) = stream("desync")
    got, ok, passes = decode_model(a, ks, comp_of, windows)
    assert (ok, passes) == (ok_w, passes_w) and ok and passes >= 10
    assert torch.equal(got, want)
