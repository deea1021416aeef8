"""K15's parallel LZW design (`csrc/lzw_decode.cu`) as a numpy model,
held bit for bit to the plain version `ops/lzw.py::lzw_decode_plain`.

No kernel runs on the CPU, so the kernel's own logic is checked here
through a model of its phases, one strip at a time:
- within an epoch (the codes after a Clear, or from the strip's start),
  code k's width is 9 + [n >= 511] + [n >= 1023] + [n >= 2047] with n =
  min(257 + max(k, 1), 4096), so its bit position is a closed form;
- a chunk of 4096 codes is read at those positions, and its first
  terminating index (Clear, EOI, the end of the input, a literal's place
  taken by a code >= 258, a code past the next free one) is a min;
- code k >= 1 creates entry 257 + k, so code c >= 258 names the string
  of the code at index c - 258 plus one byte: lengths L and first bytes F
  come out by pointer jumping, the last byte of code k's string is
  F[c_k - 257];
- output offsets are an exclusive scan of L; the first code whose output
  passes the cap is cut there; each code's string is written backwards
  along its chain into a window of the chunk's output (16 KB in the
  kernel, also a few bytes here so that strings cross windows);
- an epoch longer than 4096 codes goes on against the first chunk's
  entries, which the full table freezes.
The streams: the libtiff-rule encoder and hand-made code streams of
tests/test_torch_tiff_decode.py, the GPU tests' strip batch, Pillow-
written strips of random, flat, noisy and config-4-like images, and
hypothesis-drawn code streams (Clears, EOIs, KwKwK, undefined codes,
epochs past a full table, caps at every code boundary and inside long
strings, input cut mid-code). The builders here also feed the GPU tests.
"""
import io

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from test_torch_tiff_decode import (RND, _codes, _lzw_encode,
                                    _prefix_with_final_free)

from picha_tpu_torch.codecs import tiff_host
from picha_tpu_torch.ops.lzw import (CLEAR, EOI, FIRST, TABLE, lzw_decode,
                                     lzw_decode_plain)

CHUNK = 4096            # codes a pass (the kernel's kChunk)
WINDOW = 16384          # output bytes staged at a time (its kWindow)
NONE = 1 << 62          # no stop in the chunk
CLEARED, ENDED, FAILED = 0, 1, 2   # the kinds of a stop, ordered in its key


def code_width(k):
    """Width of code k of an epoch (k codes since the Clear)."""
    k = np.asarray(k, np.int64)
    return 9 + (k >= 254) + (k >= 766) + (k >= 1790)


def code_pos(k):
    """Bit offset of code k from its epoch's first bit: the sum of the
    widths before it."""
    k = np.asarray(k, np.int64)
    return (9 * k + np.maximum(k - 254, 0) + np.maximum(k - 766, 0)
            + np.maximum(k - 1790, 0))


def read_codes(buf, nbits, start, k):
    """Codes k of the epoch whose first bit is `start` (-1 where the
    input ends before the code does)."""
    w = code_width(k)
    p = start + code_pos(k)
    ok = p + w <= nbits
    i = np.where(ok, p >> 3, 0)
    v = (buf[i] << 16) | (buf[i + 1] << 8) | buf[i + 2]
    return np.where(ok, (v >> (24 - (p & 7) - w)) & ((1 << w) - 1), -1)


def stop_keys(c, k, j):
    """Per code: 4 j + kind where code k (chunk index j) stops the
    chunk, else NONE; the min is the first stop and its kind."""
    term = (c < 0) | (c == CLEAR) | (c == EOI) | (c > 257 + k)
    kind = np.where(c == CLEAR, CLEARED,
                    np.where((c < 0) | (c == EOI), ENDED, FAILED))
    return np.where(term, 4 * j + kind, NONE)


def lengths_first_bytes(code, term):
    """Pointer jumping over p[k] = code[k] - 258 (< k): (L, F, rounds).
    Literals are the roots; a stopping code is a root of length 0."""
    root = term | (code < 256)
    length = np.where(term, 0, 1)
    first = np.where(root & ~term, code, 0)
    anc = np.where(root, -1, code - FIRST)
    rounds = 0
    while (anc >= 0).any():
        rounds += 1
        m = anc >= 0
        a = anc[m]
        length, first, anc = length.copy(), first.copy(), anc.copy()
        length[m] += length[a]
        first[m] = first[a]     # final once anc[a] is a root
        anc[m] = anc[a]
    return length, first, rounds


def emit(e, p, w0, w1, stage, code, first):
    """Code value e's string, ending before chunk byte p, into the window
    [w0, w1) of the chunk's output: backwards along its chain, stopping
    at the window's start."""
    while e >= FIRST:
        p -= 1
        if p < w1:
            stage[p - w0] = first[e - 257]
        if p == w0:
            return
        e = int(code[e - FIRST])
    stage[p - 1 - w0] = e


def lzw_decode_model(data: bytes, cap: int, window: int = WINDOW):
    """One strip through the kernel's phases -> (bytes, ok, stats); the
    output staged `window` bytes at a time."""
    data = bytes(data)
    nbits = 8 * len(data)
    buf = np.frombuffer(data + b"\0\0\0", np.uint8).astype(np.int64)
    out = bytearray(cap)
    written = start = 0
    stats = {"epochs": 0, "chunks": 0, "rounds": 0}
    j = np.arange(CHUNK)
    while True:                                     # epochs
        stats["epochs"] += 1
        k0 = 0
        while True:                                 # chunks of 4096 codes
            stats["chunks"] += 1
            k = k0 + j
            c = read_codes(buf, nbits, start, k)
            keys = stop_keys(c, k, j)
            key = int(keys.min())
            s = CHUNK if key == NONE else key >> 2
            if k0 == 0:
                code = np.where(c < 0, EOI, c)
                length, first, rounds = lengths_first_bytes(code,
                                                            keys != NONE)
                stats["rounds"] = max(stats["rounds"], rounds)
            else:                   # the table is full: no new entries
                length = np.where(c < 256, 1,
                                  length0[np.clip(c - FIRST, 0, CHUNK - 1)]
                                  + 1)
            length = np.where(j < s, length, 0)
            rel = np.cumsum(length) - length
            total = int(length.sum())
            out_n = min(total, cap - written)
            for w0 in range(0, out_n, window):
                w1 = min(w0 + window, out_n)
                stage = [-1] * (w1 - w0)
                # the codes with r < w1 and r + n > w0 (the kernel's
                # threads each test their own)
                lo = int(np.searchsorted(rel + length, w0, "right"))
                for i in range(lo, int(np.searchsorted(rel, w1))):
                    r, n = int(rel[i]), int(length[i])
                    if n and r < w1 and r + n > w0:
                        emit(int(c[i]), r + n, w0, w1, stage, code, first)
                assert -1 not in stage          # every byte staged
                out[written + w0:written + w1] = bytes(stage)
            if written + total > cap:
                return bytes(out), True, stats      # cut at the cap
            written += total
            if s < CHUNK:
                kind = key & 3
                if kind == CLEARED:
                    start += int(code_pos(k0 + s) + code_width(k0 + s))
                    break
                return bytes(out[:written]), kind == ENDED, stats
            if k0 == 0:
                length0 = length    # the frozen table's lengths
            k0 += CHUNK


def _check(seg: bytes, cap: int, window: int = WINDOW):
    want, ok = lzw_decode_plain(seg, cap)
    got, ok_m, stats = lzw_decode_model(seg, cap, window)
    assert (got, ok_m) == (want, ok)
    assert stats["rounds"] <= 12
    return stats


# -- stream builders (also the GPU tests' inputs) ---------------------------

def pack_codes(codes):
    """Codes -> bytes, each at the width the decoder reads it with (the
    index since the last Clear decides)."""
    acc, nb, k = 0, 0, 0
    out = bytearray()
    for c in codes:
        w = int(code_width(k))
        acc = (acc << w) | (c & ((1 << w) - 1))
        nb += w
        k = 0 if c == CLEAR else k + 1
        while nb >= 8:
            out.append((acc >> (nb - 8)) & 0xFF)
            nb -= 8
        acc &= (1 << nb) - 1
    if nb:
        out.append((acc << (8 - nb)) & 0xFF)
    return bytes(out)


def random_epoch(rng, n, mix, bad=0.0):
    """n codes of one epoch, valid for the decoder unless `bad` > 0:
    literals, back references, KwKwK (the next free code) or a mix; with
    probability `bad` a code is undefined (past the next free one, or
    >= 258 first)."""
    codes = []
    for k in range(n):
        nxt = min(257 + max(k, 1), TABLE)
        top = nxt if nxt < TABLE else TABLE - 1      # KwKwK while it exists
        if rng.random() < bad:
            codes.append(int(rng.integers(FIRST, TABLE)) if k == 0 or
                         nxt >= TABLE - 1 else int(rng.integers(nxt + 1,
                                                                TABLE)))
            continue
        pick = mix if mix != "mixed" else rng.choice(
            ["literal", "refs", "kwkwk"], p=[0.4, 0.5, 0.1])
        if k == 0 or pick == "literal" or top < FIRST:
            codes.append(int(rng.integers(0, 256)))
        elif pick == "kwkwk" and nxt < TABLE:
            codes.append(nxt)
        else:
            codes.append(int(rng.integers(FIRST, top + 1)))
    return codes


def long_epoch_stream(seed, n=9000, mix="refs"):
    """A Clear, then one epoch of n codes (past the full table when n >
    3839) of back references with no Clear, then EOI."""
    rng = np.random.default_rng(seed)
    return pack_codes([CLEAR] + random_epoch(rng, n, mix) + [EOI])


def config4_like(h, w, seed, noise=4.0, levels=None):
    """chip_smoke's config-4 recipe at (h, w): waves, a ramp in alpha,
    normal noise; with `levels`, quantised to that many levels a
    channel."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 127 + 70 * np.sin(xx / 11) + 40 * np.cos(yy / 7)
    a = np.stack([base, 255 - base, base * 0.5 + 60,
                  np.full_like(base, 255) - (xx + yy) % 17], -1)
    if noise:
        a = a + rng.normal(0, noise, (h, w, 4))
    a = np.clip(a, 0, 255).astype(np.uint8)
    if levels:
        a = a // (256 // levels) * (256 // levels)
    return a


def pillow_images():
    """name -> RGBA array: random, flat, noisy and config-4-like
    (plain and quantised to 8 levels without noise)."""
    rng = np.random.default_rng(15)
    return {
        "random": rng.integers(0, 256, (40, 96, 4), np.uint8),
        "flat": np.full((100, 300, 4), 77, np.uint8),
        "noisy": np.clip(120 + rng.normal(0, 20, (48, 120, 4)), 0,
                         255).astype(np.uint8),
        "config4": config4_like(64, 384, 9),
        "compressible": config4_like(64, 384, 9, noise=0, levels=8),
    }


def pillow_strips(a):
    """Every LZW strip of `a` written by Pillow (libtiff), as (segment,
    cap) with cap the strip's row bytes."""
    from PIL import Image

    out = io.BytesIO()
    Image.fromarray(a, "RGBA").save(out, "TIFF", compression="tiff_lzw")
    item = tiff_host.host_stage(out.getvalue())
    return [(seg, cap) for seg, _y0, cap in item.strips]


def strip_batch(strips, offset=0, gap=0):
    """(segment, cap) pairs -> (segs, (4, K) table, out size) for
    `lzw_decode`: segments back to back after `offset` bytes, outputs
    `gap` bytes apart."""
    lens = [len(s) for s, _ in strips]
    caps = [c for _, c in strips]
    seg_off = (offset + np.cumsum([0] + lens[:-1])).tolist()
    out_off = np.cumsum([0] + [c + gap for c in caps[:-1]]).tolist()
    segs = np.concatenate([np.zeros(offset, np.uint8)]
                          + [np.frombuffer(s, np.uint8) for s, _ in strips])
    table = torch.tensor([seg_off, lens, out_off, caps], dtype=torch.int64)
    return torch.from_numpy(segs.copy()), table, sum(caps) + gap * len(caps)


# -- the width formula ------------------------------------------------------

def test_width_formula_follows_the_decoders_state():
    """The plain decoder's width after each code of an epoch (it widens
    when its next free code reaches 511, 1023, 2047) is the closed form,
    and the positions are the sums of the widths."""
    width, nxt, pos = 9, FIRST, 0
    for k in range(6000):
        assert code_width(k) == width and code_pos(k) == pos, k
        pos += width
        if k >= 1:                  # code 0 adds no entry
            nxt = min(nxt + 1, TABLE)
            if nxt == (1 << width) - 1 and width < 12:
                width += 1


@pytest.mark.parametrize("n, k", [(510, 253), (511, 254), (1022, 765),
                                  (1023, 766), (2046, 1789), (2047, 1790)])
def test_width_at_each_boundary(n, k):
    """n = min(257 + k, 4096) is the next free code before code k."""
    assert min(257 + k, TABLE) == n
    assert code_width(k) == 9 + (n >= 511) + (n >= 1023) + (n >= 2047)


# -- the model against the plain version ------------------------------------

@pytest.mark.parametrize("boundary", [511, 1023, 2047])
@pytest.mark.parametrize("past", [-1, 0, 1])
def test_model_at_each_width_boundary(boundary, past):
    data = _prefix_with_final_free(RND, boundary + 1 + past)
    _check(_lzw_encode(data)[0], len(data))


@pytest.mark.parametrize("data, cap", [
    (b"a" * 300 + b"ab" * 40, 380), (RND + RND[:1500], 7500),
    (RND[:900], 500), (b"xyz" * 200, 301), (RND[:50], 80), (b"", 0),
    (RND[:700], 700)])
def test_model_on_encoder_streams(data, cap):
    stats = _check(_lzw_encode(data)[0], cap)
    if len(data) == 7500:
        assert stats["epochs"] >= 2          # the encoder's Clear at 4094


@pytest.mark.parametrize("cut", [1, 2, 3, 7])
def test_model_on_input_cut_mid_code(cut):
    _check(_lzw_encode(RND[:700])[0][:-cut], 700)


@pytest.mark.parametrize("codes", [
    [256, 65, 300, 257], [256, 258, 257], [256, 65, 66, 261, 257],
    [65, 258, 259, 257], [256, 256, 65, 257], [256, 65, 256, 259, 257],
    [65, 66, 257, 300], [258], [256]])
def test_model_on_hand_made_codes(codes):
    for cap in range(6):
        _check(_codes(codes), cap)
        _check(pack_codes(codes), cap)


def test_model_on_the_gpu_tests_strips():
    from test_torch_kernels_gpu import _lzw_strip_batch

    for seg, cap in _lzw_strip_batch():
        _check(seg, cap)


@pytest.mark.parametrize("name", ["random", "flat", "noisy", "config4",
                                  "compressible"])
def test_model_on_pillow_strips(name):
    rounds = 0
    for seg, cap in pillow_strips(pillow_images()[name]):
        assert lzw_decode_plain(seg, cap)[1]
        rounds = max(rounds, _check(seg, cap)["rounds"])
        _check(seg, cap, window=1000)
    if name == "flat":
        assert rounds >= 8                  # strings of hundreds of bytes


@pytest.mark.parametrize("seed, mix", [(1, "refs"), (2, "literal"),
                                       (3, "mixed")])
def test_model_past_a_full_table(seed, mix):
    """Epochs of 9,000 codes with no Clear: the codes past 4,096 take
    the first chunk's frozen entries."""
    seg = long_epoch_stream(seed, 9000, mix)
    want, ok = lzw_decode_plain(seg, 1 << 22)
    assert ok and len(want) >= 9000
    assert _check(seg, 1 << 22)["chunks"] == 1 + 3   # the Clear, 9,001 codes
    for cap in (len(want) - 1, len(want) // 2, 5000):
        _check(seg, cap)


@pytest.mark.parametrize("stream", ["kwkwk", "flat_pillow", "clears"])
def test_model_at_every_cap(stream):
    """Every cap from 0 past the output's end: each code boundary and
    every byte inside a long string."""
    seg = {"kwkwk": _lzw_encode(b"a" * 300 + b"ab" * 40)[0],
           "flat_pillow": pillow_strips(np.full((4, 30, 4), 9,
                                                np.uint8))[0][0],
           "clears": pack_codes([65, 258, 259, CLEAR, 66, 67, 258, 260,
                                 CLEAR, 68, EOI])}[stream]
    full, ok = lzw_decode_plain(seg, 1 << 20)
    assert ok
    for cap in range(len(full) + 2):
        _check(seg, cap)
        _check(seg, cap, window=5)


@st.composite
def code_streams(draw):
    """Epochs of drawn sizes and mixes, each ended by a Clear, an EOI, an
    undefined code or nothing, packed at the decoder's widths, maybe cut
    short; a cap anywhere from 0 past the output's end."""
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    codes = []
    for _ in range(draw(st.integers(1, 4))):
        mix = draw(st.sampled_from(["literal", "refs", "kwkwk", "mixed"]))
        n = draw(st.sampled_from([0, 1, 2, 3, 40, 253, 254, 300, 765, 1790,
                                  3838, 3839, 3840, 4200, 6000]))
        if mix == "kwkwk":
            n = min(n, 400)         # strings of length k: keep it small
        codes += random_epoch(rng, n, mix,
                              bad=draw(st.sampled_from([0.0, 0.0, 0.002,
                                                        0.05])))
        codes.append(draw(st.sampled_from([CLEAR, CLEAR, EOI, 4095])))
    seg = pack_codes(codes)
    if draw(st.booleans()):
        seg = seg[:draw(st.integers(0, len(seg)))]
    full = len(lzw_decode_plain(seg, 1 << 21)[0])
    cap = draw(st.one_of(st.integers(0, full + 2),
                         st.sampled_from([0, full, full + 1, 1 << 21])))
    return seg, cap, draw(st.sampled_from([WINDOW, WINDOW, 7, 64]))


@settings(max_examples=100, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(code_streams())
def test_model_on_drawn_streams(stream):
    _check(*stream)


def test_batched_plain_on_the_builders_strips():
    """The wrapper's plain route on a batch of these strips, at byte
    offset 7 and with gaps between the outputs, gives each strip's
    plain decode and leaves the gaps alone."""
    strips = (pillow_strips(pillow_images()["flat"])
              + [(long_epoch_stream(4, 5000), 70000),
                 (pack_codes([65, 300, EOI]), 10), (b"", 0)])
    segs, table, size = strip_batch(strips, offset=7, gap=3)
    out = torch.full((size,), 0xEE, dtype=torch.uint8)
    n, status = lzw_decode(segs, table[0], table[1], out, table[2],
                           table[3])
    for i, (seg, cap) in enumerate(strips):
        want, ok = lzw_decode_plain(seg, cap)
        o = int(table[2, i])
        assert int(n[i]) == len(want) and int(status[i]) == (not ok)
        assert bytes(out[o:o + len(want)].numpy()) == want
        assert (out[o + cap:o + cap + 3] == 0xEE).all()
