"""A numpy model of K1's restart decode
(`picha_tpu_torch/csrc/huffman_decode_restart.cu`) held bit for bit to the
port's plain decoder (`decode_scan_plain`, itself pinned to the JAX
reference by tests/test_torch_huffman_decode.py). No JAX compile here.

The model follows the kernel: a thread a lane (a restart segment) steps
through K4's lookup tables (`test_torch_huffman_subwindow`'s model of
`csrc/huffman_lut.cuh`), at most `steps` symbols, stopping at bit_end;
each block is built in the lane's 64-int row (the DC made absolute from
the lane's predictor of its component, started at 0) and stored whole,
zeros included, when the block ends, below the segment's end; after the
decode, the block it stopped inside is stored as it stands and the
blocks of the segment it never reached are written as zeros with the
running DC; the rows between a segment's end and the next lane's first
block (and before the first lane's) are written as zeros. The output
starts as a sentinel and every row's stores are counted: each row must be
written exactly once, and nothing is zeroed first. Held to the plain
decode on the fixtures' restart wire, chopped segments, a lane out of its
step budget, images missing segments, per-image restart intervals and a
corrupted scan.
"""
import io

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_huffman_subwindow import step, tables
from torch_helpers import noisy, pil_jpeg, port_corpus

from picha_tpu_torch.ops import jpeg_huffman_decode as hd
from picha_tpu_torch.ops.jpeg_scan import ZIGZAG, parse_baseline
from picha_tpu_torch.ops.scan_batch import ScanBatch

SENTINEL = -0x5A5A5A5A


def k1_model(a, ks, comp_of):
    """huffman_decode_restart.cu on numpy arrays, every lane in lockstep:
    (coefficients (N, mcus*B, 64) int32, ok, stores a row)."""
    tb = tables(a, ks, comp_of, 1)
    tb.W = 1 << 40             # K1 reads its words without a window
    L, B, steps, rows = tb.L, tb.B, tb.steps, tb.rows
    out = np.full((rows, 64), SENTINEL, np.int64)
    stores = np.zeros(rows, np.int64)

    def store(blk, row):
        out[blk] = row
        stores[blk] += 1

    pos = tb.base * 32
    end = pos + tb.bits
    slot = np.zeros(L, np.int64)
    z = np.zeros(L, np.int64)
    cnt = np.zeros(L, np.int64)
    blk = tb.blk_base.copy()
    seg_end = np.minimum(np.maximum(tb.blk_limit, tb.blk_base), rows)
    pred = np.zeros((L, 4), np.int64)
    buf = np.zeros((L, 64), np.int64)
    while True:
        ai = np.nonzero((cnt < steps) & (pos < end))[0]
        if not ai.size:
            break
        adv, has, zc, val, zn = step(tb, ai, pos[ai], slot[ai], z[ai])
        comp = tb.comp_of[slot[ai]]
        emit = has & (blk[ai] < seg_end[ai])
        dc = emit & (z[ai] == 0)
        val = val + np.where(dc, pred[ai, comp], 0)
        pred[ai[dc], comp[dc]] = val[dc]
        buf[ai[emit], ZIGZAG[zc[emit]]] = val[emit]
        ended = zn >= 64
        for r in ai[ended]:
            if blk[r] < seg_end[r]:
                store(blk[r], buf[r])
            buf[r] = 0
            blk[r] += 1
        pos[ai] += adv
        cnt[ai] += 1
        slot[ai] = np.where(ended, (slot[ai] + 1) % B, slot[ai])
        z[ai] = np.where(ended, 0, zn)
    ok = not (pos < end).any()
    first = min(int(tb.blk_base[0]), rows) if L else rows
    for b in range(first):
        store(b, np.zeros(64, np.int64))
    for r in range(L):
        if z[r] > 0:
            if blk[r] < seg_end[r]:
                store(blk[r], buf[r])
            blk[r] += 1
        for b in range(blk[r], seg_end[r]):
            row = np.zeros(64, np.int64)
            row[0] = pred[r, tb.comp_of[(b - tb.blk_base[r]) % B]]
            store(b, row)
        nxt = min(int(tb.blk_base[r + 1]), rows) if r + 1 < L else rows
        for b in range(seg_end[r], nxt):
            store(b, np.zeros(64, np.int64))
    coefs = out.reshape(ks[6], ks[5] * ks[3], 64)
    return coefs, ok, stores


def batch(infos, steps=None):
    sb = ScanBatch(infos)
    if steps is not None:
        sb.steps = steps
    ks, wire = sb.wire()
    args, _q = hd.wire_unpack(torch.from_numpy(wire), ks, infos[0].ncomp)
    return args, ks, torch.as_tensor(sb.comp_of, dtype=torch.int32)


def check(args, ks, comp_of, want_ok=True):
    assert ks[9], "a restart single-pass batch"
    got, ok, stores = k1_model(args, ks, comp_of)
    assert (stores == 1).all(), "a row not written exactly once"
    want, ok_want = hd.decode_scan_plain(args, ks, comp_of)
    assert ok == bool(ok_want) == want_ok
    np.testing.assert_array_equal(got, want.numpy())
    return got


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain decoder's lockstep loops over small tensors run several
    times faster on one torch thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _chop(info):
    for k in range(0, len(info.segments), 3):
        info.segments[k] = info.segments[k][: len(info.segments[k]) // 2]
    return info


def test_model_matches_plain_on_the_fixture_wire():
    """A 1920x1088 restart-8 fixture: 1,020 segments, every row stored
    once by the lane whose segment holds it."""
    info = parse_baseline(port_corpus(1)[0])
    check(*batch([info]))


def test_model_matches_plain_on_chopped_segments():
    """Every third segment cut in half: the lanes run out of bits inside
    a block, which is stored as it stands, and the blocks they never
    reach carry the running DC."""
    infos = [_chop(parse_baseline(b)) for b in port_corpus(3)[1:]]
    got = check(*batch(infos))
    assert (got[:, :, 1:] == 0).all(axis=2).sum() > 1000


def test_model_matches_plain_out_of_budget():
    """A symbol budget of 128: every long lane stops short, ok is
    false."""
    info = parse_baseline(port_corpus(1)[0])
    check(*batch([info], steps=128), want_ok=False)


def test_model_matches_plain_with_missing_segments():
    """An image whose scan holds only its first 100 segments: no lane
    holds the rest of its rows, which the lane before them writes as
    zeros."""
    infos = [parse_baseline(b) for b in port_corpus(3)]
    infos[1].segments = infos[1].segments[:100]
    args, ks, comp_of = batch(infos)
    got = check(args, ks, comp_of)
    nblk = ks[5] * ks[3]
    assert (got[1, 100 * 8 * 6:] == 0).all()
    assert (got[2, :nblk] != 0).any()


@pytest.mark.parametrize("sub", ["4:2:0", "4:4:4"])
def test_model_matches_plain_per_image_restart_intervals(sub):
    """Three small images with restart intervals of 1, 2 and 5 MCUs (and
    a grey one with 3): segments of differing lengths, images of
    differing segment counts, the rows of a short last segment."""
    bufs = [pil_jpeg(noisy(s, 40, 72), quality=90, subsampling=sub,
                     restart_marker_blocks=ri)
            for s, ri in ((1, 1), (2, 2), (3, 5))]
    check(*batch([parse_baseline(b) for b in bufs]))
    grey = [pil_jpeg(noisy(4, 40, 72)[..., 0], restart_marker_blocks=3)]
    check(*batch([parse_baseline(b) for b in grey]))


def test_model_matches_plain_on_a_corrupted_scan():
    """Flipped scan bits: the garbage decodes to whatever the clamped
    table rule gives, the same in the model and the plain decoder."""
    buf = bytearray(port_corpus(1)[0])
    info = parse_baseline(bytes(buf))
    rng = np.random.default_rng(3)
    start = len(buf) - sum(len(s) + 2 for s in info.segments)
    for p in rng.integers(start, len(buf) - 2, 64):
        if buf[p] < 0xFE and buf[p - 1] != 0xFF:
            buf[p] ^= 0x01
    args, ks, comp_of = batch([parse_baseline(bytes(buf))])
    got, ok, stores = k1_model(args, ks, comp_of)
    want, ok_want = hd.decode_scan_plain(args, ks, comp_of)
    assert (stores == 1).all() and ok == bool(ok_want)
    np.testing.assert_array_equal(got, want.numpy())


def test_model_on_tables_of_their_own():
    """Two images re-encoded with optimize=True (each its own Huffman
    tables: K1 reads them from global memory on the card) at restart
    intervals of 8 MCUs."""
    src = port_corpus(1)[0]
    bufs = []
    for q in (80, 95):
        b = io.BytesIO()
        Image.open(io.BytesIO(src)).crop((0, 0, 256, 128)).save(
            b, "JPEG", quality=q, optimize=True, restart_marker_blocks=8)
        bufs.append(b.getvalue())
    args, ks, comp_of = batch([parse_baseline(b) for b in bufs])
    assert ks[7] >= 8
    check(args, ks, comp_of)
