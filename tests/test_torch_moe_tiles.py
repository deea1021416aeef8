"""The tuned K19's design (`csrc/vit_moe.cu::moe_route_dispatch_tiles`)
as a numpy model of its phases, held bit for bit to
`ops.moe.route_dispatch_plain` and to the reference's `_switch_moe`
dispatch lines (picha_tpu/models/vit.py:211-224) on JAX-CPU:

- tiles of `TILE_TOKENS` tokens in token order; in each, warps of 32
  tokens grouped by expert as `__match_any_sync` groups them: a token's
  rank among the earlier lanes of its expert, each warp's count;
- each tile's exclusive prefix by the kernel's decoupled look-back (a
  warp an expert, 32 descriptors a step, adding aggregates up to the
  nearest inclusive prefix) on snapshots of the earlier tiles'
  descriptors drawn at random (all aggregates, all inclusive, a mix),
  checked against the true prefix;
- slots (the prefix, the earlier warps' counts, the rank), drops past
  `cap`; the rows' 16-byte words walked as each thread walks them
  (`WordWalk`: the first `PREFETCH` words in flight, then the rest
  `PREFETCH` at a time, stepped without a division), -0 stored as +0;
- the rows past each expert's count zeroed as E contiguous ranges
  shared by a grid of CTAs; every word of the buffer written exactly
  once.

Cases: token counts below, at and past one tile and no multiple of it;
E = 1, 4, 64; router ties (the first maximum wins); a skewed router and
one expert taking every token (drops); cap 1; rows of 1, 8, 48, 256 and
257 words.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picha_tpu_torch.ops import moe

THREADS, PREFETCH = 256, 8           # csrc/vit_moe.cu: kThreads, kPrefetch
TILE = moe.TILE_TOKENS
GRID = 132 * 3                       # a card's SMs x blocks an SM
SENTINEL = 0x7FC1


def _inputs(t, e, d, kind, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    if kind == "skewed":             # expert 0 takes most tokens: drops
        logits[:, 0] += 2.0
    elif kind == "tie":              # equal top logits: the first wins
        logits[::3, min(1, e - 1)] = logits[::3].max(-1)
        logits[::3, e - 1] = logits[::3, min(1, e - 1)]
    elif kind == "one":              # every token on expert 0
        logits[:, 0] = 50.0
    y = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32)
                         * 2.0).to(torch.bfloat16)
    y[::5, ::3] = -0.0
    return logits, y


def _look_back(desc, tile, e, lane_count=32):
    """The kernel's look_back on a descriptor snapshot: desc[p, e] =
    (flag, value), flag 1 an aggregate, 2 an inclusive prefix."""
    if tile == 0:
        return 0
    excl, p = 0, tile - 1
    while True:
        lanes = [p - lane for lane in range(lane_count)]
        flags = [desc[q, e, 0] if q >= 0 else 2 for q in lanes]
        vals = [desc[q, e, 1] if q >= 0 else 0 for q in lanes]
        assert all(f in (1, 2) for f in flags)     # every lane waited
        incl = [lane for lane in range(lane_count) if flags[lane] == 2]
        last = incl[0] if incl else lane_count - 1
        excl += sum(vals[:last + 1])
        if incl:
            return excl
        p -= lane_count


def k19_tiles_model(logits, y, cap, p_inclusive, seed):
    """The tuned K19 in numpy: (xe (E, cap, d) bf16 bits as uint16,
    eidx, sidx int32, gk float32)."""
    t, n_exp = logits.shape
    d = y.shape[1]
    chunks = d // 8
    expert_t, gate_t = moe.route_plain(torch.from_numpy(logits))
    expert, gate = expert_t.numpy(), gate_t.numpy()
    ntiles = -(-t // TILE)
    ex = np.full(ntiles * TILE, -1, np.int64)
    ex[:t] = expert
    ex = ex.reshape(ntiles, TILE // 32, 32)
    # a warp's groups: rank among its earlier lanes of the same expert
    oh = ex[..., None] == np.arange(n_exp)                # (T, W, 32, E)
    rank = (np.cumsum(oh, 2) - oh).astype(np.int64)
    rank = np.where(ex >= 0, np.take_along_axis(
        rank, np.maximum(ex, 0)[..., None], 3)[..., 0], 0)
    wcount = oh.sum(2)                                    # (T, W, E)
    agg = wcount.sum(1)                                   # (T, E)
    incl_true = np.cumsum(agg, 0)
    # look-backs on random snapshots of the earlier descriptors
    rng = np.random.default_rng(seed)
    desc = np.zeros((ntiles, n_exp, 2), np.int64)
    excl = np.zeros((ntiles, n_exp), np.int64)
    for tile in range(ntiles):
        for e in range(n_exp):
            excl[tile, e] = _look_back(desc, tile, e)
            assert excl[tile, e] == incl_true[tile, e] - agg[tile, e]
        for p in range(tile + 1):        # the snapshot the next tile sees
            inc = p == tile or rng.random() < p_inclusive
            desc[p, :, 0] = 2 if inc else 1
            desc[p, :, 1] = incl_true[p] if inc else agg[p]
    # slots, drops
    earlier = np.cumsum(wcount, 1) - wcount                # (T, W, E)
    eidx = np.full(t, -1, np.int64)
    sidx = np.full(t, -1, np.int64)
    gk = np.zeros(t, np.float32)
    dst = np.full((ntiles, TILE), -1, np.int64)
    for tile in range(ntiles):
        for tok in range(min(TILE, t - tile * TILE)):
            i = tile * TILE + tok
            w, lane = divmod(tok, 32)
            e = int(expert[i])
            slot = excl[tile, e] + earlier[tile, w, e] + rank[tile, w, lane]
            keep = slot < cap
            eidx[i] = e if keep else n_exp
            sidx[i] = slot if keep else 0
            gk[i] = gate[i] if keep else np.float32(0.0)
            if keep:
                dst[tile, tok] = (e * cap + slot) * chunks
    # the rows' words as each thread walks them, -0 stored as +0
    words = y.view(torch.int16).numpy().view(np.uint16).reshape(t, chunks, 8)
    words = np.where(words == 0x8000, np.uint16(0), words)
    xe = np.full((n_exp * cap * chunks, 8), SENTINEL, np.uint16)
    writes = np.zeros(n_exp * cap * chunks, np.int64)
    tid = np.arange(THREADS)
    q, r = THREADS // chunks, THREADS % chunks
    for tile in range(ntiles):
        nrows = min(TILE, t - tile * TILE)
        row, c = tid // chunks, tid % chunks
        seen = 0
        while (row < nrows).any():
            for _ in range(PREFETCH):
                live = row < nrows
                k = tid + seen * THREADS
                assert (row[live] * chunks + c[live] == k[live]).all()
                d_row = np.where(live, dst[tile, np.minimum(row, TILE - 1)],
                                 -1)
                kept = live & (d_row >= 0)
                at = d_row[kept] + c[kept]
                xe[at] = words[tile * TILE + row[kept], c[kept]]
                np.add.at(writes, at, 1)
                row, c = row + q, c + r
                wrap = c >= chunks
                c, row = np.where(wrap, c - chunks, c), row + wrap
                seen += 1
    # the rows past each expert's count: E ranges over the grid
    totals = np.minimum(incl_true[-1], cap)
    grid = min(ntiles, GRID)
    g = np.arange(grid * THREADS)
    for e in range(n_exp):
        a, b = (e * cap + totals[e]) * chunks, (e + 1) * cap * chunks
        for k0 in range(a, b, grid * THREADS):
            at = k0 + g
            at = at[at < b]
            xe[at] = 0
            np.add.at(writes, at, 1)
    assert (writes == 1).all()                   # every word written once
    return (xe.reshape(n_exp, cap, d), eidx.astype(np.int32),
            sidx.astype(np.int32), gk)


def _reference_dispatch(logits, y, cap):
    """picha_tpu/models/vit.py:211-224 on JAX-CPU from the router logits:
    (xe bits, eidx, sidx, gate * keep)."""
    n_exp = logits.shape[1]
    lg = jnp.asarray(logits)
    gates = jax.nn.softmax(lg, axis=-1)
    expert = jnp.argmax(gates, axis=-1)
    gate = jnp.max(gates, axis=-1)
    oh = jax.nn.one_hot(expert, n_exp, dtype=jnp.float32)
    pos = (jnp.cumsum(oh, axis=0) - 1.0) * oh
    slot = jnp.sum(pos, axis=-1).astype(jnp.int32)
    keep = slot < cap
    eidx = jnp.where(keep, expert, n_exp)
    sidx = jnp.where(keep, slot, 0)
    yb = jnp.asarray(y.float().numpy()).astype(jnp.bfloat16)
    xe = jnp.zeros((n_exp + 1, cap, y.shape[1]), jnp.bfloat16).at[
        eidx, sidx].add(yb)[:n_exp]
    bits = np.asarray(jax.lax.bitcast_convert_type(xe, jnp.uint16))
    return (bits, np.asarray(eidx), np.asarray(sidx),
            np.asarray(gate * keep), np.asarray(gates))


# (t, E, d, router, capacity factor or cap)
CASES = {
    "one_token": (1, 4, 384, "normal", 1.5),
    "one_tile": (64, 4, 384, "normal", 1.5),
    "past_a_tile": (65, 4, 64, "normal", 1.5),
    "odd": (200, 4, 8, "normal", 1.5),
    "many_tiles_skewed": (4097, 4, 64, "skewed", 1.5),
    "one_expert": (3000, 1, 8, "normal", 1.5),
    "experts_64": (2000, 64, 16, "normal", 1.5),
    "ties": (777, 4, 16, "tie", 1.5),
    "all_on_one": (500, 8, 8, "one", 0.5),
    "cap_1": (130, 4, 8, "normal", "cap1"),
    "words_256": (70, 4, 2048, "normal", 1.5),
    "words_257": (70, 4, 2056, "skewed", 1.5),
}


@pytest.mark.parametrize("p_inclusive", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("name", list(CASES))
def test_k19_tiles_model_is_the_plain_version(name, p_inclusive):
    t, e, d, kind, cf = CASES[name]
    logits, y = _inputs(t, e, d, kind, seed=t + e + d)
    cap = 1 if cf == "cap1" else moe.capacity(t, e, cf)
    xe, eidx, sidx, gk = k19_tiles_model(logits, y, cap, p_inclusive,
                                         seed=len(name))
    want = moe.route_dispatch_plain(torch.from_numpy(logits), y, cap)
    np.testing.assert_array_equal(
        xe, want[0].view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(eidx, want[1].numpy())
    np.testing.assert_array_equal(sidx, want[2].numpy())
    assert gk.tobytes() == want[3].numpy().tobytes()
    if kind in ("skewed", "one") or cf == "cap1":
        assert (eidx == e).any()                 # tokens really drop


@pytest.mark.parametrize("name", ["many_tiles_skewed", "experts_64", "ties",
                                  "cap_1"])
def test_k19_tiles_model_is_the_reference_dispatch(name):
    """Against the reference's lines on JAX-CPU: routing, slots and the
    buffer bit for bit (its softmax sums in its own order, so the gate
    within 1e-6 relative; the inputs' top-2 gates are equal or more than
    1e-6 of the top gate apart, a few ulps, so both take the same
    expert)."""
    t, e, d, kind, cf = CASES[name]
    logits, y = _inputs(t, e, d, kind, seed=t + e + d)
    cap = 1 if cf == "cap1" else moe.capacity(t, e, cf)
    xe, eidx, sidx, gk = k19_tiles_model(logits, y, cap, 0.3, seed=7)
    r_xe, r_eidx, r_sidx, r_gk, gates = _reference_dispatch(logits, y, cap)
    if e > 1:
        top2 = np.sort(gates, -1)[:, -2:]
        gap = top2[:, 1] - top2[:, 0]
        assert ((gap == 0) | (gap > 1e-6 * top2[:, 1])).all()
    np.testing.assert_array_equal(xe, r_xe)
    np.testing.assert_array_equal(eidx, r_eidx)
    np.testing.assert_array_equal(sidx, r_sidx)
    np.testing.assert_allclose(gk, r_gk, rtol=1e-6, atol=0)


def test_k19_scratch_follows_the_route():
    """The tuned kernel's scratch is its ticket and a descriptor a tile
    and expert; past the envelope, the block table and the totals."""
    assert moe.scratch_bytes(50176, 4, 384) == 16 + 784 * 4 * 8
    assert moe.scratch_bytes(1, 64, 8) == 16 + 64 * 8
    assert moe.scratch_bytes(3001, 128, 64) == (12 + 1) * 128 * 4
    assert moe.scratch_bytes(257, 4, 387) == (2 + 1) * 4 * 4
