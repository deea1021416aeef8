"""A numpy model of K30's tiled design (`csrc/coef_restore.cu`:
gap4_tile_sums, gap4_write, gap4_adds) held bit for bit to the port's
plain `gap4_restore_plain` on gap4 wires that cross many tiles.

The model runs the kernels' decomposition at a small tile: every tile's
gap sums (primary and side stream), each tile's base as the sum of its
image's earlier tiles, its entries' indices from the base and a scan of
its own gaps, the cells it owns (from its first entry's index, cell 0 for
tile 0, to the next tile's first index, the plane's end for the last
tile) staged a chunk of cells at a time and stored as a head, whole
16-byte words and a tail, the entries at the next tile's first index
summed into the tile's spill, then the side stream, the spills and the
corrections added. The output starts as a sentinel: every cell must be
written exactly once by the owned ranges, and no entry may fall before
its tile's range. Wires: the numpy packer's, runs of zero gaps across
tile boundaries, an image with no entries, one that ends before its
plane, indices past the plane (dropped: the expectation is the plain
version on the wire with those entries made no-ops), escapes, side
values and corrections at tile boundaries, an empty primary stream, and
hypothesis-drawn wires. Nothing here calls picha_tpu/native."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from torch_helpers import (gap4_indices, gap4_tile_wires, gap4_within,
                           tiled_restore_model)

from picha_tpu_torch.ops.coef_restore import gap4_restore_plain


def k30_model(prim, sg, sv, ci, cv, m, tile, cells, vec=True):
    """K30's three kernels on numpy arrays -> ((n, m) int64 planes, (n,
    m) count of the owned-range writes of each cell): the tiled model
    with the primary byte's gap (b >> 4) and value ((b & 15) - 7, 0 at
    the escape 15)."""
    nib = (prim & 15).astype(np.int64)
    return tiled_restore_model(prim >> 4, np.where(nib == 15, 0, nib - 7),
                               sg, sv, ci, cv, m, tile, cells, vec)


def plain(prim, sg, sv, ci, cv, bh, bw):
    """gap4_restore_plain on the wire with the entries past the plane made
    no-ops (what K30 computes)."""
    prim, sg, sv = gap4_within(prim, sg, sv, bh * bw * 64)
    got = gap4_restore_plain(*(torch.from_numpy(np.ascontiguousarray(a))
                               for a in (prim, sg, sv, ci, cv)), bh, bw)
    return got.numpy().reshape(prim.shape[0], -1)


def check(wire, tile, cells, vec=True):
    prim, sg, sv, ci, cv, bh, bw = wire
    m = bh * bw * 64
    got, writes = k30_model(prim, sg, sv, ci, cv, m, tile, cells, vec)
    assert (writes == 1).all(), "a cell not written exactly once"
    np.testing.assert_array_equal(got, plain(*wire))


WIRES = gap4_tile_wires(11, 16)


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("name", sorted(WIRES))
def test_k30_model_matches_plain(name, vec):
    """Tiles of 16 entries, 32 cells staged at once (each tile's range
    spans several chunks)."""
    check(WIRES[name], 16, 32, vec)


@pytest.mark.parametrize("tile,cells", [(8, 8), (24, 1000), (64, 64)])
def test_k30_model_other_tiles(tile, cells):
    for name in ("packed", "zero_runs", "boundary_escapes", "past_m"):
        check(WIRES[name], tile, cells)


def test_k30_wires_hold_their_cases():
    """Each named wire holds what its name says, at the model's tile."""
    tile = 16
    prim, sg, sv, _ci, _cv, bh, bw = WIRES["past_m"]
    m = bh * bw * 64
    assert gap4_indices(prim >> 4)[0, -1] >= m
    assert gap4_indices(sg)[0, -1] >= m
    z = WIRES["zero_runs"][0]
    assert ((z[:, tile::tile] >> 4) == 0).all()
    assert (WIRES["empty_image"][0][1] == 0x07).all()
    sh = WIRES["short_image"][0]
    assert gap4_indices(sh >> 4)[2, -1] < m // 2 + 16
    esc = WIRES["boundary_escapes"][0]
    assert ((esc[:, ::tile] & 15) == 15).all()
    assert WIRES["no_primary"][0].shape[1] == 0
    for name, w in WIRES.items():
        assert w[0].shape[1] == 0 or w[0].shape[1] > 8 * tile, name


def test_k30_model_spills_runs_across_boundaries():
    """A run of equal indices spanning whole tiles: the tiles own nothing
    and spill every value to the cell's owner."""
    n, bh, bw, tile = 2, 1, 2, 8
    m = bh * bw * 64
    prim = np.full((n, 6 * tile), 0x07, np.uint8)
    prim[:, 0] = (5 << 4) | 9                # cell 4, value 2
    prim[:, 1:4 * tile] = 8                  # gap 0, value 1: cell 4
    prim[:, 4 * tile] = (15 << 4) | 0        # cell 19, value -7
    sg = np.zeros((n, 0), np.uint8)
    sv = np.zeros((n, 0), np.int8)
    ci = np.zeros(0, np.int32)
    cv = np.zeros(0, np.int16)
    got, writes = k30_model(prim, sg, sv, ci, cv, m, tile, 16)
    assert (writes == 1).all()
    want = plain(prim, sg, sv, ci, cv, bh, bw)
    np.testing.assert_array_equal(got, want)
    assert want[0, 4] == 2 + 4 * tile - 1 and want[0, 19] == -7


@st.composite
def wires(draw):
    n = draw(st.integers(1, 3))
    bh, bw = draw(st.integers(1, 3)), draw(st.integers(1, 2))
    m = bh * bw * 64
    k1 = draw(st.integers(0, 120))
    k2 = draw(st.integers(0, 40))
    seed = draw(st.integers(0, 2 ** 32 - 1))
    rng = np.random.default_rng(seed)
    hi_gap = draw(st.sampled_from([1, 3, 16]))
    prim = ((rng.integers(0, hi_gap, (n, k1)) << 4)
            | rng.integers(0, 16, (n, k1))).astype(np.uint8)
    sg = rng.integers(0, draw(st.sampled_from([2, 30, 256])),
                      (n, k2)).astype(np.uint8)
    sv = rng.integers(-128, 128, (n, k2)).astype(np.int8)
    kc = draw(st.integers(0, 6))
    ci = rng.integers(0, n * m, kc).astype(np.int32)
    cv = rng.integers(-900, 900, kc).astype(np.int16)
    return prim, sg, sv, ci, cv, bh, bw


@settings(max_examples=100, deadline=None, derandomize=True)
@given(wire=wires(), tile=st.sampled_from([8, 16, 32]),
       cells=st.sampled_from([4, 8, 40]), vec=st.booleans())
def test_k30_model_on_drawn_wires(wire, tile, cells, vec):
    check(wire, tile, cells, vec)
