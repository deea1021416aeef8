"""A numpy model of K29's tiled design (`csrc/coef_restore.cu`:
gap8_tile_sums, gap8_write, gap8_adds, the code K30 runs with the gap8
entry reading) held bit for bit to the port's plain `gap8_restore_plain`
(itself held to the reference's `gap8_restore` by
tests/test_torch_uploads.py) on gap8 wires that cross many tiles.

The model (`torch_helpers.tiled_restore_model`) runs the kernels'
decomposition at a small tile: every tile's gap sums, each tile's base as
the sum of its image's earlier tiles, its entries' indices from the base
and a scan of its own gaps, the cells it owns (from its first entry's
index, cell 0 for tile 0, to the next tile's first index, the plane's end
for the last tile) staged a chunk of cells at a time and stored as a
head, whole 16-byte words and a tail, the entries at the next tile's
first index summed into the tile's spill, then the spills and the
corrections added (K29 has no side stream). The output starts as a
sentinel: every cell must be written exactly once by the owned ranges.
Wires (`torch_helpers.gap8_tile_wires`): the numpy packer's, runs of zero
gaps across tile boundaries, gap-255 chains across tiles, an image with
no entries, one that ends before its plane, indices past the plane
(dropped: the expectation is the plain version on the wire with those
entries made no-ops), corrections at tile boundaries, and
hypothesis-drawn wires. Nothing here calls picha_tpu/native."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from torch_helpers import (gap4_indices, gap8_packed_wire, gap8_tile_wires,
                           gap8_within, tiled_restore_model)

from picha_tpu_torch.ops.coef_restore import gap8_restore_plain

def k29_model(g, v, ci, cv, m, tile, cells, vec=True):
    """K29's three kernels on numpy arrays -> ((n, m) int64 planes, (n,
    m) count of the owned-range writes of each cell)."""
    n = g.shape[0]
    side = (np.zeros((n, 0), np.uint8), np.zeros((n, 0), np.int8))
    return tiled_restore_model(g, v, *side, ci, cv, m, tile, cells, vec)


def plain(g, v, ci, cv, bh, bw):
    """gap8_restore_plain on the wire with the entries past the plane made
    no-ops (what K29 computes)."""
    g, v = gap8_within(g, v, bh * bw * 64)
    got = gap8_restore_plain(*(torch.from_numpy(np.ascontiguousarray(a))
                               for a in (g, v, ci, cv)), bh, bw)
    return got.numpy().reshape(g.shape[0], -1)


def check(wire, tile, cells, vec=True):
    g, v, ci, cv, bh, bw = wire
    m = bh * bw * 64
    got, writes = k29_model(g, v, ci, cv, m, tile, cells, vec)
    assert (writes == 1).all(), "a cell not written exactly once"
    np.testing.assert_array_equal(got, plain(*wire))


WIRES = gap8_tile_wires(11, 16)


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("name", sorted(WIRES))
def test_k29_model_matches_plain(name, vec):
    """Tiles of 16 entries, 32 cells staged at once (each tile's range
    spans several chunks; a gap-255 chain's tiles span hundreds)."""
    check(WIRES[name], 16, 32, vec)


@pytest.mark.parametrize("tile,cells", [(8, 8), (24, 1000), (64, 64)])
def test_k29_model_other_tiles(tile, cells):
    for name in ("packed", "zero_runs", "gap255", "past_m"):
        check(WIRES[name], tile, cells)


def test_k29_model_at_the_kernel_tile():
    """The kernel's own tile (2,048 entries, 8,192 staged cells) on the
    packer's wire of three 68 x 120-block planes: tens of tiles an
    image, each tile's range several staged chunks."""
    rng = np.random.default_rng(5)
    bh, bw = 68, 120
    wire = gap8_packed_wire(rng, 3, bh, bw) + (bh, bw)
    assert wire[0].shape[1] > 20 * 2048
    check(wire, 2048, 8192)


def test_k29_wires_hold_their_cases():
    """Each named wire holds what its name says, at the model's tile."""
    tile = 16
    g, v, _ci, _cv, bh, bw = WIRES["past_m"]
    assert gap4_indices(g)[0, -1] >= bh * bw * 64
    z, zv = WIRES["zero_runs"][:2]
    assert ((z[:, tile::tile] == 0) & (zv[:, tile::tile] != 0)).any()
    chain = WIRES["gap255"][0]
    runs = [len(r) for row in chain
            for r in np.split(row, np.flatnonzero(row != 255)) if len(r)]
    assert max(runs) > 2 * tile
    assert (WIRES["empty_image"][0][1] == 0).all()
    sh = WIRES["short_image"]
    assert gap4_indices(sh[0])[2, -1] < sh[4] * sh[5] * 64 // 2 + 255
    g, _v, ci, _cv, bh, bw = WIRES["boundary_corrections"]
    m = bh * bw * 64
    firsts = gap4_indices(g)[:, ::tile]
    assert np.isin((np.arange(3)[:, None] * m + firsts).reshape(-1),
                   ci).all()
    for name, w in WIRES.items():
        assert w[0].shape[1] > 4 * tile, name


def test_k29_model_spills_runs_across_boundaries():
    """A run of equal indices spanning whole tiles: the tiles own nothing
    and spill every value to the cell's owner; a gap-255 chain after it
    crosses two tiles."""
    n, bh, bw, tile = 2, 40, 2, 8
    m = bh * bw * 64
    g = np.zeros((n, 8 * tile), np.uint8)
    v = np.zeros((n, 8 * tile), np.int8)
    g[:, 0], v[:, 0] = 5, 2                  # cell 4, value 2
    v[:, 1:4 * tile] = 1                     # gap 0, value 1: cell 4
    g[:, 4 * tile:6 * tile] = 255            # a chain, values 0
    g[:, 6 * tile], v[:, 6 * tile] = 9, -7   # cell 4 + 16 * 255 + 9
    ci = np.array([4, m + 4 + 16 * 255 + 9], np.int32)
    cv = np.array([300, -300], np.int16)
    got, writes = k29_model(g, v, ci, cv, m, tile, 16)
    assert (writes == 1).all()
    want = plain(g, v, ci, cv, bh, bw)
    np.testing.assert_array_equal(got, want)
    c = 4 + 16 * 255 + 9
    assert want[0, 4] == 2 + 4 * tile - 1 + 300 and want[0, c] == -7
    assert want[1, c] == -7 - 300


@st.composite
def wires(draw):
    n = draw(st.integers(1, 3))
    bh, bw = draw(st.integers(1, 3)), draw(st.integers(1, 2))
    m = bh * bw * 64
    k = draw(st.integers(0, 120))
    seed = draw(st.integers(0, 2 ** 32 - 1))
    rng = np.random.default_rng(seed)
    hi_gap = draw(st.sampled_from([1, 3, 16, 256]))
    g = rng.integers(0, hi_gap, (n, k)).astype(np.uint8)
    v = rng.integers(-128, 128, (n, k)).astype(np.int8)
    kc = draw(st.integers(0, 6))
    ci = rng.integers(0, n * m, kc).astype(np.int32)
    cv = rng.integers(-900, 900, kc).astype(np.int16)
    return g, v, ci, cv, bh, bw


@settings(max_examples=100, deadline=None, derandomize=True)
@given(wire=wires(), tile=st.sampled_from([8, 16, 32]),
       cells=st.sampled_from([4, 8, 40]), vec=st.booleans())
def test_k29_model_on_drawn_wires(wire, tile, cells, vec):
    check(wire, tile, cells, vec)
