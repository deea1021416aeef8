"""A numpy model of K27's tiled design (`csrc/coef_restore.cu`:
densify_write, then densify_adds, on the tiled code of K29 and K30 with
the sparse upload's entries, which carry their index) held bit for bit to
the port's plain `densify_plain` and to the reference's
`_jit_batch_graph.densify` on JAX-CPU (read out of the batch graph's
closure, as tests/test_torch_uploads.py does).

The model (`torch_helpers.densify_model`) runs the kernel's
decomposition at a small tile: tile t of a row owns the cells from its
first entry's index to the next tile's first index (tile 0 from cell 0,
the last tile to the plane's end), clamped to the plane; it stages them
a chunk of cells at a time, adds its entries' values there and stores
the cells as a head, whole 16-byte words and a tail; its entries at the
next tile's first index (a run of one index across the edge, the padding
run at m - 1 across many tiles) go to its spill, which the second launch
adds. The output starts as a sentinel: every cell must be written
exactly once. Indices outside the plane add nothing (the expectation is
the plain version on the wire with those entries made no-ops). A row
whose index decreases is flagged where the kernel traps. Wires:
`torch_helpers.densify_tile_wires` (the packer's, the padding run over
three or more tiles, a nonzero at m - 1 before the padding, a row all
padding, runs of one index across tile edges, indices past m, indices
below 0), `repeated_index_wires`, and tile sizes other than the
kernel's. Nothing here calls picha_tpu/native."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import (densify_decreasing_wires, densify_model,
                           densify_packed_wire, densify_tile_wires,
                           pil_jpeg, repeated_index_wires, smooth_rgb)

from picha_tpu.pipeline import jpeg_batch as ref_jb
from picha_tpu_torch.ops.coef_restore import densify_plain
from picha_tpu_torch.pipeline import JpegBatchPipeline

TILE, CELLS = 2048, 8192     # the kernel's kTileEntries and kStagedCells
WIRES = densify_tile_wires(11, 16)


def plain(idx, val, bh, bw):
    """densify_plain on the wire with the entries outside the plane made
    no-ops (what K27 computes) -> (n, m) int32."""
    m = bh * bw * 64
    inside = (idx >= 0) & (idx < m)
    i = np.where(inside, idx, 0).astype(np.int32)
    v = np.where(inside, val, 0).astype(np.int16)
    got = densify_plain(torch.from_numpy(i), torch.from_numpy(v), bh, bw)
    return got.numpy().reshape(idx.shape[0], -1)


def check(wire, tile, cells, vec=True):
    idx, val, bh, bw = wire
    got, writes, ordered = densify_model(idx, val, bh * bw * 64, tile, cells,
                                         vec)
    assert ordered
    assert (writes == 1).all(), "a cell not written exactly once"
    np.testing.assert_array_equal(got, plain(*wire))
    return got


_REF = []


def reference_densify():
    """The reference's `densify` (the closure of its batch graph for a
    sparse upload; it does not depend on the batch's signature)."""
    if not _REF:
        pipe = JpegBatchPipeline(encode_quality=None, fused=False,
                                 upload="sparse", device="cpu")
        cos = pipe.entropy_decode([pil_jpeg(smooth_rgb(24, 32, 1),
                                            quality=85)])
        sig, ks, _args = pipe.stack_bucket(cos)
        inner = ref_jb._jit_batch_graph(sig, None, None, "cubic", 1.0, False,
                                        None, sparse_ks=ks).__wrapped__
        _REF.append(inner.__closure__[
            inner.__code__.co_freevars.index("densify")].cell_contents)
    return _REF[0]


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("name", sorted(WIRES))
def test_k27_model_matches_plain(name, vec):
    """Tiles of 16 entries, 32 cells staged at once (each tile's range
    spans several chunks; the padding run's tiles own nothing)."""
    check(WIRES[name], 16, 32, vec)


@pytest.mark.parametrize("tile,cells", [(8, 8), (24, 1000), (64, 64),
                                        (100, 12)])
def test_k27_model_other_tiles(tile, cells):
    for name, wire in densify_tile_wires(3, tile).items():
        check(wire, tile, cells)
    for name in ("packed", "repeats", "past_m", "last_cell"):
        check(WIRES[name], tile, cells)


def test_k27_model_at_the_kernel_tile():
    """The kernel's own tile (2,048 entries, 8,192 staged cells) on the
    packer's wire of three 48 x 60-block planes: tens of tiles an image,
    each tile's range several staged chunks."""
    rng = np.random.default_rng(5)
    bh, bw = 48, 60
    wire = densify_packed_wire(rng, 3, bh, bw, 0.1, 16384) + (bh, bw)
    assert wire[0].shape[1] > 8 * TILE
    check(wire, TILE, CELLS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k27_model_adds_every_entry_at_repeated_indices(seed):
    """`repeated_index_wires`' sparse wire (duplicate sorted indices, each
    added), at tiles that cut its runs."""
    idx, val = repeated_index_wires(seed)["sparse"]
    for tile, cells in ((8, 16), (32, 8), (7, 100)):
        check((idx, val, 2, 3), tile, cells)


def test_k27_wires_hold_their_cases():
    """Each named wire holds what its name says, at the model's tile."""
    tile = 16
    idx, val, bh, bw = WIRES["padding_run"]
    m = bh * bw * 64
    pad = (idx[1] == m - 1) & (val[1] == 0)
    assert pad.sum() >= 3 * tile
    assert (idx[1, ::tile] == m - 1).sum() >= 3
    idx, val = WIRES["last_cell"][:2]
    first = np.flatnonzero(idx[1] == m - 1)[0]
    assert val[1, first] != 0 and (val[1, first + 1:] == 0).all()
    assert (WIRES["all_padding"][0][2] == m - 1).all()
    assert (WIRES["all_padding"][1][2] == 0).all()
    idx, val = WIRES["repeats"][:2]
    assert ((idx[:, tile::tile] == idx[:, tile - 1:-1:tile]) &
            (val[:, tile::tile] != 0)).any()
    assert (WIRES["past_m"][0][0, -1] >= m) and (WIRES["past_m"][1][0, -1])
    assert WIRES["negative"][0][2, 0] < 0
    for name, w in WIRES.items():
        assert w[0].shape[1] > 4 * tile, name


def test_k27_model_spills_runs_across_tiles():
    """A run of one index over whole tiles: those tiles own nothing and
    spill every value to the cell's owner, which writes it once."""
    n, bh, bw, tile = 2, 3, 2, 8
    m = bh * bw * 64
    idx = np.full((n, 8 * tile), m - 1, np.int32)
    val = np.zeros((n, 8 * tile), np.int16)
    idx[:, :4 * tile + 3] = 5
    val[:, :4 * tile + 3] = 1
    idx[:, 4 * tile + 3] = m - 1
    val[:, 4 * tile + 3] = -9
    got = check((idx, val, bh, bw), tile, 16)
    assert got[0, 5] == 4 * tile + 3 and got[0, m - 1] == -9
    assert (np.delete(got[0], [5, m - 1]) == 0).all()


@pytest.mark.parametrize("name", ["in_thread", "across_threads",
                                  "across_tile", "after_padding"])
def test_k27_model_flags_a_decreasing_row(name):
    """A row whose index decreases once (inside a thread's eight entries,
    between two threads, across a tile's edge, after the padding run) is
    flagged, where the kernel traps; the ordered row beside it is not
    the fault."""
    idx, val, bh, bw = densify_decreasing_wires(TILE)[name]
    assert (np.diff(idx[0].astype(np.int64)) >= 0).all()
    _out, _w, ordered = densify_model(idx, val, bh * bw * 64, TILE, CELLS)
    assert not ordered
    _out, _w, ordered = densify_model(idx[:1], val[:1], bh * bw * 64, TILE,
                                      CELLS)
    assert ordered


@pytest.mark.parametrize("name", ["packed", "padding_run", "last_cell",
                                  "all_padding", "repeats", "past_m"])
def test_k27_model_matches_reference_densify(name):
    """The reference's own densify (a scatter-add into zeros, indices past
    the plane dropped) on the same wire, on JAX-CPU."""
    idx, val, bh, bw = WIRES[name]
    got = check(WIRES[name], 16, 32)
    want = np.asarray(reference_densify()(jnp.asarray(idx), jnp.asarray(val),
                                          bh, bw))
    np.testing.assert_array_equal(got, want.reshape(idx.shape[0], -1))
