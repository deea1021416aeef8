"""Baseline JPEG Huffman decode of whole scans on the device.

Counterpart of `picha_tpu/ops/jpeg_huffman_decode_tpu.py`:
`build_wire_unpack` -> `wire_unpack`, `build_decoder_core` ->
`decode_scan`, `split_planes` -> `split_planes`. The host side
(`ScanBatch`: segment geometry, deduplicated tables, the coalesced
wire) is the port's copy in `ops/scan_batch.py`, behind `scan_wire`.

`decode_scan` dispatches on the batch's mode (`ScanBatch.single_pass`):
- restart single-pass (one lane per restart segment, exact entries):
  kernel K1 (`csrc/huffman_decode_restart.cu`: the lookup tables built
  on the card, then a thread a lane storing whole blocks, every row of
  the output written once) for CUDA tensors, `decode_scan_plain` for
  CPU tensors;
- chunked speculative decode (scans without restart markers, or with
  segments no lane can hold whole): kernel K4
  (`csrc/huffman_decode_chunked.cu`: a thread a lane for the Jacobi
  passes, block starts and settle in one cooperative launch, then an
  emission a thread a window of K4_WINDOWS from checkpoints the passes
  record, storing whole 256-byte blocks) then the DC scan K5
  (`dc_integrate`, two launches) for CUDA tensors,
  `decode_scan_chunked_plain` for CPU tensors.
Both plain decoders step every lane in lockstep through `_symbol`, one
Huffman symbol per step, and integrate DC with `dc_integrate_plain`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels._build import KERNELS, ptr, require_cuda, stream_of
from .jpeg_scan import ZIGZAG
from .scan_batch import MAX_PASSES, ScanBatch


class DecoderArgs(NamedTuple):
    """Device views of `ScanBatch.wire()`, in `ScanBatch.args()` order.
    `words` holds the big-endian-packed u32 scan words as int32 bits."""
    words: torch.Tensor
    lane_word_base: torch.Tensor
    lane_bits: torch.Tensor
    lane_pinned: torch.Tensor
    lane_seg_first: torch.Tensor
    lane_blk_base: torch.Tensor
    lane_blk_limit: torch.Tensor
    limit: torch.Tensor
    delta: torch.Tensor
    hv: torch.Tensor
    lane_uid6: torch.Tensor
    ri_blk: torch.Tensor


def wire_unpack(buf: torch.Tensor, scan_ks, ncomp: int):
    """1-D uint8 wire (`ScanBatch.wire()`, already on its device) ->
    (DecoderArgs, qtabs tuple of (N, 1, 1, 64) int32). Every section is
    a view of `buf`; the layout follows the code of `ScanBatch.wire`
    (ri_blk ships as int32)."""
    (_C, n_lanes, _steps, _B, _comp_of, _mcus, n_img, n_uniq, _nblkmax,
     _single, nw) = scan_ks
    off = 0

    def take(count, dtype):
        nonlocal off
        width = torch.empty((), dtype=dtype).element_size()
        raw = buf[off:off + count * width]
        off += count * width
        return raw if dtype == torch.uint8 else raw.view(dtype)

    words = take(nw, torch.int32)
    lanes = [take(n_lanes, torch.int32) for _ in range(5)]
    limit = take(n_uniq * 16, torch.int32).view(n_uniq, 16)
    delta = take(n_uniq * 17, torch.int32).view(n_uniq, 17)
    hv = take(n_uniq * 256, torch.int32).view(n_uniq, 256)
    qtabs = tuple(
        (take(n_img * 64, torch.int16).to(torch.int32) & 0xFFFF)
        .view(n_img, 1, 1, 64) for _ in range(ncomp))
    lane_pinned = take(n_lanes, torch.uint8) != 0
    lane_uid6 = take(n_lanes * 6, torch.uint8).view(n_lanes, 6)
    ri_blk = take(n_img, torch.int32)
    if off != buf.numel():
        raise ValueError(f"wire holds {buf.numel()} bytes, layout {off}")
    args = DecoderArgs(words, lanes[0], lanes[1], lane_pinned, lanes[2],
                       lanes[3], lanes[4], limit, delta, hv, lane_uid6,
                       ri_blk)
    return args, qtabs


def scan_wire(infos):
    """Parsed scans (`parse_baseline`) -> (scan_ks, wire): the decoder's
    static key and the one coalesced uint8 host buffer that `wire_unpack`
    takes apart on the device (`ScanBatch.wire()`), for restart and
    chunked batches alike. Raises ValueError past ScanBatch's capacity
    gates."""
    return ScanBatch(infos).wire()


def decode_scan(args: DecoderArgs, scan_ks, comp_of: torch.Tensor,
                max_passes: int = MAX_PASSES):
    """Whole-scan decode -> (coefs (N, mcus*B, 64) int32 in scan order,
    natural coefficient order, absolute DC; ok 0-dim bool tensor).
    `comp_of` is the (B,) int32 slot->component table on the same
    device. Restart single-pass batches (`scan_ks[9]`) take K1, chunked
    batches K4 + K5 (`max_passes` Jacobi passes at most); CPU tensors
    take the plain versions."""
    if scan_ks[9]:
        if args.words.device.type == "cpu":
            return decode_scan_plain(args, scan_ks, comp_of)
        return _decode_scan_kernel(args, scan_ks, comp_of)
    out, ok, _passes = decode_scan_chunked(args, scan_ks, comp_of,
                                           max_passes)
    return out, ok


def _decode_scan_kernel(a: DecoderArgs, scan_ks, comp_of):
    """K1: the table build, then a thread a lane storing whole blocks
    (every row of the output written once: nothing zeroed first)."""
    (_C, n_lanes, steps, B, comp_sig_of, mcus, n_img, n_uniq, _nblkmax,
     _single, _nw) = scan_ks
    _check_kernel_args(a, scan_ks, comp_of, "K1")
    dev = a.words.device
    rows = n_img * mcus * B
    out = torch.empty((rows, 64), dtype=torch.int32, device=dev)
    lut = torch.empty(LUT_INTS * n_uniq, dtype=torch.int32, device=dev)
    ok = torch.ones(1, dtype=torch.int32, device=dev)
    KERNELS["huffman_decode_restart"](
        ptr(a.words), ptr(a.lane_word_base), ptr(a.lane_bits),
        ptr(a.lane_blk_base), ptr(a.lane_blk_limit), ptr(a.limit),
        ptr(a.delta), ptr(a.hv), n_uniq, ptr(a.lane_uid6), ptr(comp_of),
        _comp2(comp_sig_of), B, n_lanes, steps, a.words.numel(), ptr(lut),
        ptr(out), rows, ptr(ok), stream_of(out))
    return out.view(n_img, mcus * B, 64), ok[0] != 0


def _check_kernel_args(a: DecoderArgs, scan_ks, comp_of, name):
    B, comp_sig_of = scan_ks[3], scan_ks[4]
    require_cuda(a.words, name)
    dev = a.words.device
    int_parts = (a.words, a.lane_word_base, a.lane_bits, a.lane_seg_first,
                 a.lane_blk_base, a.lane_blk_limit, a.limit, a.delta, a.hv,
                 comp_of)
    for t in int_parts + (a.lane_uid6, a.lane_pinned):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} inputs must be contiguous on one "
                             f"device")
    if any(t.dtype != torch.int32 for t in int_parts):
        raise TypeError(f"{name} takes int32 words, lane arrays and tables")
    if (a.lane_uid6.dtype != torch.uint8 or a.lane_pinned.dtype != torch.bool
            or comp_of.numel() != B):
        raise TypeError("lane_uid6 must be uint8, lane_pinned bool and "
                        "comp_of (B,)")
    if not 1 <= B <= 64 or max(comp_sig_of) >= 4:
        raise ValueError(f"{name} handles B <= 64 and <= 4 components")


# -- plain versions ------------------------------------------------------------

class _PlainTables(NamedTuple):
    """int64 copies of the wire's decode tables for the plain decoders."""
    words: torch.Tensor      # (nw,) u32 values
    lim: torch.Tensor        # (U, 16)
    dlt: torch.Tensor        # (U, 17)
    hv: torch.Tensor         # (U, 256)
    uid6: torch.Tensor       # (L, 6)
    comp_of: torch.Tensor    # (B,)
    zz: torch.Tensor         # (64,) zigzag position -> natural index


def _plain_tables(a: DecoderArgs, comp_of) -> _PlainTables:
    i64 = torch.int64
    return _PlainTables(
        a.words.to(i64) & 0xFFFFFFFF, a.limit.to(i64), a.delta.to(i64),
        a.hv.to(i64), a.lane_uid6.to(i64), comp_of.to(i64),
        torch.as_tensor(ZIGZAG, dtype=i64, device=a.words.device))


def _symbol(t: _PlainTables, lanes, pos, slot, z, active, B, window=None):
    """One Huffman symbol for each of `lanes` (indices into the lane
    arrays) at bit `pos`, as the reference's `sym` step decodes it: the
    clamped table lookup, value bits, DC/EOB/ZRL handling. Lanes that
    are not `active` keep their state. `window` = (word_base, W): words
    outside [word_base, word_base + W) read as 0, as the reference's
    per-lane window does (a speculative entry may point before it).
    Returns (pos, slot, z, ended, z_coef, val, has_value): the new
    state, whether the symbol ended a block, and the value it carries
    at zigzag position z_coef (has_value: a DC or a nonzero-size AC
    inside the block)."""
    i64 = torch.int64
    nw = t.words.numel()
    wl = pos >> 5
    b = pos & 31
    if window is None:
        wl = wl.clamp(0, nw - 2)
        w0, w1 = t.words[wl], t.words[wl + 1]
    else:
        base, width = window
        rel = wl - base

        def word(k):
            inside = (rel + k >= 0) & (rel + k < width)
            return torch.where(inside, t.words[(wl + k).clamp(0, nw - 1)], 0)

        w0, w1 = word(0), word(1)
    w32 = ((w0 << b) | (w1 >> (32 - b))) & 0xFFFFFFFF
    P = w32 >> 16
    uid = t.uid6[lanes, t.comp_of[slot] * 2 + (z > 0).to(i64)]
    cnt = (P[:, None] >= t.lim[uid]).sum(1)
    clen = (1 + cnt).clamp(max=16)
    idx = ((P >> (16 - clen)) + t.dlt[uid, clen]).clamp(0, 255)
    sym = t.hv[uid, idx]
    run = torch.where(z > 0, sym >> 4, 0)
    size = sym & 15
    val = ((w32 << clen) & 0xFFFFFFFF) >> (32 - size.clamp(min=1))
    val = torch.where(val < (1 << (size - 1).clamp(min=0)),
                      val - (1 << size) + 1, val)
    val = torch.where(size > 0, val, 0)
    is_dc = z == 0
    is_eob = ~is_dc & (size == 0) & (run != 15)
    is_zrl = ~is_dc & (size == 0) & (run == 15)
    z_coef = torch.where(is_dc, 0, z + run)
    z_new = torch.where(is_dc, 1, torch.where(
        is_eob, 64, torch.where(is_zrl, z + 16, z + run + 1)))
    has_value = (is_dc | (size > 0)) & (z_coef < 64)
    pos = torch.where(active, pos + clen + size, pos)
    ended = active & (z_new >= 64)
    z = torch.where(active, torch.where(z_new >= 64, 0, z_new), z)
    slot = torch.where(ended, (slot + 1) % B, slot)
    return pos, slot, z, ended, z_coef, val, has_value


def _decode_lanes(t: _PlainTables, lanes, pos, slot, z, bit_end, steps, B,
                  window=None, emit_to=None):
    """Lockstep decode of `lanes` from (pos, slot, z): at most `steps`
    symbols each, a lane freezing once pos reaches its bit_end.
    `window` = (word_base, W) per lane (see `_symbol`). `emit_to` =
    (out_flat, blk_start, blk_limit) writes every value to its
    natural-order cell of block blk_start + (blocks ended so far) while
    that block is below blk_limit. Every 64 steps the lanes still short
    of bit_end are gathered anew, so frozen lanes cost nothing. Returns
    (pos, slot, z, nblk)."""
    state = [pos.clone(), slot.clone(), z.clone(), torch.zeros_like(pos)]
    for first in range(0, steps, 64):
        live = (state[0] < bit_end).nonzero().squeeze(1)
        if not live.numel():
            break
        p, s, zc, nb = (a[live] for a in state)
        end = bit_end[live]
        win = None if window is None else (window[0][live], window[1])
        if emit_to is not None:
            out, blk_start, blk_limit = emit_to
            b0, lim = blk_start[live], blk_limit[live]
        for _ in range(first, min(first + 64, steps)):
            active = p < end
            p_new, s, zc, ended, z_coef, val, has_value = _symbol(
                t, lanes[live], p, s, zc, active, B, win)
            if emit_to is not None:
                blk = b0 + nb
                emit = active & has_value & (blk < lim)
                cell = blk * 64 + t.zz[z_coef.clamp(max=63)]
                out[cell[emit]] = val[emit].to(torch.int32)
            p = p_new
            nb = nb + ended.to(nb.dtype)
        for a, v in zip(state, (p, s, zc, nb)):
            a[live] = v
    return tuple(state)


def dc_integrate_plain(out: torch.Tensor, comp_of: torch.Tensor,
                       ri_blk: torch.Tensor, mcus: int) -> torch.Tensor:
    """DC diffs -> absolute DC, in place on `out` (N, mcus*B, 64) int32:
    per image and component a segmented inclusive sum over the blocks,
    restarting where blk % ri_blk equals the component's first slot (the
    start of each restart segment; for a scan without DRI, ri_blk is the
    image's block count). The reference's associative scan
    (`build_decoder_core`, :1218-1243). Returns `out`."""
    i64 = torch.int64
    dev = out.device
    nblk_img = out.shape[1]
    comp_of = comp_of.to(i64)
    comp_seq = comp_of.repeat(mcus)                          # (nblk_img,)
    blk_ar = torch.arange(nblk_img, device=dev)
    blk_mod = blk_ar[None, :] % ri_blk.to(i64)[:, None]      # (N, nblk_img)
    dc = out[:, :, 0].to(i64)
    acc = torch.zeros_like(dc)
    comp_np = comp_of.cpu().numpy()
    for ci in range(int(comp_np.max()) + 1):
        first_off = int(np.nonzero(comp_np == ci)[0][0])
        m = (comp_seq == ci)[None, :]
        x = torch.where(m, dc, 0)
        reset = (blk_mod == first_off) & m
        cs = x.cumsum(1)
        start = torch.where(reset, blk_ar[None, :], 0).cummax(1).values
        s = cs - (cs - x).gather(1, start)
        acc = acc + torch.where(m, s, 0)
    out[:, :, 0] = acc.to(torch.int32)
    return out


def decode_scan_plain(a: DecoderArgs, scan_ks, comp_of: torch.Tensor):
    """Plain torch version of K1 (restart single-pass batches only):
    every lane steps in lockstep from its segment start (frozen lanes
    masked), one symbol per step, at most `steps` steps; DC diffs become
    absolute by `dc_integrate_plain`. Runs on any device."""
    (_C, n_lanes, steps, B, _comp_tuple, mcus, n_img, _n_uniq, _nblkmax,
     single, _nw) = scan_ks
    if not single:
        raise ValueError("decode_scan_plain takes restart single-pass "
                         "batches; chunked ones go to "
                         "decode_scan_chunked_plain")
    dev = a.words.device
    i64 = torch.int64
    t = _plain_tables(a, comp_of)
    lanes = torch.arange(n_lanes, device=dev)
    pos = a.lane_word_base.to(i64) * 32
    bit_end = pos + a.lane_bits.to(i64)
    zero = torch.zeros(n_lanes, dtype=i64, device=dev)
    out = torch.zeros(n_img * mcus * B * 64, dtype=torch.int32, device=dev)
    pos, _slot, _z, _nblk = _decode_lanes(
        t, lanes, pos, zero, zero, bit_end, steps, B,
        emit_to=(out, a.lane_blk_base.to(i64), a.lane_blk_limit.to(i64)))
    ok = ~(pos < bit_end).any()
    out = out.view(n_img, mcus * B, 64)
    return dc_integrate_plain(out, comp_of, a.ri_blk, mcus), ok


def decode_scan_chunked(a: DecoderArgs, scan_ks, comp_of: torch.Tensor,
                        max_passes: int = MAX_PASSES):
    """Chunked speculative decode -> (coefs as `decode_scan`, ok 0-dim
    bool, passes 0-dim int: the Jacobi passes run). K4 + K5 for CUDA
    tensors, `decode_scan_chunked_plain` for CPU tensors."""
    if scan_ks[9]:
        raise ValueError("decode_scan_chunked takes chunked batches")
    if a.words.device.type == "cpu":
        return decode_scan_chunked_plain(a, scan_ks, comp_of, max_passes)
    out, ok, passes = _decode_scan_chunked_kernel(a, scan_ks, comp_of,
                                                  max_passes)
    return dc_integrate(out, comp_of, a.ri_blk, scan_ks[5]), ok, passes


# K1's and K4's lookup tables (csrc/huffman_lut.cuh): LUT_INTS a unique
# table row
LUT_INTS = 2048
# K4's int32 workspace (csrc/huffman_decode_chunked.cu, `carve`): the
# lookup tables (first, 16-byte aligned); the checkpoints, 4 ints each,
# K4_WINDOWS + 1 a lane (the passes record the decode's state at kWindows
# = 8 equal bit offsets of each lane, and the emission runs a thread a
# window from them); K4_LANE_ARRAYS arrays of n_lanes; max_passes change
# flags; 2 flags; K4_MAX_GRID block sums
K4_WINDOWS = 8
K4_LANE_ARRAYS = 12
K4_MAX_GRID = 2048
# K5's int32 scratch: 2 ints (sum, reset flag) a component of 4 a tile of
# K5_TILE_BLOCKS blocks, then the DC diffs packed, an int a block
K5_TILE_BLOCKS = 2048


def k4_work_ints(n_lanes: int, max_passes: int, n_uniq: int) -> int:
    """Length of K4's int32 workspace (`carve` in its source)."""
    return (LUT_INTS * n_uniq + (4 * (K4_WINDOWS + 1) + K4_LANE_ARRAYS) * n_lanes
            + max_passes + 2 + K4_MAX_GRID)


def _comp2(comp_sig_of) -> int:
    """comp_of packed 2 bits a slot, as a signed 32-bit int (K1 and K4
    read it for 16 slots or fewer)."""
    if len(comp_sig_of) > 16:
        return 0
    v = sum((c & 3) << (2 * s) for s, c in enumerate(comp_sig_of))
    return v - (1 << 32) if v >= 1 << 31 else v


def _decode_scan_chunked_kernel(a: DecoderArgs, scan_ks, comp_of,
                                max_passes):
    """K4: Jacobi passes, block starts and emission, DC left as diffs."""
    (C, n_lanes, steps, B, comp_sig_of, mcus, n_img, n_uniq, _nblkmax,
     _single, nw) = scan_ks
    _check_kernel_args(a, scan_ks, comp_of, "K4")
    if max_passes < 1 or C % 32:
        raise ValueError("K4 needs max_passes >= 1 and C % 32 == 0")
    dev = a.words.device
    rows = n_img * mcus * B
    out = torch.empty((rows, 64), dtype=torch.int32, device=dev)
    work = torch.empty(k4_work_ints(n_lanes, max_passes, n_uniq),
                       dtype=torch.int32, device=dev)
    info = torch.zeros(3, dtype=torch.int32, device=dev)
    KERNELS["huffman_decode_chunked"](
        ptr(a.words), ptr(a.lane_word_base), ptr(a.lane_bits),
        ptr(a.lane_pinned), ptr(a.lane_seg_first), ptr(a.lane_blk_base),
        ptr(a.lane_blk_limit), ptr(a.limit), ptr(a.delta), ptr(a.hv),
        n_uniq, ptr(a.lane_uid6), ptr(comp_of), _comp2(comp_sig_of), B,
        n_lanes, C, steps, max_passes, nw, ptr(work), ptr(out), rows,
        ptr(info), stream_of(out))
    return out.view(n_img, mcus * B, 64), info[0] != 0, info[1]


def decode_scan_chunked_plain(a: DecoderArgs, scan_ks, comp_of: torch.Tensor,
                              max_passes: int = MAX_PASSES):
    """Plain torch version of K4 + K5, the reference's chunked mode
    (`build_decoder_core(single_pass=False)`) in lockstep over lanes:

    - entries (off, slot, z) start at (0, 0, 0); a pass decodes each
      lane from word_base*32 + off for at most `steps` symbols or until
      bit_end, giving its exit (pos - (word_base*32 + C), slot, z), its
      count of ended blocks and `overflow` (pos < bit_end). Only lanes
      whose entry differs from the one their stored exit came from are
      decoded again (every lane on the first pass): the same exits as
      re-decoding all;
    - Jacobi: each entry becomes the previous lane's exit, except that
      segment-first (pinned) lanes keep (0, 0, 0); passes repeat while
      an entry changed and fewer than `max_passes` ran, and
      ok = no change pending and no lane overflowed;
    - block starts are the segmented exclusive prefix of the block
      counts per segment; an emission pass from the converged entries
      writes each value straight to its natural-order cell of block
      blk_start + (blocks ended), below the segment's block limit;
    - `dc_integrate_plain` makes DC absolute.

    Returns (coefs (N, mcus*B, 64) int32, ok 0-dim bool, passes 0-dim
    int64). Runs on any device."""
    (C, n_lanes, steps, B, _comp_tuple, mcus, n_img, _n_uniq, _nblkmax,
     single, _nw) = scan_ks
    if single:
        raise ValueError("decode_scan_chunked_plain takes chunked batches")
    dev = a.words.device
    i64 = torch.int64
    t = _plain_tables(a, comp_of)
    width = C // 32 + 2
    base = a.lane_word_base.to(i64)
    start = base * 32
    bit_end = start + a.lane_bits.to(i64)
    pinned = a.lane_pinned
    entry = torch.zeros((3, n_lanes), dtype=i64, device=dev)  # off, slot, z
    decoded_from = torch.full_like(entry, -1)   # sentinel: decode all
    exits = torch.zeros_like(entry)
    nblk = torch.zeros(n_lanes, dtype=i64, device=dev)
    overflow = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
    passes, changed = 0, True
    while changed and passes < max_passes:
        lanes = (entry != decoded_from).any(0).nonzero().squeeze(1)
        if lanes.numel():
            e = entry[:, lanes]
            pos, slot, z, nb = _decode_lanes(
                t, lanes, start[lanes] + e[0], e[1], e[2], bit_end[lanes],
                steps, B, window=(base[lanes], width))
            exits[:, lanes] = torch.stack([pos - (start[lanes] + C), slot, z])
            nblk[lanes] = nb
            overflow[lanes] = pos < bit_end[lanes]
            decoded_from[:, lanes] = e
        prop = torch.cat([exits.new_zeros(3, 1), exits[:, :-1]], 1)
        prop = torch.where(pinned, 0, prop)
        changed = bool((prop != entry).any())
        entry = prop
        passes += 1
    ok = torch.tensor(not changed, device=dev) & ~overflow.any()

    prev = nblk.cumsum(0) - nblk
    blk_start = (a.lane_blk_base.to(i64) + prev
                 - prev[a.lane_seg_first.to(i64)])
    out = torch.zeros(n_img * mcus * B * 64, dtype=torch.int32, device=dev)
    _decode_lanes(t, torch.arange(n_lanes, device=dev), start + entry[0],
                  entry[1], entry[2], bit_end, steps, B,
                  window=(base, width),
                  emit_to=(out, blk_start, a.lane_blk_limit.to(i64)))
    out = out.view(n_img, mcus * B, 64)
    return (dc_integrate_plain(out, comp_of, a.ri_blk, mcus), ok,
            torch.tensor(passes, device=dev))


def dc_integrate(out: torch.Tensor, comp_of: torch.Tensor,
                 ri_blk: torch.Tensor, mcus: int) -> torch.Tensor:
    """DC diffs -> absolute DC in place (see `dc_integrate_plain`):
    kernel K5 for CUDA tensors, the plain version for CPU tensors.
    Returns `out`."""
    if out.device.type == "cpu":
        return dc_integrate_plain(out, comp_of, ri_blk, mcus)
    require_cuda(out, "K5")
    n_img, nblk_img, width = out.shape
    B = comp_of.numel()
    if width != 64 or nblk_img != mcus * B:
        raise ValueError("K5 takes (N, mcus*B, 64) blocks")
    for t in (out, comp_of, ri_blk):
        if t.device != out.device or not t.is_contiguous():
            raise ValueError("K5 inputs must be contiguous on one device")
        if t.dtype != torch.int32:
            raise TypeError("K5 takes int32 blocks, comp_of and ri_blk")
    tiles = -(-nblk_img // K5_TILE_BLOCKS)
    if not 1 <= B <= 64 or ri_blk.numel() != n_img or tiles > 65535:
        raise ValueError("K5 handles B <= 64, one ri_blk per image and at "
                         "most 65535 tiles of 2048 blocks an image")
    scratch = torch.empty(2 * 4 * n_img * tiles + n_img * nblk_img,
                          dtype=torch.int32, device=out.device)
    KERNELS["dc_integrate"](ptr(out), ptr(comp_of), ptr(ri_blk), n_img,
                            nblk_img, B, ptr(scratch), stream_of(out))
    return out


def kernel_info(n_uniq: int = 4, n_lanes: int = 10240) -> dict:
    """K4's builds and launch shapes as the card reports them, at
    `n_uniq` unique table rows and `n_lanes` lanes: for the pass kernel and the emission kernel, registers and
    local (spill) bytes a thread, static and dynamic shared bytes a block,
    resident blocks a multiprocessor, threads a block and the grid.
    Launches nothing."""
    import ctypes

    from ..kernels._build import library

    vals = (ctypes.c_int * 14)()
    rc = library().picha_huffman_decode_chunked_info(n_uniq, n_lanes, vals)
    if rc != 0:
        raise RuntimeError(f"picha_huffman_decode_chunked_info: CUDA error "
                           f"{rc}")
    keys = ("registers", "local_bytes", "static_shared_bytes",
            "dynamic_shared_bytes", "blocks_per_sm", "threads", "grid")
    return {"K4_passes": dict(zip(keys, vals[:7])),
            "K4_emit": dict(zip(keys, vals[7:])),
            "tables_in_shared": vals[3] > 0}


def restart_kernel_info(n_uniq: int = 4, n_lanes: int = 16320) -> dict:
    """K1's build and launch plan as the card reports them, at `n_uniq`
    unique table rows and `n_lanes` lanes (a restart batch's shape, as
    the plan picks it in a launch): registers and local (spill) bytes a
    thread, static and dynamic shared bytes a block, resident blocks a
    multiprocessor, threads a block and the grid, and whether the tables
    sit in shared memory. Launches nothing."""
    import ctypes

    from ..kernels._build import library

    vals = (ctypes.c_int * 8)()
    rc = library().picha_huffman_decode_restart_info(n_uniq, n_lanes, vals)
    if rc != 0:
        raise RuntimeError(f"picha_huffman_decode_restart_info: CUDA error "
                           f"{rc}")
    keys = ("registers", "local_bytes", "static_shared_bytes",
            "dynamic_shared_bytes", "blocks_per_sm", "threads", "grid")
    return dict(zip(keys, vals[:7]), tables_in_shared=vals[7] > 0)


def split_planes(out: torch.Tensor, comp_sig, split_idx):
    """(N, mcus*B, 64) scan-order blocks -> tuple of (N, bh, bw, 64)
    per-component planes. `split_idx`: per-component int64 index
    tensors from `scan_batch.split_indices`, on `out`'s device."""
    n_img = out.shape[0]
    return tuple(
        out.index_select(1, idx).view(n_img, comp_sig[ci][0],
                                      comp_sig[ci][1], 64)
        for ci, idx in enumerate(split_idx))
