"""Baseline JPEG Huffman decode of restart-interval scans on the device.

Counterpart of `picha_tpu/ops/jpeg_huffman_decode_tpu.py`:
`build_wire_unpack` -> `wire_unpack`, `build_decoder_core(single_pass=
True)` -> `decode_scan`, `split_planes` -> `split_planes`. The host side
(`ScanBatch`: segment geometry, deduplicated tables, the coalesced
wire) is the reference's own, reused unchanged behind `scan_wire`.

`decode_scan` launches kernel K1 (`csrc/huffman_decode_restart.cu`, one
thread per restart segment) for CUDA tensors and runs
`decode_scan_plain`, a lockstep-over-lanes torch loop, for CPU tensors.
The speculative no-restart decoder (`single_pass=False`) is not ported:
such batches raise NotImplementedError (ROADMAP.md, queue 1 item 4).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from picha_tpu.ops.jpeg_huffman_decode_tpu import ScanBatch
from picha_tpu.ops.jpeg_scan import ZIGZAG

from ..kernels._build import KERNELS, ptr, require_cuda, stream_of


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


_NO_RESTART = ("speculative no-restart decode (build_decoder_core with "
               "single_pass=False) is not ported yet: ROADMAP.md queue 1 "
               "item 4 (Slice D)")


def scan_wire(infos):
    """Parsed scans (`parse_baseline`) -> (scan_ks, wire): the decoder's
    static key and the one coalesced uint8 host buffer that `wire_unpack`
    takes apart on the device (`ScanBatch.wire()`). Raises ValueError
    past ScanBatch's capacity gates and NotImplementedError for a batch
    without restart markers."""
    batch = ScanBatch(infos)
    if not batch.single_pass:
        raise NotImplementedError(_NO_RESTART)
    return batch.wire()


def _check_key(scan_ks):
    if not scan_ks[9]:
        raise NotImplementedError(_NO_RESTART)


def decode_scan(args: DecoderArgs, scan_ks, comp_of: torch.Tensor):
    """Restart single-pass decode -> (coefs (N, mcus*B, 64) int32 in
    scan order, natural coefficient order, absolute DC; ok 0-dim bool
    tensor). `comp_of` is the (B,) int32 slot->component table on the
    same device. Launches K1 for CUDA tensors; the plain version runs
    only for CPU tensors."""
    _check_key(scan_ks)
    if args.words.device.type == "cpu":
        return decode_scan_plain(args, scan_ks, comp_of)
    return _decode_scan_kernel(args, scan_ks, comp_of)


def _decode_scan_kernel(a: DecoderArgs, scan_ks, comp_of):
    (_C, n_lanes, steps, B, comp_sig_of, mcus, n_img, n_uniq, _nblkmax,
     _single, _nw) = scan_ks
    require_cuda(a.words, "K1")
    dev = a.words.device
    int_parts = (a.words, a.lane_word_base, a.lane_bits, a.lane_blk_base,
                 a.lane_blk_limit, a.limit, a.delta, a.hv, comp_of)
    for t in int_parts + (a.lane_uid6,):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("K1 inputs must be contiguous on one device")
    if any(t.dtype != torch.int32 for t in int_parts):
        raise TypeError("K1 takes int32 words, lane arrays and tables")
    if a.lane_uid6.dtype != torch.uint8 or comp_of.numel() != B:
        raise TypeError("lane_uid6 must be uint8 and comp_of (B,)")
    if not 1 <= B <= 64 or max(comp_sig_of) >= 4:
        raise ValueError("K1 handles B <= 64 and <= 4 components")
    out = torch.zeros((n_img * mcus * B, 64), dtype=torch.int32, device=dev)
    ok = torch.ones(1, dtype=torch.int32, device=dev)
    KERNELS["huffman_decode_restart"](
        ptr(a.words), ptr(a.lane_word_base), ptr(a.lane_bits),
        ptr(a.lane_blk_base), ptr(a.lane_blk_limit), ptr(a.limit),
        ptr(a.delta), ptr(a.hv), n_uniq, ptr(a.lane_uid6), ptr(comp_of),
        B, n_lanes, steps, ptr(out), ptr(ok), stream_of(out))
    return out.view(n_img, mcus * B, 64), ok[0] != 0


def decode_scan_plain(a: DecoderArgs, scan_ks, comp_of: torch.Tensor):
    """Plain torch version of K1: every lane steps in lockstep (frozen
    lanes masked), one symbol per step, at most `steps` steps; DC diffs
    become absolute by a segmented cumsum per component, as the
    reference's associative scan does. Runs on any device."""
    _check_key(scan_ks)
    (_C, n_lanes, steps, B, _comp_tuple, mcus, n_img, _n_uniq, _nblkmax,
     _single, _nw) = scan_ks
    dev = a.words.device
    i64 = torch.int64
    nblk_img = mcus * B
    words = a.words.to(i64) & 0xFFFFFFFF
    nw = words.numel()
    comp_of = comp_of.to(i64)
    lim, dlt, hvt = a.limit.to(i64), a.delta.to(i64), a.hv.to(i64)
    uid6 = a.lane_uid6.to(i64)
    lanes = torch.arange(n_lanes, device=dev)
    zz = torch.as_tensor(ZIGZAG, dtype=i64, device=dev)
    pos = a.lane_word_base.to(i64) * 32
    bit_end = pos + a.lane_bits.to(i64)
    blk_base = a.lane_blk_base.to(i64)
    blk_limit = a.lane_blk_limit.to(i64)
    slot = torch.zeros(n_lanes, dtype=i64, device=dev)
    z = torch.zeros_like(slot)
    nblk = torch.zeros_like(slot)
    out = torch.zeros(n_img * nblk_img * 64, dtype=torch.int32, device=dev)
    for step in range(steps):
        active = pos < bit_end
        if step % 64 == 0 and not bool(active.any()):
            break
        wl = (pos >> 5).clamp(0, nw - 2)
        b = pos & 31
        w32 = ((words[wl] << b) | (words[wl + 1] >> (32 - b))) & 0xFFFFFFFF
        P = w32 >> 16
        uid = uid6[lanes, comp_of[slot] * 2 + (z > 0).to(i64)]
        cnt = (P[:, None] >= lim[uid]).sum(1)
        clen = (1 + cnt).clamp(max=16)
        idx = ((P >> (16 - clen)) + dlt[uid, clen]).clamp(0, 255)
        sym = hvt[uid, idx]
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
        blk = blk_base + nblk
        emit = active & (is_dc | (size > 0)) & (z_coef < 64) \
            & (blk < blk_limit)
        cell = blk * 64 + zz[z_coef.clamp(max=63)]
        out[cell[emit]] = val[emit].to(torch.int32)
        pos = torch.where(active, pos + clen + size, pos)
        ended = active & (z_new >= 64)
        z = torch.where(active, torch.where(z_new >= 64, 0, z_new), z)
        slot = torch.where(ended, (slot + 1) % B, slot)
        nblk = torch.where(ended, nblk + 1, nblk)
    ok = ~(pos < bit_end).any()
    out = out.view(n_img, nblk_img, 64)

    # DC diffs -> absolute: per-component segmented inclusive sum that
    # restarts at each restart segment's first block of the component
    comp_seq = comp_of.repeat(mcus)                          # (nblk_img,)
    blk_ar = torch.arange(nblk_img, device=dev)
    blk_mod = blk_ar[None, :] % a.ri_blk.to(i64)[:, None]    # (N, nblk_img)
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
    return out, ok


def split_planes(out: torch.Tensor, comp_sig, split_idx):
    """(N, mcus*B, 64) scan-order blocks -> tuple of (N, bh, bw, 64)
    per-component planes. `split_idx`: per-component int64 index
    tensors from `picha_tpu.ops.jpeg_huffman_decode_tpu.split_indices`,
    on `out`'s device."""
    n_img = out.shape[0]
    return tuple(
        out.index_select(1, idx).view(n_img, comp_sig[ci][0],
                                      comp_sig[ci][1], 64)
        for ci, idx in enumerate(split_idx))
