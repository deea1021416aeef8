"""Host prep of the device Huffman decoder: one same-signature batch of
parsed scans -> the decoder's static key and one coalesced uint8 wire.

The port's copy of the host half of
`picha_tpu/ops/jpeg_huffman_decode_tpu.py` (its constants, `prep_tables`,
`min_bits_per_symbol`, `ScanBatch`, `split_indices`) and of
`picha_tpu/bucketing.py`, with the same semantics and the same wire
bytes; `tests/test_torch_host_copies.py` pins each to its original.
`ops/jpeg_huffman_decode.py::wire_unpack` takes the wire apart on the
device.

Two batch modes:
- restart single-pass: every image carries restart markers and every
  segment fits one lane (<= SEG_LANE_CAP bits), so each segment gets
  its own lane with an exact entry state (kernel K1);
- chunked: segments are cut into CHUNK_BITS lanes that start from a
  guessed entry state and iterate to a fixpoint (kernels K4 + K5).
"""
from __future__ import annotations

import functools
from typing import List

import numpy as np

from .jpeg_scan import ScanInfo, derive_tables, mcu_slot_tables, scatter_layout

CHUNK_BITS = 4096            # C: bits per lane in chunked mode
LANE_GRANULE = 2048          # lane-count bucket
WORD_GRANULE = 16384         # words-section floor granule (64 KiB)
STEP_GRANULE = 64            # symbol-steps bucket
SEG_LANE_CAP = 24576         # single-pass mode: max segment bits per lane
MAX_PASSES = 48              # Jacobi pass budget of the chunked decoder


def bucket_geometric(k: int, granule: int) -> int:
    """Round k up to 16 mantissa steps per octave, at least `granule`."""
    k = max(int(k), granule)
    step = max(granule, 1 << max(0, k.bit_length() - 4))
    return -(-k // step) * step


def prep_tables(info: ScanInfo):
    """Per-image decode tables, one row pair per component, row t =
    comp*2 + (0 dc | 1 ac): (limit (6, 16) int32 left-aligned exclusive
    bounds for l = 1..16, delta (6, 17) int32 = valptr - mincode, hv
    (6, 256) int32). Unused rows are zero. Memoised on the info."""
    cached = getattr(info, "_prep_tables", None)
    if cached is not None:
        return cached
    limit = np.zeros((6, 16), np.int32)
    delta = np.zeros((6, 17), np.int32)
    hv = np.zeros((6, 256), np.int32)
    for ci in range(info.ncomp):
        for cls in (0, 1):
            lim, mc, vp, h = derive_tables(
                *info.huffman[(cls, info.scan_tables[ci][cls])])
            t = ci * 2 + cls
            limit[t] = np.minimum(lim[1:17], 2 ** 31 - 1).astype(np.int32)
            delta[t] = (vp - mc).astype(np.int32)
            hv[t] = h
    info._prep_tables = (limit, delta, hv)
    return limit, delta, hv


def min_bits_per_symbol(info: ScanInfo) -> float:
    """Sustained lower bound on bits per symbol under the image's
    tables (sizes the per-lane step budget): the best of an empty-block
    cycle (DC + EOB), a full-block cycle (DC + 63 cheapest ACs) and
    pure cheapest-AC runs."""
    min_dc, min_eob, min_ac = 16.0, 16.0, 32.0
    for (cls, _tid), (bits, vals) in info.huffman.items():
        p = 0
        for ln in range(1, 17):
            for v in vals[p : p + bits[ln - 1]]:
                if cls == 0:
                    min_dc = min(min_dc, float(ln + v))
                elif v == 0:
                    min_eob = min(min_eob, float(ln))
                else:
                    min_ac = min(min_ac, float(ln + (v & 15)))
            p += bits[ln - 1]
    return max(1.0, min((min_dc + min_eob) / 2.0,
                        (min_dc + 63.0 * min_ac) / 64.0, min_ac))


class ScanBatch:
    """Wire prep for one same-signature batch of parsed scans (numpy).
    Raises ValueError past its capacity gates (int32 bit addresses, 256
    unique table rows): the caller then decodes on the host."""

    def __init__(self, infos: List[ScanInfo], chunk_bits: int = CHUNK_BITS):
        self.infos = infos
        self.C = C = chunk_bits
        info0 = infos[0]
        sig = info0.comp_sig
        self.comp_sig = sig
        self.comp_of = mcu_slot_tables(sig)          # (B,)
        self.B = B = int(self.comp_of.size)
        self.mcus = mcus = info0.mcus
        self.nblk_img = mcus * B
        n_img = len(infos)

        # per-segment geometry
        seg_bytes: List[bytes] = []
        seg_img, seg_blk0, seg_nblk = [], [], []
        for img, info in enumerate(infos):
            ri = info.restart_interval or mcus
            blk_base_img = img * self.nblk_img
            for si, seg in enumerate(info.segments):
                n_mcu = min(ri, mcus - si * ri)
                if n_mcu <= 0:
                    continue
                seg_bytes.append(seg)
                seg_img.append(img)
                seg_blk0.append(blk_base_img + si * ri * B)
                seg_nblk.append(n_mcu * B)
        seg_bits = np.array([len(s) * 8 for s in seg_bytes], np.int64)
        # single-pass mode: one (wider) lane per restart segment, every
        # entry state exact, no Jacobi passes
        self.single_pass = bool(
            len(seg_bytes) >= 2 * n_img
            and all(i.restart_interval for i in infos)
            and int(seg_bits.max()) <= SEG_LANE_CAP)
        if self.single_pass:
            self.C = C = int(bucket_geometric(int(seg_bits.max()), 512))
            seg_nch = np.ones(len(seg_bytes), np.int64)
        else:
            seg_nch = np.maximum(1, -(-seg_bits // C))
        seg_img = np.array(seg_img, np.int32)
        seg_blk0 = np.array(seg_blk0, np.int32)
        seg_nblk = np.array(seg_nblk, np.int32)
        nseg = seg_nch.size
        # one padded byte buffer for all segments -> u32 words; single-
        # pass segments are packed byte-tight (word-aligned): a lane's
        # window may read into the next segment, which is inert since the
        # lane stops at its own bit_end
        if self.single_pass:
            seg_words = -(-seg_bits // 32)
        else:
            seg_words = seg_nch * (C // 32) + 2
        word_starts = np.concatenate(
            [[0], np.cumsum(seg_words)]).astype(np.int64)
        total_words = int(word_starts[-1])
        if total_words * 32 > 2**31 - C - 64:
            # bit positions on the device are int32
            raise ValueError(
                f"batch scan data ({total_words * 4} bytes padded) "
                f"exceeds the int32 bit-address space; split the batch "
                f"or use the host path")
        byte_buf = np.full(total_words * 4, 0xFF, np.uint8)
        for s, seg in enumerate(seg_bytes):
            o = int(word_starts[s]) * 4
            byte_buf[o : o + len(seg)] = np.frombuffer(seg, np.uint8)
        words_all = byte_buf.reshape(-1, 4).astype(np.uint32) @ np.array(
            [1 << 24, 1 << 16, 1 << 8, 1], np.uint32)
        # segments -> lanes
        lane_seg = np.repeat(np.arange(nseg), seg_nch)
        lane_starts = np.concatenate(
            [[0], np.cumsum(seg_nch)]).astype(np.int64)
        chunk_in_seg = (np.arange(lane_seg.size)
                        - lane_starts[lane_seg])
        lane_word_base = (word_starts[lane_seg]
                          + chunk_in_seg * (C // 32)).astype(np.int32)
        # per-lane bit budget: C for interior chunks, the tail for a
        # segment's last chunk
        lane_bits = np.minimum(
            C, seg_bits[lane_seg] - chunk_in_seg * C).astype(np.int32)
        lane_pinned = chunk_in_seg == 0
        lane_img = seg_img[lane_seg]
        lane_seg_first = lane_starts[lane_seg].astype(np.int32)
        lane_blk_base = seg_blk0[lane_seg]
        lane_blk_limit = seg_blk0[lane_seg] + seg_nblk[lane_seg]
        n_lanes = int(lane_seg.size)
        self.n_lanes = -(-n_lanes // LANE_GRANULE) * LANE_GRANULE
        trash_blk = n_img * self.nblk_img
        # dead pad lanes: pinned, pointing at the last slack words, with
        # an empty block range at the trash block
        tail = max(64, C // 32 + 2)
        self.words = np.concatenate(
            [words_all, np.full(tail, 0xFFFFFFFF, np.uint32)])
        dead_base = self.words.size - C // 32 - 2

        def padded(a, fill, dtype):
            out = np.full(self.n_lanes, fill, dtype)
            out[:n_lanes] = a
            return out

        self.lane_word_base = padded(lane_word_base, dead_base, np.int32)
        self.lane_bits = padded(lane_bits, 0, np.int32)
        self.lane_pinned = padded(lane_pinned, True, bool)
        self.lane_img = padded(lane_img, n_img - 1, np.int32)
        self.lane_seg_first = padded(lane_seg_first, n_lanes, np.int32)
        self.lane_blk_base = padded(lane_blk_base, trash_blk, np.int32)
        self.lane_blk_limit = padded(lane_blk_limit, trash_blk, np.int32)

        # decode tables deduplicated across the batch (uint8 ids)
        tabs = [prep_tables(i) for i in infos]
        uniq = {}
        uid_img = np.zeros((n_img, 6), np.int32)
        rows = []
        for img, (limit, delta, hv) in enumerate(tabs):
            for t in range(6):
                key = (limit[t].tobytes(), delta[t].tobytes(),
                       hv[t].tobytes())
                if key not in uniq:
                    uniq[key] = len(rows)
                    rows.append((limit[t], delta[t], hv[t]))
                uid_img[img, t] = uniq[key]
        if len(rows) > 256:
            raise ValueError(
                f"batch has {len(rows)} unique Huffman table rows "
                f"(uint8 id space is 256); split the batch or use the "
                f"host path")
        uid_img = uid_img.astype(np.uint8)
        self.n_uniq = -(-len(rows) // 4) * 4
        self.limit = np.zeros((self.n_uniq, 16), np.int32)
        self.delta = np.zeros((self.n_uniq, 17), np.int32)
        self.hv = np.zeros((self.n_uniq, 256), np.int32)
        for u, (lim, dl, hvr) in enumerate(rows):
            self.limit[u], self.delta[u], self.hv[u] = lim, dl, hvr
        self.lane_uid6 = uid_img[self.lane_img]       # (L, 6) u8
        self.qtables = [
            np.stack([info.comps[ci][2] for info in infos])[:, None, None, :]
            for ci in range(info0.ncomp)]
        # DC reset geometry: the restart span in blocks, per image
        self.ri_blk = np.array(
            [(info.restart_interval or mcus) * B for info in infos],
            np.int32)
        # worst-case symbols per lane under these tables
        mb = min(min_bits_per_symbol(i) for i in infos)
        self.steps = -(-(int(C / mb) + 8) // STEP_GRANULE) * STEP_GRANULE
        # max blocks any lane can emit into
        if self.single_pass:
            span = int(seg_nblk.max())
        else:
            span = min(int(seg_nblk.max()), self.steps // 2 + 2)
        self.nblkmax = -(-span // 8) * 8

    def args(self):
        return [self.words, self.lane_word_base, self.lane_bits,
                self.lane_pinned, self.lane_seg_first,
                self.lane_blk_base, self.lane_blk_limit,
                self.limit, self.delta, self.hv, self.lane_uid6,
                self.ri_blk]

    def static_key(self):
        return (self.C, self.n_lanes, self.steps, self.B,
                tuple(int(x) for x in self.comp_of), self.mcus,
                len(self.infos), self.n_uniq, self.nblkmax,
                self.single_pass)

    def wire(self):
        """(static key + (words section length,), one coalesced uint8
        buffer). Layout: words (u32, padded to WORD_GRANULE) | 5 x lane
        int32 arrays | limit | delta | hv (int32) | qtables (u16 per
        component) | lane_pinned (u8) | lane_uid6 (u8) | ri_blk (int32)."""
        nw = bucket_geometric(self.words.size, WORD_GRANULE)
        words = np.full(nw, 0xFFFFFFFF, np.uint32)
        words[: self.words.size] = self.words
        sections = [
            words.view(np.uint8),
            self.lane_word_base.view(np.uint8),
            self.lane_bits.view(np.uint8),
            self.lane_seg_first.view(np.uint8),
            self.lane_blk_base.view(np.uint8),
            self.lane_blk_limit.view(np.uint8),
            np.ascontiguousarray(self.limit).view(np.uint8).reshape(-1),
            np.ascontiguousarray(self.delta).view(np.uint8).reshape(-1),
            np.ascontiguousarray(self.hv).view(np.uint8).reshape(-1),
        ]
        for q in self.qtables:
            sections.append(np.ascontiguousarray(
                q.astype(np.uint16)).view(np.uint8).reshape(-1))
        sections.append(self.lane_pinned.astype(np.uint8))
        sections.append(np.ascontiguousarray(self.lane_uid6).reshape(-1))
        sections.append(self.ri_blk.view(np.uint8).reshape(-1))
        ks = self.static_key() + (nw,)
        return ks, np.concatenate(sections)


@functools.lru_cache(maxsize=64)
def split_indices(comp_sig):
    """Per-component gather indices: grid flat position -> scan-order
    block index (the inverse of scatter_layout)."""
    out_idx, _, total = scatter_layout(comp_sig)
    inv = np.zeros(total, np.int32)
    real = out_idx < total
    inv[out_idx[real]] = np.nonzero(real)[0].astype(np.int32)
    bases = np.cumsum([0] + [c[0] * c[1] for c in comp_sig])[:-1]
    return [inv[bases[ci] : bases[ci] + bh * bw]
            for ci, (bh, bw, _, _) in enumerate(comp_sig)]
