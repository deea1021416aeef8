"""Host-side model of a baseline JPEG scan: header parse and scan layout.

The port's copy of the parts of `picha_tpu/ops/jpeg_scan.py` that the
device decode path calls (`ZIGZAG`, `ScanInfo`, `parse_baseline`,
`derive_tables`, `mcu_slot_tables`, `scatter_layout`), and of its numpy
entropy decoder `decode_reference`, the plain version of the port's host
C++ decoder (`csrc/jpeg_entropy_host.cu`), with the same semantics;
`tests/test_torch_host_copies.py` pins each to its original.
`parse_baseline` returns None for anything the device decoder does not
take (progressive, arithmetic, 12-bit, multi-scan, CMYK, malformed
tables): the caller decodes such files on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)


@dataclasses.dataclass
class ScanInfo:
    """Parsed baseline JPEG structure (single interleaved scan)."""
    width: int
    height: int
    ncomp: int
    # per component: (h_samp, v_samp, qtable (64,) uint16 natural order)
    comps: List[Tuple[int, int, np.ndarray]]
    # per component: (dc_table_id, ac_table_id)
    scan_tables: List[Tuple[int, int]]
    # (cls, id) -> (bits list[16], vals list[int])
    huffman: Dict[Tuple[int, int], Tuple[List[int], List[int]]]
    restart_interval: int
    # entropy-coded data, 0xFF00 unstuffed, one bytes per restart segment
    segments: List[bytes]
    # 1 grayscale, 2 RGB, 3 YCbCr
    color_space: int

    @property
    def comp_sig(self):
        """((blocks_h, blocks_w, h_samp, v_samp), ...) with libjpeg's
        component grids (width_in_blocks = ceil(width*h_samp /
        (hmax*8))); the scan's MCU grid can be one block wider or taller
        (dummy blocks in the bitstream, not in the grids)."""
        hmax = max(h for h, _, _ in self.comps)
        vmax = max(v for _, v, _ in self.comps)
        out = []
        for h, v, _ in self.comps:
            bw = -(-(self.width * h) // (hmax * 8))
            bh = -(-(self.height * v) // (vmax * 8))
            out.append((bh, bw, h, v))
        return tuple(out)

    @property
    def mcus(self) -> int:
        hmax = max(h for h, _, _ in self.comps)
        vmax = max(v for _, v, _ in self.comps)
        return (-(-self.width // (8 * hmax))) * (-(-self.height // (8 * vmax)))


def _unstuff(data: bytes) -> bytes:
    """Remove the 0x00 bytes that follow 0xFF in entropy-coded data."""
    return data.replace(b"\xff\x00", b"\xff")


def parse_baseline(buf: bytes) -> Optional[ScanInfo]:
    """Parse a baseline (SOF0/SOF1), Huffman, single-interleaved-scan
    JPEG. Returns None for anything else (progressive, arithmetic,
    12-bit, multi-scan, CMYK, illegal tables or sampling, truncated
    scans): callers decode those on the host."""
    if len(buf) < 4 or buf[0] != 0xFF or buf[1] != 0xD8:
        return None
    i = 2
    qtables: Dict[int, np.ndarray] = {}
    huffman: Dict[Tuple[int, int], Tuple[List[int], List[int]]] = {}
    comps: List[Tuple[int, int, int]] = []  # (h, v, tq) by index
    comp_ids: List[int] = []
    width = height = 0
    restart = 0
    sof_seen = False
    saw_jfif = False
    adobe_transform = None  # APP14 'Adobe' colour-transform byte
    while i + 4 <= len(buf):
        if buf[i] != 0xFF:
            return None
        marker = buf[i + 1]
        if marker == 0xD8 or (0xD0 <= marker <= 0xD7) or marker == 0x01:
            i += 2
            continue
        ln = (buf[i + 2] << 8) | buf[i + 3]
        if ln < 2 or i + 2 + ln > len(buf):
            return None
        seg = buf[i + 4 : i + 2 + ln]
        if marker in (0xC0, 0xC1):  # SOF0 baseline / SOF1 extended seq
            if sof_seen or len(seg) < 6:
                return None
            if seg[0] != 8:
                return None
            height = (seg[1] << 8) | seg[2]
            width = (seg[3] << 8) | seg[4]
            nc = seg[5]
            if nc not in (1, 3) or len(seg) < 6 + 3 * nc:
                return None
            for c in range(nc):
                cid, hv, tq = seg[6 + 3 * c : 9 + 3 * c]
                hs, vs = hv >> 4, hv & 15
                # legal sampling is 1-4 (B.2.2); libjpeg rejects the rest
                if not (1 <= hs <= 4 and 1 <= vs <= 4) or tq > 3:
                    return None
                comps.append((hs, vs, tq))
                comp_ids.append(cid)
            if nc == 1:
                # a single-component scan has one data unit per MCU
                # whatever its declared sampling (B.2.3)
                comps = [(1, 1, comps[0][2])]
            else:
                # fractional upsampling ratios: libjpeg raises, so the
                # host path gives the clean error
                hm = max(h for h, _, _ in comps)
                vm = max(v for _, v, _ in comps)
                if any(hm % h or vm % v for h, v, _ in comps):
                    return None
            sof_seen = True
        elif marker in (0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA,
                        0xCB, 0xCD, 0xCE, 0xCF):
            return None  # progressive / arithmetic / hierarchical
        elif marker == 0xC4:  # DHT
            pos = 0
            while pos + 17 <= len(seg):
                tc_th = seg[pos]
                bits = list(seg[pos + 1 : pos + 17])
                nv = sum(bits)
                # structurally illegal tables go to the host path
                if nv > 256 or (tc_th >> 4) > 1 or (tc_th & 15) > 3:
                    return None
                cap = 2
                for n in bits:
                    if n > cap:
                        return None
                    cap = (cap - n) * 2
                if pos + 17 + nv > len(seg):
                    return None
                vals = list(seg[pos + 17 : pos + 17 + nv])
                huffman[(tc_th >> 4, tc_th & 15)] = (bits, vals)
                pos += 17 + nv
        elif marker == 0xDB:  # DQT
            pos = 0
            while pos + 1 <= len(seg):
                pq, tq = seg[pos] >> 4, seg[pos] & 15
                n = 128 if pq else 64
                if pos + 1 + n > len(seg):
                    return None
                raw = seg[pos + 1 : pos + 1 + n]
                if pq:
                    z = np.frombuffer(bytes(raw), ">u2").astype(np.uint16)
                else:
                    z = np.frombuffer(bytes(raw), np.uint8).astype(np.uint16)
                nat = np.zeros(64, np.uint16)
                nat[ZIGZAG] = z
                qtables[tq] = nat
                pos += 1 + n
        elif marker == 0xE0:  # APP0: libjpeg honours JFIF from 14 bytes
            if len(seg) >= 14 and seg[:5] == b"JFIF\x00":
                saw_jfif = True
        elif marker == 0xEE:  # APP14
            if len(seg) >= 12 and seg[:5] == b"Adobe":
                adobe_transform = seg[11]
        elif marker == 0xDD:  # DRI
            if len(seg) < 2:
                return None
            restart = (seg[0] << 8) | seg[1]
        elif marker == 0xDA:  # SOS
            if not sof_seen or len(seg) < 1:
                return None
            ns = seg[0]
            if ns != len(comps) or len(seg) < 1 + 2 * ns + 3:
                return None  # non-interleaved multi-scan
            scan_tables: List[Tuple[int, int]] = [(0, 0)] * len(comps)
            for c in range(ns):
                cid, tt = seg[1 + 2 * c], seg[2 + 2 * c]
                if cid not in comp_ids:
                    return None
                scan_tables[comp_ids.index(cid)] = (tt >> 4, tt & 15)
            ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
            if ss != 0 or se != 63:
                return None
            # the entropy data runs to the next non-RST marker; marker
            # positions are found vectorised (thousands of segments)
            data_start = i + 2 + ln
            arr = np.frombuffer(buf, np.uint8)
            ff = np.nonzero(arr[data_start:-1] == 0xFF)[0] + data_start
            nxt = arr[ff + 1]
            marks = ff[nxt != 0x00]
            mvals = arr[marks + 1] if marks.size else marks
            seg_bounds: List[Tuple[int, int]] = []
            seg_start = j = data_start
            terminated = False
            for p, m in zip(marks.tolist(), mvals.tolist()):
                if p < seg_start:
                    continue  # inside a previous marker pair
                if m == 0xFF:
                    continue  # fill byte before a marker
                if 0xD0 <= m <= 0xD7:
                    seg_bounds.append((seg_start, p))
                    seg_start = p + 2
                else:
                    j = p
                    terminated = True
                    break
            if not terminated:
                # truncated scan: the host path pads it with a warning
                return None
            seg_bounds.append((seg_start, min(j, len(buf))))
            segments = [_unstuff(buf[a:b]) for a, b in seg_bounds]
            try:
                full = [(h, v, qtables[tq]) for h, v, tq in comps]
            except KeyError:
                return None
            needed = {(0, t[0]) for t in scan_tables}
            needed |= {(1, t[1]) for t in scan_tables}
            if not needed.issubset(huffman.keys()):
                return None
            # colour space as libjpeg's default_decompress_parms: JFIF
            # forces YCbCr; Adobe transform 0 keeps the components (RGB),
            # 1 means YCbCr; component ids 'R','G','B' mean RGB
            if len(comps) == 1:
                cs = 1
            elif saw_jfif:
                cs = 3
            elif adobe_transform is not None:
                cs = 2 if adobe_transform == 0 else 3
            elif comp_ids == [82, 71, 66]:
                cs = 2
            else:
                cs = 3
            return ScanInfo(
                width=width, height=height, ncomp=len(comps), comps=full,
                scan_tables=scan_tables, huffman=huffman,
                restart_interval=restart, segments=segments,
                color_space=cs)
        elif marker == 0xD9:
            return None
        i += 2 + ln
    return None


def derive_tables(bits: List[int], vals: List[int]):
    """Canonical Huffman decode tables (JPEG F.2.2.3), indexed 1..16:
      limit[l]  : 16-bit-left-aligned exclusive upper bound for codes of
                  length <= l (monotone; code length = 1 + #(P >= limit))
      mincode[l]: first code of length l
      valptr[l] : index into vals of the first code of length l
    and hv (256,) the values."""
    limit = np.zeros(17, np.int64)
    mincode = np.zeros(17, np.int64)
    valptr = np.zeros(17, np.int64)
    code = 0
    p = 0
    prev_limit = 0
    for ln in range(1, 17):
        mincode[ln] = code
        valptr[ln] = p
        n = bits[ln - 1]
        code += n
        p += n
        prev_limit = max(prev_limit, code << (16 - ln))
        limit[ln] = prev_limit
        code <<= 1
    hv = np.zeros(256, np.int32)
    hv[: len(vals)] = vals
    return limit, mincode, valptr, hv


def mcu_slot_tables(comp_sig):
    """comp_of (B,) int32: the component owning each of the B blocks of
    one MCU."""
    comp_of = []
    for ci, (_, _, hs, vs) in enumerate(comp_sig):
        comp_of += [ci] * (hs * vs)
    return np.array(comp_of, np.int32)


def scatter_layout(comp_sig):
    """Scan-order block j (one MCU's worth repeated per MCU) -> flat
    index into the concatenation of the per-component (bh*bw) grids;
    MCU-padding dummy blocks map to the trash slot `total`. Returns
    (out_idx (nblk_total,), comp_of (nblk_total,), total)."""
    bh0, bw0 = comp_sig[0][0], comp_sig[0][1]
    mcu_y = -(-bh0 // comp_sig[0][3])
    mcu_x = -(-bw0 // comp_sig[0][2])
    bases = np.cumsum([0] + [c[0] * c[1] for c in comp_sig])[:-1]
    total = int(sum(c[0] * c[1] for c in comp_sig))
    idx, comp_of = [], []
    for r in range(mcu_y):
        for c in range(mcu_x):
            for ci, (bh, bw, hs, vs) in enumerate(comp_sig):
                for dy in range(vs):
                    for dx in range(hs):
                        row, col = r * vs + dy, c * hs + dx
                        if row >= bh or col >= bw:
                            idx.append(total)  # stream-only dummy
                        else:
                            idx.append(bases[ci] + row * bw + col)
                        comp_of.append(ci)
    return (np.array(idx, np.int32), np.array(comp_of, np.int32), total)


# -- the numpy entropy decoder ------------------------------------------------

class _BitReader:
    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.pos = 0

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            b = self.bits[self.pos] if self.pos < self.bits.size else 1
            v = (v << 1) | int(b)
            self.pos += 1
        return v

    def peek16(self) -> int:
        v = 0
        for k in range(16):
            p = self.pos + k
            b = self.bits[p] if p < self.bits.size else 1
            v = (v << 1) | int(b)
        return v


def _extend(v: int, size: int) -> int:
    if size == 0:
        return 0
    return v if v >= (1 << (size - 1)) else v - (1 << size) + 1


def decode_reference(info: ScanInfo):
    """Sequential numpy decoder: segments -> per-component (bh, bw, 64)
    int16 natural-order coefficient planes (absolute DC). Reads past a
    segment's end give 1-bits; restart segments reset the DC
    predictors."""
    sig = info.comp_sig
    tabs = {k: derive_tables(*v) for k, v in info.huffman.items()}
    comp_of = mcu_slot_tables(sig)
    B = comp_of.size
    out_idx, _, total = scatter_layout(sig)
    coefs = np.zeros((out_idx.size, 64), np.int16)  # scan order, zigzag
    mcus = info.mcus
    ri = info.restart_interval or mcus
    blk = 0
    for si, seg in enumerate(info.segments):
        rd = _BitReader(seg)
        pred = [0] * info.ncomp
        n_mcu = min(ri, mcus - si * ri)
        for _ in range(n_mcu):
            for slot in range(B):
                ci = int(comp_of[slot])
                dc_t, ac_t = info.scan_tables[ci]
                limit, mincode, valptr, hv = tabs[(0, dc_t)]
                # DC
                P = rd.peek16()
                clen = 1 + int(np.sum(P >= limit[1:17]))
                idx = (P >> (16 - clen)) - int(mincode[clen]) \
                    + int(valptr[clen])
                rd.pos += clen
                size = int(hv[idx])
                diff = _extend(rd.read(size), size)
                pred[ci] += diff
                coefs[blk, 0] = pred[ci]
                # AC
                limit, mincode, valptr, hv = tabs[(1, ac_t)]
                z = 1
                while z < 64:
                    P = rd.peek16()
                    clen = 1 + int(np.sum(P >= limit[1:17]))
                    idx = (P >> (16 - clen)) - int(mincode[clen]) \
                        + int(valptr[clen])
                    rd.pos += clen
                    sym = int(hv[idx])
                    run, size = sym >> 4, sym & 15
                    if size == 0:
                        if run == 15:
                            z += 16
                            continue
                        break  # EOB
                    z += run
                    v = _extend(rd.read(size), size)
                    if z < 64:
                        coefs[blk, z] = v
                    z += 1
                blk += 1
    # zigzag -> natural, then scatter scan-order blocks into the
    # per-component grids (dummies land in the trash slot)
    nat = np.zeros_like(coefs)
    nat[:, ZIGZAG] = coefs
    flat = np.zeros((total + 1, 64), np.int16)
    flat[out_idx[:blk]] = nat[:blk]
    bases = np.cumsum([0] + [c[0] * c[1] for c in sig])[:-1]
    return [flat[bases[ci] : bases[ci] + bh * bw].reshape(bh, bw, 64)
            for ci, (bh, bw, _, _) in enumerate(sig)]
