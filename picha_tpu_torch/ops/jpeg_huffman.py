"""Baseline JPEG Huffman scan encode on the device, and the header
writer for the scans it produces.

Counterpart of `picha_tpu/ops/jpeg_huffman_tpu.py`:
`build_scan_encoder` -> `scan_encode` (kernel K3,
`csrc/huffman_encode_scan.cu`, for CUDA tensors; `scan_encode_plain`
for CPU tensors), `std_huffman_tables` -> `ANNEX_K`, `jpeg_header` ->
`jpeg_header`. The block layout (`_mcu_layout`), the per-symbol code
arrays (`_code_arrays`), the DQT writer (`_dqt`) and `assemble` are the
port's copies of the reference's, pinned by
`tests/test_torch_host_copies.py`.

The reference parses the standard tables out of a libjpeg-written DHT
at run time. This package holds them as a constant (JPEG Annex K,
K.3), so the device path needs no native library; a test pins them to
the libjpeg-derived tables.
"""
from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple

import numpy as np
import torch

from ..kernels._build import KERNELS, aligned, ptr, require_cuda, stream_of
from .jpeg import quality_tables
from .jpeg_scan import ZIGZAG


def _code_arrays(bits, vals, nsyms):
    """(bits, vals) -> (code, length) arrays indexed by symbol."""
    code = np.zeros(nsyms, np.int32)
    length = np.zeros(nsyms, np.int32)
    c = 0
    for ln in range(1, 17):
        for v in vals[sum(bits[: ln - 1]) : sum(bits[:ln])]:
            code[v] = c
            length[v] = ln
            c += 1
        c <<= 1
    return code, length


def _mcu_layout(comp_sig):
    """Block order of an interleaved baseline scan. comp_sig: ((bh, bw,
    h_samp, v_samp), ...). Returns (gather_idx (nblk,) into the flat
    concat of the component grids, dummy_mask (nblk,) bool for blocks
    past a grid (AC zeroed), table_id (nblk,) 0 luma / 1 chroma,
    prev_idx (nblk,) the previous real block of the same component, -1
    for each component's first; dummies emit DC diff 0, so the DC chain
    passes through them)."""
    bh0, bw0 = comp_sig[0][0], comp_sig[0][1]
    mcu_y = -(-bh0 // comp_sig[0][3])
    mcu_x = -(-bw0 // comp_sig[0][2])
    bases = np.cumsum([0] + [c[0] * c[1] for c in comp_sig])[:-1]
    idx, dummy, tid, comp_of = [], [], [], []
    for r in range(mcu_y):
        for c in range(mcu_x):
            for ci, (bh, bw, hs, vs) in enumerate(comp_sig):
                for dy in range(vs):
                    for dx in range(hs):
                        row, col = r * vs + dy, c * hs + dx
                        dum = row >= bh or col >= bw
                        row, col = min(row, bh - 1), min(col, bw - 1)
                        idx.append(bases[ci] + row * bw + col)
                        dummy.append(dum)
                        tid.append(0 if ci == 0 else 1)
                        comp_of.append(ci)
    idx = np.array(idx, np.int32)
    dummy = np.array(dummy, bool)
    tid = np.array(tid, np.int32)
    prev = np.full(len(idx), -1, np.int32)
    last = {}
    for j, ci in enumerate(comp_of):
        if ci in last:
            prev[j] = last[ci]
        if not dummy[j]:
            last[ci] = j
    return idx, dummy, tid, prev


def _dqt(qtab, tid):
    return struct.pack(">HHB", 0xFFDB, 67, tid) + bytes(
        int(qtab[z]) & 0xFF for z in ZIGZAG)


def assemble(header: bytes, scan: np.ndarray, nbytes: int) -> bytes:
    """Header + the scan's first nbytes + EOI."""
    if nbytes > scan.size:
        raise OverflowError(
            f"Huffman scan overflowed its {scan.size}-byte buffer")
    return header + scan[:nbytes].tobytes() + b"\xff\xd9"


def _table(bits_hex: str, vals_hex: str):
    return list(bytes.fromhex(bits_hex)), list(bytes.fromhex(vals_hex))


# {(class 0 DC | 1 AC, id 0 luma | 1 chroma): (bits[16], vals)}
ANNEX_K = {
    (0, 0): _table("00 01 05 01 01 01 01 01 01 00 00 00 00 00 00 00",
                   "00 01 02 03 04 05 06 07 08 09 0a 0b"),
    (0, 1): _table("00 03 01 01 01 01 01 01 01 01 01 00 00 00 00 00",
                   "00 01 02 03 04 05 06 07 08 09 0a 0b"),
    (1, 0): _table(
        "00 02 01 03 03 02 04 03 05 05 04 04 00 00 01 7d",
        "01 02 03 00 04 11 05 12 21 31 41 06 13 51 61 07 22 71 14 32 81 91"
        "a1 08 23 42 b1 c1 15 52 d1 f0 24 33 62 72 82 09 0a 16 17 18 19 1a"
        "25 26 27 28 29 2a 34 35 36 37 38 39 3a 43 44 45 46 47 48 49 4a 53"
        "54 55 56 57 58 59 5a 63 64 65 66 67 68 69 6a 73 74 75 76 77 78 79"
        "7a 83 84 85 86 87 88 89 8a 92 93 94 95 96 97 98 99 9a a2 a3 a4 a5"
        "a6 a7 a8 a9 aa b2 b3 b4 b5 b6 b7 b8 b9 ba c2 c3 c4 c5 c6 c7 c8 c9"
        "ca d2 d3 d4 d5 d6 d7 d8 d9 da e1 e2 e3 e4 e5 e6 e7 e8 e9 ea f1 f2"
        "f3 f4 f5 f6 f7 f8 f9 fa"),
    (1, 1): _table(
        "00 02 01 02 04 04 03 04 07 05 04 04 00 01 02 77",
        "00 01 02 03 11 04 05 21 31 06 12 41 51 07 61 71 13 22 32 81 08 14"
        "42 91 a1 b1 c1 09 23 33 52 f0 15 62 72 d1 0a 16 24 34 e1 25 f1 17"
        "18 19 1a 26 27 28 29 2a 35 36 37 38 39 3a 43 44 45 46 47 48 49 4a"
        "53 54 55 56 57 58 59 5a 63 64 65 66 67 68 69 6a 73 74 75 76 77 78"
        "79 7a 82 83 84 85 86 87 88 89 8a 92 93 94 95 96 97 98 99 9a a2 a3"
        "a4 a5 a6 a7 a8 a9 aa b2 b3 b4 b5 b6 b7 b8 b9 ba c2 c3 c4 c5 c6 c7"
        "c8 c9 ca d2 d3 d4 d5 d6 d7 d8 d9 da e2 e3 e4 e5 e6 e7 e8 e9 ea f2"
        "f3 f4 f5 f6 f7 f8 f9 fa"),
}


def code_table() -> np.ndarray:
    """(4, 256) int32 packed (len << 16 | code) rows: DC luma, DC
    chroma, AC luma, AC chroma (the reference's `big_packed`)."""
    out = np.zeros((4, 256), np.int32)
    for (cls, tid), (bits, vals) in ANNEX_K.items():
        code, length = _code_arrays(bits, vals, 12 if cls == 0 else 256)
        out[cls * 2 + tid, :code.size] = (length << 16) | code
    return out


def jpeg_header(width: int, height: int, comp_sig, quality: int) -> bytes:
    """SOI..SOS header for a baseline scan with the Annex K tables
    (byte-identical to picha_tpu's jpeg_header, which a test pins)."""
    qluma, qchroma = quality_tables(quality)
    ncomp = len(comp_sig)
    out = struct.pack(">H", 0xFFD8)
    out += (struct.pack(">HH", 0xFFE0, 16) + b"JFIF\x00"
            + struct.pack(">BBBHHBB", 1, 1, 0, 1, 1, 0, 0))
    out += _dqt(qluma, 0)
    if ncomp > 1:
        out += _dqt(qchroma, 1)
    sof = struct.pack(">HHBHHB", 0xFFC0, 8 + 3 * ncomp, 8, height, width,
                      ncomp)
    for ci, (_, _, hs, vs) in enumerate(comp_sig):
        sof += struct.pack(">BBB", ci + 1, (hs << 4) | vs,
                           0 if ci == 0 else 1)
    out += sof
    for (cls, tid), (bits, vals) in sorted(ANNEX_K.items()):
        out += struct.pack(">HHB", 0xFFC4, 19 + len(vals), (cls << 4) | tid)
        out += bytes(bits) + bytes(vals)
    sos = struct.pack(">HHB", 0xFFDA, 6 + 2 * ncomp, ncomp)
    for ci in range(ncomp):
        tid = 0 if ci == 0 else 1
        sos += struct.pack(">BB", ci + 1, (tid << 4) | tid)
    return out + sos + struct.pack(">BBB", 0, 63, 0)


class ScanLayout(NamedTuple):
    """`_mcu_layout(comp_sig)` as (nblk,) int32 device tensors."""
    gidx: torch.Tensor
    dummy: torch.Tensor
    tid: torch.Tensor
    prev: torch.Tensor


def _cdiv(a, b):
    return -(-a // b)


def _bitsize(x):
    a = x.abs()
    return sum((a >= (1 << k)).to(torch.int64) for k in range(11))


def _low_bits(x, s):
    return torch.where(x < 0, x - 1, x) & ((1 << s) - 1)


def scan_encode_plain(coefs, layout: ScanLayout, tab, byte_cap: int):
    """Plain torch version of K3, after the reference's dense 65-slot
    packet layout: packets by table lookup, bit offsets by cumsum, words
    by scatter-add of disjoint bit fields, bytes with 0xFF stuffing.
    Returns (scan (N, byte_cap) uint8, nbytes (N,) int32)."""
    n_img = coefs[0].shape[0]
    dev = coefs[0].device
    i64 = torch.int64
    flat = torch.cat([c.reshape(n_img, -1, 64) for c in coefs], 1).to(i64)
    gidx, tid, prev = (t.to(i64) for t in (layout.gidx, layout.tid,
                                           layout.prev))
    dummy = layout.dummy != 0
    zz = torch.as_tensor(ZIGZAG, dtype=i64, device=dev)
    tabl = tab.to(i64).view(4, 256)
    blocks = flat[:, gidx][:, :, zz]                  # (N, nblk, 64) zigzag
    dc = blocks[:, :, 0]
    prev_dc = torch.where(prev[None] < 0, 0, dc[:, prev.clamp(min=0)])
    diff = torch.where(dummy[None], 0, dc - prev_dc)
    s = _bitsize(diff)
    cl = tabl[tid[None].expand_as(diff), s]
    dc_pkt = ((cl & 0xFFFF) << s) | _low_bits(diff, s)
    dc_len = (cl >> 16) + s

    ac = torch.where(dummy[None, :, None], 0, blocks[:, :, 1:])
    nz = ac != 0
    pos = torch.arange(1, 64, device=dev)
    prev_nz = torch.where(nz, pos, 0).cummax(2).values
    prev_nz = torch.cat([torch.zeros_like(prev_nz[:, :, :1]),
                         prev_nz[:, :, :-1]], 2)
    s_ac = _bitsize(ac)
    has_next = nz.flip(2).to(i64).cummax(2).values.flip(2) != 0
    d = pos - prev_nz
    zrl = ~nz & has_next & (d % 16 == 0)
    sym = torch.where(nz, (((pos - prev_nz - 1) & 15) << 4) | s_ac, 0xF0)
    cl_ac = tabl[(2 + tid)[None, :, None].expand_as(sym), sym]
    sval = torch.where(nz, s_ac, 0)
    ac_pkt = ((cl_ac & 0xFFFF) << sval) | torch.where(
        nz, _low_bits(ac, s_ac), 0)
    live = nz | zrl
    ac_pkt = torch.where(live, ac_pkt, 0)
    ac_len = torch.where(live, (cl_ac >> 16) + sval, 0)

    eob = ~nz[:, :, 62]
    cl_eob = tabl[2 + tid, 0][None].expand_as(eob)
    eob_pkt = torch.where(eob, cl_eob & 0xFFFF, 0)
    eob_len = torch.where(eob, cl_eob >> 16, 0)

    pkt = torch.cat([dc_pkt[..., None], ac_pkt, eob_pkt[..., None]],
                    2).view(n_img, -1)
    ln = torch.cat([dc_len[..., None], ac_len, eob_len[..., None]],
                   2).view(n_img, -1)
    ends = ln.cumsum(1)
    total = ends[:, -1]
    pad = (-total) % 8                        # final 1-bits packet
    offs = torch.cat([ends - ln, total[:, None]], 1)
    pkt = torch.cat([pkt, ((1 << pad) - 1)[:, None]], 1)
    ln = torch.cat([ln, pad[:, None]], 1)

    nwords = _cdiv(byte_cap, 4)
    wi = offs >> 5
    rem = (offs & 31) + ln - 32
    live = ln > 0
    c1 = torch.where(rem <= 0, pkt << (-rem).clamp(0, 32),
                     pkt >> rem.clamp(min=0))
    c2 = torch.where(rem > 0, (pkt << (32 - rem).clamp(0, 32)) & 0xFFFFFFFF,
                     0)
    words = torch.zeros((n_img, nwords + 1), dtype=i64, device=dev)
    # packets occupy disjoint bits: the sum of their fields IS the OR;
    # words past the buffer land in the trash column
    words.scatter_add_(1, wi.clamp(max=nwords), torch.where(live, c1, 0))
    words.scatter_add_(1, (wi + 1).clamp(max=nwords),
                       torch.where(live, c2, 0))
    words = words[:, :nwords]
    shifts = torch.tensor([24, 16, 8, 0], dtype=i64, device=dev)
    byte = ((words[:, :, None] >> shifts) & 0xFF).reshape(
        n_img, nwords * 4)[:, :byte_cap]

    nraw = (total + pad) // 8
    b = torch.arange(byte_cap, device=dev)[None]
    in_range = b < nraw[:, None]
    is_ff = (byte == 0xFF) & in_range
    nff_before = is_ff.to(i64).cumsum(1) - is_ff.to(i64)
    out_idx = torch.where(in_range, (b + nff_before).clamp(max=byte_cap),
                          byte_cap)
    out = torch.zeros((n_img, byte_cap + 1), dtype=i64, device=dev)
    out.scatter_add_(1, out_idx, torch.where(in_range, byte, 0))
    nbytes = nraw + is_ff.sum(1)
    return out[:, :byte_cap].to(torch.uint8), nbytes.to(torch.int32)


# K3's tile and chunk (csrc/huffman_encode_scan.cu: kTile, kChunk, kMaxPlanes)
TILE_BLOCKS, CHUNK_BYTES, MAX_PLANES = 256, 4096, 3


def scan_sizes(n_img: int, nblk: int, byte_cap: int):
    """K3's scratch for a call: (nwords, sync_len): the words a raw scan
    holds (a multiple of 4, covering byte_cap), and the int64 tickets,
    look-back descriptors and boundary words (three a tile of
    TILE_BLOCKS scan blocks, one a chunk of CHUNK_BYTES raw bytes, two
    tickets in one), rounded up to an even count so that the words after
    them start 16-byte aligned."""
    nwords = _cdiv(_cdiv(byte_cap, 4), 4) * 4
    tiles = n_img * _cdiv(nblk, TILE_BLOCKS)
    chunks = n_img * _cdiv(byte_cap, CHUNK_BYTES)
    return nwords, _cdiv(2 + 3 * tiles + chunks, 2) * 2


def scan_encode(coefs, layout: ScanLayout, tab, byte_cap: int):
    """Quantised planes (tuple of (N, bh, bw, 64) int, natural order)
    -> (scan (N, byte_cap) uint8, nbytes (N,) int32); nbytes > byte_cap
    signals overflow (the bytes are then invalid), and every byte past
    nbytes is 0. `layout` and `tab` (the (4, 256) int32 `code_table()`)
    live on the planes' device. Launches K3 for CUDA tensors; the plain
    version runs only for CPU tensors."""
    if coefs[0].device.type == "cpu":
        return scan_encode_plain(coefs, layout, tab, byte_cap)
    require_cuda(coefs[0], "K3")
    dev = coefs[0].device
    n_img = coefs[0].shape[0]
    if not 1 <= len(coefs) <= MAX_PLANES or byte_cap < 1:
        raise ValueError(f"K3 takes 1-{MAX_PLANES} planes and a byte cap "
                         f">= 1")
    planes = [aligned(c.to(torch.int16)) for c in coefs]
    nblk = layout.gidx.numel()
    for t in (*layout, tab):
        if t.device != dev or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise TypeError("K3 layout and table must be contiguous int32 "
                            "tensors on the planes' device")
    if nblk < 1 or any(t.numel() != nblk for t in layout) \
            or tab.numel() != 4 * 256:
        raise ValueError("K3 layout arrays must all be (nblk,), nblk >= 1")
    if any(p.device != dev or p.dim() != 4 or p.shape[0] != n_img
           or p.shape[3] != 64 for p in planes):
        raise ValueError("K3 takes (N, bh, bw, 64) planes of one batch on "
                         "one device")
    nwords, sync_len = scan_sizes(n_img, nblk, byte_cap)
    # the kernels' tickets and descriptors (zeroed by K3), then the raw
    # scan words and byte counts
    work = torch.empty(sync_len + _cdiv(n_img * (nwords + 1), 2),
                       dtype=torch.int64, device=dev)
    out = torch.empty((n_img, byte_cap), dtype=torch.uint8, device=dev)
    nbytes = torch.empty(n_img, dtype=torch.int32, device=dev)
    unused = MAX_PLANES - len(planes)
    ptrs = [ptr(p) for p in planes] + [ptr(planes[0])] * unused
    sizes = [p.shape[1] * p.shape[2] for p in planes] + [0] * unused
    KERNELS["huffman_encode_scan"](
        *ptrs, *sizes, len(planes), n_img, nblk, ptr(layout.gidx),
        ptr(layout.dummy), ptr(layout.tid), ptr(layout.prev), ptr(tab),
        ptr(work) + 8 * sync_len, nwords, ptr(work), sync_len, ptr(out),
        byte_cap, ptr(nbytes), stream_of(planes[0]))
    return out, nbytes


_K3_INFO_KEYS = ("bits_registers", "bits_local_bytes",
                 "bits_static_shared_bytes", "bits_dynamic_shared_bytes",
                 "bits_blocks_an_sm", "stuff_registers", "stuff_local_bytes",
                 "stuff_static_shared_bytes", "stuff_blocks_an_sm", "sms",
                 "tile_blocks", "chunk_bytes")


def kernel_info(coefs, layout: ScanLayout, byte_cap: int) -> dict:
    """K3's builds (scan_bits_kernel, stuff_kernel: registers, local
    bytes, shared bytes, blocks an SM) and its plan for a call on the
    CUDA planes `coefs`: tiles of scan blocks, the persistent grid,
    chunks of raw bytes."""
    from ..kernels._build import library

    out = (ctypes.c_int * len(_K3_INFO_KEYS))()
    with torch.cuda.device(coefs[0].device):
        rc = library().picha_huffman_encode_scan_info(out)
    if rc != 0:
        raise RuntimeError(f"picha_huffman_encode_scan_info: CUDA error {rc}")
    info = dict(zip(_K3_INFO_KEYS, out))
    n_img, nblk = coefs[0].shape[0], layout.gidx.numel()
    tiles = n_img * _cdiv(nblk, info["tile_blocks"])
    return dict(info, tiles=tiles,
                grid=min(tiles, info["sms"] * info["bits_blocks_an_sm"]),
                chunks=n_img * _cdiv(byte_cap, info["chunk_bytes"]))
