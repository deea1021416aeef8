"""The host JPEG writer of `JpegBatchPipeline(encode_backend="raw420")`
and `(encode_backend="tpu")`: padded 4:2:0 planes (K31's buffer) or
quantised coefficient planes (K2's) -> baseline JPEG bytes, as libjpeg
writes them.

Counterpart of the reference's libjpeg host stages:
- `native.jpeg_encode_raw420` (`picha_tpu/native/src/jpegshim.cc:296-357`:
  `jpeg_set_defaults`, `jpeg_set_quality(q, TRUE)`, `raw_data_in`,
  `jpeg_write_raw_data`): `write_raw420`;
- `native.jpeg_coef_write` (`jpegshim.cc:533-620`,
  `jpeg_write_coefficients`): `write_coefficients`.

With those settings libjpeg does three things, and so does this module:
the integer "islow" forward DCT (`fdct_islow`, jfdctint.c), jcdctmgr.c's
rounded division by `quantval << 3` (`quantize_libjpeg`) and a sequential
Huffman scan with the Annex K tables (the port's plain scan encode,
`ops/jpeg_huffman.py::scan_encode_plain`, whose block layout already
codes libjpeg's dummy blocks: DC difference 0, no AC). The buffer has no
byte budget: it grows as `jpeg_mem_dest`'s does. `libjpeg_header` writes
the header libjpeg writes (its DHT order and table slots differ from the
device encode's `jpeg_header`).

`native=True` runs the host C++ of `csrc/jpeg_write_host.cu` (built into
the kernel library at first use, which needs nvcc: the card machine),
one image a call; ctypes releases the GIL, so the pipeline runs it on its
thread pool. The numpy / torch-CPU code here is its plain version: the
same bytes.
"""
from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np
import torch

from .jpeg import quality_tables, yuv420_sizes
from .jpeg_huffman import (ANNEX_K, ScanLayout, _dqt, _mcu_layout,
                           code_table, scan_encode_plain)

CONST_BITS, PASS1_BITS = 13, 2
# jfdctint.c's FIX(x) = x * 2^13 rounded
_F = dict(c0298631336=2446, c0390180644=3196, c0541196100=4433,
          c0765366865=6270, c0899976223=7373, c1175875602=9633,
          c1501321110=12299, c1847759065=15137, c1961570560=16069,
          c2053119869=16819, c2562915447=20995, c3072711026=25172)
BYTES_PER_BLOCK = 424   # a block's longest code (1681 bits) with stuffing


def _cdiv(a, b):
    return -(-a // b)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _fdct_pass(d, axis, pass1: bool):
    """One 8-point pass of jpeg_fdct_islow along `axis` (rows first, then
    columns), int64."""
    x = [np.take(d, i, axis) for i in range(8)]
    tmp0, tmp7 = x[0] + x[7], x[0] - x[7]
    tmp1, tmp6 = x[1] + x[6], x[1] - x[6]
    tmp2, tmp5 = x[2] + x[5], x[2] - x[5]
    tmp3, tmp4 = x[3] + x[4], x[3] - x[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    sh = CONST_BITS - PASS1_BITS if pass1 else CONST_BITS + PASS1_BITS
    out = [None] * 8
    if pass1:
        out[0] = (tmp10 + tmp11) << PASS1_BITS
        out[4] = (tmp10 - tmp11) << PASS1_BITS
    else:
        out[0] = _descale(tmp10 + tmp11, PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, PASS1_BITS)
    z1 = (tmp12 + tmp13) * _F["c0541196100"]
    out[2] = _descale(z1 + tmp13 * _F["c0765366865"], sh)
    out[6] = _descale(z1 - tmp12 * _F["c1847759065"], sh)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F["c1175875602"]
    t4, t5 = tmp4 * _F["c0298631336"], tmp5 * _F["c2053119869"]
    t6, t7 = tmp6 * _F["c3072711026"], tmp7 * _F["c1501321110"]
    z1 = z1 * -_F["c0899976223"]
    z2 = z2 * -_F["c2562915447"]
    z3 = z3 * -_F["c1961570560"] + z5
    z4 = z4 * -_F["c0390180644"] + z5
    out[7] = _descale(t4 + z1 + z3, sh)
    out[5] = _descale(t5 + z2 + z4, sh)
    out[3] = _descale(t6 + z2 + z3, sh)
    out[1] = _descale(t7 + z1 + z4, sh)
    return np.stack(out, axis)


def fdct_islow(samples):
    """(..., 8, 8) samples 0-255 -> (..., 64) int64 natural-order DCT
    coefficients scaled by 8: libjpeg's jpeg_fdct_islow on the samples
    - 128."""
    d = np.asarray(samples, np.int64) - 128
    d = _fdct_pass(d, -1, True)
    d = _fdct_pass(d, -2, False)
    return d.reshape(d.shape[:-2] + (64,))


def quantize_libjpeg(ws, qtab):
    """jcdctmgr.c's quantisation of fdct_islow's output: with q =
    quantval << 3, sign(x) * ((|x| + (q >> 1)) // q) -> int16."""
    q = np.asarray(qtab, np.int64) << 3
    a = np.abs(ws)
    v = (a + (q >> 1)) // q
    return np.where(ws < 0, -v, v).astype(np.int16)


def _blocks(plane, bh, bw):
    """The (bh, bw, 8, 8) blocks of the top-left bh*8 x bw*8 samples."""
    return plane[:bh * 8, :bw * 8].reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)


def resized_comp_sig(h: int, w: int, channels: int):
    """Component block grids ((bh, bw, h_samp, v_samp), ...) of an h x w
    encode with libjpeg's ceil(comp / 8) blocks: one grey component, or
    4:2:0 colour."""
    if channels == 1:
        return ((_cdiv(h, 8), _cdiv(w, 8), 1, 1),)
    ch, cw = _cdiv(h, 2), _cdiv(w, 2)
    return ((_cdiv(h, 8), _cdiv(w, 8), 2, 2),
            (_cdiv(ch, 8), _cdiv(cw, 8), 1, 1),
            (_cdiv(ch, 8), _cdiv(cw, 8), 1, 1))


def raw420_coefficients(y, cb, cr, ew: int, eh: int, quality: int):
    """Padded planes (y (ceil16(eh), ceil16(ew)), cb / cr half that,
    uint8) -> the quantised (bh, bw, 64) int16 planes libjpeg's raw write
    codes: each real block through fdct_islow and quantize_libjpeg with
    the luma / chroma tables of `quality`."""
    ql, qc = quality_tables(quality)
    return [quantize_libjpeg(fdct_islow(_blocks(np.asarray(p), bh, bw)), q)
            for p, (bh, bw, _, _), q in zip((y, cb, cr),
                                            resized_comp_sig(eh, ew, 3),
                                            (ql, qc, qc))]


def _slots(qtables):
    """jpeg_coef_write's table slots: component c takes slot c, or the
    previous component's slot when its table equals that one's."""
    slots = []
    for c, q in enumerate(qtables):
        if c and np.array_equal(q, qtables[c - 1]):
            slots.append(slots[-1])
        else:
            slots.append(c)
    return slots


@functools.lru_cache(maxsize=64)
def _header(width, height, comp_sig, tables, slots):
    out = struct.pack(">H", 0xFFD8)
    out += (struct.pack(">HH", 0xFFE0, 16) + b"JFIF\x00"
            + struct.pack(">BBBHHBB", 1, 1, 0, 1, 1, 0, 0))
    sent = set()
    for q, s in zip(tables, slots):
        if s not in sent:
            sent.add(s)
            out += _dqt(np.frombuffer(q, np.uint16), s)
    ncomp = len(comp_sig)
    out += struct.pack(">HHBHHB", 0xFFC0, 8 + 3 * ncomp, 8, height, width,
                       ncomp)
    for ci, ((_, _, hs, vs), s) in enumerate(zip(comp_sig, slots)):
        out += struct.pack(">BBB", ci + 1, (hs << 4) | vs, s)
    sent = set()
    for ci in range(ncomp):
        tid = 0 if ci == 0 else 1
        for cls in (0, 1):
            if (cls, tid) in sent:
                continue
            sent.add((cls, tid))
            bits, vals = ANNEX_K[(cls, tid)]
            out += struct.pack(">HHB", 0xFFC4, 19 + len(vals),
                               (cls << 4) | tid)
            out += bytes(bits) + bytes(vals)
    out += struct.pack(">HHB", 0xFFDA, 6 + 2 * ncomp, ncomp)
    for ci in range(ncomp):
        tid = 0 if ci == 0 else 1
        out += struct.pack(">BB", ci + 1, (tid << 4) | tid)
    return out + struct.pack(">BBB", 0, 63, 0)


def libjpeg_header(width: int, height: int, comp_sig, qtables, slots=None):
    """SOI..SOS as libjpeg writes them for a baseline encode with the
    Annex K tables: JFIF APP0, one DQT per table slot in component order,
    SOF0, then per component its DC and AC tables (luma 0 for the first,
    chroma 1 for the others) each the first time it is used, SOS.
    `qtables` (64,) natural order, one per component; `slots` their
    quantisation table slots (default: jpeg_coef_write's sharing rule,
    `_slots`)."""
    tabs = tuple(np.ascontiguousarray(q, np.uint16).tobytes()
                 for q in qtables)
    if slots is None:
        slots = _slots([np.frombuffer(t, np.uint16) for t in tabs])
    return _header(int(width), int(height), tuple(tuple(int(v) for v in c)
                                                  for c in comp_sig),
                   tabs, tuple(int(s) for s in slots))


def scan_bound(comp_sig) -> int:
    """Bytes that hold the scan of any coefficients of these grids."""
    b0 = comp_sig[0]
    mcus = _cdiv(b0[0], b0[3]) * _cdiv(b0[1], b0[2])
    return mcus * sum(hs * vs for _, _, hs, vs in comp_sig) \
        * BYTES_PER_BLOCK + 16


@functools.lru_cache(maxsize=64)
def _layout(comp_sig):
    return ScanLayout(*(torch.as_tensor(a, dtype=torch.int32)
                        for a in _mcu_layout(comp_sig)))


@functools.lru_cache(maxsize=1)
def _code_table():
    return np.ascontiguousarray(code_table(), np.int32)


def scan_plain(planes, comp_sig) -> bytes:
    """Coefficient planes (bh, bw, 64) int16 -> the scan bytes (stuffed,
    1-padded, no EOI) through the plain scan encode, its buffer grown
    until the scan fits."""
    coefs = tuple(torch.as_tensor(np.asarray(p, np.int16))[None]
                  for p in planes)
    layout, tab = _layout(comp_sig), torch.as_tensor(_code_table())
    cap = max(4096, 32 * layout.gidx.numel())
    while True:
        scan, nbytes = scan_encode_plain(coefs, layout, tab, cap)
        n = int(nbytes[0])
        if n <= cap:
            return scan[0, :n].numpy().tobytes()
        cap = 2 * n


def scan_native(planes, comp_sig) -> bytes:
    """`scan_plain`'s bytes through the host C++
    (`picha_host_jpeg_write_coefficients`)."""
    from ..kernels._build import library

    n = len(planes)
    planes = [np.ascontiguousarray(p, np.int16) for p in planes]
    geom = [np.ascontiguousarray([c[i] for c in comp_sig], np.int32)
            for i in range(4)]
    cap = scan_bound(comp_sig)
    out = np.empty(cap, np.uint8)
    nbytes = ctypes.c_int64()
    ptrs = (ctypes.c_void_p * n)(*[p.ctypes.data for p in planes])
    rc = library().picha_host_jpeg_write_coefficients(
        n, ptrs, *(g.ctypes.data for g in geom), _code_table().ctypes.data,
        out.ctypes.data, cap, ctypes.addressof(nbytes))
    if rc != 0:
        raise ValueError(f"host JPEG writer failed ({rc})")
    return out[:nbytes.value].tobytes()


def write_coefficients(planes, ew: int, eh: int, quality: int,
                       native: bool = False) -> bytes:
    """The counterpart of `native.jpeg_coef_write(ew, eh, comps)` for the
    "tpu" backend: 1 (grey) or 3 (4:2:0) quantised (bh, bw, 64) int16
    planes, quantised with `quality_tables(quality)` (luma, then chroma
    for both chroma planes) -> JPEG bytes."""
    sig = resized_comp_sig(eh, ew, len(planes))
    for p, (bh, bw, _, _) in zip(planes, sig):
        if tuple(p.shape) != (bh, bw, 64):
            raise ValueError(f"plane {tuple(p.shape)} is not the "
                             f"{(bh, bw, 64)} grid of a {ew}x{eh} encode")
    ql, qc = quality_tables(quality)
    tables = (ql, qc, qc)[:len(planes)]
    scan = (scan_native if native else scan_plain)(planes, sig)
    return libjpeg_header(ew, eh, sig, tables) + scan + b"\xff\xd9"


def write_raw420(y, cb, cr, ew: int, eh: int, quality: int,
                 native: bool = False) -> bytes:
    """The counterpart of `native.jpeg_encode_raw420(y, cb, cr, ew, eh,
    quality)`: padded 4:2:0 planes (y (ceil16(eh), ceil16(ew)), cb / cr
    half that, uint8) -> a 3-component JPEG, quantisation tables in slots
    0 / 1 / 1 as jpeg_set_quality sets them."""
    hpad, wpad, _, _ = yuv420_sizes(eh, ew)
    shapes = ((hpad, wpad), (hpad // 2, wpad // 2), (hpad // 2, wpad // 2))
    for p, s in zip((y, cb, cr), shapes):
        if tuple(p.shape) != s:
            raise ValueError(f"plane {tuple(p.shape)} is not {s} for a "
                             f"{ew}x{eh} encode")
    sig = resized_comp_sig(eh, ew, 3)
    ql, qc = quality_tables(quality)
    header = libjpeg_header(ew, eh, sig, (ql, qc, qc), (0, 1, 1))
    if not native:
        planes = raw420_coefficients(y, cb, cr, ew, eh, quality)
        return header + scan_plain(planes, sig) + b"\xff\xd9"
    from ..kernels._build import library

    y, cb, cr = (np.ascontiguousarray(p, np.uint8) for p in (y, cb, cr))
    q32 = [np.ascontiguousarray(q, np.int32) for q in (ql, qc)]
    cap = scan_bound(sig)
    out = np.empty(cap, np.uint8)
    nbytes = ctypes.c_int64()
    rc = library().picha_host_jpeg_write_raw420(
        y.ctypes.data, cb.ctypes.data, cr.ctypes.data, ew, eh,
        q32[0].ctypes.data, q32[1].ctypes.data, _code_table().ctypes.data,
        out.ctypes.data, cap, ctypes.addressof(nbytes))
    if rc != 0:
        raise ValueError(f"host JPEG writer failed ({rc})")
    return header + out[:nbytes.value].tobytes() + b"\xff\xd9"


def split_yuv420(buf, ew: int, eh: int):
    """One image's row of K31's (N, bytes) buffer -> (y, cb, cr) views."""
    hpad, wpad, ysz, csz = yuv420_sizes(eh, ew)
    return (buf[:ysz].reshape(hpad, wpad),
            buf[ysz:ysz + csz].reshape(hpad // 2, wpad // 2),
            buf[ysz + csz:ysz + 2 * csz].reshape(hpad // 2, wpad // 2))
