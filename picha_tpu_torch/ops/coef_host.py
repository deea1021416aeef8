"""The host side of the host-coefficient uploads: the coefficient set, the
host entropy decoder and the sparse wire packers.

Counterparts (the port's own copies) of:
- `picha_tpu/native/lib.py::JpegCoefficients` (:539-560, `from_parts`):
  `JpegCoefficients`, the coefficient set of one image (width, height,
  colour space and per component `coefs` (bh, bw, 64) int16, `qtable`
  (64,) uint16, `h_samp`, `v_samp`, `blocks_w`, `blocks_h`, `width`,
  `height`);
- `native.jpeg_entropy_decode` (:599-675) over `jpegentropy.cc`:
  `decode_native`, the host C++ decoder of `csrc/jpeg_entropy_host.cu`
  (no libjpeg) for the card, and `decode_plain` through
  `ops/jpeg_scan.py::decode_reference` (numpy), its plain version on the
  CPU;
- `pipeline/jpeg_batch.py::entropy_decode`'s thread policy (:35-68):
  `entropy_decode` (segment-parallel when the batch is narrower than the
  thread budget, image-parallel otherwise; ctypes releases the GIL);
- `native.gap8_pack` (:846) and `native.gap4_pack_batch` (:927) over
  `sparsepack.cc`: `gap8_pack`, `gap4_pack_batch`, the host C++ of
  `csrc/sparse_pack_host.cu` on the card and the numpy `gap8_pack_plain`,
  `gap4_pack_plain` on the CPU (the same bytes);
- `picha_tpu/bucketing.py::bucket_geometric`.

`native=True` selects the C++ (built into the kernel library at first
use, which needs nvcc: the card machine); the pipeline passes it when its
device is a CUDA device.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from .jpeg_scan import ScanInfo, decode_reference, derive_tables


class JpegCoefficients:
    """Entropy-decoded JPEG: per component quantised DCT coefficients
    (blocks_h, blocks_w, 64) int16 and a (64,) uint16 qtable."""

    __slots__ = ("width", "height", "ncomp", "color_space", "comps")

    @classmethod
    def from_parts(cls, width, height, color_space, comps):
        co = object.__new__(cls)
        co.width, co.height = width, height
        co.ncomp, co.color_space = len(comps), color_space
        co.comps = comps
        return co

    @property
    def comp_sig(self):
        """((blocks_h, blocks_w, h_samp, v_samp), ...), as a parsed scan's
        `comp_sig`: the pipeline's signature of the set."""
        return tuple((c["blocks_h"], c["blocks_w"], c["h_samp"], c["v_samp"])
                     for c in self.comps)


def coefficient_set(info: ScanInfo, planes) -> JpegCoefficients:
    """A parsed scan and its decoded planes -> the coefficient set."""
    hmax = max(h for h, _, _ in info.comps)
    vmax = max(v for _, v, _ in info.comps)
    return JpegCoefficients.from_parts(info.width, info.height,
                                       info.color_space, [{
        "h_samp": h, "v_samp": v,
        "blocks_w": bw, "blocks_h": bh,
        "width": -(-info.width * h // hmax),
        "height": -(-info.height * v // vmax),
        "qtable": q, "coefs": planes[ci],
    } for ci, ((bh, bw, _, _), (h, v, q)) in enumerate(
        zip(info.comp_sig, info.comps))])


def decode_plain(info: ScanInfo) -> JpegCoefficients:
    """The numpy decode (`decode_reference`) of one parsed scan."""
    return coefficient_set(info, decode_reference(info))


def decode_native(info: ScanInfo, nthreads: int = 1) -> JpegCoefficients:
    """The host C++ decode of one parsed scan, its restart segments on
    `nthreads` threads; bit for bit `decode_plain`."""
    from ..kernels._build import library

    sig = info.comp_sig
    ncomp = info.ncomp
    hmax = max(h for h, _, _ in info.comps)
    # table rows, deduplicated in first-use order; per component row ids
    rows, row_of, nbits_rows, dc_tab, ac_tab = [], {}, [], [], []
    for ci in range(ncomp):
        for cls, dest in ((0, dc_tab), (1, ac_tab)):
            key = (cls, info.scan_tables[ci][cls])
            if key not in row_of:
                row_of[key] = len(rows)
                rows.append(derive_tables(*info.huffman[key]))
                nbits_rows.append([0] + list(info.huffman[key][0]))
            dest.append(row_of[key])
    limit, mincode, valptr = (np.ascontiguousarray(
        np.stack([r[i] for r in rows]), np.int64) for i in range(3))
    hv = np.ascontiguousarray(np.stack([r[3] for r in rows]), np.int32)
    nbits = np.ascontiguousarray(np.array(nbits_rows), np.int32)
    data = b"".join(info.segments)
    arr = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
    seg_off = np.zeros(len(info.segments) + 1, np.int64)
    np.cumsum([len(s) for s in info.segments], out=seg_off[1:])
    outs = [np.zeros((bh, bw, 64), np.int16) for bh, bw, _, _ in sig]
    out_ptrs = (ctypes.c_void_p * ncomp)(*[o.ctypes.data for o in outs])

    def ints(vals):
        return np.ascontiguousarray(list(vals), np.int32)

    geom = [ints(h for h, _, _ in info.comps), ints(v for _, v, _ in info.comps),
            ints(c[1] for c in sig), ints(c[0] for c in sig), ints(dc_tab),
            ints(ac_tab)]
    mcus = info.mcus
    rc = library().picha_host_entropy_segments(
        arr.ctypes.data, seg_off.ctypes.data, len(info.segments), mcus,
        info.restart_interval or mcus, -(-info.width // (8 * hmax)), ncomp,
        *(g.ctypes.data for g in geom), limit.ctypes.data,
        mincode.ctypes.data, valptr.ctypes.data, hv.ctypes.data,
        nbits.ctypes.data, len(rows), max(1, int(nthreads)), out_ptrs)
    if rc != 0:
        raise ValueError("host entropy decode refused the scan")
    return coefficient_set(info, outs)


def entropy_decode(infos, native: bool, pool=None,
                   max_threads: Optional[int] = None):
    """Parsed scans -> coefficient sets, with the reference's thread
    policy: a batch narrower than the thread budget splits each image's
    restart segments over the idle threads (segment-parallel), a wider one
    decodes one image a thread (image-parallel). `pool` runs the images;
    the plain (numpy) decode runs serially."""
    if not native:
        return [decode_plain(i) for i in infos]
    cores = os.cpu_count() or 1
    if max_threads is not None:
        cores = max(1, min(cores, max_threads))
    n = len(infos)
    if cores > 1 and 0 < n < cores:
        base, extra = divmod(cores, n)
        threads = [base + (1 if i < extra else 0) for i in range(n)]
    else:
        threads = [1] * n

    def one(item):
        return decode_native(*item)

    items = list(zip(infos, threads))
    if pool is None or cores <= 1:
        return [one(x) for x in items]
    return list(pool.map(one, items))


# -- the wire packers ----------------------------------------------------------

def bucket_geometric(k: int, granule: int) -> int:
    """k rounded up to 16 mantissa steps per octave, at least `granule`."""
    k = max(int(k), granule)
    step = max(granule, 1 << max(0, k.bit_length() - 4))
    return -(-k // step) * step


def _chain(pos, limit):
    """Entries at sorted positions `pos` (the last one the tail pin) with
    gaps from the previous position (from -1 at first), each gap past
    `limit` split off as (limit, dummy) entries first: (the stream's gaps,
    the stream index of each entry of `pos`)."""
    prev = np.concatenate([[-1], pos[:-1]])
    gap = pos - prev
    dummies = np.where(gap > limit, (gap - 1) // limit, 0)
    real_at = np.cumsum(dummies + 1) - 1
    gaps = np.full(int(real_at[-1]) + 1, limit, np.int64)
    gaps[real_at] = gap - limit * dummies
    return gaps, real_at


def gap8_pack_plain(coefs: np.ndarray):
    """int16 plane -> (gaps u8, vals i8, corr_idx i32, corr_val i16), the
    gap8 wire of `sparse_pack_host.cu::picha_host_gap8_pack`."""
    flat = np.ascontiguousarray(coefs.reshape(-1), dtype=np.int16)
    n = flat.size
    nz = np.flatnonzero(flat)
    pos = np.concatenate([nz, [n - 1]])
    v = np.concatenate([flat[nz], [0]]).astype(np.int32)
    gaps, real_at = _chain(pos, 255)
    v8 = np.clip(v, -128, 127)
    vals = np.zeros(gaps.size, np.int8)
    vals[real_at] = v8
    bad = v != v8
    return (gaps.astype(np.uint8), vals, pos[bad].astype(np.int32),
            (v - v8)[bad].astype(np.int16))


def gap4_pack_plain(coefs: np.ndarray, corr_base: int = 0):
    """int16 plane -> (prim u8, sgaps u8, svals i8, corr_idx i32, corr_val
    i16), one image's gap4 streams (`sparse_pack_host.cu::gap4_one`),
    corrections at corr_base + index."""
    flat = np.ascontiguousarray(coefs.reshape(-1), dtype=np.int16)
    n = flat.size
    nz = np.flatnonzero(flat)
    v = flat[nz].astype(np.int32)
    pos = np.concatenate([nz, [n - 1]])
    code = np.concatenate([np.where(np.abs(v) <= 7, v + 7, 15), [7]])
    gaps, real_at = _chain(pos, 15)
    prim = (gaps << 4 | 7).astype(np.uint8)
    prim[real_at] = (gaps[real_at] << 4 | code).astype(np.uint8)
    esc = np.abs(v) > 7
    epos = np.concatenate([nz[esc], [n - 1]])
    ev = np.concatenate([v[esc], [0]])
    sgaps, s_at = _chain(epos, 255)
    ev8 = np.clip(ev, -128, 127)
    svals = np.zeros(sgaps.size, np.int8)
    svals[s_at] = ev8
    bad = ev != ev8
    return (prim, sgaps.astype(np.uint8), svals,
            (corr_base + epos[bad]).astype(np.int32),
            (ev - ev8)[bad].astype(np.int16))


def gap8_pack(coefs: np.ndarray, native: bool = False):
    """The gap8 wire of one plane: `picha_host_gap8_pack` (`native`) or
    `gap8_pack_plain`, the same bytes."""
    if not native:
        return gap8_pack_plain(coefs)
    from ..kernels._build import library

    flat = np.ascontiguousarray(coefs.reshape(-1), dtype=np.int16)
    n = flat.size
    cap = n + n // 255 + 2
    gaps = np.empty(cap, np.uint8)
    vals = np.empty(cap, np.int8)
    corr_idx = np.empty(max(1, n), np.int32)
    corr_val = np.empty(max(1, n), np.int16)
    npairs, ncorr = ctypes.c_size_t(), ctypes.c_size_t()
    rc = library().picha_host_gap8_pack(
        flat.ctypes.data, n, gaps.ctypes.data, vals.ctypes.data,
        ctypes.addressof(npairs), corr_idx.ctypes.data, corr_val.ctypes.data,
        ctypes.addressof(ncorr))
    if rc != 0:
        raise ValueError("gap8 pack failed")
    k, c = npairs.value, ncorr.value
    return gaps[:k], vals[:k], corr_idx[:c].copy(), corr_val[:c].copy()


def gap4_pack_batch(planes, native: bool = False):
    """Same-shape int16 planes -> (k1, k2, kc, prim (nb, k1) u8, sgaps
    (nb, k2) u8, svals (nb, k2) i8, corr_idx (kc,) i32, corr_val (kc,)
    i16): the padded gap4 wire rows (`native.gap4_pack_batch`'s at its
    default granules 8192 / 4096 / 1024), through
    `picha_host_gap4_batch_begin` / `_finish` (`native`) or the numpy
    packer."""
    nb = len(planes)
    flats = [np.ascontiguousarray(p.reshape(-1), dtype=np.int16)
             for p in planes]
    n = flats[0].size
    if nb * n > 2**31 - 1:
        raise ValueError("gap4 batch: batch-flat indices past int32")
    if native:
        from ..kernels._build import library

        lib = library()
        ptrs = (ctypes.c_void_p * nb)(*[f.ctypes.data for f in flats])
        np1, np2, np3 = (np.empty(nb, np.int64) for _ in range(3))
        handle = ctypes.c_void_p()
        rc = lib.picha_host_gap4_batch_begin(
            ptrs, nb, n, ctypes.addressof(handle), np1.ctypes.data,
            np2.ctypes.data, np3.ctypes.data)
        if rc != 0:
            raise ValueError("gap4 batch pack failed")
    else:
        packed = [gap4_pack_plain(f, j * n) for j, f in enumerate(flats)]
        np1, np2, np3 = (np.array([p[i].size for p in packed], np.int64)
                         for i in (0, 1, 3))

    k1 = bucket_geometric(max(1, int(np1.max())), 8192)
    k2 = bucket_geometric(max(1, int(np2.max())), 4096)
    kc = bucket_geometric(max(1, int(np3.sum())), 1024)
    prim = np.empty((nb, k1), np.uint8)
    sgaps = np.empty((nb, k2), np.uint8)
    svals = np.empty((nb, k2), np.int8)
    corr_idx = np.empty(kc, np.int32)
    corr_val = np.empty(kc, np.int16)
    if native:
        rc = lib.picha_host_gap4_batch_finish(
            handle, prim.ctypes.data, k1, sgaps.ctypes.data,
            svals.ctypes.data, k2, corr_idx.ctypes.data, corr_val.ctypes.data,
            kc)
        if rc != 0:
            raise ValueError("gap4 batch finish failed")
        return k1, k2, kc, prim, sgaps, svals, corr_idx, corr_val
    prim[:] = 0x07
    sgaps[:] = 0
    svals[:] = 0
    corr_idx[:] = nb * n - 1
    corr_val[:] = 0
    off = 0
    for j, (p, sg, sv, ci, cv) in enumerate(packed):
        prim[j, :p.size] = p
        sgaps[j, :sg.size] = sg
        svals[j, :sv.size] = sv
        corr_idx[off:off + ci.size] = ci
        corr_val[off:off + cv.size] = cv
        off += ci.size
    return k1, k2, kc, prim, sgaps, svals, corr_idx, corr_val
