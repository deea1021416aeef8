"""Restores of the host-coefficient uploads: kernels K27-K30 and their
plain torch twins, and the device unpack of the gap8 / gap4 wires.

Counterparts of `picha_tpu/pipeline/jpeg_batch.py`'s device side of
`upload="sparse" | "int8" | "gap8" | "gap4"`:

  `densify`        K27, `_jit_batch_graph.densify` (:244-256): (N, k)
                   indices + int16 values -> dense planes
  `int8_restore`   K28, `int8_restore` (:274-282): the int8 body plus a
                   batch-flat int16 correction list
  `gap8_restore`   K29, `gap8_restore` (:258-272): per image the running
                   sum of u8 gaps - 1 (clamped at 0) indexes i8 values,
                   then the corrections
  `gap4_restore`   K30, `gap4_restore_flat` (:119-142): a nibble primary
                   stream (gap << 4 | code; 7 adds zero, 15 escapes), the
                   escapes' values in a gap8 side stream, the corrections
  K27, K29 and K30 run one tiled code over the whole batch (`kernel_info`
  reads the tile and their eight kernels' builds from the card); K27's
  indices must never decrease within a row (the packers' np.flatnonzero
  order): its kernel traps on a decrease, so the call ends with a CUDA
  error instead of a plane.
  `unpack_gap8`, `unpack_gap4_wire`  the one coalesced wire upload ->
                   views per section (`_jit_batch_graph.unpack_gap8`,
                   :284-315; `unpack_gap4_wire`, :145-180), cut by one
                   `split`, then the restores

Every restore returns (N, bh, bw, 64) int32 planes, the dtype and layout
`split_planes` hands K6 and the fused product on the scan path. Each
wrapper launches its kernel (`csrc/coef_restore.cu`) for CUDA tensors and
runs its `*_plain` twin only for CPU tensors; both give the reference's
integer scatter-adds exactly.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels._build import KERNELS, ptr, require_cuda, stream_of


def _i32(t):
    return t.to(torch.int32)


def densify_plain(idx, val, bh: int, bw: int):
    """idx (N, k) int32, val (N, k) int16 -> (N, bh, bw, 64) int32."""
    m = bh * bw * 64
    out = torch.zeros((idx.shape[0], m), dtype=torch.int32,
                      device=idx.device)
    out.scatter_add_(1, idx.long(), _i32(val))
    return out.view(-1, bh, bw, 64)


def int8_restore_plain(c8, idx, val):
    """c8 (N, bh, bw, 64) int8, idx (k,) int32 batch-flat, val (k,) int16
    -> (N, bh, bw, 64) int32."""
    flat = _i32(c8).reshape(-1)
    flat.index_add_(0, idx.long(), _i32(val))
    return flat.view(c8.shape)


def _gap_indices(g):
    """(N, k) u8 gaps -> (N, k) int64 indices: cumsum - 1, clamped at 0
    (the reference's `jnp.maximum(idx, 0)`)."""
    return (torch.cumsum(g.to(torch.int64), 1) - 1).clamp_min(0)


def gap8_restore_plain(g, v, ci, cv, bh: int, bw: int):
    """g (N, k) uint8, v (N, k) int8, ci (kc,) int32 batch-flat, cv (kc,)
    int16 -> (N, bh, bw, 64) int32."""
    m = bh * bw * 64
    n = g.shape[0]
    base = torch.arange(n, device=g.device)[:, None] * m
    flat = torch.zeros(n * m, dtype=torch.int32, device=g.device)
    flat.index_add_(0, (_gap_indices(g) + base).reshape(-1),
                    _i32(v).reshape(-1))
    flat.index_add_(0, ci.long(), _i32(cv))
    return flat.view(n, bh, bw, 64)


def gap4_restore_plain(prim, sg, sv, ci, cv, bh: int, bw: int):
    """prim (N, k1) uint8, sg (N, k2) uint8, sv (N, k2) int8, ci (kc,)
    int32 batch-flat, cv (kc,) int16 -> (N, bh, bw, 64) int32."""
    m = bh * bw * 64
    n = prim.shape[0]
    base = torch.arange(n, device=prim.device)[:, None] * m
    nib = _i32(prim & 15)
    v = torch.where(nib == 15, torch.zeros_like(nib), nib - 7)
    flat = torch.zeros(n * m, dtype=torch.int32, device=prim.device)
    flat.index_add_(0, (_gap_indices(prim >> 4) + base).reshape(-1),
                    v.reshape(-1))
    flat.index_add_(0, (_gap_indices(sg) + base).reshape(-1),
                    _i32(sv).reshape(-1))
    flat.index_add_(0, ci.long(), _i32(cv))
    return flat.view(n, bh, bw, 64)


def _check(kernel, *pairs):
    for t, dtype in pairs:
        require_cuda(t, kernel)
        if t.dtype != dtype:
            raise TypeError(f"{kernel} takes {dtype}, got {t.dtype}")


def densify(idx, val, bh: int, bw: int):
    """K27 (see the module doc); the plain version for CPU tensors."""
    if idx.device.type == "cpu":
        return densify_plain(idx, val, bh, bw)
    _check("K27", (idx, torch.int32), (val, torch.int16))
    if idx.dim() != 2 or val.shape != idx.shape or val.device != idx.device:
        raise ValueError("K27 takes (N, k) indices and values on one device")
    idx, val = idx.contiguous(), val.contiguous()
    n, k = idx.shape
    out = torch.empty((n, bh, bw, 64), dtype=torch.int32, device=idx.device)
    scratch, nbytes = _tile_scratch(n, k, 0, idx.device)
    KERNELS["coef_densify"](ptr(idx), ptr(val), n, k, bh * bw * 64, ptr(out),
                            ptr(scratch), nbytes, stream_of(idx))
    return out


def int8_restore(c8, idx, val):
    """K28 (see the module doc); the plain version for CPU tensors."""
    if c8.device.type == "cpu":
        return int8_restore_plain(c8, idx, val)
    _check("K28", (c8, torch.int8), (idx, torch.int32), (val, torch.int16))
    if idx.dim() != 1 or val.shape != idx.shape or \
            any(t.device != c8.device for t in (idx, val)):
        raise ValueError("K28 takes (k,) corrections on the body's device")
    c8, idx, val = c8.contiguous(), idx.contiguous(), val.contiguous()
    out = torch.empty(c8.shape, dtype=torch.int32, device=c8.device)
    KERNELS["coef_int8_restore"](ptr(c8), c8.numel(), ptr(idx), ptr(val),
                                 idx.numel(), ptr(out), stream_of(c8))
    return out


_TILES_INFO = []
_TILE_KERNELS = ("gap4_tile_sums", "gap4_write", "gap4_adds",
                 "gap8_tile_sums", "gap8_write", "gap8_adds",
                 "densify_write", "densify_adds")


def _tiles_info() -> list:
    """`picha_coef_tiles_info`: entries a tile, cells a block stages, then
    the registers, local bytes, shared bytes, threads and blocks a
    multiprocessor of K30's, K29's and K27's kernels."""
    from ..kernels._build import library

    if not _TILES_INFO:
        out = (ctypes.c_int * (2 + 5 * len(_TILE_KERNELS)))()
        rc = library().picha_coef_tiles_info(out)
        if rc != 0:
            raise RuntimeError(f"picha_coef_tiles_info: CUDA error {rc}")
        _TILES_INFO.extend(out)
    return _TILES_INFO


def kernel_info() -> dict:
    """K27's, K29's and K30's tile and the builds of their kernels, from
    the card."""
    info = _tiles_info()
    keys = ("registers", "local_bytes", "shared_bytes", "threads",
            "blocks_an_sm")
    return dict(tile_entries=info[0], staged_cells=info[1], **{
        name: dict(zip(keys, info[2 + 5 * i:7 + 5 * i]))
        for i, name in enumerate(_TILE_KERNELS)})


def _tile_scratch(n: int, k1: int, k2: int, device):
    """K27's, K29's and K30's scratch: a spill (int64 cell, int32 value)
    and a sum a primary tile, a sum a side tile -> (tensor, its bytes)."""
    tile = _tiles_info()[0]
    tp, ts = max(1, -(-k1 // tile)), -(-k2 // tile)
    nbytes = n * tp * 16 + n * ts * 4
    return torch.empty(-(-nbytes // 8), dtype=torch.int64,
                       device=device), nbytes


def gap8_restore(g, v, ci, cv, bh: int, bw: int):
    """K29 (see the module doc); the plain version for CPU tensors."""
    if g.device.type == "cpu":
        return gap8_restore_plain(g, v, ci, cv, bh, bw)
    _check("K29", (g, torch.uint8), (v, torch.int8), (ci, torch.int32),
           (cv, torch.int16))
    if g.dim() != 2 or v.shape != g.shape or ci.shape != cv.shape:
        raise ValueError("K29 takes (N, k) gaps and values and (kc,) "
                         "corrections")
    g, v, ci, cv = (t.contiguous() for t in (g, v, ci, cv))
    n, k = g.shape
    out = torch.empty((n, bh, bw, 64), dtype=torch.int32, device=g.device)
    scratch, nbytes = _tile_scratch(n, k, 0, g.device)
    KERNELS["coef_gap8_restore"](ptr(g), ptr(v), n, k, bh * bw * 64, ptr(ci),
                                 ptr(cv), ci.numel(), ptr(out), ptr(scratch),
                                 nbytes, stream_of(g))
    return out


def gap4_restore(prim, sg, sv, ci, cv, bh: int, bw: int):
    """K30 (see the module doc); the plain version for CPU tensors."""
    if prim.device.type == "cpu":
        return gap4_restore_plain(prim, sg, sv, ci, cv, bh, bw)
    _check("K30", (prim, torch.uint8), (sg, torch.uint8), (sv, torch.int8),
           (ci, torch.int32), (cv, torch.int16))
    if prim.dim() != 2 or sg.dim() != 2 or sv.shape != sg.shape or \
            sg.shape[0] != prim.shape[0] or ci.shape != cv.shape:
        raise ValueError("K30 takes (N, k1) primary, (N, k2) side streams "
                         "and (kc,) corrections")
    prim, sg, sv, ci, cv = (t.contiguous() for t in (prim, sg, sv, ci, cv))
    n, k1 = prim.shape
    k2 = sg.shape[1]
    out = torch.empty((n, bh, bw, 64), dtype=torch.int32, device=prim.device)
    scratch, nbytes = _tile_scratch(n, k1, k2, prim.device)
    KERNELS["coef_gap4_restore"](ptr(prim), ptr(sg), ptr(sv), n, k1, k2,
                                 bh * bw * 64, ptr(ci), ptr(cv), ci.numel(),
                                 ptr(out), ptr(scratch), nbytes,
                                 stream_of(prim))
    return out


# -- the coalesced wires ---------------------------------------------------------

def _qtabs(sec, nb: int, ncomp: int):
    """The wire's uint16 qtables section -> per component (nb, 1, 1, 64)
    int32, widened in one pass."""
    q = (sec.view(torch.int16).to(torch.int32) & 0xFFFF).view(
        ncomp, nb, 1, 1, 64)
    return q.unbind(0)


def _split(buf, sizes):
    if sum(sizes) != buf.numel():
        raise ValueError(f"wire holds {buf.numel()} bytes, layout "
                         f"{sum(sizes)}")
    return buf.split(sizes)


def unpack_gap8(buf, gap8_ks, ncomp: int):
    """The gap8 wire (`stack_bucket`'s, on its device) -> ([per component
    (g (nb, k) u8, v (nb, k) i8, ci (kc,) i32, cv (kc,) i16)], qtabs):
    views of the one upload, cut by one `split` (each view a tensor op
    costs the host microseconds), the qtables widened in one pass."""
    nb, ks = gap8_ks
    sizes = []
    for k, kc in ks[:ncomp]:
        sizes += [nb * k, nb * k, 4 * kc, 2 * kc]
    sizes.append(2 * 64 * nb * ncomp)
    sec = _split(buf, sizes)
    parts = []
    for i, (k, _kc) in enumerate(ks[:ncomp]):
        g, v, ci, cv = sec[4 * i:4 * i + 4]
        parts.append((g.view(nb, k), v.view(torch.int8).view(nb, k),
                      ci.view(torch.int32), cv.view(torch.int16)))
    return parts, _qtabs(sec[-1], nb, ncomp)


def unpack_gap4(buf, gap4_ks, ncomp: int):
    """The gap4 wire (`stack_gap4_wire`'s, on its device) -> ([per
    component (prim (nb, k1) u8, sg (nb, k2) u8, sv (nb, k2) i8, ci (kc,)
    i32, cv (kc,) i16)], qtabs): views of the one upload, cut by one
    `split` (each view a tensor op costs the host microseconds), the
    qtables widened in one pass."""
    nb, ks = gap4_ks
    sizes = []
    for k1, k2, kc in ks[:ncomp]:
        sizes += [nb * k1, nb * k2, nb * k2, 4 * kc, 2 * kc]
    sizes.append(2 * 64 * nb * ncomp)
    sec = _split(buf, sizes)
    parts = []
    for i, (k1, k2, _kc) in enumerate(ks[:ncomp]):
        prim, sg, sv, ci, cv = sec[5 * i:5 * i + 5]
        parts.append((prim.view(nb, k1), sg.view(nb, k2),
                      sv.view(torch.int8).view(nb, k2), ci.view(torch.int32),
                      cv.view(torch.int16)))
    return parts, _qtabs(sec[-1], nb, ncomp)


def unpack_gap4_wire(buf, gap4_ks, comp_sig):
    """The reference's `unpack_gap4_wire`: the gap4 wire -> (per-component
    (nb, bh, bw, 64) int32 planes through K30, qtabs)."""
    parts, qtabs = unpack_gap4(buf, gap4_ks, len(comp_sig))
    coefs = tuple(gap4_restore(*p, comp_sig[i][0], comp_sig[i][1])
                  for i, p in enumerate(parts))
    return coefs, qtabs
