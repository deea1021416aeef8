"""Batched PNG encode with the filter pass on the device, and batched
PNG decode with the unfilter and the spec transforms on the device.

Counterpart of `picha_tpu/pipeline/png_batch.py`.

Encode (`encode_filtered`): the candidate filter streams of every image
of an (N, H, W, C) uint8 or uint16 batch come from kernel K12
(`ops/png_filter.py`; 16-bit samples as their big-endian bytes, bpp =
2 x channels) in one tensor, which is read back once; then the host runs
the probe's pick (`codecs/png_host.py::probe_pick`, the one selection
rule the single-image encode shares), deflate (`deflateThreads` > 1:
`png_host.deflate_parallel`) and chunk assembly per image on pool
threads (zlib releases the GIL). One K12 launch writes every candidate
stream: three with the default probe (up, sub, adaptive), one with a
fixed strategy or an image too small to probe.

Decode (`PngBatchPipeline`): per image on pool threads, the host stage
(`host_stage`: chunks, header, PLTE and tRNS, zlib inflate); then per
same-signature bucket one pinned upload of the filtered streams (and the
palette tables), kernel K13 (`ops/png_unfilter.py`: the unfilter, once
per Adam7 pass), the sub-byte unpack (a torch shift-and-mask; depth 8
and 16 are views of the unfiltered bytes), kernel K14
(`ops/png_transform.py`: the reference's `_jit_transform`), and one
readback of the unfilter statuses. Colour-key tRNS batches take the
per-image `_to_target` on the host, as the reference does.
"""
from __future__ import annotations

import os
import threading
import zlib
from concurrent.futures import Executor, ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from ..codecs import png_decode as P
from ..codecs.png_host import (COLOR_TYPE_OF, PROBE_ORDER, deflate_parallel,
                               png_file, probe_applies, probe_pick)
from ..errors import CodecError
from ..ops.png_filter import filter_streams
from ..ops.png_transform import png_transform
from ..ops.png_unfilter import check_status, png_unfilter
from ..runtime.device import resolve_device, to_device, upload

_pool_lock = threading.Lock()
_pools: dict = {}


def host_pool(workers: int) -> ThreadPoolExecutor:
    """The process's pool of `workers` threads for the per-image host
    stages (deflate, inflate, TIFF strips): one pool per size, shared by
    every pipeline that asks for that size and never shut down."""
    with _pool_lock:
        if workers not in _pools:
            _pools[workers] = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="picha-host")
        return _pools[workers]


def deflate_pool() -> ThreadPoolExecutor:
    """The shared pool of the per-image deflate and assembly."""
    return host_pool(min(8, os.cpu_count() or 1))


def sample_rows(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) uint8 or uint16 pixels -> (N, H, W*C*bps) uint8 rows
    as PNG stores them (16-bit samples big-endian)."""
    n, h, w, ch = x.shape
    if x.dtype == torch.uint8:
        return x.reshape(n, h, w * ch)
    v = x.to(torch.int32)
    return torch.stack([v >> 8, v & 0xFF], dim=-1).to(torch.uint8).reshape(
        n, h, w * ch * 2)


def filter_candidates(x: torch.Tensor, strategy=None):
    """(N, H, W, C) uint8 / uint16 pixels on their device -> (strategies,
    (len(strategies), N, H, W*C*bps+1) uint8 filtered rows on that
    device): PROBE_ORDER when the default probe applies, else the one
    strategy (-1 for the default on a small image)."""
    if x.dim() != 4 or x.dtype not in (torch.uint8, torch.uint16):
        raise ValueError("encode_filtered expects (N, H, W, C) uint8 or "
                         "uint16")
    n, h, w, ch = x.shape
    if ch not in COLOR_TYPE_OF:
        raise ValueError(f"encode_filtered takes 1-4 channels, not {ch}")
    bps = 2 if x.dtype == torch.uint16 else 1
    rows = sample_rows(x)
    rb = w * ch * bps
    if strategy is None and probe_applies(h, rb):
        strategies = PROBE_ORDER
    else:
        strategies = (-1 if strategy is None else int(strategy),)
    return strategies, filter_streams(rows, ch * bps, strategies)


def assemble(cands: np.ndarray, width: int, channels: int, level: int,
             pool: Optional[Executor] = None, depth: int = 8,
             threads: Optional[int] = None) -> list:
    """Host (K, N, H, RB+1) filtered candidates -> N PNG files: the
    probe's pick when K > 1, deflate at `level` (`threads` > 1: the
    parallel deflate, as the reference's `deflateThreads`), chunks."""
    k, n, h = cands.shape[:3]
    color_type = COLOR_TYPE_OF[channels]

    def one(i):
        pick = probe_pick([cands[j, i] for j in range(k)], h) if k > 1 else 0
        if threads is not None and threads > 1:
            idat = deflate_parallel(cands[pick, i].reshape(-1),
                                    6 if level == -1 else level, threads)
        else:
            idat = zlib.compress(cands[pick, i].tobytes(), level)
        return png_file(width, h, depth, color_type, idat)

    return list((pool or deflate_pool()).map(one, range(n)))


def encode_filtered(batch, level: int = 4, strategy=None, device="cuda",
                    pool: Optional[Executor] = None,
                    threads: Optional[int] = None) -> list:
    """Batched PNG encode of an (N, H, W, C) uint8 or uint16 batch
    (numpy, or a tensor) with the filter on `device`: N PNG files, 8- or
    16-bit by the dtype. strategy None is the codec's default (the probe
    over up / sub / adaptive); an int -1..4 pins one strategy; `threads`
    is the reference's `deflateThreads`."""
    x = to_device(batch, resolve_device(device))
    _strategies, out = filter_candidates(x, strategy)
    cands = out.cpu().numpy()
    return assemble(cands, x.shape[2], x.shape[3], level, pool,
                    16 if x.dtype == torch.uint16 else 8, threads)


# -- decode -------------------------------------------------------------------

def host_stage(buf):
    """bytes -> (header, inflated filtered stream (uint8 array, cut to
    the header's size), palette (k, 3) or None, tRNS bytes or None):
    the serial host part of the decode, on a pool thread."""
    buf = bytes(buf)
    h = P._parse_header(buf)
    raw, palette, trns = P.inflate(buf, h)
    n = P.need(h)
    if raw.size < n:
        raise CodecError("PNG pixel data truncated")
    return h, raw[:n], palette, trns


def signature(h) -> tuple:
    return (h.width, h.height, h.bit_depth, h.color_type)


def pack(parts) -> tuple:
    """The bucket's host buffer for its one upload: the filtered streams
    back to back, plain images first, then the Adam7 ones (each group
    one (n, stream) block), then the (N, 256, 3) palettes and (N, 256)
    tRNS alphas of a palette bucket. Returns (buffer, groups, tables):
    groups [(image indices, interlace, offset, stream bytes)], tables
    (palette offset, tRNS offset or None) or None."""
    h0 = parts[0][0]
    groups, chunks, off = [], [], 0
    for lace in (0, 1):
        idx = [i for i, p in enumerate(parts) if p[0].interlace == lace]
        if idx:
            size = parts[idx[0]][1].size
            groups.append((idx, lace, off, size))
            chunks += [parts[i][1] for i in idx]
            off += size * len(idx)
    tables = None
    if h0.color_type == P.CT_PALETTE:
        n = len(parts)
        pal = np.zeros((n, 256, 3), np.uint8)
        ta = np.full((n, 256), 255, np.uint8)
        has_trns = any(t is not None for *_x, t in parts)
        for i, (_h, _r, p, t) in enumerate(parts):
            if p is None:
                raise CodecError("palette PNG missing PLTE")
            # crafted files can carry > 256 PLTE entries / tRNS bytes:
            # clamp
            pal[i, : min(256, p.shape[0])] = p[:256]
            if t is not None:
                tv = np.frombuffer(t, np.uint8)[:256]
                ta[i, : tv.size] = tv
        chunks.append(pal.reshape(-1))
        tables = (off, off + pal.size if has_trns else None)
        if has_trns:
            chunks.append(ta.reshape(-1))
    return np.concatenate(chunks), groups, tables


def unpack_samples(plane: torch.Tensor, pw: int, ch: int,
                   depth: int) -> torch.Tensor:
    """(N, ph, rowbytes) unfiltered bytes -> (N, ph, pw, ch * bps) uint8
    sample bytes: a view at depth 8 and 16, sub-byte samples unpacked
    MSB-first (shift and mask)."""
    n, ph, rb = plane.shape
    if depth >= 8:
        return plane[:, :, :pw * ch * depth // 8].reshape(
            n, ph, pw, ch * depth // 8)
    per = 8 // depth
    shifts = torch.arange(per - 1, -1, -1, dtype=torch.int32,
                          device=plane.device) * depth
    ex = (plane[..., None].to(torch.int32) >> shifts) & ((1 << depth) - 1)
    return ex.reshape(n, ph, rb * per)[:, :, :pw * ch].to(
        torch.uint8).reshape(n, ph, pw, ch)


def unfilter_groups(buf: torch.Tensor, parts, groups) -> tuple:
    """The uploaded streams -> ((N, H, W, C*bps) uint8 sample bytes,
    [unfilter statuses]): K13 once per group and (Adam7) pass."""
    h0 = parts[0][0]
    ch = P._CHANNELS[h0.color_type]
    bpp = max(1, (ch * h0.bit_depth) // 8)
    bps = 2 if h0.bit_depth == 16 else 1
    n = len(parts)
    statuses = []
    if len(groups) == 1 and not groups[0][1] and h0.bit_depth >= 8:
        idx, _lace, off, size = groups[0]
        rows = buf[off:off + size * n].view(n, h0.height, -1)
        plane, status = png_unfilter(rows, bpp)
        return unpack_samples(plane, h0.width, ch, h0.bit_depth), [status]
    samples = torch.zeros((n, h0.height, h0.width, ch * bps),
                          dtype=torch.uint8, device=buf.device)
    for idx, lace, off, size in groups:
        block = buf[off:off + size * len(idx)].view(len(idx), size)
        at = torch.as_tensor(idx, device=buf.device)
        pos = 0
        for (x0, y0, dx, dy, pw, ph, rb) in P.passes(parts[idx[0]][0]):
            rows = block[:, pos:pos + ph * (rb + 1)].unflatten(1, (ph, rb + 1))
            plane, status = png_unfilter(rows, bpp)
            statuses.append(status)
            pos += ph * (rb + 1)
            samples[at, y0::dy, x0::dx] = unpack_samples(plane, pw, ch,
                                                         h0.bit_depth)
    return samples, statuses


def decode_parts(parts, pixel, deep: bool, device,
                 mark=None) -> torch.Tensor:
    """Host-stage results of one bucket -> (N, H, W, C) pixels of the
    resolved target on `device` (uint16 for a deep target). `mark(stage)`,
    when given, is called after each stage ("pack", "upload",
    "unfilter", "transform", "status"), for a caller that times them."""
    if len({signature(p[0]) for p in parts}) != 1:
        raise ValueError("mixed PNG signatures; bucket inputs first")
    mark = mark or (lambda _stage: None)
    h0 = parts[0][0]
    target = P._resolve_pixel(h0, pixel, deep)
    host, groups, tables = pack(parts)
    mark("pack")
    buf = upload(host, device)
    mark("upload")
    samples, statuses = unfilter_groups(buf, parts, groups)
    mark("unfilter")
    if h0.color_type != P.CT_PALETTE and any(
            t is not None for *_x, t in parts):
        # colour-key tRNS (exact-match alpha) is rare: the exact
        # single-image transform per item on the host, and stack
        check_status(*statuses)
        sb = samples.cpu().numpy()
        if h0.bit_depth == 16:
            sb = (sb[..., 0::2].astype(np.uint16) << 8) | sb[..., 1::2]
        out = np.stack([P._to_target(sb[i], hh, p, t, target)
                        for i, (hh, _r, p, t) in enumerate(parts)])
        return upload(out, device)
    pal = trns = None
    if tables is not None:
        n = len(parts)
        pal = buf[tables[0]:tables[0] + n * 768].view(n, 256, 3)
        if tables[1] is not None:
            trns = buf[tables[1]:tables[1] + n * 256].view(n, 256)
    out = png_transform(samples, h0.color_type, h0.bit_depth, target, pal,
                        trns)
    mark("transform")
    check_status(*statuses)
    mark("status")
    return out


class PngBatchPipeline:
    """Batched PNG decode: the host stage on pool threads, then the
    unfilter (K13) and the spec transforms (K14) on `device` (see the
    module doc); the plain versions on the CPU.

    >>> out = PngBatchPipeline()(png_bytes_list)     # (N, H, W, C)

    `pixel` / `deep` pick the target as the reference's decode does
    (`codecs/png_decode.py::_resolve_pixel`); a batch of several
    signatures raises ValueError.
    """

    def __init__(self, pixel: Optional[str] = None, deep: bool = False,
                 num_threads: int = 8, device="cuda"):
        self.pixel = pixel
        self.deep = deep
        self.device = resolve_device(device)
        self._pool = host_pool(num_threads)

    def host_stage(self, bufs: Sequence[bytes]) -> list:
        return list(self._pool.map(host_stage, bufs))

    def __call__(self, bufs: Sequence[bytes]) -> torch.Tensor:
        return decode_parts(self.host_stage(bufs), self.pixel, self.deep,
                            self.device)
