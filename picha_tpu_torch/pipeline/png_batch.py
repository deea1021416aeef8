"""Batched PNG encode with the filter pass on the device.

Counterpart of the encode side of `picha_tpu/pipeline/png_batch.py`
(`encode_filtered`): the candidate filter streams of every image of an
(N, H, W, C) uint8 batch come from kernel K12 (`ops/png_filter.py`) in
one tensor, which is read back once; then the host runs the probe's pick
(`codecs/png_host.py::probe_pick`, the one selection rule the
single-image encode shares), deflate and chunk assembly per image on
pool threads (zlib releases the GIL). With the default probe that is
three K12 launches (up, sub, adaptive); with a fixed strategy, or an
image too small to probe, one.

The decode side (`PngBatchPipeline`, host inflate and unfilter, then the
spec transforms on the device) is not ported yet: ROADMAP.md queue 2
row 11c.
"""
from __future__ import annotations

import os
import threading
import zlib
from concurrent.futures import Executor, ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..codecs.png_host import (COLOR_TYPE_OF, PROBE_ORDER, png_file,
                               probe_applies, probe_pick)
from ..ops.png_filter import filter_batch
from ..runtime.device import resolve_device, to_device

_pool_lock = threading.Lock()
_pool: Optional[ThreadPoolExecutor] = None


def deflate_pool() -> ThreadPoolExecutor:
    """The shared pool of the per-image deflate and assembly."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1),
                thread_name_prefix="picha-png")
        return _pool


def filter_candidates(x: torch.Tensor, strategy=None):
    """(N, H, W, C) uint8 pixels on their device -> (strategies,
    (len(strategies), N, H, W*C+1) uint8 filtered rows on that device):
    PROBE_ORDER when the default probe applies, else the one strategy
    (-1 for the default on a small image)."""
    if x.dim() != 4 or x.dtype != torch.uint8:
        raise ValueError("encode_filtered expects (N, H, W, C) uint8")
    n, h, w, ch = x.shape
    if ch not in COLOR_TYPE_OF:
        raise ValueError(f"encode_filtered takes 1-4 channels, not {ch}")
    rows = x.reshape(n, h, w * ch)
    if strategy is None and probe_applies(h, w * ch):
        strategies = PROBE_ORDER
    else:
        strategies = (-1 if strategy is None else int(strategy),)
    out = torch.empty((len(strategies), n, h, w * ch + 1), dtype=torch.uint8,
                      device=x.device)
    for j, s in enumerate(strategies):
        filter_batch(rows, ch, s, out=out[j])
    return strategies, out


def assemble(cands: np.ndarray, width: int, channels: int, level: int,
             pool: Optional[Executor] = None) -> list:
    """Host (K, N, H, RB+1) filtered candidates -> N PNG files: the
    probe's pick when K > 1, deflate at `level`, chunks."""
    k, n, h = cands.shape[:3]
    color_type = COLOR_TYPE_OF[channels]

    def one(i):
        pick = probe_pick([cands[j, i] for j in range(k)], h) if k > 1 else 0
        idat = zlib.compress(cands[pick, i].tobytes(), level)
        return png_file(width, h, 8, color_type, idat)

    return list((pool or deflate_pool()).map(one, range(n)))


def encode_filtered(batch, level: int = 4, strategy=None, device="cuda",
                    pool: Optional[Executor] = None) -> list:
    """Batched PNG encode of an (N, H, W, C) uint8 batch (numpy, or a
    tensor) with the filter on `device`: N PNG files. strategy None is
    the codec's default (the probe over up / sub / adaptive); an int
    -1..4 pins one strategy."""
    x = to_device(batch, resolve_device(device))
    _strategies, out = filter_candidates(x, strategy)
    cands = out.cpu().numpy()
    return assemble(cands, x.shape[2], x.shape[3], level, pool)
