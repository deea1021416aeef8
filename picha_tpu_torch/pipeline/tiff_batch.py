"""Batched TIFF decode to rgba: host stage on pool threads, LZW and the
sample transforms on the device.

Counterpart of `picha_tpu/pipeline/tiff_batch.py` (`TiffBatchPipeline`).
Per image on pool threads, the host stage (`codecs/tiff_host.py`): the
IFD parse, the reference's layout test and crafted-header caps, the
FillOrder 2 reversal, and the strips: LZW strips are handed on as they
are; deflate, PackBits and uncompressed strips are decompressed into
rows. Per same-signature bucket, one pinned upload carries the strip
table, the LZW segments, the other images' rows and the colormaps;
kernel K15 (`ops/lzw.py`) decodes every LZW strip of the bucket in one
launch into the (N, H, rowbytes) rows, kernel K16
(`ops/tiff_transform.py`) maps the rows to (N, H', W', 4) rgba, and one
readback of K15's statuses raises CodecError for a failed or short
strip. On the CPU every stage runs its plain version.

A layout outside the device graph takes `codecs/image_host.py::
decode_tiff` (Pillow) whole, counted in `fallbacks`; a bucket of only
such images returns them stacked, and a mix raises ValueError as the
reference's mixed signatures do.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..codecs.tiff_host import host_stage
from ..ops.lzw import check_strips, lzw_decode
from ..ops.tiff_transform import tiff_transform
from ..runtime.device import resolve_device, upload
from .png_batch import host_pool


def signature(item) -> tuple:
    return item[0]


class Layout(NamedTuple):
    """Where the parts of a bucket sit in its one upload (byte offsets):
    the (4, K) int64 strip table (segment offset, segment length, output
    offset, cap) at 0, the LZW segments, the rows of the non-LZW images
    (`host_idx`, in that order), the (N, 1 << bits, 3) colormaps."""
    nstrips: int
    segs: int
    rows: int
    host_idx: list
    cmaps: Optional[int]


def pack(items) -> tuple:
    """HostItems of one signature -> (the host buffer, its Layout)."""
    width, height, spp, bits = items[0].sig[:4]
    rb = (width * spp * bits + 7) // 8
    image = height * rb
    segs, table = [], []
    pos = 0
    for i, it in enumerate(items):
        for seg, y0, cap in it.strips:
            table.append((pos, len(seg), i * image + y0 * rb, cap))
            segs.append(np.frombuffer(seg, np.uint8))
            pos += len(seg)
    k = len(table)
    tab = np.asarray(table, np.int64).reshape(k, 4).T.copy()
    host_idx = [i for i, it in enumerate(items) if it.rows is not None]
    chunks = [tab.view(np.uint8).reshape(-1), *segs,
              *(items[i].rows.reshape(-1) for i in host_idx)]
    cmaps = None
    if items[0].cmap is not None:
        cmaps = tab.nbytes + pos + len(host_idx) * image
        chunks.append(np.stack([it.cmap for it in items]).reshape(-1))
    layout = Layout(k, tab.nbytes, tab.nbytes + pos, host_idx, cmaps)
    return np.concatenate(chunks), layout


def decode_items(items, device, mark=None) -> torch.Tensor:
    """HostItems of one signature -> (N, H', W', 4) uint8 rgba on
    `device`: one upload, K15 over every LZW strip, K16, one readback
    of the strip statuses. `mark(stage)`, when given, is called after
    each stage ("pack", "upload", "lzw", "transform", "status"), for a
    caller that times them."""
    mark = mark or (lambda _stage: None)
    sig = items[0].sig
    width, height, spp, bits = sig[:4]
    rb = (width * spp * bits + 7) // 8
    n = len(items)
    host, lay = pack(items)
    mark("pack")
    buf = upload(host, device)
    mark("upload")
    m = len(lay.host_idx)
    block = buf[lay.rows:lay.rows + m * height * rb].view(m, height, rb)
    if m == n:
        rows = block
    else:
        rows = torch.empty((n, height, rb), dtype=torch.uint8,
                           device=buf.device)
        if m:
            rows[torch.as_tensor(lay.host_idx, device=buf.device)] = block
    got = status = table = None
    if lay.nstrips:
        table = buf[:lay.segs].view(torch.int64).view(4, lay.nstrips)
        got, status = lzw_decode(buf[lay.segs:lay.rows], table[0], table[1],
                                 rows, table[2], table[3])
    mark("lzw")
    cmaps = None
    if lay.cmaps is not None:
        cmaps = buf[lay.cmaps:].view(n, 1 << bits, 3)
    out = tiff_transform(rows, sig, cmaps)
    mark("transform")
    if lay.nstrips:
        check_strips(got, status, table[3])
    mark("status")
    return out


class TiffBatchPipeline:
    """Batched TIFF decode to rgba, the device stages per bucket (see
    the module doc).

    >>> out = TiffBatchPipeline()(bufs)   # (N, H, W, 4) uint8 tensor
    """

    def __init__(self, index: int = 0, num_threads: Optional[int] = None,
                 device="cuda"):
        self.index = index
        self.device = resolve_device(device)
        self.fallbacks = 0
        self._pool = host_pool(num_threads or 8)

    def host_stage(self, bufs: Sequence[bytes]) -> list:
        return list(self._pool.map(lambda b: host_stage(b, self.index),
                                   bufs))

    def __call__(self, bufs: Sequence[bytes]) -> torch.Tensor:
        items = self.host_stage(bufs)
        if len({signature(it) for it in items}) != 1:
            raise ValueError(
                "mixed-signature batch; group by tiff_batch.signature first")
        if signature(items[0]) == "fallback":
            from ..codecs.image_host import decode_tiff

            self.fallbacks += len(items)
            arrs = self._pool.map(lambda b: decode_tiff(
                b, {"index": self.index}, device=self.device).to_array(),
                bufs)
            return upload(np.stack(list(arrs)), self.device)
        return decode_items(items, self.device)
