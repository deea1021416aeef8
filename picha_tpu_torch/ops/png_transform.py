"""PNG spec transforms, decoded samples -> the target pixel format:
kernel K14.

Counterpart of `picha_tpu/pipeline/png_batch.py::_jit_transform`
(:38-96): the palette take from per-image 256-entry zero-padded tables
(an index past the PLTE gives black) and the tRNS alpha take (255 past
the tRNS), sub-byte grey scaled by 255 // maxv, grey -> rgb by
replication, rgb -> grey as (6968 r + 23434 g + 2366 b + 16384) >> 15 in
uint32, alpha synthesised at maxval, uint16 out for a deep target, else
the 16 -> 8 high-byte chop. The reference flattens the per-image tables
and offsets the indices (:140-148); here the tables are (N, 256, 3) and
(N, 256) and each pixel reads its own image's.

The samples come as bytes: (N, H, W, C * bps) uint8, bps 2 (big-endian,
as PNG stores them) at depth 16, else 1 with sub-byte samples unpacked.

  `png_transform_plain`  the torch version
  `png_transform`        K14 (`csrc/png_transform.cu`) for CUDA tensors,
                         the plain version for CPU tensors
  `kernel_info`          the build of the K14 kernel a signature launches
"""
from __future__ import annotations

import torch

from ..codecs.png_decode import _CHANNELS as CHANNELS
from ..codecs.png_decode import _GREY_B, _GREY_G, _GREY_R
from ..kernels._build import KERNELS, ptr, require_cuda, stream_of
from ..pixels import pixel_format


def _validate(samples, color_type, depth, pal):
    if samples.dim() != 4 or samples.dtype != torch.uint8:
        raise ValueError("png_transform expects (N, H, W, C*bps) uint8")
    if color_type not in CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"bad PNG colour type {color_type} / depth {depth}")
    if samples.shape[-1] != CHANNELS[color_type] * (2 if depth == 16 else 1):
        raise ValueError(f"{samples.shape[-1]} sample bytes for colour type "
                         f"{color_type} at depth {depth}")
    if color_type == 3 and pal is None:
        raise ValueError("a palette batch needs its (N, 256, 3) tables")


def png_transform_plain(samples, color_type: int, depth: int, target: str,
                        pal=None, trns=None):
    """(N, H, W, C*bps) uint8 sample bytes -> (N, H, W, C') uint8 (uint16
    for a deep target) pixels of `target`."""
    _validate(samples, color_type, depth, pal)
    fmt = pixel_format(target)
    x = samples.to(torch.int64)
    if depth == 16:
        x = (x[..., 0::2] << 8) | x[..., 1::2]
    alpha = None
    if color_type == 3:
        img = torch.arange(x.shape[0], device=x.device)[:, None, None]
        idx = x[..., 0]
        color = pal.to(torch.int64)[img, idx]
        if trns is not None:
            alpha = trns.to(torch.int64)[img, idx]
        depth = 8
    else:
        if color_type == 0 and depth < 8:
            x = (x * (255 // ((1 << depth) - 1))) & 0xFF
            depth = 8
        if color_type in (4, 6):
            alpha, color = x[..., -1], x[..., :-1]
        else:
            color = x
    maxval = 65535 if depth == 16 else 255
    if fmt.is_color and color.shape[-1] == 1:
        color = color.expand(*color.shape[:-1], 3)
    elif not fmt.is_color and color.shape[-1] == 3:
        r, g, b = color.unbind(-1)
        color = ((_GREY_R * r + _GREY_G * g + _GREY_B * b + 16384)
                 >> 15)[..., None]
    if fmt.has_alpha:
        if alpha is None:
            alpha = torch.full(color.shape[:-1], maxval, dtype=torch.int64,
                               device=x.device)
        out = torch.cat([color, alpha[..., None]], dim=-1)
    else:
        out = color
    if fmt.is_deep:
        return out.to(torch.int32).to(torch.uint16)
    if depth == 16:
        out = out >> 8
    return out.to(torch.uint8)


def png_transform(samples, color_type: int, depth: int, target: str,
                  pal=None, trns=None):
    """(N, H, W, C*bps) uint8 sample bytes -> `target` pixels on the same
    device; `pal` (N, 256, 3) and `trns` (N, 256) uint8 for a palette
    batch (`trns` None: no tRNS in the batch). Launches K14 for CUDA
    tensors; the plain version runs only for CPU tensors."""
    color_type, depth = int(color_type), int(depth)
    if samples.device.type == "cpu":
        return png_transform_plain(samples, color_type, depth, target, pal,
                                   trns)
    require_cuda(samples, "K14")
    _validate(samples, color_type, depth, pal)
    fmt = pixel_format(target)
    n, h, w, _ = samples.shape
    tables = [t for t in (pal, trns) if t is not None]
    if any(t.device != samples.device or t.dtype != torch.uint8
           for t in tables):
        raise TypeError("K14's tables are uint8 on the samples' device")
    if pal is not None and tuple(pal.shape) != (n, 256, 3) or \
            trns is not None and tuple(trns.shape) != (n, 256):
        raise ValueError("K14 takes (N, 256, 3) palettes and (N, 256) tRNS")
    samples = samples.contiguous()
    pal = None if pal is None else pal.contiguous()
    trns = None if trns is None else trns.contiguous()
    out = torch.empty((n, h, w, fmt.channels),
                      dtype=torch.uint16 if fmt.is_deep else torch.uint8,
                      device=samples.device)
    KERNELS["png_transform"](
        ptr(samples), n, h, w, color_type, depth,
        None if pal is None else ptr(pal),
        None if trns is None else ptr(trns),
        int(fmt.is_color), int(fmt.has_alpha), int(fmt.is_deep), ptr(out),
        stream_of(samples))
    return out


_INFO = ("registers", "local_bytes", "shared_bytes", "threads",
         "blocks_per_sm", "group_px")


def kernel_info(color_type: int, depth: int, target: str) -> dict:
    """The build of the K14 kernel that (colour type, depth) -> `target`
    launches, as the card reports it: registers and local (spill) bytes a
    thread, shared bytes and threads a block, resident blocks a
    multiprocessor, and the pixels a thread converts at a time. Launches
    nothing and counts no launch."""
    import ctypes

    from ..kernels._build import library

    fmt = pixel_format(target)
    vals = (ctypes.c_int * 6)()
    rc = library().picha_png_transform_info(
        int(color_type), int(depth), int(fmt.is_color), int(fmt.has_alpha),
        int(fmt.is_deep), vals)
    if rc != 0:
        raise RuntimeError(f"picha_png_transform_info: CUDA error {rc}")
    return dict(zip(_INFO, vals))
