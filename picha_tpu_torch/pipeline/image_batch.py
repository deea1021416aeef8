"""Generic batched image pipeline (any codec): host decode -> device
crop / resize / convert -> host encode.

Counterpart of `picha_tpu/pipeline/image_batch.py`; BASELINE config 4
("256-image batched decode -> subView crop -> resize -> encodeWebP /
encodeTiff lzw"). Decode runs on pool threads through the port's host
codecs (`codecs/`, Pillow), the pixel work on one device, and the
encode returns to the pool (PNG encodes filter on the device, kernel
K12, before their host deflate).

The device graph is the reference's `_jit_transform` (unpack -> crop ->
resize -> channel map -> pack, or clip with `normalize`): with a resize,
K11 (unpack + crop window, float32 out) -> K8 width pass -> K8 height
pass -> K11 (map + pack, or clip); without one, a single K11 launch. On
the CPU every stage runs its plain version.

Not ported: the reference's `backend="host"` route (crop view + the
native AVX2 resize per image, `_call_host_stream`), which needs
`picha_tpu/native`: it raises NotImplementedError naming ROADMAP.md
queue 1 item 7; `backend="auto"` takes the device.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from ..codecs import CODECS, decode_sync
from ..codecs.image_host import png_options
from ..errors import InvalidImageError
from ..image import Image, _infer_pixel
from ..ops.resize import crop_resize_map, window_tensors
from ..ops.resize_weights import parse_resize_options
from ..pixels import TORCH_DTYPE, pixel_format
from ..runtime.device import resolve_device, to_device
from .png_batch import encode_filtered


class ImageBatchPipeline:
    """decode -> [crop] -> [resize] -> [convert] -> {pixels | encode}.

    crop: (x, y, w, h), the batched analog of Image.sub_view. resize:
    (width, height) with `filter` / `filter_scale` (the reference's
    resize semantics). convert: the destination pixel format. normalize:
    float32 on the 0-1 scale (clipped) instead of packed pixels.
    encode: (mimetype, opts) through the port's codecs on pool threads.
    """

    def __init__(self, crop: Optional[tuple] = None,
                 resize: Optional[tuple] = None,
                 filter: Optional[str] = None,
                 filter_scale: Optional[float] = None,
                 convert: Optional[str] = None,
                 normalize: bool = False,
                 encode: Optional[tuple] = None,
                 num_threads: int = 8,
                 backend: str = "auto",
                 device="cuda"):
        if backend not in ("auto", "host", "device"):
            raise ValueError("backend must be auto/host/device")
        if backend == "host":
            raise NotImplementedError(
                "ImageBatchPipeline(backend='host') (the native host "
                "resize) is not ported to picha_tpu_torch: ROADMAP.md "
                "queue 1 item 7")
        opts = {}
        if filter is not None:
            opts["filter"] = filter
        if filter_scale is not None:
            opts["filterScale"] = filter_scale
        self._filter, self._fscale = parse_resize_options(opts)
        self.crop = crop
        self.resize = resize
        self.convert = convert
        self.normalize = normalize
        self.encode = encode
        self.device = resolve_device(device)
        self._windows = {}
        self._pool = ThreadPoolExecutor(max_workers=num_threads,
                                        thread_name_prefix="picha-batch")

    def _map(self, fn, seq):
        """Pool map on multi-core hosts; serial on one core, where pool
        threads only convoy on the GIL."""
        if (os.cpu_count() or 1) <= 1:
            return [fn(x) for x in seq]
        return list(self._pool.map(fn, seq))

    def _decode_images(self, bufs: Sequence[bytes],
                       opts: Optional[dict] = None,
                       mimetype: Optional[str] = None) -> list:
        """Host decode on pool threads -> list of Images (`mimetype`
        names the codec, else each file is sniffed)."""
        return self._map(lambda b: decode_sync(b, opts, mimetype,
                                               device=self.device), bufs)

    def decode_batch(self, bufs: Sequence[bytes], opts: Optional[dict] = None,
                     mimetype: Optional[str] = None) -> np.ndarray:
        """Host decode; all images must share one shape and pixel format
        (bucket upstream, or use __call__, which buckets)."""
        imgs = self._decode_images(bufs, opts, mimetype)
        if len({(i.width, i.height, i.pixel) for i in imgs}) != 1:
            raise ValueError("mixed shapes/formats; bucket inputs first")
        return np.stack([i.to_array() for i in imgs])

    def _check_crop(self, height: int, width: int) -> None:
        """Reject out-of-bounds crops as Image.sub_view does (slicing
        would clamp, and the resize would stretch the truncated
        region)."""
        if self.crop is None:
            return
        x, y, w, h = self.crop
        if x < 0 or y < 0 or w < 1 or h < 1 or x + w > width \
                or y + h > height:
            raise InvalidImageError(
                f"crop {w}x{h}+{x}+{y} outside {width}x{height}")

    def windows(self, src_h: int, src_w: int):
        """The resize's per-output tap windows for a (cropped) source of
        src_h x src_w, on the device (built once per size)."""
        key = (src_h, src_w)
        if key not in self._windows:
            w, h = self.resize
            self._windows[key] = (
                window_tensors(w, src_w, self._filter, self._fscale,
                               self.device),
                window_tensors(h, src_h, self._filter, self._fscale,
                               self.device))
        return self._windows[key]

    def transform(self, batch) -> torch.Tensor:
        """(N, H, W, C) uint8 / uint16 pixels (numpy, or a tensor) -> the
        op chain's output on the device: K11 -> K8 W -> K8 H -> K11 with
        a resize, one K11 without."""
        self._check_crop(batch.shape[1], batch.shape[2])
        x = to_device(batch, self.device)
        if x.dim() != 4 or x.dtype not in (torch.uint8, torch.uint16):
            raise TypeError("transform takes (N, H, W, C) uint8 or uint16 "
                            "pixels")
        fmt = None if self.convert is None else pixel_format(self.convert)
        channels = x.shape[-1] if fmt is None else fmt.channels
        dtype = (torch.float32 if self.normalize else
                 x.dtype if fmt is None else TORCH_DTYPE[fmt.dtype])
        h, w = (x.shape[1], x.shape[2]) if self.crop is None else \
            (self.crop[3], self.crop[2])
        windows = None if self.resize is None else self.windows(h, w)
        return crop_resize_map(x, windows, channels, dtype, crop=self.crop,
                               clip=self.normalize)

    def encode_batch(self, batch) -> list:
        """Encode every image of an (N, H, W, C) batch (numpy, or a
        tensor) with `encode`: PNG through `encode_filtered` (K12 on the
        device), the other codecs on pool threads."""
        mimetype, opts = self.encode
        codec = CODECS[mimetype]
        if mimetype == "image/png":
            level, strategy, threads = png_options(opts)
            return encode_filtered(batch, level, strategy,
                                   device=self.device, pool=self._pool,
                                   threads=threads)
        if isinstance(batch, torch.Tensor):
            batch = batch.cpu().numpy()
        pixel = _infer_pixel(batch.dtype, batch.shape[-1])
        return self._map(lambda arr: codec.encode_sync(
            Image.from_array(arr, pixel), opts or {}), batch)

    def __call__(self, bufs: Sequence[bytes],
                 decode_opts: Optional[dict] = None,
                 mimetype: Optional[str] = None):
        imgs = self._decode_images(bufs, decode_opts, mimetype)
        if len({(i.width, i.height, i.pixel) for i in imgs}) == 1:
            out = self.transform(np.stack([i.to_array() for i in imgs]))
            return out if self.encode is None else self.encode_batch(out)
        # heterogeneous inputs (a PNG that decodes rgb next to a TIFF
        # that always decodes rgba, mixed dimensions): bucket by (shape,
        # pixel), run each bucket, reassemble in input order
        return self._call_mixed(imgs)

    def _call_mixed(self, imgs):
        buckets: dict = {}
        for i, img in enumerate(imgs):
            buckets.setdefault((img.width, img.height, img.pixel),
                               []).append(i)
        results: list = [None] * len(imgs)
        for idxs in buckets.values():
            out = self.transform(np.stack([imgs[i].to_array() for i in idxs]))
            if self.encode is not None:
                part = self.encode_batch(out)
            else:
                part = out.cpu().numpy()
            for j, i in enumerate(idxs):
                results[i] = part[j]
        if self.encode is not None:
            return results
        if len({r.shape for r in results}) == 1:
            return np.stack(results)
        return results  # ragged outputs stay a list
