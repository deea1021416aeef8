"""JPEG decode and encode on the host, through Pillow's libjpeg.

The port's counterpart of the JPEG entry points of `picha_tpu/native`
(`jpeg_decode`, `jpeg_encode`), which the port cannot use: that library
is built from C++ sources with cmake at first use and needs a system
libjpeg. The port's host fallbacks (files the device decoder does not
take, a decoder flag, the encode-overflow clone) go through here.

  `decode_rgb(buf)`       -> (H, W, 3) uint8, or (H, W, 1) for grey, as
                             libjpeg decodes it; CMYK/YCCK files are
                             folded to RGB as the reference folds them
                             (rgb = c * k // 255 on Adobe-inverted
                             samples)
  `encode(img, quality)`  -> baseline JPEG bytes, 4:2:0 for colour,
                             with libjpeg's quality scaling (the same
                             bytes as `picha_tpu/native`'s encoder)
"""
from __future__ import annotations

import io

import numpy as np


def decode_rgb(buf) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, or (H, W, 1) uint8 grey."""
    from PIL import Image

    im = Image.open(io.BytesIO(bytes(buf)))
    im.load()
    if im.mode == "L":
        return np.asarray(im, dtype=np.uint8)[..., None]
    if im.mode == "CMYK":
        # Pillow reads Adobe CMYK inverted ("CMYK;I"): undo that to get
        # libjpeg's samples, then the reference's fold
        raw = 255 - np.asarray(im, dtype=np.int32)
        rgb = raw[..., :3] * raw[..., 3:] // 255
        return rgb.astype(np.uint8)
    return np.asarray(im.convert("RGB"), dtype=np.uint8)


def encode(img: np.ndarray, quality: int) -> bytes:
    """(H, W, 3) or (H, W, 1) uint8 -> baseline JPEG bytes at `quality`
    (4:2:0 for colour)."""
    from PIL import Image

    img = np.ascontiguousarray(img, dtype=np.uint8)
    kw = {"subsampling": 2}
    if img.ndim == 3 and img.shape[2] == 1:
        img, kw = img[..., 0], {}   # grey: one 1x1 component
    out = io.BytesIO()
    Image.fromarray(img).save(out, "JPEG", quality=int(quality), **kw)
    return out.getvalue()
