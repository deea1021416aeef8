"""JPEG decode and encode on the host, through Pillow's libjpeg.

The port's counterpart of the JPEG entry points of `picha_tpu/native`
(`jpeg_decode`, `jpeg_encode`), which the port cannot use: that library
is built from C++ sources with cmake at first use and needs a system
libjpeg. The port's host fallbacks (files the device decoder does not
take, a decoder flag, the encode-overflow clone) go through here.

  `decode_rgb(buf, channels, scale_denom)`
                          -> (H, W, 3) uint8, or (H, W, 1) for grey, as
                             libjpeg decodes it; CMYK/YCCK files are
                             folded to RGB as the reference folds them
                             (rgb = c * k // 255 on Adobe-inverted
                             samples); `channels` 1 asks libjpeg's own
                             grey output, 3 RGB; `scale_denom` 2/4/8 is
                             libjpeg's scaled decode to ceil(W/d) x
                             ceil(H/d), both through Pillow's `draft`
  `encode(img, quality, ...)`
                          -> JPEG bytes at `quality` with libjpeg's
                             quality scaling (the same bytes as
                             `picha_tpu/native`'s encoder), 4:2:0 for
                             colour unless `subsample` is False (4:4:4);
                             `restart` (MCUs between RST markers),
                             `progressive` (libjpeg's simple progression)
                             and `optimize` (optimal Huffman tables) as
                             the reference's encoder sets them
"""
from __future__ import annotations

import io

import numpy as np

from ..errors import CodecError

_ITEM_11 = "ROADMAP.md queue 1 item 11"


def decode_rgb(buf, channels=None, scale_denom: int = 1) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, or (H, W, 1) uint8 grey (a
    one-component file, or `channels` 1). `scale_denom` 2, 4 or 8 decodes
    at ceil(W/d) x ceil(H/d) with libjpeg's scaled IDCT."""
    from PIL import Image

    im = Image.open(io.BytesIO(bytes(buf)))
    if channels == 1 and im.mode == "CMYK":
        raise CodecError("libjpeg has no CMYK -> grey conversion")
    if channels == 1 or scale_denom > 1:
        w, h = im.size
        d = scale_denom
        if w < d or h < d:
            raise NotImplementedError(
                f"scaleDenom {d} of a {w}x{h} JPEG (Pillow's draft cannot "
                f"scale below 1 pixel) is not ported: {_ITEM_11}")
        im.draft("L" if channels == 1 else None,
                 (w // d, h // d) if d > 1 else None)
        if im.size != (-(-w // d), -(-h // d)):
            raise NotImplementedError(
                f"Pillow's draft gave {im.size} for scaleDenom {d} of a "
                f"{w}x{h} JPEG: {_ITEM_11}")
    im.load()
    if im.mode == "L":
        grey = np.asarray(im, dtype=np.uint8)[..., None]
        return np.repeat(grey, 3, axis=-1) if channels == 3 else grey
    if channels == 1:
        raise NotImplementedError(
            f"libjpeg's grey output from a {im.mode} JPEG through Pillow: "
            f"{_ITEM_11}")
    if im.mode == "CMYK":
        # Pillow reads Adobe CMYK inverted ("CMYK;I"): undo that to get
        # libjpeg's samples, then the reference's fold
        raw = 255 - np.asarray(im, dtype=np.int32)
        rgb = raw[..., :3] * raw[..., 3:] // 255
        return rgb.astype(np.uint8)
    return np.asarray(im.convert("RGB"), dtype=np.uint8)


def encode(img: np.ndarray, quality: int, restart: int = 0,
           progressive: bool = False, optimize: bool = False,
           subsample: bool = True) -> bytes:
    """(H, W, 3) or (H, W, 1) uint8 -> JPEG bytes at `quality` (4:2:0
    for colour, 4:4:4 with `subsample` False; a grey image is one 1x1
    component)."""
    from PIL import Image

    img = np.ascontiguousarray(img, dtype=np.uint8)
    kw = {"subsampling": 2 if subsample else 0}
    if img.ndim == 3 and img.shape[2] == 1:
        img, kw = img[..., 0], {}
    if restart > 0:
        kw["restart_marker_blocks"] = int(restart)
    out = io.BytesIO()
    Image.fromarray(img).save(out, "JPEG", quality=int(quality),
                              progressive=bool(progressive),
                              optimize=bool(optimize), **kw)
    return out.getvalue()
