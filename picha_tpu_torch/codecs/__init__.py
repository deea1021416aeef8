"""Host codecs of the port (counterpart of picha_tpu/codecs/, the JPEG
entry points of picha_tpu/native, and picha_tpu/catalog.py).

`CODECS` maps a mimetype to its codec, in the reference catalog's order
(jpeg, png, tiff, webp); `sniff` finds a codec by the file's magic bytes;
`decode_sync` decodes any of them to an Image.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

from ..errors import InvalidOptionsError, UnsupportedFormatError
from ..image import Image
from . import image_host, jpeg_host, jpeg_markers


class Codec(NamedTuple):
    mimetype: str
    decode_sync: Callable   # (buf, opts, device=) -> Image
    encode_sync: Callable   # (Image, opts) -> bytes


def _decode_jpeg(buf, opts=None, device=None) -> Image:
    """The reference's host JPEG decode (`picha_tpu/codecs/jpeg.py`):
    `autoOrient` turns the pixels by the EXIF orientation, `scaleDenom`
    (1, 2, 4, 8) is libjpeg's scaled decode, `pixel` ("rgb" / "grey")
    libjpeg's own colour conversion. All of it runs on the host:
    `device` is ignored."""
    opts = opts or {}
    if opts.get("autoOrient", opts.get("auto_orient", False)):
        orient = jpeg_markers.exif_orientation(bytes(buf)) or 1
        if orient != 1:
            img = _decode_jpeg(buf, {
                k: v for k, v in opts.items()
                if k not in ("autoOrient", "auto_orient")})
            arr = np.ascontiguousarray(image_host._orient(img.to_array(),
                                                          orient))
            return Image.from_array(arr, img.pixel)
    try:
        denom = int(opts.get("scaleDenom", opts.get("scale_denom", 1)))
    except (TypeError, ValueError) as e:
        raise InvalidOptionsError("scaleDenom must be 1, 2, 4 or 8") from e
    if denom not in (1, 2, 4, 8):
        raise InvalidOptionsError("scaleDenom must be 1, 2, 4 or 8")
    req = opts.get("pixel")
    if req is not None and req not in ("rgb", "grey"):
        raise InvalidOptionsError("jpeg decode supports pixel rgb/grey")
    channels = None if req is None else (1 if req == "grey" else 3)
    arr = jpeg_host.decode_rgb(buf, channels, denom)
    return Image.from_array(arr, "grey" if arr.shape[-1] == 1 else "rgb")


def _encode_jpeg(img: Image, opts=None) -> bytes:
    """The reference's host JPEG encode options: `quality` (0-100,
    clamped), `restartInterval` (MCUs, >= 0), `progressive`, `optimize`,
    `subsample` (4:2:0 when true, the default; else 4:4:4)."""
    opts = opts or {}
    if img.pixel not in ("rgb", "grey"):
        raise InvalidOptionsError(
            f"jpeg encode supports rgb/grey, got {img.pixel}")
    try:
        quality = int(opts.get("quality", 85))
        restart = int(opts.get("restartInterval",
                               opts.get("restart_interval", 0)))
    except (TypeError, ValueError) as e:
        raise InvalidOptionsError("invalid jpeg encode options") from e
    if restart < 0:
        raise InvalidOptionsError("restartInterval must be >= 0")
    return jpeg_host.encode(img.to_array(), max(0, min(100, quality)),
                            restart=restart,
                            progressive=bool(opts.get("progressive", False)),
                            optimize=bool(opts.get("optimize", False)),
                            subsample=bool(opts.get("subsample", True)))


CODECS = {c.mimetype: c for c in (
    Codec("image/jpeg", _decode_jpeg, _encode_jpeg),
    Codec("image/png", image_host.decode_png, image_host.encode_png),
    Codec("image/tiff", image_host.decode_tiff, image_host.encode_tiff),
    Codec("image/webp", image_host.decode_webp, image_host.encode_webp),
)}


def sniff(buf) -> str:
    """The mimetype of a file by its magic bytes; raises
    UnsupportedFormatError when no codec recognises it."""
    head = bytes(memoryview(buf)[:16])
    if head[:3] == b"\xff\xd8\xff":
        return "image/jpeg"
    if head[:8] == b"\x89PNG\r\n\x1a\n":
        return "image/png"
    if head[:4] in (b"II*\x00", b"MM\x00*"):
        return "image/tiff"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "image/webp"
    raise UnsupportedFormatError("unsupported image file")


def decode_sync(buf, opts=None, mimetype=None, device="cuda") -> Image:
    """Decode a file of any supported format (sniffed unless `mimetype`
    names its codec). A codec whose decode has device stages (the PNG
    and TIFF decodes through the port's own kernels) runs them on
    `device`; the others ignore it."""
    codec = CODECS[mimetype or sniff(buf)]
    return codec.decode_sync(buf, opts or {}, device=device)
