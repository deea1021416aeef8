"""Host codecs of the port (counterpart of picha_tpu/codecs/, the JPEG
entry points of picha_tpu/native, and picha_tpu/catalog.py).

`CODECS` maps a mimetype to its codec, in the reference catalog's order
(jpeg, png, tiff, webp); `sniff` finds a codec by the file's magic bytes;
`decode_sync` decodes any of them to an Image.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from ..errors import InvalidOptionsError, UnsupportedFormatError
from ..image import Image
from . import image_host, jpeg_host


class Codec(NamedTuple):
    mimetype: str
    decode_sync: Callable   # (buf, opts) -> Image
    encode_sync: Callable   # (Image, opts) -> bytes


def _decode_jpeg(buf, opts=None) -> Image:
    arr = jpeg_host.decode_rgb(buf)
    return Image.from_array(arr, "grey" if arr.shape[-1] == 1 else "rgb")


def _encode_jpeg(img: Image, opts=None) -> bytes:
    if img.pixel not in ("rgb", "grey"):
        raise InvalidOptionsError(
            f"jpeg encode supports rgb/grey, got {img.pixel}")
    try:
        quality = int((opts or {}).get("quality", 85))
    except (TypeError, ValueError) as e:
        raise InvalidOptionsError("invalid jpeg encode options") from e
    return jpeg_host.encode(img.to_array(), max(0, min(100, quality)))


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


def decode_sync(buf, opts=None, mimetype=None) -> Image:
    """Decode a file of any supported format (sniffed unless `mimetype`
    names its codec)."""
    codec = CODECS[mimetype or sniff(buf)]
    return codec.decode_sync(buf, opts or {})
