"""PNG, TIFF and WebP decode and encode on the host, through Pillow.

The port's counterpart of `picha_tpu/codecs/png.py`, `tiff.py` and
`webp.py` for the batched image pipeline (BASELINE config 4), which the
port cannot take as they are: they call `picha_tpu/native` (zlib, LZW,
libwebp), which does not build on the card machine. As
`codecs/jpeg_host.py` does for JPEG, these go through Pillow's codecs
(libpng's zlib, libtiff, libwebp) and give the reference's pixel names:

  PNG decode   by the IHDR colour type: grey, greya, rgb (palette too),
               rgba. A 16-bit PNG, which Pillow narrows to 8 bits, and a
               requested `pixel` other than the file's own raise
               NotImplementedError: the reference's PNG host stage
               (inflate, unfilter, spec transforms) is ROADMAP queue 2
               row 11c.
  PNG encode   `pipeline/png_batch.py::encode_filtered` (the filter on
               the device, kernel K12), options `compressionLevel`
               (default 4) and `filterStrategy` ("probe", -1, 0..4);
               8-bit formats only.
  TIFF decode  always rgba (the reference's TIFFReadRGBAImageOriented),
               with the Orientation tag applied; `index` picks the
               directory. 16-bit samples raise NotImplementedError (row
               11c).
  TIFF encode  `compression` "lzw" (default; Pillow's tiff_lzw), "deflate"
               (tiff_adobe_deflate) or "none" (raw); 8-bit formats.
  WebP decode  rgba when the file has alpha, else rgb.
  WebP encode  rgb / rgba, options `quality` (default 85, clamped to
               0-100), `method` (0-6, default 3, the reference's
               default), `alphaQuality` (default 100), `exact`, and the
               presets "default" and "lossless"; the other presets
               raise NotImplementedError (Pillow does not expose them).
"""
from __future__ import annotations

import io
import operator

import numpy as np

from ..errors import CodecError, InvalidOptionsError
from ..image import Image
from ..pixels import PIXEL_FORMATS, SHALLOW_OF
from .png_host import PNG_SIGNATURE

_PIL_MODE = {"grey": "L", "greya": "LA", "rgb": "RGB", "rgba": "RGBA"}
_PNG_PIXEL = {0: "grey", 2: "rgb", 3: "rgb", 4: "greya", 6: "rgba"}
_ROW_11C = "ROADMAP.md queue 2 row 11c (the PNG and TIFF host stages)"


def _open(buf, what: str):
    from PIL import Image as PILImage

    try:
        im = PILImage.open(io.BytesIO(bytes(buf)))
        im.load()
    except Exception as e:  # noqa: BLE001 - Pillow's errors, typed
        raise CodecError(f"malformed {what}: {e}") from e
    return im


def _pixels(im, pixel: str) -> Image:
    arr = np.asarray(im.convert(_PIL_MODE[pixel]), dtype=np.uint8)
    return Image.from_array(arr.reshape(im.height, im.width, -1), pixel)


def decode_png(buf, opts=None) -> Image:
    buf = bytes(buf)
    if buf[:8] != PNG_SIGNATURE or len(buf) < 33 or buf[12:16] != b"IHDR":
        raise CodecError("not a PNG file")
    depth, color_type = buf[24], buf[25]
    if color_type not in _PNG_PIXEL:
        raise CodecError(f"bad PNG colour type {color_type}")
    if depth == 16:
        raise NotImplementedError(
            f"16-bit PNG decode is not ported to picha_tpu_torch yet: "
            f"{_ROW_11C}")
    pixel = _PNG_PIXEL[color_type]
    req = (opts or {}).get("pixel")
    if req is not None:
        if req not in PIXEL_FORMATS:
            raise InvalidOptionsError("invalid pixel mode")
        if SHALLOW_OF.get(req, req) != pixel:
            raise NotImplementedError(
                f"PNG decode to {req} from {pixel} is not ported to "
                f"picha_tpu_torch yet: {_ROW_11C}")
    return _pixels(_open(buf, "PNG"), pixel)


def _orient(arr: np.ndarray, orientation: int) -> np.ndarray:
    """Normalise to top-left (as TIFFReadRGBAImageOriented TOPLEFT)."""
    if orientation == 2:
        return arr[:, ::-1]
    if orientation == 3:
        return arr[::-1, ::-1]
    if orientation == 4:
        return arr[::-1]
    if orientation == 5:
        return arr.transpose(1, 0, 2)
    if orientation == 6:
        return arr.transpose(1, 0, 2)[:, ::-1]
    if orientation == 7:
        return arr.transpose(1, 0, 2)[::-1, ::-1]
    if orientation == 8:
        return arr.transpose(1, 0, 2)[::-1]
    return arr


def decode_tiff(buf, opts=None) -> Image:
    im = _open(buf, "TIFF")
    idx = int((opts or {}).get("index", 0))
    if idx < 0 or idx >= getattr(im, "n_frames", 1):
        raise CodecError("invalid directory index")
    if idx:
        im.seek(idx)
        im.load()
    bits = im.tag_v2.get(258, (8,))
    if max(bits if isinstance(bits, tuple) else (bits,)) > 8:
        raise NotImplementedError(
            f"TIFF decode of {bits}-bit samples is not ported to "
            f"picha_tpu_torch yet: {_ROW_11C}")
    arr = np.asarray(im.convert("RGBA"), dtype=np.uint8)
    arr = _orient(arr, int(im.tag_v2.get(274, 1)))
    return Image.from_array(np.ascontiguousarray(arr), "rgba")


def decode_webp(buf, opts=None) -> Image:
    im = _open(buf, "WebP")
    return _pixels(im, "rgba" if "A" in im.getbands() else "rgb")


def _save(img: Image, fmt: str, **kw) -> bytes:
    from PIL import Image as PILImage

    arr = img.to_array()
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    out = io.BytesIO()
    PILImage.fromarray(arr, _PIL_MODE[img.pixel]).save(out, fmt, **kw)
    return out.getvalue()


_TIFF_COMPRESSION = {"lzw": "tiff_lzw", "deflate": "tiff_adobe_deflate",
                     "none": "raw"}


def encode_tiff(img: Image, opts=None) -> bytes:
    name = (opts or {}).get("compression", "lzw")
    if name not in _TIFF_COMPRESSION:
        raise InvalidOptionsError("invalid compression option")
    if img.format.is_deep:
        raise NotImplementedError(
            f"16-bit TIFF encode is not ported to picha_tpu_torch yet: "
            f"{_ROW_11C}")
    return _save(img, "TIFF", compression=_TIFF_COMPRESSION[name])


def _int_opt(opts, name, snake, lo, hi, default):
    v = opts.get(name, opts.get(snake))
    if v is None:
        return default
    if isinstance(v, bool):
        raise InvalidOptionsError(f"webp {name} must be an int in {lo}..{hi}")
    try:
        v = operator.index(v)
    except TypeError:
        raise InvalidOptionsError(
            f"webp {name} must be an int in {lo}..{hi}") from None
    if not lo <= v <= hi:
        raise InvalidOptionsError(f"webp {name} must be an int in {lo}..{hi}")
    return v


def encode_webp(img: Image, opts=None) -> bytes:
    opts = opts or {}
    if img.pixel not in ("rgb", "rgba"):
        raise InvalidOptionsError(
            f"webp encode supports rgb/rgba, got {img.pixel}")
    preset = opts.get("preset", "default")
    if preset not in ("default", "picture", "photo", "drawing", "icon",
                      "text", "lossless"):
        raise InvalidOptionsError("invalid preset")
    if preset not in ("default", "lossless"):
        raise NotImplementedError(
            f"webp preset {preset!r} is not ported to picha_tpu_torch: "
            f"ROADMAP.md queue 2 row 11c (Pillow exposes no presets)")
    try:
        quality = float(opts.get("quality", 85.0))
        alpha_quality = int(opts.get("alphaQuality",
                                     opts.get("alpha_quality", 100)))
    except (TypeError, ValueError) as e:
        raise InvalidOptionsError("invalid webp encode options") from e
    lossless = preset == "lossless"
    method = _int_opt(opts, "method", "method", 0, 6, 4 if lossless else 3)
    return _save(img, "WEBP", quality=max(0.0, min(100.0, quality)),
                 alpha_quality=max(0, min(100, alpha_quality)),
                 method=method, lossless=lossless,
                 exact=bool(opts.get("exact", False)))


def encode_png(img: Image, opts=None, device="cuda") -> bytes:
    from ..pipeline.png_batch import encode_filtered

    if img.format.is_deep:
        raise NotImplementedError(
            f"16-bit PNG encode is not ported to picha_tpu_torch yet: "
            f"{_ROW_11C}")
    level, strategy = png_options(opts)
    return encode_filtered(img.to_array()[None], level, strategy,
                           device=device)[0]


def png_options(opts) -> tuple:
    """(level, strategy) of the PNG encode options: `compressionLevel`
    -1..9 (default 4), `filterStrategy` "probe" (the default, returned
    as None), -1 or 0..4."""
    opts = opts or {}
    strategy = opts.get("filterStrategy", opts.get("filter_strategy",
                                                   "probe"))
    if strategy != "probe":
        strategy = int(strategy)
        if strategy not in (-1, 0, 1, 2, 3, 4):
            raise InvalidOptionsError(
                "filter_strategy must be 'probe', -1 (adaptive) or 0-4")
    level = int(opts.get("compressionLevel",
                         opts.get("compression_level", 4)))
    if not -1 <= level <= 9:
        raise InvalidOptionsError("compressionLevel must be -1 or 0-9")
    return level, None if strategy == "probe" else strategy
