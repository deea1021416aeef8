"""PNG, TIFF and WebP decode and encode on the host, through Pillow and
the port's own PNG and TIFF stages.

The port's counterpart of `picha_tpu/codecs/png.py`, `tiff.py` and
`webp.py` for the batched image pipeline (BASELINE config 4), which the
port cannot take as they are: they call `picha_tpu/native` (zlib, LZW,
libwebp), which does not build on the card machine. As
`codecs/jpeg_host.py` does for JPEG, these go through Pillow's codecs
(libpng's zlib, libtiff, libwebp), or through the port's own batched
decode with N = 1, and give the reference's pixel names:

  PNG decode   an 8-bit file at its own pixel format (the IHDR colour
               type: grey, greya, rgb (palette too), rgba) through
               Pillow; a 16-bit file, and a `pixel` / `deep` request for
               another format, through `pipeline/png_batch.py` (the
               port's inflate, K13 unfilter, K14 transforms) on `device`,
               with the reference's pixel rules.
  PNG encode   `pipeline/png_batch.py::encode_filtered` (the filter on
               the device, kernel K12), options `compressionLevel`
               (default 4), `filterStrategy` ("probe", -1, 0..4) and
               `deflateThreads`; 8-bit and 16-bit formats.
  TIFF decode  always rgba (the reference's TIFFReadRGBAImageOriented),
               with the Orientation tag applied; `index` picks the
               directory. Through Pillow, except what Pillow gets wrong:
               16-bit samples, predictor 2 and CMYK go through
               `pipeline/tiff_batch.py` (K15, K16) on `device` in the
               device graph's layouts; outside them 16-bit samples and
               uncompressed predictor-2 data raise NotImplementedError,
               and the rest (tiled or compressed) stays with Pillow,
               whose libtiff undoes the predictor there.
  TIFF encode  `compression` "lzw" (default; Pillow's tiff_lzw), "deflate"
               (tiff_adobe_deflate) or "none" (raw); 8-bit formats.
  WebP decode  rgba when the file has alpha, else rgb.
  WebP encode  rgb / rgba, options `quality` (default 85, clamped to
               0-100), `method` (0-6, default 3, the reference's
               default), `alphaQuality` (default 100), `exact`, and the
               presets "default" and "lossless"; the other presets, and
               `segments` / `alphaFiltering`, raise NotImplementedError
               (Pillow exposes none of them).
"""
from __future__ import annotations

import io
import operator

import numpy as np

from ..errors import CodecError, InvalidOptionsError
from ..image import Image
from ..runtime.device import resolve_device
from . import png_decode, tiff_host

_PIL_MODE = {"grey": "L", "greya": "LA", "rgb": "RGB", "rgba": "RGBA"}
_ITEM_7 = "ROADMAP.md queue 1 item 7 (still unported)"


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


def decode_png(buf, opts=None, device="cuda") -> Image:
    buf = bytes(buf)
    h = png_decode._parse_header(buf)
    opts = opts or {}
    target = png_decode._resolve_pixel(h, opts.get("pixel"),
                                       bool(opts.get("deep")))
    if h.bit_depth != 16 and target == png_decode._default_pixel(h, False):
        return _pixels(_open(buf, "PNG"), target)
    from ..pipeline.png_batch import decode_parts, host_stage

    out = decode_parts([host_stage(buf)], target, False,
                       resolve_device(device))
    return Image.from_array(out[0].cpu().numpy(), target)


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


def _tiff_stages(buf: bytes, idx: int):
    """The port's host stage of a file that Pillow decodes wrongly, else
    None (Pillow's route). Pillow narrows 16-bit samples, skips the
    predictor of uncompressed data and rounds its CMYK fold; libtiff
    undoes the predictor of compressed strips and tiles itself."""
    try:
        _endian, ifds = tiff_host._parse_ifds(buf)
    except CodecError:
        return None         # what the port's parser refuses (BigTIFF)
    if idx < 0 or idx >= len(ifds):
        raise CodecError("invalid directory index")
    ifd = ifds[idx]
    bits = ifd.get(tiff_host.T_BITS, [1])[0]
    predictor = ifd.one(tiff_host.T_PREDICTOR, 1)
    if predictor not in (1, 2):
        # 3 is floating-point differencing: the reference's codec
        # refuses it, typed, rather than return noise
        raise CodecError(f"unsupported TIFF predictor {predictor}")
    if not (bits == 16 or predictor == 2
            or ifd.one(tiff_host.T_PHOTOMETRIC, 1) == 5):
        return None
    item = tiff_host.host_stage(buf, idx)
    if item[0] != "fallback":
        return item
    raw = ifd.one(tiff_host.T_COMPRESSION, tiff_host.C_NONE) == \
        tiff_host.C_NONE
    if bits == 16 or (predictor == 2 and raw):
        raise NotImplementedError(
            f"TIFF decode of this layout ({bits}-bit samples, predictor "
            f"{predictor}, {'un' if raw else ''}compressed) outside the "
            f"device graph is not ported to picha_tpu_torch: {_ITEM_7}")
    return None


def decode_tiff(buf, opts=None, device="cuda") -> Image:
    buf = bytes(buf)
    idx = int((opts or {}).get("index", 0))
    item = _tiff_stages(buf, idx)
    if item is not None:
        from ..pipeline.tiff_batch import decode_items

        out = decode_items([item], resolve_device(device))
        return Image.from_array(out[0].cpu().numpy(), "rgba")
    im = _open(buf, "TIFF")
    if idx < 0 or idx >= getattr(im, "n_frames", 1):
        raise CodecError("invalid directory index")
    if idx:
        im.seek(idx)
        im.load()
    arr = np.asarray(im.convert("RGBA"), dtype=np.uint8)
    arr = _orient(arr, int(im.tag_v2.get(274, 1)))
    return Image.from_array(np.ascontiguousarray(arr), "rgba")


def decode_webp(buf, opts=None, device=None) -> Image:
    """Pillow's libwebp decode, on the host (`device` is ignored)."""
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
            f"16-bit TIFF encode (an LZW encoder and an IFD writer of the "
            f"port's own) is not ported to picha_tpu_torch: {_ITEM_7}")
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
            f"webp preset {preset!r} is not ported to picha_tpu_torch "
            f"(Pillow exposes no presets): {_ITEM_7}")
    try:
        quality = float(opts.get("quality", 85.0))
        alpha_quality = int(opts.get("alphaQuality",
                                     opts.get("alpha_quality", 100)))
    except (TypeError, ValueError) as e:
        raise InvalidOptionsError("invalid webp encode options") from e
    lossless = preset == "lossless"
    method = _int_opt(opts, "method", "method", 0, 6, 4 if lossless else 3)
    for name, snake, hi in (("segments", "segments", 4),
                            ("alphaFiltering", "alpha_filtering", 2)):
        if _int_opt(opts, name, snake, 0 if hi == 2 else 1, hi,
                    None) is not None:
            raise NotImplementedError(
                f"webp {name} is not ported to picha_tpu_torch (Pillow "
                f"exposes no such option): {_ITEM_7}")
    return _save(img, "WEBP", quality=max(0.0, min(100.0, quality)),
                 alpha_quality=max(0, min(100, alpha_quality)),
                 method=method, lossless=lossless,
                 exact=bool(opts.get("exact", False)))


def encode_png(img: Image, opts=None, device="cuda") -> bytes:
    """8- or 16-bit PNG (by the image's format; 16-bit samples
    big-endian, as the reference writes them) through
    `encode_filtered`, the filter on `device`."""
    from ..pipeline.png_batch import encode_filtered

    level, strategy, threads = png_options(opts)
    return encode_filtered(img.to_array()[None], level, strategy,
                           device=device, threads=threads)[0]


def png_options(opts) -> tuple:
    """(level, strategy, threads) of the PNG encode options:
    `compressionLevel` -1..9 (default 4), `filterStrategy` "probe" (the
    default, returned as None), -1 or 0..4, `deflateThreads` an int >= 1
    (default None: one zlib stream per image)."""
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
    threads = opts.get("deflateThreads", opts.get("deflate_threads", None))
    if threads is not None:
        try:
            threads = operator.index(threads)
        except TypeError:
            raise InvalidOptionsError(
                "deflateThreads must be an int >= 1") from None
        if threads < 1:
            raise InvalidOptionsError("deflateThreads must be an int >= 1")
    return level, None if strategy == "probe" else strategy, threads
