"""PNG decode, host side: chunks, header, inflate, pixel-format rules.

The port's copies of the decode half of `picha_tpu/codecs/png.py`
(`CT_*`, `_CHANNELS`, the luma weights, `_ADAM7`, `_Header`,
`_parse_chunks`, `_parse_header`, `_default_pixel`, `_resolve_pixel`,
`stat`, `_rowbytes`, `_expand_bits`, `_scale_sub_byte`,
`_decode_samples`, `_to_target`), pinned to them by
`tests/test_torch_host_copies.py` and `tests/test_torch_png_decode.py`.
Where the reference calls `picha_tpu/native`, which cannot build on the
card machine, the port uses the standard library's zlib (CRC-32 and
inflate; an overlong stream keeps its extras, as zlib does) and its own
unfilter, kernel K13 (`ops/png_unfilter.py`).

`inflate` and `passes` are the host stage of the batched decode
(`pipeline/png_batch.py`): the filtered stream and the geometry of each
(Adam7) pass. `_decode_samples` runs the whole decode of one image on a
device (the unfilter on it), for the single-image path and the tests.
"""
from __future__ import annotations

import struct
import warnings
import zlib

import numpy as np

from ..errors import CodecError, InvalidOptionsError
from ..pixels import PIXEL_FORMATS, SHALLOW_OF, pixel_format
from .png_host import PNG_SIGNATURE

# colour types
CT_GREY, CT_RGB, CT_PALETTE, CT_GREYA, CT_RGBA = 0, 2, 3, 4, 6
_CHANNELS = {CT_GREY: 1, CT_RGB: 3, CT_PALETTE: 1, CT_GREYA: 2, CT_RGBA: 4}

# libpng png_set_rgb_to_gray default coefficients (BT.709, 15-bit fixed)
_GREY_R, _GREY_G, _GREY_B = 6968, 23434, 2366

# Adam7 interlace pass geometry: (x_start, y_start, x_step, y_step)
_ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]


class _Header:
    __slots__ = ("width", "height", "bit_depth", "color_type", "interlace")


def _parse_chunks(buf: bytes):
    if len(buf) < 8 or buf[:8] != PNG_SIGNATURE:
        raise CodecError("not a PNG file")
    mv = memoryview(buf)  # CRC over a view: no per-chunk payload copy
    pos = 8
    while pos + 8 <= len(buf):
        length, ctype = struct.unpack_from(">I4s", buf, pos)
        data_start = pos + 8
        data_end = data_start + length
        if data_end + 4 > len(buf):
            raise CodecError("truncated PNG chunk")
        crc = struct.unpack_from(">I", buf, data_end)[0]
        if zlib.crc32(mv[pos + 4:data_end]) & 0xFFFFFFFF != crc:
            # libpng only warns on CRC errors in ancillary chunks
            # (lowercase first letter) and keeps going; critical chunks
            # stay hard failures
            if ctype[0:1].islower():
                warnings.warn(f"PNG CRC mismatch in ancillary chunk "
                              f"{ctype!r}; chunk skipped", stacklevel=2)
                pos = data_end + 4
                continue
            raise CodecError(f"PNG CRC mismatch in {ctype!r}")
        yield ctype, buf[data_start:data_end]
        pos = data_end + 4
        if ctype == b"IEND":
            return
    raise CodecError("PNG missing IEND")


def _parse_header(buf: bytes) -> _Header:
    for ctype, data in _parse_chunks(buf):
        if ctype != b"IHDR":
            raise CodecError("PNG missing IHDR")
        if len(data) != 13:
            raise CodecError("bad IHDR")
        h = _Header()
        (h.width, h.height, h.bit_depth, h.color_type,
         comp, filt, h.interlace) = struct.unpack(">IIBBBBB", data)
        if comp != 0 or filt != 0 or h.interlace not in (0, 1):
            raise CodecError("unsupported PNG compression/filter/interlace")
        if h.color_type not in _CHANNELS:
            raise CodecError("bad PNG colour type")
        valid_depths = {CT_GREY: (1, 2, 4, 8, 16), CT_RGB: (8, 16),
                        CT_PALETTE: (1, 2, 4, 8), CT_GREYA: (8, 16),
                        CT_RGBA: (8, 16)}[h.color_type]
        if h.bit_depth not in valid_depths:
            raise CodecError("bad PNG bit depth")
        if h.width == 0 or h.height == 0:
            raise CodecError("bad PNG dimensions")
        # libpng's default user limits plus a product cap: crafted
        # headers fail typed here, before any size-derived allocation
        if h.width > 1_000_000 or h.height > 1_000_000 \
                or h.width * h.height > 2**31:
            raise CodecError("PNG dimensions exceed limit")
        return h
    raise CodecError("empty PNG")


def _default_pixel(h: _Header, deep: bool) -> str:
    """Choose by colour/alpha masks (the reference's pngcodec.cc:61-74)."""
    deep = deep and h.bit_depth == 16
    color = h.color_type in (CT_RGB, CT_PALETTE, CT_RGBA)
    alpha = h.color_type in (CT_GREYA, CT_RGBA)
    if color and alpha:
        return "r16g16b16a16" if deep else "rgba"
    if color:
        return "r16g16b16" if deep else "rgb"
    if alpha:
        return "r16g16" if deep else "greya"
    return "r16" if deep else "grey"


def _resolve_pixel(h: _Header, req, deep: bool) -> str:
    """Requests for deep formats downgrade when the source is not
    16-bit (pngcodec.cc:61-86)."""
    if req is None:
        return _default_pixel(h, deep)
    if req not in PIXEL_FORMATS:
        raise InvalidOptionsError("invalid pixel mode")
    if h.bit_depth != 16 and req in SHALLOW_OF:
        return SHALLOW_OF[req]
    return req


def stat(buf: bytes):
    try:
        h = _parse_header(bytes(buf))
    except CodecError:
        return None
    return {"width": h.width, "height": h.height,
            "pixel": _default_pixel(h, True)}


def _rowbytes(width: int, channels: int, depth: int) -> int:
    return (width * channels * depth + 7) // 8


def _expand_bits(plane: np.ndarray, width: int, channels: int,
                 depth: int) -> np.ndarray:
    """(h, rowbytes) bytes -> (h, w, channels) uint8/16 samples (no
    value scaling for sub-byte depths: raw sample values)."""
    h = plane.shape[0]
    if depth == 8:
        return plane[:, : width * channels].reshape(h, width, channels)
    if depth == 16:
        arr = plane[:, : width * channels * 2].reshape(h, width * channels, 2)
        vals = (arr[:, :, 0].astype(np.uint16) << 8) | arr[:, :, 1]
        return vals.reshape(h, width, channels)
    # 1/2/4-bit: MSB-first within each byte
    per_byte = 8 // depth
    shifts = np.arange(per_byte - 1, -1, -1, dtype=np.uint8) * depth
    mask = (1 << depth) - 1
    expanded = (plane[:, :, None] >> shifts[None, None, :]) & mask
    expanded = expanded.reshape(h, -1)[:, : width * channels]
    return expanded.reshape(h, width, channels)


def _scale_sub_byte(samples: np.ndarray, depth: int) -> np.ndarray:
    """Grayscale 1/2/4-bit -> full 8-bit range (libpng expand_gray)."""
    factor = 255 // ((1 << depth) - 1)
    return (samples * np.uint8(factor)).astype(np.uint8)


def passes(h: _Header) -> list:
    """[(x0, y0, dx, dy, pw, ph, rowbytes)] of the non-empty passes: one
    for a plain image, up to seven for Adam7 (empty passes skipped)."""
    ch = _CHANNELS[h.color_type]
    geo = _ADAM7 if h.interlace else [(0, 0, 1, 1)]
    out = []
    for (x0, y0, dx, dy) in geo:
        pw = (h.width - x0 + dx - 1) // dx
        ph = (h.height - y0 + dy - 1) // dy
        if pw and ph:
            out.append((x0, y0, dx, dy, pw, ph,
                        _rowbytes(pw, ch, h.bit_depth)))
    return out


def inflate(buf: bytes, h: _Header):
    """The host stage: chunks -> (the inflated filtered stream as a
    uint8 array, palette (k, 3) uint8 or None, tRNS bytes or None)."""
    idat = []
    palette = None
    trns = None
    for ctype, data in _parse_chunks(buf):
        if ctype == b"IDAT":
            idat.append(data)
        elif ctype == b"PLTE":
            if len(data) % 3:
                raise CodecError("bad PLTE")
            palette = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = data
    if not idat:
        raise CodecError("PNG missing IDAT")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise CodecError(f"zlib stream is corrupt: {e}") from None
    return np.frombuffer(raw, dtype=np.uint8), palette, trns


def need(h: _Header) -> int:
    """Bytes of the filtered stream the header asks for."""
    return sum(ph * (rb + 1) for *_g, ph, rb in passes(h))


def _decode_samples(buf: bytes, h: _Header, device="cpu"):
    """Returns (samples (H,W,C) uint8|uint16, palette, trns); the
    unfilter (K13) runs on `device`."""
    import torch

    from ..ops.png_unfilter import check_status, png_unfilter

    raw, palette, trns = inflate(buf, h)
    ch = _CHANNELS[h.color_type]
    bpp = max(1, (ch * h.bit_depth) // 8)
    dtype = np.uint16 if h.bit_depth == 16 else np.uint8
    samples = np.zeros((h.height, h.width, ch), dtype=dtype)
    pos = 0
    for (x0, y0, dx, dy, pw, ph, rb) in passes(h):
        n = ph * (rb + 1)
        if raw.size < pos + n:
            raise CodecError("PNG pixel data truncated")
        rows = torch.from_numpy(
            raw[pos:pos + n].reshape(1, ph, rb + 1).copy())
        plane, status = png_unfilter(rows.to(device), bpp)
        check_status(status)
        pos += n
        samples[y0::dy, x0::dx] = _expand_bits(plane[0].cpu().numpy(), pw,
                                               ch, h.bit_depth)
    return samples, palette, trns


def _to_target(samples: np.ndarray, h: _Header, palette, trns,
               target: str) -> np.ndarray:
    """libpng-transform-equivalent mapping to the requested format
    (pngcodec.cc:138-168)."""
    fmt = pixel_format(target)
    depth = h.bit_depth
    maxval = np.uint16(65535) if depth == 16 else np.uint8(255)

    alpha = None
    if h.color_type == CT_PALETTE:
        idx = samples[:, :, 0]
        if palette is None:
            raise CodecError("palette PNG missing PLTE")
        # pad the LUT to 256 so out-of-range indices in crafted files
        # resolve to black instead of raising, as the batched path does
        pal = np.zeros((256, 3), dtype=np.uint8)
        pal[: min(256, palette.shape[0])] = palette[:256]
        rgb = pal[idx]  # (H, W, 3) uint8
        if trns is not None:
            ta = np.frombuffer(trns, dtype=np.uint8)[:256]
            lut = np.full(256, 255, dtype=np.uint8)
            lut[: len(ta)] = ta
            alpha = lut[idx]
        color = rgb
        depth = 8
        maxval = np.uint8(255)
    else:
        if h.color_type == CT_GREY and h.bit_depth < 8:
            samples = _scale_sub_byte(samples, h.bit_depth)
            depth = 8
        if h.color_type in (CT_GREYA, CT_RGBA):
            alpha = samples[:, :, -1]
            color = samples[:, :, :-1]
        else:
            color = samples
        if trns is not None and h.color_type in (CT_GREY, CT_RGB):
            # exact-match transparent colour -> alpha (tRNS_to_alpha)
            vals = np.frombuffer(trns, dtype=">u2").astype(np.uint16)
            if h.color_type == CT_GREY:
                key = vals[0] if h.bit_depth == 16 else (
                    _scale_sub_byte(np.array(vals[0] & 0xFF), h.bit_depth)
                    if h.bit_depth < 8 else vals[0] & 0xFF)
                match = color[:, :, 0] == key
            else:
                key = vals[:3] if h.bit_depth == 16 else (vals[:3] & 0xFF)
                match = np.all(color == key.astype(color.dtype), axis=-1)
            alpha = np.where(match, 0, int(maxval)).astype(color.dtype)

    # grey <-> colour mapping
    want_color = fmt.is_color
    have_color = color.shape[-1] == 3
    if want_color and not have_color:
        color = np.repeat(color, 3, axis=-1)
    elif not want_color and have_color:
        # libpng fixed-point rgb->grey (15-bit coefficients)
        r = color[..., 0].astype(np.uint32)
        g = color[..., 1].astype(np.uint32)
        b = color[..., 2].astype(np.uint32)
        grey = (_GREY_R * r + _GREY_G * g + _GREY_B * b + 16384) >> 15
        color = grey.astype(color.dtype)[..., None]

    # alpha channel handling
    if fmt.has_alpha:
        if alpha is None:
            alpha = np.full(color.shape[:2], int(maxval), dtype=color.dtype)
        out = np.concatenate([color, alpha[..., None].astype(color.dtype)],
                             axis=-1)
    else:
        out = color

    # depth moves
    if fmt.is_deep:
        if depth != 16:
            raise CodecError("deep target from non-16-bit source")
        return out.astype(np.uint16)
    if depth == 16:
        out = (out >> 8).astype(np.uint8)  # png_set_strip_16 chop
    return np.ascontiguousarray(out, dtype=np.uint8)
