"""TIFF decode, host side: the IFD parse, strip decompression and the
batched pipeline's host stage.

The port's copies from `picha_tpu/codecs/tiff.py` (the tag and
compression constants, `_BITREV`, `_TYPE_SIZES`, `_TYPE_FMT`, `_Ifd`,
`_parse_ifds`, `_decompress`) and `picha_tpu/pipeline/tiff_batch.py`
(`host_stage`, `_host_stage_parsed`), pinned to them by
`tests/test_torch_host_copies.py` and `tests/test_torch_tiff_decode.py`.
Where the reference decompresses through `picha_tpu/native`, which
cannot build on the card machine:
  deflate / Adobe deflate  the standard library's zlib, cut at the
                           strip's expected size
  PackBits                 `packbits_decode`, the port's copy of
                           `native/src/lzw.cc:269-299` (output clamped
                           at the cap; truncated input an error)
  LZW                      not decoded here: the host stage hands the
                           strips to kernel K15 (`ops/lzw.py`)
A layout outside the device graph (tiles, planar, fax, JPEG, subsampled
YCbCr, other predictors) takes the whole-file decode of
`codecs/image_host.py::decode_tiff`, as the reference takes its
single-image codec.
"""
from __future__ import annotations

import math
import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

from ..errors import CodecError

# tag ids
T_WIDTH, T_HEIGHT, T_BITS, T_COMPRESSION, T_PHOTOMETRIC = 256, 257, 258, 259, 262
T_FILLORDER, T_STRIP_OFFSETS, T_ORIENTATION, T_SPP, T_ROWS_PER_STRIP = 266, 273, 274, 277, 278
T_STRIP_COUNTS, T_PLANAR, T_PREDICTOR, T_COLORMAP, T_TILE_W = 279, 284, 317, 320, 322
T_TILE_H, T_TILE_OFFSETS, T_TILE_COUNTS, T_EXTRASAMPLES, T_SAMPLEFORMAT = 323, 324, 325, 338, 339
T_JPEG_TABLES, T_JPEG_IF, T_JPEG_IF_LEN, T_YCBCR_SUBSAMPLING = 347, 513, 514, 530

# compressions
C_NONE, C_CCITT, C_OLDJPEG, C_JPEG, C_ADEFLATE, C_PACKBITS = 1, 2, 6, 7, 8, 32773
C_LZW, C_DEFLATE = 5, 32946
C_G3, C_G4 = 3, 4

# FillOrder=2 stores bits lsb-first within each byte; libtiff reverses
# the raw segment bytes before decoding (TIFFReverseBits) and so do we
_BITREV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d"}


class _Ifd:
    __slots__ = ("tags",)

    def __init__(self):
        self.tags = {}

    def get(self, tag, default=None):
        v = self.tags.get(tag)
        if v is None:
            return default
        return v

    def one(self, tag, default=None):
        v = self.tags.get(tag)
        if v is None:
            return default
        return v[0] if isinstance(v, (list, tuple)) else v


def _parse_ifds(buf: bytes):
    if len(buf) < 8:
        raise CodecError("not a TIFF file")
    bom = buf[:2]
    if bom == b"II":
        e = "<"
    elif bom == b"MM":
        e = ">"
    else:
        raise CodecError("not a TIFF file")
    magic, off = struct.unpack(e + "HI", buf[2:8])
    if magic != 42:
        raise CodecError("not a TIFF file")
    ifds = []
    seen = set()
    while off and off not in seen:
        seen.add(off)
        if off + 2 > len(buf):
            raise CodecError("truncated TIFF IFD")
        (n,) = struct.unpack_from(e + "H", buf, off)
        ifd = _Ifd()
        pos = off + 2
        if pos + n * 12 + 4 > len(buf):
            raise CodecError("truncated TIFF IFD")
        for _ in range(n):
            tag, typ, count = struct.unpack_from(e + "HHI", buf, pos)
            size = _TYPE_SIZES.get(typ, 1) * count
            if size <= 4:
                data = buf[pos + 8 : pos + 8 + size]
            else:
                (voff,) = struct.unpack_from(e + "I", buf, pos + 8)
                if voff + size > len(buf):
                    raise CodecError("truncated TIFF value")
                data = buf[voff : voff + size]
            if typ in _TYPE_FMT:
                vals = list(struct.unpack(e + _TYPE_FMT[typ] * count, data))
            elif typ == 5 or typ == 10:  # rational
                ints = struct.unpack(e + ("i" if typ == 10 else "I") * (2 * count), data)
                vals = [ints[2 * i] / (ints[2 * i + 1] or 1) for i in range(count)]
            else:
                vals = [data]
            ifd.tags[tag] = vals
            pos += 12
        (off,) = struct.unpack_from(e + "I", buf, pos)
        ifds.append(ifd)
    return e, ifds


def packbits_decode(data: bytes, cap: int) -> bytes:
    """PackBits -> at most `cap` bytes: a run past the cap is clamped and
    ends the strip (libtiff discards the excess); input that ends inside
    a run is an error."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        c = data[i]
        i += 1
        if c < 128:                      # literal run of c + 1 bytes
            cnt = c + 1
            if i + cnt > n:
                raise CodecError("PackBits decode failed")
            wr = min(cnt, cap - len(out))
            out += data[i:i + wr]
            i += cnt
            if wr < cnt:
                break
        elif c != 128:                   # repeat the next byte 257 - c times
            cnt = 257 - c
            if i >= n:
                raise CodecError("PackBits decode failed")
            wr = min(cnt, cap - len(out))
            out += bytes([data[i]]) * wr
            i += 1
            if wr < cnt:
                break
    return bytes(out)


def _decompress(data: bytes, comp: int, expected: int) -> bytes:
    """One strip's bytes (LZW excluded: kernel K15 decodes those)."""
    if comp == C_NONE:
        return data
    if comp in (C_ADEFLATE, C_DEFLATE):
        try:
            return zlib.decompressobj().decompress(data, expected)
        except zlib.error as e:
            raise CodecError(f"zlib stream is corrupt: {e}") from None
    if comp == C_PACKBITS:
        return packbits_decode(data, expected)
    raise CodecError(f"unsupported TIFF compression {comp}")


class HostItem(NamedTuple):
    """One image's host stage: `sig` the device signature; `rows` the
    (H, rowbytes) uint8 rows of a non-LZW image, else None; `strips`
    the LZW strips [(segment bytes, first row, cap bytes)]; `cmap` the
    (1 << bits, 3) uint8 colormap of a palette image."""
    sig: tuple
    rows: Optional[np.ndarray]
    strips: list
    cmap: Optional[np.ndarray]


def host_stage(buf: bytes, index: int = 0):
    """bytes -> a HostItem, or ("fallback", None) for a layout outside
    the device graph (the caller decodes those whole)."""
    buf = bytes(buf)
    endian, ifds = _parse_ifds(buf)
    if index < 0 or index >= len(ifds):
        raise CodecError("invalid directory index")
    ifd = ifds[index]
    try:
        return _host_stage_parsed(buf, endian, ifd)
    except (TypeError, ValueError) as e:
        # crafted tag types leak non-numeric values into arithmetic
        raise CodecError("malformed TIFF tags") from e


def _host_stage_parsed(buf, endian, ifd):
    width = int(ifd.one(T_WIDTH, 0))
    height = int(ifd.one(T_HEIGHT, 0))
    if width <= 0 or height <= 0:
        raise CodecError("bad TIFF dimensions")
    spp = int(ifd.one(T_SPP, 1))
    # the single-image codec's crafted-header caps: a 200-byte file
    # claiming giant dims fails typed before any size-derived allocation
    if width > 1_000_000 or height > 1_000_000 \
            or spp <= 0 or width * height * spp > 2**31:
        raise CodecError("TIFF dimensions exceed limit")
    bits = int(ifd.get(T_BITS, [1])[0])
    comp = int(ifd.one(T_COMPRESSION, C_NONE))
    fillorder = int(ifd.one(T_FILLORDER, 1))
    photometric = int(ifd.one(T_PHOTOMETRIC, 1))
    planar = int(ifd.one(T_PLANAR, 1))
    predictor = int(ifd.one(T_PREDICTOR, 1))
    orientation = int(ifd.one(T_ORIENTATION, 1))
    subs = ifd.get(T_YCBCR_SUBSAMPLING, [2, 2]) if photometric == 6 else [1, 1]

    device_ok = (
        comp in (C_NONE, C_LZW, C_ADEFLATE, C_DEFLATE, C_PACKBITS)
        and planar == 1
        and T_TILE_OFFSETS not in ifd.tags
        and photometric in (0, 1, 2, 3, 5, 6)
        and bits in (1, 2, 4, 8, 16)
        and (photometric != 6 or list(subs)[:2] == [1, 1])
        # what the device transform cannot honour goes to the
        # single-image codec, which validates and raises typed errors
        and predictor in (1, 2)
        and not (photometric == 5 and spp < 4)
        and not (photometric == 2 and spp < 3)
    )
    if not device_ok:
        return ("fallback", None)

    offsets = ifd.get(T_STRIP_OFFSETS)
    if offsets is None:
        raise CodecError("TIFF missing strip offsets")
    rps = int(ifd.one(T_ROWS_PER_STRIP, height)) or height
    if rps < 1:
        # signed-overflow crafted values would run the strip loop zero
        # times and return an uninitialized canvas
        raise CodecError("bad TIFF RowsPerStrip")
    counts = ifd.get(T_STRIP_COUNTS)
    nstrips = math.ceil(height / rps)
    rowbytes = (width * spp * bits + 7) // 8
    if counts is None:
        if comp != C_NONE:
            raise CodecError("TIFF missing StripByteCounts")
        counts = [rowbytes * min(rps, height - s * rps) for s in range(nstrips)]
    if len(counts) < nstrips or len(offsets) < nstrips:
        raise CodecError("TIFF strip tables too short")
    rows = None if comp == C_LZW else np.empty((height, rowbytes), np.uint8)
    strips = []
    for s in range(nstrips):
        y0 = s * rps
        nrows = min(rps, height - y0)
        seg = buf[offsets[s] : offsets[s] + counts[s]]
        if fillorder == 2:
            seg = _BITREV[np.frombuffer(seg, np.uint8)].tobytes()
        if comp == C_LZW:
            strips.append((seg, y0, rowbytes * nrows))
            continue
        raw = _decompress(seg, comp, rowbytes * nrows)
        if len(raw) < rowbytes * nrows:
            raise CodecError("TIFF strip too short")
        rows[y0 : y0 + nrows] = np.frombuffer(
            raw, np.uint8, rowbytes * nrows).reshape(nrows, rowbytes)

    extras = ifd.get(T_EXTRASAMPLES)
    sig = (width, height, spp, bits, photometric, predictor, orientation,
           endian, bool(extras))
    cmap = None
    if photometric == 3:
        cm = ifd.get(T_COLORMAP)
        if cm is None:
            raise CodecError("palette TIFF missing colormap")
        n = len(cm) // 3
        lut = (np.array(cm, dtype=np.uint32).reshape(3, n).T >> 8
               ).astype(np.uint8)
        cmap = np.zeros((1 << bits, 3), np.uint8)
        cmap[: lut.shape[0]] = lut[: 1 << bits]
    return HostItem(sig, rows, strips, cmap)
