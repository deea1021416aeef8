"""The EXIF orientation of a JPEG file: the port's copy of the parse in
`picha_tpu/codecs/jpeg_markers.py` (`iter_segments`, `_exif_payload`,
`_find_orientation_entry`, `exif_orientation`), pinned to it by
`tests/test_torch_host_copies.py`. The JPEG decode's `autoOrient`
option reads it and turns the pixels with `image_host._orient`, the
TIFF codec's orientation map (EXIF orientation is TIFF tag 274).
"""
from __future__ import annotations

from typing import Optional


def iter_segments(buf: bytes):
    """Yield (marker_byte, start, total_len) for each marker segment
    between SOI and SOS/EOI. Tolerates fill bytes (0xFF padding).
    Stops at SOS (entropy data follows) or any malformed length."""
    n = len(buf)
    i = 2  # past SOI
    while i + 4 <= n:
        if buf[i] != 0xFF:
            return
        m = buf[i + 1]
        if m == 0xFF:  # fill byte
            i += 1
            continue
        if m in (0xD8, 0xD9, 0xDA) or 0xD0 <= m <= 0xD7:
            return  # SOI/EOI/SOS/RSTn: no further headers
        ln = (buf[i + 2] << 8) | buf[i + 3]
        if ln < 2 or i + 2 + ln > n:
            return
        yield m, i, 2 + ln
        i += 2 + ln


def _exif_payload(seg: bytes) -> Optional[bytes]:
    """APP1 segment bytes -> TIFF stream payload, or None."""
    if len(seg) >= 10 and seg[0] == 0xFF and seg[1] == 0xE1 \
            and seg[4:10] == b"Exif\x00\x00":
        return seg[10:]
    return None


def _find_orientation_entry(tiff: bytes) -> Optional[tuple]:
    """Walk IFD0 of an EXIF TIFF stream; return (value_offset, endian)
    for tag 0x0112 (SHORT), or None. Bounds-checked throughout:
    crafted EXIF never raises out of here."""
    if len(tiff) < 8:
        return None
    if tiff[:2] == b"II":
        e = "little"
    elif tiff[:2] == b"MM":
        e = "big"
    else:
        return None

    def u16(o):
        return int.from_bytes(tiff[o:o + 2], e)

    def u32(o):
        return int.from_bytes(tiff[o:o + 4], e)

    if u16(2) != 42:
        return None
    ifd = u32(4)
    if ifd + 2 > len(tiff):
        return None
    count = u16(ifd)
    for k in range(count):
        entry = ifd + 2 + 12 * k
        if entry + 12 > len(tiff):
            return None
        if u16(entry) == 0x0112 and u16(entry + 2) == 3:  # SHORT
            return entry + 8, e
    return None


def exif_orientation(buf: bytes) -> Optional[int]:
    """The EXIF orientation (1-8) of a JPEG, or None when absent or
    unparseable."""
    for m, start, total in iter_segments(bytes(buf)):
        if m != 0xE1:
            continue
        tiff = _exif_payload(bytes(buf[start:start + total]))
        if tiff is None:
            continue
        found = _find_orientation_entry(tiff)
        if found is None:
            return None  # EXIF present, no orientation tag
        off, e = found
        v = int.from_bytes(tiff[off:off + 2], e)
        return v if 1 <= v <= 8 else None
    return None
