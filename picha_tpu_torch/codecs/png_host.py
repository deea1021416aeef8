"""PNG encode, host side: chunk assembly, the filter probe, deflate.

Counterpart of the encode side of `picha_tpu/codecs/png.py` (copies of
`PNG_SIGNATURE`, `_chunk`, the IHDR packing, `_probe_filter`'s
selection rule and `deflate_parallel`, the `deflateThreads` route). The
reference deflates and computes CRCs through `picha_tpu/native`
(libdeflate); the port uses the standard library's zlib, so its IDAT
bytes differ from the reference's at the same level
while the inflated filtered stream is the same for every fixed filter
strategy, and the pixels decode exactly.

The probe (the reference's default `filterStrategy: "probe"`): filter
the image under each candidate strategy in `PROBE_ORDER` (up, sub,
MSD-adaptive: ordered by unfilter cost), deflate a contiguous middle
block of max(8, h // 8) rows at level 1, keep the smallest estimate; a
later candidate must beat the incumbent by more than 0.5 %. Images with
fewer than 16 rows or a filtered stream under 64 KiB skip the probe and
take the adaptive filter. The level-1 estimates come from zlib here and
from libdeflate in the reference, so the two may pick different
candidates on the same image.
"""
from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PAR_CHUNK = 1 << 18           # deflate_parallel's piece size
PROBE_ORDER = (2, 1, -1)       # up, sub, MSD-adaptive
COLOR_TYPE_OF = {1: 0, 2: 4, 3: 2, 4: 6}   # channels -> PNG colour type


def chunk(ctype: bytes, data: bytes) -> bytes:
    """One PNG chunk: length, type, data, CRC-32 of type + data."""
    crc = zlib.crc32(data, zlib.crc32(ctype)) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + ctype + data + struct.pack(">I", crc)


def ihdr(width: int, height: int, depth: int, color_type: int) -> bytes:
    """The IHDR payload: deflate compression, adaptive filtering, no
    interlace."""
    return struct.pack(">IIBBBBB", width, height, depth, color_type, 0, 0, 0)


def png_file(width: int, height: int, depth: int, color_type: int,
             idat: bytes) -> bytes:
    """Signature + IHDR + one IDAT + IEND."""
    return (PNG_SIGNATURE
            + chunk(b"IHDR", ihdr(width, height, depth, color_type))
            + chunk(b"IDAT", idat) + chunk(b"IEND", b""))


def probe_applies(h: int, rb: int) -> bool:
    """Whether the default encode probes (else it takes strategy -1)."""
    return h >= 16 and h * (rb + 1) >= (1 << 16)


def probe_pick(candidates, h: int) -> int:
    """Index into `candidates` ((h, rb+1) uint8 filtered images under
    the strategies of PROBE_ORDER, in that order) of the probe's pick."""
    n_blk = max(8, h // 8)
    r0 = (h - n_blk) // 2
    best = None
    for i, f in enumerate(candidates):
        est = len(zlib.compress(f[r0:r0 + n_blk].tobytes(), 1))
        if best is None or est < best[0] * 0.995:
            best = (est, i)
    return best[1]


def deflate_parallel(data, level: int, threads: int) -> bytes:
    """pigz-style parallel deflate producing ONE standard zlib stream:
    the input in `_PAR_CHUNK` pieces, each a raw deflate primed with the
    previous 32 KiB as a preset dictionary and ended with Z_SYNC_FLUSH
    (Z_FINISH for the last), inside the zlib header and the whole
    input's adler32. Inputs of one piece, or `threads` <= 1, take one
    `zlib.compress`. The pieces run on a pool of `threads` threads made
    for the call (zlib releases the GIL)."""
    data = memoryview(data)
    n = len(data)
    if threads <= 1 or n <= _PAR_CHUNK:
        return zlib.compress(bytes(data), level)
    starts = list(range(0, n, _PAR_CHUNK))

    def one(k: int) -> bytes:
        s = starts[k]
        e = min(n, s + _PAR_CHUNK)
        zd = bytes(data[max(0, s - 32768):s])
        co = zlib.compressobj(level, zlib.DEFLATED, -15, 9,
                              zlib.Z_DEFAULT_STRATEGY, zd)
        out = co.compress(data[s:e])
        out += co.flush(zlib.Z_FINISH if e == n else zlib.Z_SYNC_FLUSH)
        return out

    with ThreadPoolExecutor(max_workers=threads,
                            thread_name_prefix="picha-deflate") as pool:
        pieces = list(pool.map(one, range(len(starts))))
    adler = zlib.adler32(data) & 0xFFFFFFFF
    # 0x78 0x9C: CM=8/CINFO=7, FLEVEL=2, FDICT=0, check bits valid
    return b"\x78\x9c" + b"".join(pieces) + struct.pack(">I", adler)
