"""The Image value type (host, numpy).

Counterpart of `picha_tpu/image.py`, of which this is a copy (pinned by
`tests/test_torch_host_copies.py`): an image is (width, height, pixel,
stride, data) where `data` is a flat 1-D numpy uint8 buffer of at least
``stride*(height-1) + width*pixelSize`` bytes. Rows are strided;
``sub_view`` is a zero-copy strided window; `equal_pixels` and
`avg_channel_diff` look at only the payload bytes of each row (padding
excluded). The format is 'r16g16' (not the 'r16b16' typo), and the
camelCase aliases (subView, equalPixels, ...) are kept.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np

from .errors import InvalidImageError, InvalidOptionsError
from .pixels import PIXEL_FORMATS, pixel_format, pixel_size

BufferLike = Union[bytes, bytearray, memoryview, np.ndarray]


def default_stride(width: int, pixel: str) -> int:
    """4-byte-aligned row stride (lib/image.js:10, src/picha.h:212-215)."""
    return (width * pixel_size(pixel) + 3) & ~3


def _as_byte_array(data: BufferLike) -> np.ndarray:
    if isinstance(data, np.ndarray):
        if not data.flags["C_CONTIGUOUS"]:
            # a silent copy here would break the shared-buffer mutation
            # contract (writes through views must hit the caller's data)
            raise InvalidImageError("image data buffer must be contiguous")
        if data.dtype != np.uint8:
            data = data.view(np.uint8)
        return data.reshape(-1)
    if isinstance(data, memoryview):
        # a WRITABLE view (e.g. a slice of a pooled bytearray) shares
        # the caller's buffer zero-copy, same contract as bytearray; a
        # read-only view copies like bytes below. Must be C-contiguous
        # (.contiguous also admits Fortran layouts, which cast("B") and
        # np.frombuffer both reject with a raw TypeError)
        if not data.c_contiguous:
            raise InvalidImageError("image data buffer must be C-contiguous")
        if not data.readonly:
            return np.frombuffer(data.cast("B"), dtype=np.uint8)
        return np.frombuffer(data.cast("B"), dtype=np.uint8).copy()
    if isinstance(data, bytes):
        # bytes are immutable; copy so the image is mutable like Buffer
        return np.frombuffer(data, dtype=np.uint8).copy()
    if isinstance(data, bytearray):
        return np.frombuffer(data, dtype=np.uint8)  # zero-copy, writable
    raise InvalidImageError(f"unsupported data buffer type {type(data)!r}")


class Image:
    """A strided raster image over a flat byte buffer."""

    __slots__ = ("width", "height", "pixel", "stride", "data")

    def __init__(
        self,
        width: int = 0,
        height: int = 0,
        pixel: str = "rgba",
        data: Optional[BufferLike] = None,
        stride: Optional[int] = None,
    ):
        psize = pixel_size(pixel)
        if psize == 0:
            raise InvalidOptionsError(f"invalid pixel format {pixel}")
        if width < 0 or height < 0:
            raise InvalidImageError("invalid dimensions")
        if stride is None:
            stride = default_stride(width, pixel)
        if stride < width * psize:
            raise InvalidImageError("stride too short")
        self.width = int(width)
        self.height = int(height)
        self.pixel = pixel
        self.stride = int(stride)
        if data is None:
            if stride * height != 0:
                data = np.zeros(stride * height, dtype=np.uint8)
            else:
                data = np.zeros(0, dtype=np.uint8)
        arr = _as_byte_array(data)
        if height > 0 and arr.size < stride * (height - 1) + width * psize:
            raise InvalidImageError("image data too small")
        self.data = arr

    # -- geometry ----------------------------------------------------------

    @property
    def format(self):
        return pixel_format(self.pixel)

    def pixel_size(self) -> int:
        return pixel_size(self.pixel)

    @staticmethod
    def buffer_compare(a, b) -> int:
        """Lexicographic byte-buffer compare returning -1/0/1 with the
        shorter-prefix-first rule (reference lib/image.js:46-55
        Image.bufferCompare / Buffer.compare semantics). Accepts bytes
        or uint8 arrays."""
        # np.ascontiguousarray handles non-contiguous uint8 views (e.g.
        # an Image.row of a padded-stride image) that bytes(memoryview())
        # would reject with TypeError
        def _to_bytes(v):
            if isinstance(v, np.ndarray):
                return np.ascontiguousarray(v).tobytes()
            return memoryview(v).tobytes()
        av, bv = _to_bytes(a), _to_bytes(b)
        return -1 if av < bv else (1 if av > bv else 0)

    bufferCompare = buffer_compare

    def row(self, y: int) -> np.ndarray:
        """Payload bytes of row y (no padding), zero-copy."""
        if not 0 <= y < self.height:
            # a negative y would compute a negative offset and silently
            # alias the buffer tail (the same wraparound sub_view
            # rejects); y >= height would return an empty slice
            raise InvalidImageError(f"row {y} out of range")
        off = y * self.stride
        return self.data[off : off + self.width * self.pixel_size()]

    def rows(self) -> np.ndarray:
        """(height, width*psize) byte view of all row payloads, zero-copy."""
        if self.height == 0 or self.width == 0:
            return np.zeros((self.height, 0), dtype=np.uint8)
        rowbytes = self.width * self.pixel_size()
        need = (self.height - 1) * self.stride + rowbytes
        base = self.data[:need]
        strided = np.lib.stride_tricks.as_strided(
            base, shape=(self.height, rowbytes), strides=(self.stride, 1), writeable=base.flags.writeable
        )
        return strided

    # -- numpy interop -----------------------------------------------------

    def to_array(self) -> np.ndarray:
        """(H, W, C) channel-typed array. Always a COPY: when there is
        no row padding, rows() is already contiguous and
        ascontiguousarray would alias the image buffer — mutating the
        result would silently corrupt the Image (and the aliasing would
        be shape-dependent: padded-stride images got real copies)."""
        fmt = self.format
        out = np.array(self.rows(), copy=True).view(fmt.dtype)
        return out.reshape(self.height, self.width, fmt.channels)

    @classmethod
    def from_array(cls, arr: np.ndarray, pixel: Optional[str] = None) -> "Image":
        """Build an Image from an (H, W, C) or (H, W) channel array."""
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if arr.ndim != 3:
            raise InvalidImageError("expected (H, W, C) array")
        h, w, c = arr.shape
        if pixel is None:
            pixel = _infer_pixel(arr.dtype, c)
        fmt = pixel_format(pixel)
        if fmt.channels != c or fmt.dtype != arr.dtype:
            raise InvalidImageError(
                f"array {arr.dtype}x{c} does not match pixel format {pixel}"
            )
        img = cls(width=w, height=h, pixel=pixel)
        if arr.size:  # reshape(h, -1) is ambiguous for 0-height arrays
            img.rows()[:] = np.ascontiguousarray(arr).view(np.uint8) \
                .reshape(h, -1)
        return img

    # -- views and copies --------------------------------------------------

    def sub_view(self, x: int, y: int, w: int, h: int) -> "Image":
        """Zero-copy crop sharing this image's buffer (lib/image.js:76-87).

        Unlike the reference (whose Buffer.slice clamps silently), out of
        bounds rectangles are rejected — a negative offset would wrap
        around the buffer and alias wrong rows."""
        if x < 0 or y < 0 or w <= 0 or h <= 0 or \
                x + w > self.width or y + h > self.height:
            raise InvalidImageError("sub_view rectangle out of bounds")
        p = self.pixel_size()
        off = y * self.stride + x * p
        length = (h - 1) * self.stride + w * p
        return Image(
            width=w, height=h, pixel=self.pixel, stride=self.stride,
            data=self.data[off : off + length],
        )

    def copy(self, target: "Image") -> None:
        """Copy the overlapping region into target (lib/image.js:89-96)."""
        if target.pixel != self.pixel:
            raise InvalidImageError("can't copy pixels between different pixel types")
        rw = self.pixel_size() * min(self.width, target.width)
        h = min(self.height, target.height)
        for y in range(h):
            target.data[y * target.stride : y * target.stride + rw] = \
                self.data[y * self.stride : y * self.stride + rw]

    def clone(self) -> "Image":
        out = Image(width=self.width, height=self.height, pixel=self.pixel)
        self.copy(out)
        return out

    # -- comparison oracles (the public parity contract) -------------------

    def equal_pixels(self, other: "Image") -> bool:
        if (self.width != other.width or self.height != other.height
                or self.pixel != other.pixel):
            return False
        return bool(np.array_equal(self.rows(), other.rows()))

    def avg_channel_diff(self, other: "Image") -> float:
        """Mean absolute byte difference over row payloads; 255 when the
        geometries differ (lib/image.js:66-74 — note: per *byte*, so deep
        formats diff their lo/hi bytes independently, as the reference)."""
        if (self.width != other.width or self.height != other.height
                or self.pixel != other.pixel):
            return 255.0
        a = self.rows().astype(np.int32)
        b = other.rows().astype(np.int32)
        if a.size == 0:
            return 0.0
        return float(np.abs(a - b).mean())

    # -- camelCase aliases for reference users -----------------------------

    subView = sub_view
    equalPixels = equal_pixels
    avgChannelDiff = avg_channel_diff
    pixelSize = pixel_size

    @staticmethod
    def pixel_size_of(pixel: str) -> int:
        return pixel_size(pixel)

    def __repr__(self) -> str:
        return (f"Image(width={self.width}, height={self.height}, "
                f"pixel={self.pixel!r}, stride={self.stride})")


def _infer_pixel(dtype: np.dtype, channels: int) -> str:
    for name, fmt in PIXEL_FORMATS.items():
        if fmt.dtype == dtype and fmt.channels == channels:
            return name
    raise InvalidImageError(f"no pixel format for {dtype}x{channels}")
