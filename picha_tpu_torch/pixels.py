"""Pixel-format model and the normalised-float pack/unpack numerics.

Counterpart of `picha_tpu/pixels.py`: the same eight formats, with their
byte and channel geometry (a copy of the reference's table, pinned by
`tests/test_torch_host_copies.py`), and the pack/unpack rules as torch
functions:

  unpack: u / MAX                            (an IEEE division, not a
                                              multiply by 1/MAX)
  pack:   floor(clip(f * MAX + 0.5, 0, MAX)) (product and sum each
                                              rounded to f32)

`unpack_f32` and `pack_f32` are the plain versions of the two ends of
kernel K11 (`ops/colorconvert.py::pixel_map`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .errors import InvalidOptionsError


@dataclasses.dataclass(frozen=True)
class PixelFormat:
    name: str
    bytes_per_pixel: int
    channels: int
    dtype: np.dtype  # per-channel storage dtype

    @property
    def max_value(self) -> int:
        return int(np.iinfo(self.dtype).max)

    @property
    def is_deep(self) -> bool:
        return self.dtype == np.uint16

    @property
    def has_alpha(self) -> bool:
        return self.channels in (2, 4)

    @property
    def is_color(self) -> bool:
        return self.channels in (3, 4)


_U8 = np.dtype(np.uint8)
_U16 = np.dtype(np.uint16)

PIXEL_FORMATS: dict[str, PixelFormat] = {
    "rgb": PixelFormat("rgb", 3, 3, _U8),
    "rgba": PixelFormat("rgba", 4, 4, _U8),
    "grey": PixelFormat("grey", 1, 1, _U8),
    "greya": PixelFormat("greya", 2, 2, _U8),
    "r16": PixelFormat("r16", 2, 1, _U16),
    "r16g16": PixelFormat("r16g16", 4, 2, _U16),
    "r16g16b16": PixelFormat("r16g16b16", 6, 3, _U16),
    "r16g16b16a16": PixelFormat("r16g16b16a16", 8, 4, _U16),
}

# 8-bit <-> deep (16-bit) pairings by channel count.
DEEP_OF = {"grey": "r16", "greya": "r16g16", "rgb": "r16g16b16",
           "rgba": "r16g16b16a16"}
SHALLOW_OF = {v: k for k, v in DEEP_OF.items()}


def pixel_format(name: str) -> PixelFormat:
    try:
        return PIXEL_FORMATS[name]
    except KeyError:
        raise InvalidOptionsError(f"invalid pixel format {name}") from None


def pixel_size(name: str) -> int:
    """Bytes per pixel, 0 for unknown names."""
    fmt = PIXEL_FORMATS.get(name)
    return fmt.bytes_per_pixel if fmt else 0


# torch has uint16 tensors, but few CPU ops take them: the port stores
# 16-bit channels as uint16 and widens to int32 before any arithmetic
TORCH_DTYPE = {np.dtype(np.uint8): torch.uint8,
               np.dtype(np.uint16): torch.uint16}
MAX_OF = {torch.uint8: 255, torch.uint16: 65535}


def unpack_f32(x: torch.Tensor) -> torch.Tensor:
    """uint8 / uint16 channels -> float32 in [0, 1] by an IEEE division
    (the reference's `junpack_f32`); float32 passes through. The divisor
    is a tensor on x's device: torch's CUDA division by a Python scalar
    multiplies by its reciprocal, which differs from v / MAX on 126 of
    the 256 uint8 values."""
    if x.dtype == torch.float32:
        return x
    maxv = MAX_OF.get(x.dtype)
    if maxv is None:
        raise TypeError(f"unpack_f32 takes uint8, uint16 or float32, "
                        f"not {x.dtype}")
    return x.to(torch.int32).to(torch.float32) / torch.tensor(
        float(maxv), dtype=torch.float32, device=x.device)


def pack_f32(f: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 [0, 1] -> uint8 / uint16 channels, round half up with a
    clamp (the reference's `jpack`): floor(clip(f*MAX + 0.5, 0, MAX))."""
    maxv = float(MAX_OF[dtype])
    scaled = f.to(torch.float32) * maxv + 0.5
    return torch.floor(scaled.clamp(0.0, maxv)).to(torch.int32).to(dtype)
