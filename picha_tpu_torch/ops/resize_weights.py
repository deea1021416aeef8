"""Resize filters and contribution weights (numpy, float32).

The port's copy of the weight functions of `picha_tpu/ops/resize.py`
(the filters and `FILTERS`, `parse_resize_options`, `_iter_contribs`,
`resize_weights`, `BANDED_THRESHOLD`/`banded_resize_plan`,
`resize_windows`) with the reference's float32 arithmetic, so the taps
are the reference's values bit for bit; `tests/test_torch_host_copies.py`
pins each to its original. `ops/resize.py` uploads them.
"""
from __future__ import annotations

import functools
import math

import numpy as np

from ..errors import InvalidImageError, InvalidOptionsError

F32 = np.float32


def _cubic(o):
    o = abs(o)
    return F32(1.0) - F32(o) * F32(o) * (F32(0.75) - F32(0.25) * F32(o))


def _triangle(o):
    return F32(1.0) - F32(abs(o))


def _box(o):
    return F32(1.0)


def _mitchell_family(B, C):
    B, C = F32(B), F32(C)
    A3 = F32((12 - 9 * B - 6 * C) / 6)
    A2 = F32((-18 + 12 * B + 6 * C) / 6)
    A0 = F32((6 - 2 * B) / 6)
    B3 = F32((-B - 6 * C) / 6)
    B2 = F32((6 * B + 30 * C) / 6)
    B1 = F32((-12 * B - 48 * C) / 6)
    B0 = F32((8 * B + 24 * C) / 6)

    def f(o):
        x = F32(abs(o))
        if x < 1:
            return F32(A0 + x * x * (A2 + x * A3))
        return F32(B0 + x * (B1 + x * (B2 + x * B3)))

    return f


def _lanczos2(o):
    x = F32(o) * F32(math.pi)
    x2 = F32(x * x)
    if x2 == 0:
        return F32(1.0)
    return F32(F32(2.0) * F32(math.sin(x)) * F32(math.sin(x / F32(2.0))) / x2)


# name -> (support, filter)
FILTERS = {
    "cubic": (2.0, _cubic),
    "lanczos": (2.0, _lanczos2),
    "catmulrom": (2.0, _mitchell_family(0.0, 0.5)),
    "mitchel": (2.0, _mitchell_family(0.333, 0.333)),
    "box": (0.5, _box),
    "triangle": (1.0, _triangle),
}

DEFAULT_FILTER = "cubic"
DEFAULT_FILTER_SCALE = 0.70


def parse_resize_options(opts: dict):
    """(filter, filterScale) with the reference's defaulting: naming a
    filter resets the scale to 1.0."""
    name = opts.get("filter")
    scale = DEFAULT_FILTER_SCALE
    if name is not None:
        scale = 1.0
        if name not in FILTERS:
            raise InvalidOptionsError("invalid filter mode")
    else:
        name = DEFAULT_FILTER
    fs = opts.get("filterScale", opts.get("filter_scale"))
    if fs is not None:
        try:
            fs = float(fs)
        except (TypeError, ValueError) as e:
            raise InvalidOptionsError("invalid filter width") from e
        if not (fs > 0) or math.isnan(fs):
            raise InvalidOptionsError("invalid filter width")
        scale = fs
    return name, scale


def _iter_contribs(dst_size: int, src_size: int, filter_name: str,
                   filter_scale: float):
    """Yield (i, left, normalised weights) per output, with the
    reference's float32 centre walk, zero-tap trim and sequential
    normalisation."""
    base_support, base = FILTERS[filter_name]
    s = F32(filter_scale)
    support = F32(s * F32(base_support))

    def filt(x):
        return F32(base(F32(x) / s) / s)

    scale = F32(F32(src_size) / F32(dst_size))
    fscale = F32(max(max(scale, F32(1.0)), F32(F32(1.0) / support)))
    fsupport = F32(support * fscale)
    iscale = F32(F32(1.0) / fscale)
    center = F32(F32(0.5) * scale)
    for i in range(dst_size):
        left = int(max(F32(0.0), F32(math.ceil(center - fsupport))))
        right = int(min(F32(src_size - 1), F32(math.floor(center + fsupport))))
        while left < right and filt(F32(center - left) * iscale) == 0:
            left += 1
        while right > left and filt(F32(center - right) * iscale) == 0:
            right -= 1
        taps = np.arange(left, right + 1)
        w = np.array([filt(F32(center - F32(j)) * iscale) for j in taps],
                     dtype=np.float32)
        total = F32(0.0)
        for v in w:
            total = F32(total + F32(v))
        if not total > 0:
            raise InvalidImageError("degenerate resize window")
        yield i, left, w * F32(F32(1.0) / total)
        center = F32(center + scale)


@functools.lru_cache(maxsize=512)
def resize_weights(dst_size: int, src_size: int, filter_name: str,
                   filter_scale: float) -> np.ndarray:
    """Dense (dst_size, src_size) float32 contribution matrix."""
    W = np.zeros((dst_size, src_size), dtype=np.float32)
    for i, left, w in _iter_contribs(dst_size, src_size, filter_name,
                                     filter_scale):
        W[i, left:left + w.size] = w
    return W


BANDED_THRESHOLD = 512  # the banded plan above this source size
BAND_TILE = 64


@functools.lru_cache(maxsize=256)
def banded_resize_plan(dst_size: int, src_size: int, filter_name: str,
                       filter_scale: float, tile: int = BAND_TILE):
    """Banded plan: (starts (T,) int32, weights (T, tile, in_len) f32,
    dst_pad): each tile of `tile` outputs reads one source slice of
    in_len inputs starting at starts[t], clamped inside [0, src)."""
    T = -(-dst_size // tile)
    dst_pad = T * tile
    rows = list(_iter_contribs(dst_size, src_size, filter_name,
                               filter_scale))
    los, his = [], []
    for t in range(T):
        seg = rows[t * tile:(t + 1) * tile]
        if not seg:  # all-zero padding tile
            los.append(0)
            his.append(1)
        else:
            los.append(min(left for _, left, _ in seg))
            his.append(max(left + w.size for _, left, w in seg))
    in_len = min(src_size, max(h - l for l, h in zip(los, his)))
    starts = np.array([min(l, max(0, src_size - in_len)) for l in los],
                      dtype=np.int32)
    weights = np.zeros((T, tile, in_len), np.float32)
    for i, left, w in rows:
        t, r = divmod(i, tile)
        off = left - int(starts[t])
        weights[t, r, off:off + w.size] = w
    return starts, weights, dst_pad


@functools.lru_cache(maxsize=512)
def resize_windows(dst_size: int, src_size: int, filter_name: str,
                   filter_scale: float):
    """Uniform per-output tap windows: (starts int32 (dst,), taps
    float32 (dst, k)) with the reference's weight values, zero-padded
    to the widest window; starts clamped so every window fits."""
    items = list(_iter_contribs(dst_size, src_size, filter_name,
                                filter_scale))
    k = max(w.size for _, _, w in items)
    k = min(k, src_size)
    starts = np.empty(dst_size, np.int32)
    taps = np.zeros((dst_size, k), np.float32)
    for i, left, w in items:
        s = min(max(left, 0), src_size - k)
        starts[i] = s
        taps[i, left - s : left - s + w.size] = w
    return starts, taps
