"""Per-image training augmentations on the device.

Counterpart of `picha_tpu/pipeline/augment.py`. The reference draws its
random numbers from `jax.random` keys inside each function; here every
function takes its draws as explicit tensors, and `draw_augment` makes
them from an explicit `torch.Generator` (the port's own deterministic
stream, which does not reproduce `jax.random`'s bits):

  `brightness(x, f)`          clip(x * f)                 f (N,)
  `contrast(x, f)`            clip((x - m) * f + m), m the per-image grey
                              mean
  `saturation(x, f)`          clip(g + (x - g) * f), g the pixel's grey
  `color_jitter(x, fb, fc, fs)`  the three in that fixed order (None skips)
  `cutout(x, ty, tx, size)`   one size x size square per image set to
                              `fill`, top-left corner (ty, tx), clipped
                              at the borders
  `augment(x, draws, cfg)`    color_jitter, then cutout
  `mixup(x, labels, lam)`     lam = max(lam, 1 - lam); blend with the
                              batch rolled by one (plain torch: a stock
                              elementwise op; the training ingest does
                              not call it)
  `augment_fused(x, draws, cfg)`  the ingest's clip to [0, 1] followed by
                              `augment`: kernel K10 (`csrc/augment.cu`)
                              for CUDA tensors, `augment_fused_plain`
                              for CPU tensors
  `augment_sum_lanes(x, fb)`  the per-image sums of contrast's grey
                              mean in K10's order (its lane-order
                              model); `augment_fused_lanes` the plain
                              chain on that mean: K10's bits
  `kernel_info(shape, cfg, device)`  K10's plan and builds

Batches are (N, H, W, 3) float32 on the 0-1 scale. The grey weights are
the reference's renormalized luma weights (r .299, g .587, b .114).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels._build import KERNELS, aligned, ptr, require_cuda, stream_of

LUMA = np.array([0.299, 0.587, 0.114], np.float32)
LUMA = (LUMA / LUMA.sum()).astype(np.float32)
_L = tuple(float(v) for v in LUMA)

# K10's flags (csrc/augment.cu)
BRIGHTNESS, CONTRAST, SATURATION, CUTOUT = 1, 2, 4, 8
K10_THREADS = 512                      # the sum's threads (csrc/augment.cu)
_BUILD_KEYS = ("registers", "local_bytes", "shared_bytes", "threads",
               "blocks_an_sm")


class AugmentDraws(NamedTuple):
    """One batch's augment draws, (N,) each: brightness, contrast and
    saturation factors (float32, None where that op is off) and the
    cutout corners (int32, None when cutout is off)."""
    fb: Optional[torch.Tensor]
    fc: Optional[torch.Tensor]
    fs: Optional[torch.Tensor]
    ty: Optional[torch.Tensor]
    tx: Optional[torch.Tensor]

    def to(self, device) -> "AugmentDraws":
        return AugmentDraws(*(None if t is None else t.to(device)
                              for t in self))


def augment_config(cfg: Optional[dict]) -> dict:
    """The reference's augment keywords with their defaults."""
    out = {"brightness_s": 0.0, "contrast_s": 0.0, "saturation_s": 0.0,
           "cutout_size": 0, "cutout_fill": 0.0}
    for k, v in dict(cfg or {}).items():
        if k not in out:
            raise TypeError(f"unknown augment option {k!r}")
        out[k] = v
    return out


def draw_augment(gen: torch.Generator, n: int, h: int, w: int,
                 cfg: dict) -> AugmentDraws:
    """The draws of `augment` for n images of h x w from `gen` (a CPU
    generator), in a fixed order: brightness, contrast and saturation
    factors U[1-s, 1+s), then the cutout corners randint(0, h) -
    size // 2 and randint(0, w) - size // 2. Only the enabled ops
    draw."""
    cfg = augment_config(cfg)

    def factors(s):
        if not s:
            return None
        u = torch.rand(n, generator=gen, dtype=torch.float32)
        return (1.0 - s) + (2.0 * s) * u

    fb = factors(cfg["brightness_s"])
    fc = factors(cfg["contrast_s"])
    fs = factors(cfg["saturation_s"])
    ty = tx = None
    size = int(cfg["cutout_size"])
    if size:
        ty = (torch.randint(0, h, (n,), generator=gen) - size // 2).to(
            torch.int32)
        tx = (torch.randint(0, w, (n,), generator=gen) - size // 2).to(
            torch.int32)
    return AugmentDraws(fb, fc, fs, ty, tx)


def _col(f):
    return f.to(torch.float32)[:, None, None, None]


def grey(x):
    """Per-pixel luma (N, H, W): r*L0 + g*L1 + b*L2 in that order."""
    return x[..., 0] * _L[0] + x[..., 1] * _L[1] + x[..., 2] * _L[2]


def brightness(x, f):
    """Per-image scale: clip(x * f, 0, 1)."""
    return (x * _col(f)).clamp(0.0, 1.0)


def contrast(x, f, mean=None):
    """Blend with the per-image grey mean m: clip((x - m) * f + m). `mean`
    (N,), when given, is m (K10's sum order), else torch's mean."""
    m = grey(x).mean(dim=(1, 2)) if mean is None else mean.to(torch.float32)
    m = m[:, None, None, None]
    return ((x - m) * _col(f) + m).clamp(0.0, 1.0)


def saturation(x, f):
    """Blend each pixel with its grey g: clip(g + (x - g) * f)."""
    g = grey(x)[..., None]
    return (g + (x - g) * _col(f)).clamp(0.0, 1.0)


def color_jitter(x, fb=None, fc=None, fs=None, mean=None):
    """brightness -> contrast -> saturation, each skipped when its factors
    are None; `mean` is contrast's."""
    if fb is not None:
        x = brightness(x, fb)
    if fc is not None:
        x = contrast(x, fc, mean)
    if fs is not None:
        x = saturation(x, fs)
    return x


def cutout(x, ty, tx, size: int, fill: float = 0.0):
    """Set one size x size square per image to `fill`: rows ty..ty+size,
    columns tx..tx+size, clipped at the borders (corners may be
    negative)."""
    n, h, w = x.shape[0], x.shape[1], x.shape[2]
    dev = x.device
    dy = torch.arange(h, device=dev)[None, :, None] - ty.to(dev)[:, None,
                                                                 None]
    dx = torch.arange(w, device=dev)[None, None, :] - tx.to(dev)[:, None,
                                                                 None]
    inside = (dy >= 0) & (dy < size) & (dx >= 0) & (dx < size)
    return torch.where(inside[..., None],
                       torch.tensor(fill, dtype=x.dtype, device=dev), x)


def augment(x, draws: AugmentDraws, cfg: dict, mean=None):
    """color_jitter, then cutout when `cfg` has a cutout size."""
    cfg = augment_config(cfg)
    x = color_jitter(x, draws.fb, draws.fc, draws.fs, mean)
    if cfg["cutout_size"]:
        x = cutout(x, draws.ty, draws.tx, int(cfg["cutout_size"]),
                   float(cfg["cutout_fill"]))
    return x


def mixup(x, labels, lam):
    """Batch-level mixup: lam = max(lam, 1 - lam) (the dominant image
    first), then lam * x + (1 - lam) * roll(x, 1). Returns (mixed,
    mixed labels or None, lam). `lam` is a host draw (Beta(alpha,
    alpha), e.g. numpy's `Generator.beta`)."""
    lam = max(float(lam), 1.0 - float(lam))
    mixed = lam * x + (1.0 - lam) * torch.roll(x, 1, dims=0)
    ml = None
    if labels is not None:
        ml = lam * labels + (1.0 - lam) * torch.roll(labels, 1, dims=0)
    return mixed, ml, lam


def _flags(cfg, draws: AugmentDraws) -> int:
    flags = 0
    for bit, t in ((BRIGHTNESS, draws.fb), (CONTRAST, draws.fc),
                   (SATURATION, draws.fs)):
        if t is not None:
            flags |= bit
    if cfg["cutout_size"]:
        flags |= CUTOUT
    return flags


def augment_fused_plain(x, draws: AugmentDraws, cfg: dict, mean=None):
    """Plain torch version of K10: clip(x, 0, 1), then `augment` (with
    contrast's per-image mean `mean` when given)."""
    return augment(x.clamp(0.0, 1.0), draws, cfg, mean)


def augment_sum_lanes(x, fb, threads: int = K10_THREADS):
    """(N, H, W, 3) float32 -> (N,) float32: each image's sum of
    grey(clip(clip(x) * fb)) (fb None: grey(clip(x))) in K10's order, bit
    for bit: `threads` sums, sum t adding pixels t, t + threads, ... of
    the whole image to 0.0 in turn, then a halving tree (sum t += sum t +
    s for s = threads / 2 .. 1). Runs on x's device (elementwise float32
    operations, each rounded)."""
    n, h, w = x.shape[:3]
    hw = h * w
    v = x.reshape(n, hw, 3).clamp(0.0, 1.0)
    if fb is not None:
        v = (v * _col(fb)[:, :, :, 0]).clamp(0.0, 1.0)
    g = grey(v)                                              # (N, hw)
    iters = -(-hw // threads)
    g = torch.nn.functional.pad(g, (0, iters * threads - hw))
    g = g.reshape(n, iters, threads)
    acc = torch.zeros((n, threads), dtype=torch.float32, device=x.device)
    for i in range(iters):                       # + 0.0 pads: exact
        acc = acc + g[:, i]
    s = threads // 2
    while s > 0:
        acc = acc[:, :s] + acc[:, s:2 * s]
        s //= 2
    return acc[:, 0]


def augment_fused_lanes(x, draws: AugmentDraws, cfg: dict, plan: dict):
    """The plain chain on the contrast mean of `augment_sum_lanes` at
    K10's `plan` (`kernel_info(...)["plan"]`): K10's output bits."""
    mean = None
    if draws.fc is not None:
        hw = x.shape[1] * x.shape[2]
        mean = augment_sum_lanes(x, draws.fb, plan["threads"]) / hw
    return augment_fused_plain(x, draws, cfg, mean)


def kernel_info(shape, cfg: dict, device) -> dict:
    """K10's plan for (N, H, W, 3) batches under `cfg` (the chain's CTAs
    an image and threads; with contrast on, the per-image sum first:
    `plan` holds the arguments of `augment_sum_lanes`) and the builds of
    its two kernels (registers, local bytes, shared bytes, threads,
    blocks an SM), asked of `device`'s card."""
    from ..kernels._build import library

    cfg = augment_config(cfg)
    out = (ctypes.c_int * 12)()
    with torch.cuda.device(device):
        rc = library().picha_augment_info(int(shape[1]), int(shape[2]), out)
    if rc != 0:
        raise RuntimeError(f"picha_augment_info: CUDA error {rc}")
    contrast = bool(cfg["contrast_s"])
    return dict(ctas_an_image=out[0], threads=out[1], contrast_sum=contrast,
                apply=dict(zip(_BUILD_KEYS, out[2:7])),
                sum=dict(zip(_BUILD_KEYS, out[7:12])) if contrast else None,
                plan=dict(threads=K10_THREADS))


def augment_fused(x, draws: AugmentDraws, cfg: dict):
    """The ingest's clip after the resize, then the augment chain: (N, H,
    W, 3) float32 -> a new float32 tensor of the same shape. Draws on
    x's device. Launches K10 for CUDA tensors (with contrast on, the
    per-image grey sum in `augment_sum_lanes`' order first, then one
    vectorised pass); the plain version runs only for CPU tensors."""
    cfg = augment_config(cfg)
    if x.device.type == "cpu":
        return augment_fused_plain(x, draws, cfg)
    require_cuda(x, "K10")
    dev = x.device
    if x.dtype != torch.float32 or x.dim() != 4 or x.shape[3] != 3:
        raise TypeError("K10 takes an (N, H, W, 3) float32 batch")
    n, h, w = x.shape[0], x.shape[1], x.shape[2]
    if n > 65535 or h * w > (2**31 - 1) // 12:
        raise ValueError("K10 takes at most 65,535 images of at most "
                         "178,956,970 pixels")
    flags = _flags(cfg, draws)
    for t, dt in ((draws.fb, torch.float32), (draws.fc, torch.float32),
                  (draws.fs, torch.float32), (draws.ty, torch.int32),
                  (draws.tx, torch.int32)):
        if t is not None and (t.device != dev or t.dtype != dt
                              or tuple(t.shape) != (n,)
                              or not t.is_contiguous()):
            raise TypeError("K10 takes (N,) float32 factors and int32 "
                            "cutout corners on the batch's device")
    if flags & CUTOUT and (draws.ty is None or draws.tx is None):
        raise ValueError("K10: cutout is on but the draws carry no corners")
    x = aligned(x)
    out = torch.empty_like(x)
    sums = torch.empty(n, dtype=torch.float32, device=dev)

    def p(t):
        return None if t is None else ptr(t)

    KERNELS["augment"](ptr(x), n, h, w, p(draws.fb), p(draws.fc),
                       p(draws.fs), ptr(sums), p(draws.ty), p(draws.tx),
                       int(cfg["cutout_size"]), float(cfg["cutout_fill"]),
                       flags, *_L, ptr(out), stream_of(x))
    return out
