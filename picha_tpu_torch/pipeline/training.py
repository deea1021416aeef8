"""Training input on the device: batched JPEG decode, random crop, flip,
resize, clip and augment, feeding a model step.

Counterpart of `picha_tpu/pipeline/training.py` (`TrainingInput`,
`_jit_crop_resize_normalize`, `_decode_graph`). Deterministic, seedable
and resumable as the reference is: the stream is a function of (bytes,
seed, epoch, position); save `state()`, rebuild with `state=saved` and it
continues identically.

Per step (one group per shape signature):
  host:    `parse_baseline` -> `scan_wire` (the port's numpy host prep)
           -> one pinned upload
  device:  `wire_unpack` -> Huffman decode (K1 with restart markers, K4 +
           K5 without) -> `split_planes` -> staged decode with
           force_rgb (K6 dequant + IDCT, K7 upsample + colour) -> the
           full frames, (N, H, W, 3) uint8
           -> K9 crop + flip + width pass -> K8 height pass -> K10 clip +
           augment (or a plain clamp when augment is off)
           -> (N, size, size, 3) float32 in [0, 1]

Windows. With `pre_crop=True` the host draws each crop window from
`np.random.default_rng((seed, epoch, pos))` in the reference's order (x
then y, image by image); the card decodes the full frame and crops at
that absolute (x, y). The reference decodes only an iMCU-aligned region
around the window and crops at the residual offset; its own invariant
(`_crop_region`) makes that bit-identical to cropping the full-frame
decode, so both packages see the same crops. With `pre_crop=False` the
offsets come from the port's generator.

The port's random stream. Flips, on-device offsets and augment draws
come from a CPU `torch.Generator` seeded from (seed, epoch, pos) and, on
a mixed-signature batch, the group's index; they are drawn on the CPU and
uploaded, so the stream is the same on the CPU and on the card. All of a
group's draws go through `TrainingInput._draws`. The stream does not
reproduce `jax.random`'s bits.

Fallback. Files `parse_baseline` refuses (progressive, CMYK, ...), a
group past `ScanBatch`'s capacity gates and a decoder `ok` that is false
go through Pillow's decode on the host (`codecs/jpeg_host.py`), a uint8
upload and the same K9 -> K8 -> K10 stages; each such group is counted in
`scan_fallbacks`.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..codecs import jpeg_host
from ..ops.jpeg import _idct_kron, build_decode_stage
from ..ops.jpeg_huffman_decode import (decode_scan, scan_wire, split_planes,
                                       wire_unpack)
from ..ops.jpeg_scan import mcu_slot_tables, parse_baseline
from ..ops.resize import crop_flip_resize_w, resize_axis, window_tensors
from ..ops.scan_batch import split_indices
from ..runtime.device import resolve_device, upload
from .augment import AugmentDraws, augment_config, augment_fused, draw_augment
from .jpeg_batch import HostPixels, bucket_by_signature, pad_group, signature


class StepDraws(NamedTuple):
    """One group's device-side draws, (N,) each: `flip` (bool), the crop
    corners `xs`, `ys` (int32; None when the host drew the windows) and
    the augment draws (None when augment is off)."""
    flip: torch.Tensor
    xs: Optional[torch.Tensor]
    ys: Optional[torch.Tensor]
    aug: Optional[AugmentDraws]


def draw_windows(dims, crop: int, rng) -> np.ndarray:
    """The reference's host window draw (`_pre_crop_host`): for each
    image in order, x = rng.integers(0, width - crop + 1), then y =
    rng.integers(0, height - crop + 1). dims: [(width, height)]. Returns
    (N, 2) int32 [x, y]."""
    out = []
    for width, height in dims:
        x = int(rng.integers(0, width - crop + 1))
        y = int(rng.integers(0, height - crop + 1))
        out.append((x, y))
    return np.asarray(out, np.int32).reshape(len(out), 2)


def crop_resize_normalize(rgb_u8, xs, ys, flip, windows, augment_draws=None,
                          *, crop: int, augment_cfg: Optional[dict] = None):
    """Decoded frames (N, H, W, 3) uint8 -> (N, S, S, 3) float32 in [0,
    1]: crop at (xs, ys), flip where `flip`, unpack by 1/255 and resize
    (K9: crop + flip + width pass; K8: height pass), then clip, with the
    augment chain when `augment_draws` is given (K10), else a plain
    clamp. `windows`: ((starts, taps) of the width axis, then of the
    height axis) for a crop x crop source, on rgb's device."""
    (sw, tw), (sh, th) = windows
    f = crop_flip_resize_w(rgb_u8, xs, ys, flip, crop, sw, tw)
    f = resize_axis(f, sh, th, -3)
    if augment_draws is None:
        return f.clamp_(0.0, 1.0)
    return augment_fused(f, augment_draws, augment_cfg)


def _seed_of(key) -> int:
    """A 64-bit torch seed from a tuple of non-negative ints."""
    return int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0])


class TrainingInput:
    """Deterministic resumable iterator over JPEG bytes.

    >>> ti = TrainingInput(files, batch=256, crop=192, size=224, seed=0)
    >>> batch = next(ti)            # (256, 224, 224, 3) float32 in [0, 1]
    >>> saved = ti.state()
    >>> ti2 = TrainingInput(files, batch=256, crop=192, size=224,
    ...                     state=saved)   # continues identically
    """

    def __init__(self, items: Sequence[bytes], batch: int, crop: int,
                 size: int, seed: int = 0, filter: str = "cubic",
                 filter_scale: float = 1.0, state: Optional[dict] = None,
                 num_threads: int = 8, augment: Optional[dict] = None,
                 pre_crop: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.items = list(items)
        self.batch = batch
        self.crop = crop
        self.size = size
        self.filter = filter
        self.fscale = filter_scale
        self.num_threads = num_threads
        self.pre_crop = pre_crop
        self.augment = augment_config(augment) if augment else None
        self.scan_fallbacks = 0
        win = window_tensors(size, crop, filter, filter_scale, self.device)
        self._windows = (win, win)
        self._kron = torch.as_tensor(_idct_kron()).to(self.device)
        self._consts = {}
        if state is not None:
            # a reference state() may carry "ks_high" (its jit-key
            # floors); nothing here depends on it
            self.seed = state["seed"]
            self.epoch = state["epoch"]
            self.pos = state["pos"]
        else:
            self.seed = seed
            self.epoch = 0
            self.pos = 0
        self._perm = self._epoch_perm()

    def state(self) -> dict:
        return {"seed": self.seed, "epoch": self.epoch, "pos": self.pos}

    def _epoch_perm(self):
        rng = np.random.default_rng((self.seed, self.epoch))
        return rng.permutation(len(self.items))

    def __iter__(self):
        return self

    def __next__(self):
        if self.pos + self.batch > len(self.items):
            self.epoch += 1
            self.pos = 0
            self._perm = self._epoch_perm()
        epoch, pos = self.epoch, self.pos
        idx = self._perm[pos:pos + self.batch]
        self.pos += self.batch
        return self.step(epoch, pos, [self.items[i] for i in idx])

    # -- one step ------------------------------------------------------------

    def _draws(self, epoch: int, pos: int, group: Optional[int], n: int,
               width: int, height: int) -> StepDraws:
        """The device-side draws of one group of n images of width x
        height (group None on a one-signature batch), from a CPU
        generator seeded by (seed, epoch, pos[, group]): flips, then the
        crop corners (pre_crop=False), then the augment draws."""
        key = (self.seed, epoch, pos) + (() if group is None else (group,))
        gen = torch.Generator()
        gen.manual_seed(_seed_of(key))
        flip = torch.randint(0, 2, (n,), generator=gen).bool()
        xs = ys = None
        if not self.pre_crop:
            xs = torch.randint(0, width - self.crop + 1, (n,), generator=gen,
                               dtype=torch.int32)
            ys = torch.randint(0, height - self.crop + 1, (n,),
                               generator=gen, dtype=torch.int32)
        aug = None
        if self.augment is not None:
            aug = draw_augment(gen, n, self.size, self.size, self.augment)
        return StepDraws(flip, xs, ys, aug)

    def plan(self, epoch: int, pos: int, bufs):
        """The host side of a step: (groups, windows). groups: [(signature,
        input indices, items (padded to a multiple of 8 on a mixed
        batch), draws)], items being parsed scans or host pixels;
        windows: (N, 2) int32 host-drawn [x, y] (pre_crop) or None."""
        cos = [parse_baseline(bytes(b)) for b in bufs]
        refused = [b for b, c in zip(bufs, cos) if c is None]
        pixels = iter(self._host_decode(refused))
        cos = [next(pixels) if c is None else c for c in cos]
        for c, b in zip(cos, bufs):
            if not isinstance(c, HostPixels):
                c.src = b
        dims = [_dims(c) for c in cos]
        if any(min(w, h) < self.crop for w, h in dims):
            raise ValueError("crop larger than image")
        windows = None
        if self.pre_crop:
            windows = draw_windows(
                dims, self.crop, np.random.default_rng((self.seed, epoch,
                                                        pos)))
        buckets = bucket_by_signature(cos)
        if len(buckets) == 1:
            sig, idxs, items = buckets[0]
            return [(sig, idxs, items, self._draws(
                epoch, pos, None, len(items), sig[0], sig[1]))], windows
        groups = []
        for gi, (sig, idxs, items) in enumerate(buckets):
            padded, _n = pad_group(items)
            groups.append((sig, idxs, padded, self._draws(
                epoch, pos, gi, len(padded), sig[0], sig[1])))
        return groups, windows

    def step(self, epoch: int, pos: int, bufs):
        """One batch of JPEG bytes at stream position (epoch, pos) ->
        (N, size, size, 3) float32 on the device, in input order."""
        groups, windows = self.plan(epoch, pos, bufs)
        if len(groups) == 1:
            _sig, _idxs, items, draws = groups[0]
            return self._run_group(items, draws, windows)
        parts, order = [], []
        for _sig, idxs, items, draws in groups:
            gwin = None
            if windows is not None:
                gwin = np.zeros((len(items), 2), np.int32)
                gwin[:len(idxs)] = windows[np.asarray(idxs)]
            parts.append(self._run_group(items, draws, gwin)[:len(idxs)])
            order.extend(idxs)
        inv = torch.as_tensor(np.argsort(np.asarray(order)),
                              device=self.device)
        return torch.cat(parts, dim=0)[inv]

    # -- device stages -------------------------------------------------------

    def _host_decode(self, bufs):
        """Pillow's decode of files the device decoder does not take."""
        if not bufs:
            return []
        with ThreadPoolExecutor(max_workers=max(1, self.num_threads)) as ex:
            return [HostPixels(p, bytes(b)) for p, b in
                    zip(ex.map(jpeg_host.decode_rgb, bufs), bufs)]

    def decode(self, items):
        """A group's full frames on the device: (rgb (N, H, W, 3) uint8,
        ok) with ok the decoder's flag (a device bool) or None for host
        pixels; None when the scans are past ScanBatch's capacity
        gates."""
        if isinstance(items[0], HostPixels):
            rgb = upload(np.stack([c.pixels for c in items]), self.device)
            if rgb.shape[-1] == 1:
                rgb = rgb.expand(*rgb.shape[:-1], 3).contiguous()
            return rgb, None
        try:
            ks, wire = scan_wire(items)
        except ValueError:
            return None
        sig = signature(items[0])
        width, height, cs, comp_sig = sig
        if sig not in self._consts:
            self._consts[sig] = (
                torch.as_tensor(mcu_slot_tables(comp_sig)).to(
                    self.device, torch.int32),
                [torch.as_tensor(i).to(self.device, torch.int64)
                 for i in split_indices(comp_sig)])
        comp_of, split_idx = self._consts[sig]
        dargs, qtabs = wire_unpack(upload(wire, self.device), ks,
                                   len(comp_sig))
        coefs, ok = decode_scan(dargs, ks, comp_of)
        planes = split_planes(coefs, comp_sig, split_idx)
        del coefs   # int32, 3.2 GB at 256 x 1080p: free it before K6 runs
        stage = build_decode_stage(comp_sig, cs, width, height,
                                   force_rgb=True)
        return stage(planes, qtabs, self._kron), ok

    def _run_group(self, items, draws: StepDraws, windows):
        if isinstance(items[0], HostPixels):
            self.scan_fallbacks += 1
        dec = self.decode(items)
        if dec is None:     # past ScanBatch's capacity gates
            return self._run_group(
                self._host_decode([c.src for c in items]), draws, windows)
        rgb, ok = dec
        dev = self.device
        if windows is not None:
            xs = torch.as_tensor(windows[:, 0]).to(dev)
            ys = torch.as_tensor(windows[:, 1]).to(dev)
        else:
            xs, ys = draws.xs.to(dev), draws.ys.to(dev)
        aug = None if draws.aug is None else draws.aug.to(dev)
        out = crop_resize_normalize(
            rgb, xs, ys, draws.flip.to(dev), self._windows, aug,
            crop=self.crop, augment_cfg=self.augment)
        if ok is not None and not bool(ok):
            # the device decoder flagged the group: redo it from Pillow's
            # pixels with the same draws and windows
            return self._run_group(
                self._host_decode([c.src for c in items]), draws, windows)
        return out


def _dims(co):
    """(width, height) of a parsed scan or host pixels."""
    if isinstance(co, HostPixels):
        return co.pixels.shape[1], co.pixels.shape[0]
    return co.width, co.height
