"""Device resolution, CUDA-event timing and card identification.

Counterpart of the device plumbing in `picha_tpu/runtime/` (there JAX
picks its backend; here the caller names the device). Asking for a CUDA
device where there is no card raises: nothing here falls back to the
CPU on its own.
"""
from __future__ import annotations

import subprocess

import numpy as np
import torch


def upload(arr, device: torch.device) -> torch.Tensor:
    """A host numpy array -> a tensor on `device`: through pinned memory
    and asynchronous on CUDA, the array's own memory on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def to_device(arr, device: torch.device) -> torch.Tensor:
    """A host numpy array or a tensor -> a tensor on `device` (numpy
    through `upload`; a tensor already there is returned as it is)."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    return upload(np.asarray(arr), device)


def resolve_device(device="cuda") -> torch.device:
    """`device` (str or torch.device) -> torch.device. Raises
    RuntimeError when a CUDA device is asked for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                f"False; pass device='cpu' to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class CudaTimer:
    """Times the work enqueued inside a `with` block on the current
    stream with CUDA events; `ms` is read after the block (it
    synchronises on the end event)."""

    def __init__(self):
        self._start = torch.cuda.Event(enable_timing=True)
        self._end = torch.cuda.Event(enable_timing=True)
        self.ms = None

    def __enter__(self):
        self._start.record()
        return self

    def __exit__(self, *exc):
        self._end.record()
        self._end.synchronize()
        self.ms = self._start.elapsed_time(self._end)
        return False


def card_id() -> str:
    """The card's name and power limit, exactly as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints them (one line per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
