"""Kernel loader seam: nvcc build at first use, ctypes binding, launch
counts (see `_build`)."""

from ._build import KERNELS, launch_counts, reset_launch_counts  # noqa: F401
