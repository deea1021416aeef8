"""Device resolution, timing and card identification."""

from .device import CudaTimer, card_id, resolve_device, upload  # noqa: F401
