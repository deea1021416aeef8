"""Device resolution, timing and card identification."""

from .device import (CudaTimer, card_id, resolve_device,  # noqa: F401
                     to_device, upload)
