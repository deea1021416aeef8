"""Batched pipelines of the port (counterpart of picha_tpu/pipeline/).

  JpegBatchPipeline — decode -> resize -> {uint8 | re-encode} on one
  device; the all-device JPEG transcode path.
  TrainingInput — decode -> random crop + flip -> resize -> clip (+
  augment) on one device; the training ingest.
"""

from .jpeg_batch import JpegBatchPipeline, device_constants  # noqa: F401
from .training import TrainingInput  # noqa: F401
