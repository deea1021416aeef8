"""Batched pipelines of the port (counterpart of picha_tpu/pipeline/).

  JpegBatchPipeline — decode -> resize -> {uint8 | re-encode} on one
  device; the JPEG transcode path, with the reference's uploads and
  encode backends.
  TrainingInput — decode -> random crop + flip -> resize -> clip (+
  augment) on one device; the training ingest.
  ImageBatchPipeline — host decode (Pillow) -> crop -> resize -> convert
  on one device (K11, K8) -> host encode; BASELINE config 4.
  encode_filtered — batched PNG encode (8- and 16-bit) with the filter
  pass on the device (K12), deflate on the host.
  PngBatchPipeline — host inflate -> unfilter (K13) -> spec transforms
  (K14) on one device.
  TiffBatchPipeline — host IFD parse and strips -> LZW (K15) -> sample
  transforms and orientation (K16) on one device.
"""

from .image_batch import ImageBatchPipeline  # noqa: F401
from .jpeg_batch import JpegBatchPipeline, device_constants  # noqa: F401
from .png_batch import PngBatchPipeline, encode_filtered  # noqa: F401
from .tiff_batch import TiffBatchPipeline  # noqa: F401
from .training import TrainingInput  # noqa: F401
