"""picha_tpu_torch — the PyTorch/CUDA port of picha_tpu for one NVIDIA H100.

The JAX package `picha_tpu` stays the reference: every module here names
its counterpart there, and the tests feed the same numpy inputs to both.
This package imports `torch` and never `jax`; it reuses picha_tpu's
numpy-only host modules (header parse, scan wire layout, weight folds,
libjpeg bindings) instead of copying them.

Ported so far: the all-device JPEG transcode path
(`pipeline.JpegBatchPipeline(fused=True, upload="scan",
encode_backend="device")`), with hand-written CUDA kernels (`csrc/`):
Huffman decode of restart segments (K1) and of scans without restart
markers (speculative chunked decode K4 and its DC scan K5), the encoder
front (K2: colour convert, downsample, fDCT, quantise) and Huffman scan
encode (K3).
"""

__version__ = "0.1.0"
