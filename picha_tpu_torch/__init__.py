"""picha_tpu_torch — the PyTorch/CUDA port of picha_tpu for one NVIDIA H100.

The JAX package `picha_tpu` stays the reference: every module here names
its counterpart there, and the tests feed the same numpy inputs to both.
This package imports `torch` and never `jax`, and nothing of
`picha_tpu`: it keeps its own copies of the host code it needs (header
parse, scan wire, weight folds, pixel formats, the Image model, PNG
chunks), each pinned to its original by `tests/test_torch_host_copies.py`,
and its host codecs go through Pillow (`codecs/`).

Ported so far, with hand-written CUDA kernels (`csrc/`, built by nvcc at
first use):
- the JPEG transcode, `pipeline.JpegBatchPipeline` (fused or staged
  pixel path; every upload and encode backend of the reference, with its
  defaults): Huffman decode of restart segments (K1) and of scans
  without restart markers (K4, with its DC scan K5), the encoder front
  (K2) and the Huffman scan encode (K3); the staged decode's dequant +
  IDCT (K6), upsample + colour (K7) and the resize, one axis per launch
  (K8); the host-coefficient uploads' restores (K27-K30) behind a host
  C++ entropy decoder and packers; the raw420 encode's 4:2:0 pack (K31)
  and, for "raw420" and "tpu", a host C++ JPEG writer (libjpeg's islow
  fDCT, quantisation and Huffman scan, no libjpeg);
- the training ingest, `pipeline.TrainingInput`: crop + flip + width
  pass (K9), clip + augment (K10);
- the pixel-array path: unpack, crop window, channel map and pack (K11)
  behind `resize_sync` / `color_convert_sync` and
  `pipeline.ImageBatchPipeline` (BASELINE config 4), and the PNG encode
  filters with the adaptive pick (K12) behind
  `pipeline.encode_filtered`;
- the batched PNG and TIFF decode, `pipeline.PngBatchPipeline` and
  `pipeline.TiffBatchPipeline`: the PNG unfilter (K13) and spec
  transforms (K14), the TIFF LZW strips (K15) and transforms (K16);
- the ViT that consumes the ingest's batches, `models.vit.ViT` (the
  forward pass, dense and switch-MoE; bf16 products through
  `torch.matmul`): LayerNorm (K17), attention (K18), the MoE's route +
  dispatch (K19) and combine (K20); and its train step,
  `models.vit.make_train_step`, whose backward runs K21-K24 (the
  backwards of K17-K20) with cuBLAS for the products, `optim.adamw`
  (optax's AdamW in plain torch) and `models.checkpoint` (the
  reference's npz format);
- the ResNet that consumes them too, `models.resnet.ResNet` (the
  forward pass; bf16 convolutions through cuDNN with the reference's
  SAME padding): instance norm + scale + ReLU (K25); and its train step,
  `models.resnet.make_train_step`, whose backward runs K26 (K25's
  backward) with cuDNN for the convolutions, and the same AdamW and
  checkpoint.

The public single-image functions below run on the card unless
`device="cpu"` is asked for; the async forms run on a pool thread and
return a Future (or call `cb(err, result)`).
"""
from __future__ import annotations

from typing import Callable, Optional

from .errors import (CodecError, InvalidImageError, InvalidOptionsError,
                     PichaError, UnsupportedFormatError)
from .image import Image
from .ops.colorconvert import color_convert_image
from .ops.resize import resize_image
from .runtime.executor import run_async

__version__ = "0.1.0"

__all__ = [
    "Image", "PichaError", "InvalidImageError", "InvalidOptionsError",
    "UnsupportedFormatError", "CodecError",
    "resize", "resizeSync", "resize_sync",
    "colorConvert", "colorConvertSync", "color_convert", "color_convert_sync",
]


def resize_sync(img: Image, opts: dict, device="cuda") -> Image:
    return resize_image(img, opts, device)


def resize(img: Image, opts: dict, cb: Optional[Callable] = None,
           device="cuda"):
    return run_async(lambda: resize_image(img, opts, device), cb)


def color_convert_sync(img: Image, opts: dict, device="cuda") -> Image:
    return color_convert_image(img, opts, device)


def color_convert(img: Image, opts: dict, cb: Optional[Callable] = None,
                  device="cuda"):
    return run_async(lambda: color_convert_image(img, opts, device), cb)


resizeSync = resize_sync
colorConvert = color_convert
colorConvertSync = color_convert_sync
