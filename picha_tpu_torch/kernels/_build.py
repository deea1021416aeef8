"""Build and bind the hand-written CUDA kernels (`picha_tpu_torch/csrc/`).

Route: `nvcc` compiles every `csrc/*.cu` for sm_90a (one process per
source, all at once) and links them into one shared library with a
plain C interface, loaded with ctypes. Pointers and the
stream go across as `c_void_p`, sizes as `c_int` (`c_int64` where a
size may pass 2^31), scales as `c_float`. Every C entry point
launches on the caller's stream, does not synchronise, and returns
`cudaGetLastError()`; `Kernel.__call__` raises when that is not 0.

The build runs at first use, from the sources in this checkout only,
into `csrc/build/` (gitignored). The library name carries a hash of the
sources and flags, so an edited source rebuilds and concurrent
processes never load a half-written file. Importing this module needs
no nvcc and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
Z = ctypes.c_size_t

# C entry point -> argument types (a kernel's stream is always last; the
# picha_host_* functions are host code and take none)
SIGNATURES = {
    "picha_huffman_decode_restart": [
        P, P, P, P, P, P, P, P, I, P, P, I, I, I, I, I, P, P, I, P, P],
    "picha_huffman_decode_restart_info": [I, I, P],
    "picha_jpeg_encode_front": [
        P, I, I, I, I, P, P, P, P, P, P, I, I, I, I, P],
    "picha_jpeg_encode_front_info": [I, P],
    "picha_huffman_encode_scan": [
        P, P, P, I, I, I, I, I, I, P, P, P, P, P, P, I, P, L, P, I, P, P],
    "picha_huffman_encode_scan_info": [P],
    "picha_huffman_decode_chunked": [
        P, P, P, P, P, P, P, P, P, P, I, P, P, I, I, I, I, I, I, I, P, P, L,
        P, P],
    "picha_huffman_decode_chunked_info": [I, I, P],
    "picha_dc_integrate": [P, P, P, I, I, I, P, P],
    "picha_idct_plane": [P, I, P, P, I, I, I, I, I, P, P],
    "picha_idct_plane_info": [I, P],
    "picha_upsample_color": [P, P, P, P, *[I] * 16, I, I, I, I, I, P, P],
    "picha_upsample_color_build": [I] * 10,
    "picha_upsample_color_info": [I, P],
    "picha_resize_axis": [P, I, L, I, I, L, P, P, I, F, F, P, I, I, P],
    "picha_resize_2d": [P, I, L, I, I, I, I, I, P, P, I, P, P, I, F, F, P,
                        I, I, I, I, I, P],
    "picha_resize_info": [I, I, I, I, I, P],
    "picha_crop_flip_resize_w": [P, I, I, I, I, P, P, P, I, P, P, I, I, F,
                                 P, P],
    "picha_crop_flip_resize": [P, I, I, I, I, P, P, P, I, I, I, P, P, I, P,
                               P, I, F, P, I, I, I, I, I, P],
    "picha_augment": [P, I, I, I, P, P, P, P, P, P, I, F, I, F, F, F, P, P],
    "picha_augment_info": [I, I, P],
    "picha_pixel_map": [P, I, L, I, I, I, I, I, I, I, I, I, F, F, F, P, P],
    "picha_png_filter": [P, I, I, I, I, I, I, P, L, P],
    "picha_png_filter_info": [L, I, I, I, P],
    "picha_png_unfilter": [P, L, I, I, I, I, P, P, P],
    "picha_png_unfilter_info": [I, I, I, I, P],
    "picha_png_transform": [P, I, I, I, I, I, P, P, I, I, I, P, P],
    "picha_png_transform_info": [I, I, I, I, I, P],
    "picha_lzw_decode": [P, P, P, P, P, I, P, P, P, P],
    "picha_lzw_decode_info": [P],
    "picha_tiff_transform": [P, I, I, I, L, I, I, I, I, I, I, I, P, P, P],
    "picha_tiff_transform_info": [I, I, I, I, I, I, P],
    "picha_vit_layernorm": [P, P, P, L, I, P, P],
    "picha_vit_layernorm_info": [L, I, P],
    "picha_vit_attention": [P, I, I, I, I, F, I, P, P],
    "picha_vit_attention_info": [I, I, I, P],
    "picha_moe_route_dispatch": [P, P, L, I, I, I, P, L, P, P, P, P, P, P],
    "picha_moe_route_dispatch_info": [P],
    "picha_moe_combine": [P, P, P, P, L, I, I, I, P, P],
    "picha_vit_layernorm_bwd": [P, P, P, L, I, P, P, L, P, P, P],
    "picha_vit_layernorm_bwd_info": [L, I, P],
    "picha_vit_attention_bwd": [P, P, I, I, I, I, F, I, P, P, P, P],
    "picha_vit_attention_bwd_info": [I, I, I, P],
    "picha_moe_dispatch_bwd": [P, P, P, P, P, L, I, I, I, P, P, P],
    "picha_moe_combine_bwd": [P, P, P, P, P, L, I, I, I, P, P, P],
    "picha_resnet_norm": [P, P, I, L, I, P, P, P],
    "picha_resnet_norm_info": [L, I, I, P],
    "picha_resnet_div_check": [P, P, L, P, P],
    "picha_resnet_norm_bwd": [P, P, P, P, P, I, L, I, P, P, P, P],
    "picha_resnet_norm_bwd_info": [L, I, I, P],
    "picha_coef_densify": [P, P, L, L, L, P, P],
    "picha_coef_int8_restore": [P, L, P, P, L, P, P],
    "picha_coef_gap8_restore": [P, P, L, L, L, P, P, L, P, P, L, P],
    "picha_coef_gap4_restore": [P, P, P, L, L, L, L, P, P, L, P, P, L, P],
    "picha_coef_tiles_info": [P],
    "picha_host_entropy_segments": [P, P, I, L, L, L, I, *[P] * 11, I, I, P],
    "picha_host_gap8_pack": [P, Z, P, P, P, P, P, P],
    "picha_host_gap4_batch_begin": [P, I, Z, P, P, P, P],
    "picha_host_gap4_batch_finish": [P, P, Z, P, P, Z, P, P, Z],
    "picha_yuv420_pack": [P, I, I, I, I, I, P, P],
    "picha_host_jpeg_write_coefficients": [I, P, P, P, P, P, P, P, L, P],
    "picha_host_jpeg_write_raw420": [P, P, P, I, I, P, P, P, P, L, P],
}

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "building the CUDA kernels needs nvcc (CUDA_HOME/bin or PATH)")
    return found


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpicha_kernels-{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile csrc/*.cu unless this exact source set is built already:
    one nvcc per source, all started together, then one link. Raises
    RuntimeError with nvcc's diagnostics on failure."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *compile_flags, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [(p.args[-1], p.communicate()[0], p.returncode) for p in procs]
        failed = [f"{src} ({rc}):\n{log}" for src, log, rc in logs if rc]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", lib, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({res.returncode}):\n{res.stdout}\n"
                f"{res.stderr}")
        os.replace(lib, path)
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.picha_cuda_error_string.argtypes = [ctypes.c_int]
            lib.picha_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


class Kernel:
    """One C entry point with its launch count. `launches` counts the
    calls that launched the kernel and returned cudaSuccess."""

    def __init__(self, name: str, symbol: str, source: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.source = source        # path in the repo
        self.replaces = replaces    # the JAX function it replaces
        self.launches = 0

    def __call__(self, *args):
        lib = library()
        rc = getattr(lib, self.symbol)(*args)
        if rc != 0:
            msg = lib.picha_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} ({msg})")
        self.launches += 1


KERNELS = {
    k.name: k for k in (
        Kernel("huffman_decode_restart", "picha_huffman_decode_restart",
               "picha_tpu_torch/csrc/huffman_decode_restart.cu",
               "picha_tpu/ops/jpeg_huffman_decode_tpu.py:428"),
        Kernel("jpeg_encode_front", "picha_jpeg_encode_front",
               "picha_tpu_torch/csrc/jpeg_encode_front.cu",
               "picha_tpu/ops/jpeg_tpu.py:385"),
        Kernel("huffman_encode_scan", "picha_huffman_encode_scan",
               "picha_tpu_torch/csrc/huffman_encode_scan.cu",
               "picha_tpu/ops/jpeg_huffman_tpu.py:173"),
        Kernel("huffman_decode_chunked", "picha_huffman_decode_chunked",
               "picha_tpu_torch/csrc/huffman_decode_chunked.cu",
               "picha_tpu/ops/jpeg_huffman_decode_tpu.py:428 "
               "(single_pass=False)"),
        Kernel("dc_integrate", "picha_dc_integrate",
               "picha_tpu_torch/csrc/huffman_decode_chunked.cu",
               "picha_tpu/ops/jpeg_huffman_decode_tpu.py:1218"),
        Kernel("idct_plane", "picha_idct_plane",
               "picha_tpu_torch/csrc/jpeg_idct_plane.cu",
               "picha_tpu/ops/jpeg_tpu.py:66"),
        Kernel("upsample_color", "picha_upsample_color",
               "picha_tpu_torch/csrc/jpeg_upsample_color.cu",
               "picha_tpu/ops/jpeg_tpu.py:140 (with :177, :190, :199 and "
               ":234-260)"),
        Kernel("resize_axis", "picha_resize_axis",
               "picha_tpu_torch/csrc/resize_axis.cu",
               "picha_tpu/ops/resize.py:296 (and resize_f32 :330)"),
        Kernel("resize_2d", "picha_resize_2d",
               "picha_tpu_torch/csrc/resize_axis.cu",
               "picha_tpu/ops/resize.py:330 (resize_f32: _apply_axis :296 "
               "on the width, then on the height, in one launch)"),
        Kernel("crop_flip_resize", "picha_crop_flip_resize",
               "picha_tpu_torch/csrc/resize_axis.cu",
               "picha_tpu/pipeline/training.py:64 (crop, flip, unpack and "
               "resize_f32's width and height passes, :64-70, in one "
               "launch)"),
        Kernel("crop_flip_resize_w", "picha_crop_flip_resize_w",
               "picha_tpu_torch/csrc/crop_resize.cu",
               "picha_tpu/pipeline/training.py:64 (crop, flip, unpack and "
               "the width pass of resize_f32, :64-70; the per-axis route "
               "of windows no tile holds)"),
        Kernel("augment", "picha_augment", "picha_tpu_torch/csrc/augment.cu",
               "picha_tpu/pipeline/augment.py:105 (with :42-89, and the "
               "clip of training.py:70)"),
        Kernel("pixel_map", "picha_pixel_map",
               "picha_tpu_torch/csrc/pixel_map.cu",
               "picha_tpu/pixels.py:112 (junpack_f32, jpack :119), "
               "ops/colorconvert.py:136 (_jit_convert, map_channels :66) "
               "and pipeline/image_batch.py:27 (_jit_transform)"),
        Kernel("png_filter", "picha_png_filter",
               "picha_tpu_torch/csrc/png_filter.cu",
               "picha_tpu/ops/png_filter_tpu.py:33 (_build)"),
        Kernel("png_unfilter", "picha_png_unfilter",
               "picha_tpu_torch/csrc/png_unfilter.cu",
               "picha_tpu/native/src/pngfilter.cc:209 (picha_png_unfilter, "
               "a native host stage; called at picha_tpu/codecs/png.py:169)"),
        Kernel("png_transform", "picha_png_transform",
               "picha_tpu_torch/csrc/png_transform.cu",
               "picha_tpu/pipeline/png_batch.py:38 (_jit_transform)"),
        Kernel("lzw_decode", "picha_lzw_decode",
               "picha_tpu_torch/csrc/lzw_decode.cu",
               "picha_tpu/native/src/lzw.cc:85 (picha_lzw_decode, and "
               "lzw_decode_multi :176; native host stages called at "
               "picha_tpu/codecs/tiff.py:158 and :312)"),
        Kernel("tiff_transform", "picha_tiff_transform",
               "picha_tpu_torch/csrc/tiff_transform.cu",
               "picha_tpu/pipeline/tiff_batch.py:139 (_jit_transform)"),
        Kernel("vit_layernorm", "picha_vit_layernorm",
               "picha_tpu_torch/csrc/vit_layernorm.cu",
               "picha_tpu/models/vit.py:145 (_ln)"),
        Kernel("vit_attention", "picha_vit_attention",
               "picha_tpu_torch/csrc/vit_attention.cu",
               "picha_tpu/models/vit.py:171-180 (forward's attention)"),
        Kernel("moe_route_dispatch", "picha_moe_route_dispatch",
               "picha_tpu_torch/csrc/vit_moe.cu",
               "picha_tpu/models/vit.py:211-224 (_switch_moe's softmax, "
               "top-1, slots and dispatch scatter)"),
        Kernel("moe_combine", "picha_moe_combine",
               "picha_tpu_torch/csrc/vit_moe.cu",
               "picha_tpu/models/vit.py:228-230 (_switch_moe's combine "
               "gather)"),
        Kernel("vit_layernorm_bwd", "picha_vit_layernorm_bwd",
               "picha_tpu_torch/csrc/vit_layernorm_bwd.cu",
               "picha_tpu/models/vit.py:145-152 (the VJP of _ln in "
               "jax.value_and_grad(loss_fn), :255)"),
        Kernel("vit_attention_bwd", "picha_vit_attention_bwd",
               "picha_tpu_torch/csrc/vit_attention_bwd.cu",
               "picha_tpu/models/vit.py:171-180 (the VJP of forward's "
               "attention in jax.value_and_grad(loss_fn), :255)"),
        Kernel("moe_dispatch_bwd", "picha_moe_dispatch_bwd",
               "picha_tpu_torch/csrc/vit_moe_bwd.cu",
               "picha_tpu/models/vit.py:213-224 (the VJP of _switch_moe's "
               "router softmax / max and dispatch scatter, :255)"),
        Kernel("moe_combine_bwd", "picha_moe_combine_bwd",
               "picha_tpu_torch/csrc/vit_moe_bwd.cu",
               "picha_tpu/models/vit.py:228-230 (the VJP of _switch_moe's "
               "combine gather, :255)"),
        Kernel("resnet_norm", "picha_resnet_norm",
               "picha_tpu_torch/csrc/resnet_norm.cu",
               "picha_tpu/models/resnet.py:100 (_norm, and the jax.nn.relu "
               "after it at :129, :131)"),
        Kernel("resnet_norm_bwd", "picha_resnet_norm_bwd",
               "picha_tpu_torch/csrc/resnet_norm_bwd.cu",
               "picha_tpu/models/resnet.py:100-106 (the VJP of _norm and "
               "the relu after it in jax.value_and_grad(loss_fn), :161)"),
        Kernel("coef_densify", "picha_coef_densify",
               "picha_tpu_torch/csrc/coef_restore.cu",
               "picha_tpu/pipeline/jpeg_batch.py:244 (_jit_batch_graph."
               "densify, upload='sparse')"),
        Kernel("coef_int8_restore", "picha_coef_int8_restore",
               "picha_tpu_torch/csrc/coef_restore.cu",
               "picha_tpu/pipeline/jpeg_batch.py:274 (_jit_batch_graph."
               "int8_restore, upload='int8')"),
        Kernel("coef_gap8_restore", "picha_coef_gap8_restore",
               "picha_tpu_torch/csrc/coef_restore.cu",
               "picha_tpu/pipeline/jpeg_batch.py:258 (_jit_batch_graph."
               "gap8_restore, upload='gap8')"),
        Kernel("coef_gap4_restore", "picha_coef_gap4_restore",
               "picha_tpu_torch/csrc/coef_restore.cu",
               "picha_tpu/pipeline/jpeg_batch.py:119 (gap4_restore_flat, "
               "via unpack_gap4_wire :145, upload='gap4')"),
        Kernel("yuv420_pack", "picha_yuv420_pack",
               "picha_tpu_torch/csrc/yuv420_pack.cu",
               "picha_tpu/pipeline/jpeg_batch.py:384 (_jit_batch_graph's "
               "yuv420_out branch, :384-413, encode_backend='raw420')"),
    )
}


def reset_launch_counts():
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def require_cuda(t, kernel: str):
    """Raise unless `t` is a CUDA tensor: a wrapper runs its plain
    version for CPU tensors and its kernel for CUDA tensors, nothing
    else."""
    if t.device.type != "cuda":
        raise ValueError(f"{kernel} takes CPU tensors (plain version) or "
                         f"CUDA tensors (kernel), got {t.device}")


def aligned(t, nbytes: int = 16):
    """`t` made contiguous, copied once more if its data pointer is not a
    multiple of `nbytes` (a kernel that reads 4- or 16-byte words)."""
    t = t.contiguous()
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def ptr(t) -> int:
    """Device pointer of a tensor for a c_void_p argument."""
    return t.data_ptr()


def stream_of(t) -> int:
    """The current CUDA stream of the tensor's device, as an int."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
