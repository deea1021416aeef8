"""Import hygiene and device rules of the port (picha_tpu_torch): it never
imports jax, asking for a card where there is none raises, and the
kernel wrappers take their plain versions only for CPU tensors."""
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_helpers import scan_batch_inputs, smooth_rgb

from picha_tpu.native import lib as native
from picha_tpu_torch.kernels import _build, launch_counts

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import picha_tpu_torch, picha_tpu_torch.kernels\n"
        "import picha_tpu_torch.ops.jpeg, picha_tpu_torch.ops.jpeg_fused\n"
        "import picha_tpu_torch.ops.jpeg_huffman\n"
        "import picha_tpu_torch.ops.jpeg_huffman_decode\n"
        "from picha_tpu_torch.pipeline import JpegBatchPipeline\n"
        "p = JpegBatchPipeline(width=8, height=8, encode_quality=85,\n"
        "                      device='cpu')\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from picha_tpu_torch.pipeline import JpegBatchPipeline
    from picha_tpu_torch.runtime import resolve_device

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        JpegBatchPipeline(width=8, height=8, encode_quality=85)
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_build_without_nvcc_raises():
    if shutil.which("nvcc") or (pathlib.Path(
            os.environ.get("CUDA_HOME") or "/usr/local/cuda")
            / "bin" / "nvcc").exists():
        pytest.skip("nvcc is present")
    if _build.library_path().exists():
        pytest.skip("a built kernel library is present")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_cpu_tensors_take_plain_versions_without_launches():
    """CPU tensors run the plain versions and count no launch; a tensor
    on any other device goes to the kernel path, which raises here (no
    card, no nvcc) instead of falling back."""
    from picha_tpu.ops.jpeg_tpu import _idct_kron, quality_tables
    from picha_tpu_torch.ops.jpeg import encode_blocks
    from picha_tpu_torch.ops.jpeg_huffman_decode import decode_scan

    before = launch_counts()
    buf = native.jpeg_encode(smooth_rgb(32, 48, 0), 85, restart=2)
    _sb, ks, args, _q, comp_of = scan_batch_inputs([buf])
    out, ok = decode_scan(args, ks, comp_of)
    assert bool(ok) and out.device.type == "cpu"
    ql, qc = (torch.as_tensor(q.astype(np.int32)) for q in quality_tables(85))
    kron = torch.as_tensor(_idct_kron())
    f255 = torch.full((1, 16, 16, 3), 100.0)
    encode_blocks(f255, ql, qc, kron)
    assert launch_counts() == before
    with pytest.raises((RuntimeError, TypeError, ValueError)):
        encode_blocks(f255.to("meta"), ql.to("meta"), qc.to("meta"),
                      kron.to("meta"))
    assert launch_counts() == before
