"""Port fused decode+resize (picha_tpu_torch/ops/jpeg_fused.py) against
picha_tpu's `fused_decode_resize` (JAX on the CPU): the same folded
weights and coefficients, max |diff| <= 2e-3 on the 0-255 scale (f32
matmuls summed in another order), and full f32 whatever the global
matmul precision says."""
import numpy as np
import pytest
import torch

from conftest import fixture_bytes
from torch_helpers import smooth_rgb

from picha_tpu.native import lib as native
from picha_tpu.ops.jpeg_fused import fused_decode_resize as ref_fused
from picha_tpu.ops.resize import parse_resize_options
from picha_tpu.pipeline.jpeg_batch import signature
from picha_tpu_torch.ops.jpeg import pack_u8
from picha_tpu_torch.ops.jpeg_fused import fused_decode_resize
from picha_tpu_torch.pipeline.jpeg_batch import device_constants

TOL = 2e-3


def _case(kind):
    if kind == "cmyk":
        return native.JpegCoefficients(fixture_bytes("test2cmyk.jpg"))
    img = smooth_rgb(61, 90, 2)
    if kind == "grey":
        return native.JpegCoefficients(native.jpeg_encode(
            np.ascontiguousarray(img[..., :1]), 85))
    return native.JpegCoefficients(native.jpeg_encode(
        img, 85, subsample=(kind == "420")))


def _run_both(co, out_w, out_h, filt="cubic"):
    sig = signature(co)
    width, height, cs, comp_sig = sig
    name, fscale = parse_resize_options({"filter": filt})
    coefs = [c["coefs"][None].astype(np.int32) for c in co.comps]
    qtabs = [c["qtable"].astype(np.int32)[None, None, None, :]
             for c in co.comps]
    want = np.asarray(ref_fused(comp_sig, cs, width, height, out_w, out_h,
                                name, fscale, coefs, qtabs))
    consts = device_constants(sig, out_w, out_h, name, fscale, None, "cpu",
                              fused=True)
    got = fused_decode_resize(comp_sig, cs,
                              [torch.as_tensor(c) for c in coefs],
                              [torch.as_tensor(q) for q in qtabs],
                              consts.weights)
    return got, want


@pytest.mark.parametrize("kind,out_w,out_h", [
    ("420", 45, 30), ("444", 120, 80), ("grey", 37, 23), ("cmyk", 40, 30)])
def test_fused_matches_reference(kind, out_w, out_h):
    got, want = _run_both(_case(kind), out_w, out_h)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) <= TOL


def test_fused_ignores_global_tf32_and_restores_it():
    """With reduced-precision float32 matmuls allowed globally, the call
    still runs full f32 (same result as under 'highest') and leaves the
    global setting as it found it."""
    co = _case("420")
    base, want = _run_both(co, 45, 30)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        got, _ = _run_both(co, 45, 30)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(got, base)
    assert float(np.abs(got.numpy() - want).max()) <= TOL


def test_pack_rounds_half_up_and_clips():
    f = torch.tensor([-3.0, 0.49, 0.5, 1.5, 254.5, 254.49, 300.0])
    np.testing.assert_array_equal(pack_u8(f).numpy(),
                                  [0, 0, 1, 2, 255, 254, 255])
