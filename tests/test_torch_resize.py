"""Port separable resize (picha_tpu_torch/ops/resize.py) against
picha_tpu's `resize_f32` (JAX on the CPU): every filter, the dense plan
(source <= 512) and the banded plan (source > 512), downscale and
upscale. Both port forms, `resize_f32_plain` (the reference's dense and
banded contractions) and the windowed sum of K8's plain twin, stay
within 1e-6 of the reference on the 0-1 scale (f32 sums in another
order)."""
import numpy as np
import pytest
import torch

from picha_tpu.ops.resize import FILTERS
from picha_tpu.ops.resize import resize_f32 as ref_resize
from picha_tpu_torch.ops.resize import (INV255, resize_axis,
                                        resize_axis_windowed_plain,
                                        resize_f32, resize_f32_plain,
                                        resize_windowed, window_tensors)

TOL = 1e-6
# name -> (src_h, src_w, dst_h, dst_w)
SHAPES = {
    "dense_down": (37, 45, 23, 30),
    "dense_up": (20, 33, 41, 50),
    "banded_down_w": (24, 600, 15, 250),
    "banded_up_h": (520, 16, 700, 24),
}


def _image(shape, seed, c=3):
    src_h, src_w = shape[:2]
    return np.random.default_rng(seed).random((2, src_h, src_w, c),
                                              dtype=np.float32)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("filt", list(FILTERS))
def test_resize_matches_reference(filt, shape):
    _sh, _sw, dst_h, dst_w = SHAPES[shape]
    x = _image(SHAPES[shape], len(filt) + len(shape))
    fscale = 0.7 if filt == "cubic" else 1.0
    want = np.asarray(ref_resize(x, dst_w, dst_h, filt, fscale))
    for fn in (resize_f32_plain, resize_f32):
        got = fn(torch.as_tensor(x), dst_w, dst_h, filt, fscale)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        assert float(np.abs(got.numpy() - want).max()) <= TOL, fn.__name__


@pytest.mark.parametrize("c", [1, 3])
def test_uint8_input_unpacks_before_the_taps(c):
    """uint8 in: v * f32(1/255) before any tap, as the reference unpacks
    (jpeg_batch.py pixel_stages) before resize_f32."""
    u8 = np.random.default_rng(c).integers(0, 256, (1, 30, 530, c),
                                           np.uint8)
    want = np.asarray(ref_resize(u8.astype(np.float32) * np.float32(INV255),
                                 200, 17, "cubic", 0.7))
    got = resize_f32(torch.as_tensor(u8), 200, 17, "cubic", 0.7)
    assert float(np.abs(got.numpy() - want).max()) <= TOL
    f = torch.as_tensor(u8).to(torch.float32) * INV255
    assert torch.equal(got, resize_f32(f, 200, 17, "cubic", 0.7))


def test_out_scale_is_one_final_multiply():
    """out_scale scales the finished sum (K2 then packs f * 255 exactly as
    the reference's floor(clip(f * 255 + 0.5)) does)."""
    u8 = torch.as_tensor(np.random.default_rng(5).integers(
        0, 256, (2, 40, 60, 3), np.uint8))
    windows = (window_tensors(25, 60, "lanczos", 1.0, "cpu"),
               window_tensors(19, 40, "lanczos", 1.0, "cpu"))
    base = resize_windowed(u8, windows)
    assert torch.equal(resize_windowed(u8, windows, out_scale=255.0),
                       base * 255.0)


@pytest.mark.parametrize("axis", [-2, -3])
def test_resize_axis_is_the_windowed_twin_on_cpu(axis):
    """On CPU tensors the wrapper runs the plain twin itself, and the
    twin's windows are the reference's `resize_windows`."""
    x = torch.as_tensor(_image((31, 43), 9))
    src = x.shape[axis]
    starts, taps = window_tensors(12, src, "mitchel", 1.0, "cpu")
    got = resize_axis(x, starts, taps, axis)
    assert torch.equal(got, resize_axis_windowed_plain(x, starts, taps,
                                                       axis))
    dense = torch.zeros(12, src)
    for o in range(12):
        dense[o, starts[o]:starts[o] + taps.shape[1]] = taps[o]
    want = torch.einsum("os,nswc->nowc" if axis == -3 else "os,nhsc->nhoc",
                        dense.double(), x.double())
    assert float((got.double() - want).abs().max()) <= TOL
