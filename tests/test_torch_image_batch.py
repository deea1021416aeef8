"""The port's pixel-array path against picha_tpu's on JAX-CPU: the
batched transform of ImageBatchPipeline (K11 -> K8 -> K8 -> K11, or one
K11, through their plain versions on CPU tensors) against the
reference's `_jit_transform`, `resize_batch` against `_jit_resize`, and
the single-image resize sync and async forms.

Tolerances: without a resize the pixels are exact. With one, K8's twin
sums each output's taps in window order where the reference contracts a
dense or banded einsum, so packed pixels may differ by 1 LSB (of their
own depth), on at most 1 % of them on average (mean <= 0.01 LSB);
`normalize` floats are within 1e-6.
"""
import io

import numpy as np
import pytest
import torch

import picha_tpu as ref
from picha_tpu.errors import InvalidImageError as RefInvalidImage
from picha_tpu.ops.resize import _jit_resize
from picha_tpu.pipeline import ImageBatchPipeline as RefPipeline
from picha_tpu.pixels import PIXEL_FORMATS

import picha_tpu_torch as port
from picha_tpu_torch.codecs import image_host
from picha_tpu_torch.errors import InvalidImageError
from picha_tpu_torch.ops.resize import resize_batch
from picha_tpu_torch.pipeline import ImageBatchPipeline

N, H, W = 3, 40, 52
CROP = (5, 3, 30, 20)


def _src(pixel, seed=0, n=N, h=H, w=W):
    """Smooth waves plus noise, so resizes land between levels."""
    fmt = PIXEL_FORMATS[pixel]
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    chans = [0.5 + 0.35 * np.sin(xx / (3 + c) + yy / (5 + c) + seed)
             for c in range(fmt.channels)]
    f = np.stack(chans, -1)[None] + rng.normal(0, 0.03,
                                               (n, h, w, fmt.channels))
    return np.round(np.clip(f, 0, 1) * fmt.max_value).astype(fmt.dtype)


CASES = {
    "plain_rgba": ("rgba", {}),
    "crop": ("rgba", dict(crop=CROP)),
    "crop_grey": ("rgba", dict(crop=CROP, convert="grey")),
    "crop_r16g16b16": ("rgb", dict(crop=CROP, convert="r16g16b16")),
    "normalize": ("rgba", dict(normalize=True)),
    "crop_normalize_greya": ("rgba", dict(crop=CROP, normalize=True,
                                          convert="greya")),
    "u16_crop_rgb": ("r16g16b16", dict(crop=CROP, convert="rgb")),
    "resize_cubic": ("rgba", dict(resize=(25, 17))),
    "resize_up_cubic": ("rgb", dict(resize=(70, 61))),
    "resize_lanczos_crop": ("rgba", dict(crop=CROP, resize=(60, 41),
                                         filter="lanczos")),
    "resize_box_fscale": ("rgba", dict(resize=(25, 17), filter="box",
                                       filter_scale=2.0)),
    "resize_cubic_fscale": ("rgb", dict(resize=(20, 33),
                                        filter_scale=0.7)),
    "resize_normalize": ("rgba", dict(crop=CROP, resize=(25, 17),
                                      normalize=True)),
    "resize_normalize_grey": ("rgb", dict(resize=(25, 17), normalize=True,
                                          convert="grey")),
    "u16_resize": ("r16g16b16a16", dict(resize=(25, 17),
                                        filter="lanczos")),
    "u16_resize_crop_r16": ("r16g16b16", dict(crop=CROP, resize=(25, 17),
                                              convert="r16")),
    "grey_resize_rgba": ("grey", dict(resize=(25, 17), convert="rgba")),
    "greya_resize_rgb": ("greya", dict(crop=CROP, resize=(25, 17),
                                       convert="rgb")),
    **{f"resize_convert_{dst}": ("rgba", dict(crop=CROP, resize=(25, 17),
                                              convert=dst))
       for dst in PIXEL_FORMATS},
}


def _compare(got, want, resized, normalized):
    assert got.shape == want.shape and got.dtype == want.dtype
    if normalized:
        assert float(np.abs(got - want).max()) <= 1e-6
        return
    if not resized:
        np.testing.assert_array_equal(got, want)
        return
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1 and d.mean() <= 0.01


@pytest.mark.parametrize("case", list(CASES))
def test_transform_matches_reference(case):
    pixel, kw = CASES[case]
    batch = _src(pixel, seed=len(case))
    want = np.asarray(RefPipeline(backend="device", **kw).transform(batch))
    got = ImageBatchPipeline(device="cpu", **kw).transform(batch)
    assert got.device.type == "cpu"
    _compare(got.numpy(), want, "resize" in kw, kw.get("normalize", False))


@pytest.mark.parametrize("crop", [(-1, 0, 10, 10), (0, -2, 10, 10),
                                  (0, 0, W + 1, 10), (45, 0, 8, 10),
                                  (0, 35, 10, 6), (0, 0, 0, 5), (0, 0, 5, 0)])
def test_out_of_bounds_crops_raise_in_both(crop):
    batch = _src("rgba")
    with pytest.raises(RefInvalidImage):
        RefPipeline(crop=crop, resize=(8, 8), backend="device").transform(
            batch)
    with pytest.raises(InvalidImageError):
        ImageBatchPipeline(crop=crop, resize=(8, 8),
                           device="cpu").transform(batch)


@pytest.mark.parametrize("filt", ["cubic", "lanczos", "box", "triangle"])
@pytest.mark.parametrize("pixel", ["rgba", "r16g16b16", "grey"])
@pytest.mark.parametrize("dst", [(25, 17), (70, 61)])
def test_resize_batch_matches_reference(filt, pixel, dst):
    batch = _src(pixel, seed=len(filt))
    want = np.asarray(_jit_resize(batch.dtype.name, dst[0], dst[1], filt,
                                  1.0)(batch))
    got = resize_batch(torch.from_numpy(batch), dst[0], dst[1], filt, 1.0)
    _compare(got.numpy(), want, True, False)


def test_call_mixed_keeps_input_order():
    """TIFFs (always rgba) and PNGs (rgb) of two sizes in one call: the
    buckets run separately and the results come back in input order,
    each equal to its own transform and within the tolerance of the
    reference's transform of the same pixels."""
    tiff_a = _src("rgba", 1, n=1)[0]
    tiff_b = _src("rgba", 2, n=1, h=30, w=36)[0]
    png_c = _src("rgb", 3, n=1)[0]
    bufs, arrays = [], []
    for arr, enc in ((tiff_a, image_host.encode_tiff),
                     (png_c, image_host.encode_png),
                     (tiff_b, image_host.encode_tiff),
                     (tiff_a, image_host.encode_tiff),
                     (png_c, image_host.encode_png)):
        pixel = "rgba" if arr.shape[-1] == 4 else "rgb"
        img = port.Image.from_array(arr, pixel)
        bufs.append(enc(img, {}, device="cpu") if enc is image_host.encode_png
                    else enc(img, {}))
        arrays.append(arr)
    kw = dict(crop=(2, 2, 24, 20), resize=(16, 12))
    pipe = ImageBatchPipeline(device="cpu", **kw)
    out = pipe(bufs)
    assert isinstance(out, list) and len(out) == 5
    for arr, got in zip(arrays, out):
        one = pipe.transform(arr[None]).numpy()[0]
        np.testing.assert_array_equal(got, one)
        want = np.asarray(RefPipeline(backend="device", **kw).transform(
            arr[None]))[0]
        _compare(got, want, True, False)
    same = pipe([bufs[0], bufs[3]])
    assert isinstance(same, torch.Tensor) and same.shape == (2, 12, 16, 4)


def test_backend_host_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ImageBatchPipeline(backend="host", device="cpu")
    with pytest.raises(ValueError):
        ImageBatchPipeline(backend="gpu", device="cpu")


@pytest.mark.parametrize("mimetype,opts", [
    ("image/tiff", {"compression": "lzw"}), ("image/tiff", {}),
    ("image/png", {}), ("image/png", {"filterStrategy": 4}),
    ("image/webp", {"quality": 85})])
def test_config4_encode_legs_decode(mimetype, opts):
    """BASELINE config 4's chain (crop, resize, encode) on CPU tensors:
    the lossless outputs decode with Pillow to the transform's pixels,
    the WebP ones within the reference's lossy oracle (< 8 LSB mean)."""
    from PIL import Image as PILImage

    srcs = [image_host.encode_tiff(port.Image.from_array(a, "rgba"),
                                   {"compression": "lzw"})
            for a in _src("rgba", 9, n=2, h=80, w=104)]
    kw = dict(crop=(4, 4, 96, 72), resize=(60, 40))
    pipe = ImageBatchPipeline(device="cpu", **kw)
    pixels = pipe.transform(pipe.decode_batch(srcs, mimetype="image/tiff"))
    outs = ImageBatchPipeline(device="cpu", encode=(mimetype, opts), **kw)(
        srcs, mimetype="image/tiff")
    for o, want in zip(outs, pixels.numpy()):
        im = PILImage.open(io.BytesIO(o))
        assert im.size == (60, 40) and im.mode == "RGBA"
        got = np.asarray(im)
        if mimetype == "image/webp":
            assert np.abs(got.astype(int) - want).mean() < 8
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pixel", ["rgba", "rgb", "grey", "r16g16b16"])
@pytest.mark.parametrize("opts", [{"width": 25, "height": 17},
                                  {"width": 70, "height": 9,
                                   "filter": "lanczos"}])
def test_resize_sync_async_and_reference(pixel, opts):
    """The single-image resize: sync and async byte-identical, and
    within 1 LSB of the reference's resizeSync (its numpy path at this
    size)."""
    arr = _src(pixel, 4, n=1)[0]
    img = port.Image.from_array(arr, pixel)
    sync = port.resize_sync(img, opts, device="cpu")
    assert port.resize(img, opts, device="cpu").result(60).equal_pixels(sync)
    want = ref.resizeSync(ref.Image.from_array(arr, pixel), opts)
    assert (sync.width, sync.height, sync.pixel) == (want.width, want.height,
                                                     pixel)
    d = np.abs(sync.to_array().astype(np.int64) - want.to_array())
    assert d.max() <= 1


def test_resize_sync_errors_like_reference():
    from picha_tpu_torch.errors import InvalidOptionsError

    img = port.Image.from_array(_src("rgb", n=1)[0], "rgb")
    for opts in ({"width": 0, "height": 5}, {"width": 5},
                 {"width": 5, "height": 5, "filter": "nope"}):
        with pytest.raises(InvalidOptionsError):
            port.resize_sync(img, opts, device="cpu")
