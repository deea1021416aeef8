"""The port's public surface where the reference's has more (ROADMAP
queue 3, F8): `ViTConfig`'s `dtype` field, and the `pipeline` package's
`signature`, `augment` and module-level `entropy_decode`. The reference
is read with `inspect` only; nothing here calls `picha_tpu/native`. The
port's `entropy_decode` is held to its own host decoder
(`ops/coef_host.py`) on the committed fixtures."""
import dataclasses
import inspect
import pathlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from picha_tpu.models import vit as ref_vit
from picha_tpu.pipeline import jpeg_batch as ref_jpeg_batch
from picha_tpu_torch import pipeline
from picha_tpu_torch.models import vit as port_vit
from picha_tpu_torch.ops import coef_host
from picha_tpu_torch.ops.jpeg_scan import parse_baseline

FIXTURES = pathlib.Path(__file__).parent / "fixtures" / "port"
SMALL = ["raw420_coef1_q95.jpg", "raw420_coef3_q50.jpg",
         "raw420_planes_q50.jpg", "raw420_planes_q95.jpg"]


def test_vit_config_takes_the_reference_fields():
    ref = {f.name: f.default for f in dataclasses.fields(ref_vit.ViTConfig)}
    port = {f.name: f.default for f in dataclasses.fields(port_vit.ViTConfig)}
    assert ref == port
    cfg = port_vit.ViTConfig(depth=2, dtype="bfloat16")
    assert cfg.dtype == "bfloat16" and cfg.depth == 2
    assert port_vit.ViTConfig().dtype is None


def test_vit_config_dtype_is_not_read():
    import torch

    g = torch.Generator().manual_seed(0)
    a = port_vit.init_params(port_vit.TINY, g, "cpu")
    b = port_vit.init_params(dataclasses.replace(port_vit.TINY, dtype=object()),
                             torch.Generator().manual_seed(0), "cpu")
    x = torch.rand((2, 32, 32, 3), generator=g)
    ya = port_vit.forward(a, x, port_vit.TINY)
    yb = port_vit.forward(b, x, dataclasses.replace(port_vit.TINY,
                                                    dtype=object()))
    assert torch.equal(ya, yb)


@pytest.mark.parametrize("name", ["signature", "augment", "entropy_decode"])
def test_pipeline_exports_the_reference_names(name):
    import picha_tpu.pipeline as ref_pipeline

    assert hasattr(ref_pipeline, name)
    assert name in dir(pipeline)
    if name == "augment":
        assert inspect.ismodule(pipeline.augment)
        assert pipeline.augment.__name__ == "picha_tpu_torch.pipeline.augment"
    else:
        assert callable(getattr(pipeline, name))


def test_entropy_decode_has_the_reference_signature():
    def params(fn):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()]

    assert params(pipeline.entropy_decode) == \
        params(ref_jpeg_batch.entropy_decode)


def _assert_same_sets(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.width, g.height, g.ncomp, g.color_space) == \
            (w.width, w.height, w.ncomp, w.color_space)
        assert g.comp_sig == w.comp_sig
        for cg, cw in zip(g.comps, w.comps):
            assert cg.keys() == cw.keys()
            for k in cg:
                assert np.array_equal(np.asarray(cg[k]), np.asarray(cw[k])), k


@pytest.mark.parametrize("pooled", [False, True])
def test_entropy_decode_is_the_host_decoder(pooled):
    bufs = [(FIXTURES / f).read_bytes() for f in SMALL + ["ref_0.jpg"]]
    want = [coef_host.decode_plain(parse_baseline(b)) for b in bufs]
    if pooled:
        with ThreadPoolExecutor(2) as pool:
            got = pipeline.entropy_decode(bufs, pool, max_threads=2)
    else:
        got = pipeline.entropy_decode([bytearray(b) for b in bufs])
    _assert_same_sets(got, want)
    assert pipeline.signature(got[-1]) == (960, 544, want[-1].color_space,
                                           want[-1].comp_sig)


def test_entropy_decode_refuses_libjpeg():
    buf = (FIXTURES / SMALL[0]).read_bytes()
    with pytest.raises(NotImplementedError, match="item 5"):
        pipeline.entropy_decode([buf], force_libjpeg=True)
    # a progressive file is libjpeg's alone: the same refusal
    from PIL import Image

    import io
    out = io.BytesIO()
    Image.new("RGB", (16, 16), (10, 200, 30)).save(out, "JPEG",
                                                    progressive=True)
    with pytest.raises(NotImplementedError, match="item 5"):
        pipeline.entropy_decode([out.getvalue()])
    assert pipeline.entropy_decode([]) == []
