"""The compact pre-activation ResNet that consumes the training ingest:
the forward pass and the train step.

Counterpart of `picha_tpu/models/resnet.py`: `ResNetConfig`, `TINY`
(:20-30), `init_params` (:33-68), `_norm` (:100-106), `_conv`
(:109-116), `forward` (:119-142) and `make_train_step` (:145-166). The
default is the reference's own: 224², a 3x3 stem of 64 channels, stages
of (64, 128, 256) channels with 2 blocks each (the first of a stage at
stride 2), 1000 classes; about 3.0 M parameters. Activations are bf16
NHWC, as the reference's. Each block's instance norm + scale + ReLU is
K25 with its backward K26 (`ops/instance_norm.py`), the plain torch
versions on CPU tensors. The convolutions are `F.conv2d` in bf16 on the
NHWC tensor seen as channels-last NCHW (cuDNN on the card), with the
reference's SAME padding done here: (1, 1) for a 3x3 at stride 1,
(0, 1) for a 3x3 at stride 2 on an even size (JAX pads after, not
before; `same_pads`), none for a 1x1. The identity downsample is the
strided slice `[:, ::2, ::2, :]`. The mean pool and the head run in f32,
the head product in IEEE f32.

Every forward and the train step's backward hold `conv_pin`: cuDNN's
deterministic algorithms without autotuning (a resumed step is bit for
bit; cuDNN's weight gradients may otherwise sum with atomics) and
`ops.jpeg.full_fp32` for the head, the caller's flags restored after.

Parameters keep the reference's tree (a list of stages, each a list of
block dicts, `proj: None` where a block keeps its width) and its HWIO
conv layout, in float32; `params_from_jax` takes the reference's tree as
numpy arrays. The train step is functional on that tree (as the ViT's,
`models/vit.py`) with `optim.adamw`, and `models/checkpoint.py` writes
the reference's npz. The `ResNet` module is the serving form.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.instance_norm import norm_relu
from ..ops.jpeg import full_fp32
from ..ops.layernorm import true_div
from ..optim import adamw, apply_updates, tree_leaves, tree_unflatten
from ..runtime.device import resolve_device, to_device
from ._tree import _map, _no_mark, _Tree, params_from_jax  # noqa: F401


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    image_size: int = 224
    stem_channels: int = 64
    stage_channels: tuple = (64, 128, 256)
    blocks_per_stage: int = 2
    classes: int = 1000


TINY = ResNetConfig(image_size=32, stem_channels=32,
                    stage_channels=(32, 64), blocks_per_stage=1, classes=16)


def init_params(cfg: ResNetConfig, generator: torch.Generator,
                device="cuda") -> Dict:
    """A random parameter tree with the reference's shapes and scales:
    convolutions (kh, kw, cin, cout) normal / sqrt(kh * kw * cin), the
    head normal / sqrt(C), norm scales 1, `proj` a 1x1 convolution where
    a block changes its width and None where it keeps it; drawn on the
    CPU from `generator` (a seed gives the same weights on every device)
    and moved to `device`."""
    dev = resolve_device(device)

    def normal(shape, fan_in):
        return torch.randn(shape, generator=generator,
                           dtype=torch.float32) / math.sqrt(fan_in)

    def conv(k, cin, cout):
        return normal((k, k, cin, cout), k * k * cin)

    last = cfg.stage_channels[-1]
    params = {"stem": conv(3, 3, cfg.stem_channels),
              "head": normal((last, cfg.classes), last), "stages": []}
    cin = cfg.stem_channels
    for cout in cfg.stage_channels:
        stage = []
        for _ in range(cfg.blocks_per_stage):
            stage.append({"conv1": conv(3, cin, cout),
                          "conv2": conv(3, cout, cout),
                          "proj": conv(1, cin, cout) if cin != cout else None,
                          "scale1": torch.ones(cin),
                          "scale2": torch.ones(cout)})
            cin = cout
        params["stages"].append(stage)
    return _map(lambda t: t.to(dev), params)


@contextlib.contextmanager
def conv_pin():
    """cuDNN's deterministic algorithms, without autotuning, and
    `full_fp32` inside the block; the caller's `deterministic` and
    `benchmark` flags (process-wide, so autograd's device thread sees
    them) are restored exactly."""
    cd = torch.backends.cudnn
    prev = cd.deterministic, cd.benchmark
    cd.deterministic, cd.benchmark = True, False
    try:
        with full_fp32():
            yield
    finally:
        cd.deterministic, cd.benchmark = prev


def same_pads(size: int, k: int, stride: int):
    """XLA's "SAME" padding of one spatial axis, (before, after): the
    output has ceil(size / stride) samples and the odd pixel of the
    padding goes after."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride: int = 1):
    """x (N, H, W, Cin) NHWC, w (kh, kw, Cin, Cout) HWIO cast to x's
    dtype -> (N, H', W', Cout) NHWC, the reference's SAME padding: a
    symmetric pad is the convolution's own, an asymmetric one is
    `F.pad` before it (never a symmetric pad and a crop: that would move
    the sample points)."""
    (t, b), (l, r) = (same_pads(x.shape[1], w.shape[0], stride),
                      same_pads(x.shape[2], w.shape[1], stride))
    xc = x.permute(0, 3, 1, 2)                 # NCHW, channels last in memory
    wc = w.to(x.dtype).permute(3, 2, 0, 1)     # OIHW
    if t == b and l == r:
        out = F.conv2d(xc, wc, stride=stride, padding=(t, l))
    else:
        out = F.conv2d(F.pad(xc, (l, r, t, b)), wc, stride=stride)
    return out.permute(0, 2, 3, 1)


def forward(params, images, cfg: ResNetConfig,
            mark: Optional[Callable[[str], None]] = None):
    """images: (N, H, W, 3) float32 in [0, 1] (the ingest's output).
    Returns (N, classes) float32 logits. `mark(stage)`, when given, is
    called after each stage ("stem", "K25", "stage<i>_conv",
    "residual", "head"); a stage names the work enqueued since the
    previous call (a convolution includes its weights' bf16 cast and its
    padding, "residual" the strided-slice shortcut and the add)."""
    mark = mark or _no_mark
    with conv_pin():
        x = _conv(images.to(torch.bfloat16), params["stem"])
        mark("stem")
        for si, stage in enumerate(params["stages"]):
            conv = f"stage{si}_conv"
            for bi, blk in enumerate(stage):
                stride = 2 if bi == 0 else 1
                h = norm_relu(x, blk["scale1"])
                mark("K25")
                h = _conv(h, blk["conv1"], stride)
                mark(conv)
                h = norm_relu(h, blk["scale2"])
                mark("K25")
                h = _conv(h, blk["conv2"])
                mark(conv)
                shortcut = x
                if blk["proj"] is not None:
                    shortcut = _conv(shortcut, blk["proj"], stride)
                    mark(conv)
                elif stride != 1:
                    # the identity downsample: the stride-2 SAME sample
                    # points
                    shortcut = shortcut[:, ::stride, ::stride, :]
                x = h + shortcut
                mark("residual")
        pooled = true_div(x.to(torch.float32).sum((1, 2)),
                          x.shape[1] * x.shape[2])
        logits = pooled @ params["head"]
        mark("head")
    return logits


def loss_fn(params, images, labels, cfg: ResNetConfig,
            mark: Optional[Callable[[str], None]] = None):
    """The mean negative log-likelihood of `labels` ((N,) integers) under
    log_softmax(forward(...)), a float32 scalar (the reference's
    :152-155)."""
    logp = torch.log_softmax(forward(params, images, cfg, mark), -1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def make_train_step(cfg: ResNetConfig, learning_rate: float = 3e-4,
                    device="cuda"):
    """Returns (init_opt, train_step), as the reference's :145-166:
    `init_opt(params) -> opt_state` and `train_step(params, opt_state,
    images, labels) -> (params, opt_state, loss)`, functional on the
    parameter tree (new leaves; the inputs are not changed; `None` leaves
    stay `None`) with `optim.adamw(learning_rate)`. Images and labels
    are moved to `device`, which is the card unless the CPU is asked for;
    the forward and the backward both run under `conv_pin`.
    `train_step(..., mark=fn)` calls `fn(stage)` after each forward stage
    (see `forward`), then "loss", "backward" and "optimizer"."""
    dev = resolve_device(device)
    tx = adamw(learning_rate)

    def init_opt(params):
        return tx.init(params)

    def train_step(params, opt_state, images, labels,
                   mark: Optional[Callable[[str], None]] = None):
        mark = mark or _no_mark
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with conv_pin():
            loss = loss_fn(tree_unflatten(params, leaves),
                           to_device(images, dev), to_device(labels, dev),
                           cfg, mark)
            mark("loss")
            grads = torch.autograd.grad(loss, leaves)
            mark("backward")
        updates, opt_state = tx.update(tree_unflatten(params, list(grads)),
                                       opt_state, params)
        params = apply_updates(params, updates)
        mark("optimizer")
        return params, opt_state, loss.detach()

    return init_opt, train_step


class ResNet(nn.Module):
    """`forward` as a module: `ResNet(cfg, seed=0)(images)` -> logits.
    The parameters are `init_params(cfg,
    torch.Generator().manual_seed(seed))` unless a tree is given
    (`params_from_jax` for the reference's). Runs on the card unless
    device="cpu" is asked for."""

    def __init__(self, cfg: ResNetConfig = ResNetConfig(), seed: int = 0,
                 params: Optional[Dict] = None, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        if params is None:
            params = init_params(cfg, torch.Generator().manual_seed(seed),
                                 dev)
        self.cfg = cfg
        self.weights = _Tree(_map(lambda t: t.to(dev), params))

    def params(self) -> Dict:
        return self.weights.tree()

    def forward(self, images, mark: Optional[Callable[[str], None]] = None):
        return forward(self.weights.tree(), images, self.cfg, mark)
