"""The ViT that consumes the training ingest: the forward pass and the
train step, dense and switch-MoE (BASELINE.json config 5's "...
normalize feeding a ViT step").

Counterpart of `picha_tpu/models/vit.py`: `ViTConfig`, `TINY`,
`TINY_MOE`, `init_params` (:65-109), `forward` (:155-191),
`_switch_moe` (:194-230), `loss_fn` (:233-240) and `make_train_step`
(:243-260). ViT-S/16 widths by default (224², patch 16, dim 384, 12
blocks of 6 heads, MLP 1536, 1000 classes), with the reference's
variant: no class token, no biases, mean pooling. Products are bf16
with f32 sums (`torch.matmul` / `torch.bmm`: cuBLAS on the card, under
`ops.jpeg.full_precision`, forward and backward); LayerNorm is K17 with
its backward K21 (`ops/layernorm.py`), attention K18 / K22
(`ops/attention.py`), the MoE's route + dispatch K19 / K23 and its
combine K20 / K24 (`ops/moe.py`), each the plain torch version on CPU
tensors. GELU, the log-softmax, the mean pool and the residual adds go
through torch's autograd.

Parameters keep the reference's tree (dicts, a list of blocks) and its
(in, out) weight layout, in float32; `params_from_jax` takes the
reference's tree as numpy arrays. The train step is functional on that
tree, as the reference's: gradients are taken for the f32 leaves
through their bf16 casts, the optimizer is `optim.adamw` (optax's
arithmetic and defaults), and `models/checkpoint.py` writes the
reference's npz. The `ViT` module is the serving form: its parameters
take no gradient.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.jpeg import full_fp32, full_precision
from ..ops.layernorm import layer_norm
from ..ops.moe import capacity, combine, route_dispatch
from ..optim import adamw, apply_updates, tree_leaves, tree_unflatten
from ..runtime.device import resolve_device, to_device
from ._tree import _map, _no_mark, _Tree, params_from_jax  # noqa: F401


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch: int = 16
    dim: int = 384
    depth: int = 12
    heads: int = 6
    mlp_ratio: int = 4
    classes: int = 1000
    # switch-MoE: every `moe_every`-th block swaps its MLP for
    # `moe_experts` expert FFNs with top-1 routing (0 = dense model)
    moe_experts: int = 0
    moe_every: int = 2
    capacity_factor: float = 1.5

    def is_moe_block(self, i: int) -> bool:
        # every moe_every-th block, counting from the moe_every-th
        return (self.moe_experts > 0
                and i % self.moe_every == self.moe_every - 1)

    @property
    def seq_len(self) -> int:
        return (self.image_size // self.patch) ** 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


TINY = ViTConfig(image_size=32, patch=8, dim=128, depth=2, heads=4,
                 mlp_ratio=4, classes=16)
TINY_MOE = ViTConfig(image_size=32, patch=8, dim=128, depth=2, heads=4,
                     mlp_ratio=4, classes=16, moe_experts=4)


def init_params(cfg: ViTConfig, generator: torch.Generator,
                device="cuda") -> Dict:
    """A random parameter tree with the reference's shapes and scales:
    weights normal / sqrt(fan_in), pos_embed 0.02 * normal, LayerNorm
    scale 1 and bias 0, drawn on the CPU from `generator` (so a seed
    gives the same weights on every device) and moved to `device`."""
    dev = resolve_device(device)
    dim, f = cfg.dim, cfg.mlp_ratio * cfg.dim

    def normal(shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    def dense(fan_in, shape):
        return normal(shape) / math.sqrt(fan_in)

    def ln():
        return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}

    pp = cfg.patch * cfg.patch * 3
    params = {"patch_embed": dense(pp, (pp, dim)),
              "pos_embed": 0.02 * normal((cfg.seq_len, dim)),
              "head": dense(dim, (dim, cfg.classes)),
              "final_ln": ln(), "blocks": []}
    for i in range(cfg.depth):
        blk = {"ln1": ln(), "qkv": dense(dim, (dim, 3 * dim)),
               "proj": dense(dim, (dim, dim)), "ln2": ln()}
        if cfg.is_moe_block(i):
            E = cfg.moe_experts
            blk["router"] = dense(dim, (dim, E))
            blk["w_in"] = dense(dim, (E, dim, f))
            blk["w_out"] = dense(f, (E, f, dim))
        else:
            blk["mlp_in"] = dense(dim, (dim, f))
            blk["mlp_out"] = dense(f, (f, dim))
        params["blocks"].append(blk)
    return _map(lambda t: t.to(dev), params)


def forward(params, images, cfg: ViTConfig,
            mark: Optional[Callable[[str], None]] = None):
    """images: (N, H, W, 3) float32 in [0, 1] (the ingest's output).
    Returns (N, classes) float32 logits. `mark(stage)`, when given, is
    called after each stage ("embed", "K17", "qkv", "K18", "proj",
    "mlp_in", "gelu", "mlp_out", "router", "K19", "experts", "K20",
    "residual", "head"); a stage names the work enqueued since the
    previous call (products include their weights' bf16 cast and, for
    proj and mlp_out, the residual add)."""
    mark = mark or _no_mark
    bf16 = torch.bfloat16
    n, h, w, _ = images.shape
    p, s = cfg.patch, cfg.seq_len
    with full_precision():
        x = images.reshape(n, h // p, p, w // p, p, 3)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(n, s, p * p * 3)
        x = x.to(bf16) @ params["patch_embed"].to(bf16)
        x = x + params["pos_embed"].to(bf16)
        mark("embed")
        scale = 1.0 / math.sqrt(cfg.head_dim)
        for blk in params["blocks"]:
            y = layer_norm(x, blk["ln1"]["scale"], blk["ln1"]["bias"])
            mark("K17")
            qkv = y @ blk["qkv"].to(bf16)
            mark("qkv")
            o = attention(qkv.view(n, s, 3, cfg.heads, cfg.head_dim), scale)
            mark("K18")
            x = x + o @ blk["proj"].to(bf16)
            mark("proj")
            y = layer_norm(x, blk["ln2"]["scale"], blk["ln2"]["bias"])
            mark("K17")
            if "router" in blk:
                y = _switch_moe(y, blk, cfg, mark)
                x = x + y
                mark("residual")
            else:
                y = y @ blk["mlp_in"].to(bf16)
                mark("mlp_in")
                y = F.gelu(y, approximate="tanh")
                mark("gelu")
                x = x + y @ blk["mlp_out"].to(bf16)
                mark("mlp_out")
        x = layer_norm(x, params["final_ln"]["scale"],
                       params["final_ln"]["bias"])
        mark("K17")
        pooled = x.to(torch.float32).mean(1).to(bf16)
        logits = (pooled @ params["head"].to(bf16)).to(torch.float32)
        mark("head")
    return logits


def _switch_moe(y, blk, cfg: ViTConfig, mark=None):
    """Top-1 switch routing with static capacity (the reference's
    :194-230): the router product in IEEE f32, K19, the expert FFNs as
    bf16 batched products with tanh-GELU between them, K20. Dropped
    tokens give 0 (they pass through the caller's residual)."""
    mark = mark or _no_mark
    bf16 = torch.bfloat16
    n, s, d = y.shape
    t = n * s
    cap = capacity(t, cfg.moe_experts, cfg.capacity_factor)
    yt = y.reshape(t, d)
    with full_fp32():
        logits = yt.to(torch.float32) @ blk["router"]
    mark("router")
    xe, eidx, sidx, gk = route_dispatch(logits, yt, cap)
    mark("K19")
    he = F.gelu(torch.bmm(xe, blk["w_in"].to(bf16)), approximate="tanh")
    ye = torch.bmm(he, blk["w_out"].to(bf16))
    mark("experts")
    out = combine(ye, eidx, sidx, gk)
    mark("K20")
    return out.reshape(n, s, d)


def loss_fn(params, images, labels, cfg: ViTConfig,
            mark: Optional[Callable[[str], None]] = None):
    """The mean negative log-likelihood of `labels` ((N,) integers) under
    log_softmax(forward(...)), a float32 scalar (the reference's
    :233-240)."""
    logp = torch.log_softmax(forward(params, images, cfg, mark), -1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def make_train_step(cfg: ViTConfig, learning_rate: float = 3e-4,
                    device="cuda"):
    """Returns (init_opt, train_step), as the reference's :243-260:
    `init_opt(params) -> opt_state` and `train_step(params, opt_state,
    images, labels) -> (params, opt_state, loss)`, functional on the
    parameter tree (new leaves; the inputs are not changed) with
    `optim.adamw(learning_rate)`. Images and labels are moved to
    `device`, which is the card unless the CPU is asked for; the forward
    and the backward both run under `full_precision` (bf16 products
    summed in f32, f32 products in IEEE f32, whatever the global flags
    say). `train_step(..., mark=fn)` calls `fn(stage)` after each forward
    stage (see `forward`), then "loss", "backward" and "optimizer"."""
    dev = resolve_device(device)
    tx = adamw(learning_rate)

    def init_opt(params):
        return tx.init(params)

    def train_step(params, opt_state, images, labels,
                   mark: Optional[Callable[[str], None]] = None):
        mark = mark or _no_mark
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with full_precision():
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


class ViT(nn.Module):
    """`forward` as a module: `ViT(cfg, seed=0)(images)` -> logits. The
    parameters are `init_params(cfg, torch.Generator().manual_seed(seed))`
    unless a tree is given (`params_from_jax` for the reference's). Runs
    on the card unless device="cpu" is asked for."""

    def __init__(self, cfg: ViTConfig = ViTConfig(), seed: int = 0,
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
