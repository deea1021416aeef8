"""Parameter-tree helpers the port's models share: `_map` over a tree of
dicts and lists, `params_from_jax` (the reference's numpy tree -> the
port's tensors), `_Tree` (a tree held as frozen nn.Parameters) and
`_no_mark` (the default stage hook). A `None` leaf (a ResNet block
without `proj`) stays `None` throughout, as the reference's trees keep
it."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..runtime.device import resolve_device


def _map(fn, tree):
    """`tree` with `fn` applied to every leaf; `None` stays `None`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def params_from_jax(tree, device="cuda") -> Dict:
    """The reference's parameter tree, its leaves as numpy arrays
    (`jax.tree.map(np.asarray, params)`), -> the port's tree of float32
    tensors on `device`; `None` leaves stay `None`."""
    dev = resolve_device(device)
    return _map(lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(dev), tree)


def _no_mark(stage: str) -> None:
    pass


class _Tree(nn.Module):
    """A parameter tree (dicts of tensors, of dicts and of lists, lists of
    dicts or of lists; a `None` leaf stays `None`) held as frozen
    nn.Parameters; `tree()` gives it back as dicts and lists."""

    def __init__(self, tree: Dict):
        super().__init__()
        self._keys = list(tree)
        for k, v in tree.items():
            if isinstance(v, (dict, list)):
                self.add_module(k, _node(v))
            elif v is None:
                self.register_parameter(k, None)
            else:
                self.register_parameter(k, nn.Parameter(v,
                                                        requires_grad=False))

    def tree(self) -> Dict:
        return {k: _unnode(getattr(self, k)) for k in self._keys}


def _node(v):
    if isinstance(v, dict):
        return _Tree(v)
    return nn.ModuleList(_node(b) for b in v)


def _unnode(v):
    if isinstance(v, _Tree):
        return v.tree()
    if isinstance(v, nn.ModuleList):
        return [_unnode(b) for b in v]
    return v
