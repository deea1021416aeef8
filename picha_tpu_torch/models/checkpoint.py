"""Checkpoint / resume for training runs, in the reference's npz format.

Counterpart of `picha_tpu/models/checkpoint.py` (:60-102), without jax:
one flattened npz holding `params/<path>` for every parameter leaf (dict
keys sorted, list indices, None leaves skipped), `opt/<i>` for the
optimizer state's leaves in tree order, and `__meta__`, a JSON string of
{"step", "input_state"}; written to a temporary file beside `path` and
moved into place with `os.replace`. The port's `optim.AdamWState(count,
mu, nu)` flattens to optax's adamw leaves (count, every mu leaf, every nu
leaf), so a checkpoint written by either package loads in the other.
`input_state` is the ingest's `TrainingInput.state()`.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from ..optim import tree_leaves, tree_unflatten


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix="", out=None):
    if out is None:
        out = {}
    if tree is None:
        # None leaves carry no data; the template restores them on load
        return out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        out[prefix.rstrip("/")] = _numpy(tree)
    return out


def _unflatten_into(template, flat, prefix=""):
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_into(v, flat, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    return _like(flat[prefix.rstrip("/")], template)


def _like(arr, template):
    """An npz array as a tensor with the template leaf's dtype and device."""
    t = torch.from_numpy(np.array(arr))
    if isinstance(template, torch.Tensor):
        return t.to(device=template.device, dtype=template.dtype)
    return t


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    raise TypeError(f"not JSON serialisable: {type(o)!r}")


def save_checkpoint(path: str, params: Any, opt_state: Any = None,
                    input_state: Optional[dict] = None, step: int = 0) -> None:
    """Atomic write of {params, opt_state, input_state, step} to `path`."""
    payload = _flatten({"params": params})
    if opt_state is not None:
        for i, leaf in enumerate(tree_leaves(opt_state)):
            payload[f"opt/{i}"] = _numpy(leaf)
    meta = json.loads(json.dumps(
        {"step": step, "input_state": input_state or {}},
        default=_json_default))
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta, default=_json_default),
                     **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, params_template: Any,
                    opt_state_template: Any = None):
    """Returns (params, opt_state, input_state, step); each leaf takes its
    template leaf's dtype and device; opt_state is None when no template
    is supplied."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    params = _unflatten_into(params_template, flat, "params/")
    opt_state = None
    if opt_state_template is not None:
        leaves = tree_leaves(opt_state_template)
        opt_state = tree_unflatten(opt_state_template, [
            _like(flat[f"opt/{i}"], leaf) for i, leaf in enumerate(leaves)])
    return params, opt_state, meta["input_state"], meta["step"]
