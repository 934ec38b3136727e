"""The reference's parameters carried across into the port.

``params_from_reference(tree, cfg)`` takes the pytree that the JAX
reference's ``Transformer.init`` returns, with every leaf already turned
into a numpy array by the caller (``np.asarray``; bf16 leaves arrive as
``ml_dtypes.bfloat16``), and returns this port's parameters: the same names,
with the reference's stacked layer axes split into one dict per layer
(``(L, ...)`` -> ``blocks[i]``; gemma2's ``(L/2, 2, ...)`` -> ``blocks[2i+j]``).
bf16 goes through float32, so the values are carried bit for bit.  Nothing
of JAX is imported: the tree is plain dicts of numpy arrays.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.layers import dtype_of


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.kind not in "fiub":           # ml_dtypes.bfloat16 and kin
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_reference(tree: Dict[str, Any], cfg, device=None
                          ) -> Dict[str, Any]:
    """See the module docstring.  ``cfg`` is the port's ``ModelConfig`` of
    the same architecture (a ``dense``/``vlm``/``audio`` family)."""
    dt = dtype_of(cfg.param_dtype)
    device = torch.device("cpu" if device is None else device)
    out: Dict[str, Any] = {}
    for key, sub in tree.items():
        if key != "blocks":
            out[key] = _map(sub, lambda a: _tensor(a, dt, device))
            continue
        L = cfg.num_layers
        if cfg.local_global:
            take = lambda a, i: np.asarray(a)[i // 2, i % 2]  # noqa: E731
        else:
            take = lambda a, i: np.asarray(a)[i]              # noqa: E731
        out["blocks"] = [_map(sub, lambda a, i=i: _tensor(take(a, i), dt,
                                                          device))
                         for i in range(L)]
    return out


def params_to_numpy(params, cfg) -> Dict[str, Any]:
    """The port's parameters as nested dicts of float32 numpy arrays, with
    the per-layer list restacked the reference's way: the inverse of
    ``params_from_reference`` (a test helper)."""
    def f32(t):
        return t.detach().float().cpu().numpy()
    out: Dict[str, Any] = {}
    for key, sub in params.items():
        if key == "blocks":
            continue
        out[key] = _map(sub, f32)
    stacked = _stack([_map(b, f32) for b in params["blocks"]])
    if cfg.local_global:
        stacked = _map(stacked, lambda a: a.reshape(
            (a.shape[0] // 2, 2) + a.shape[1:]))
    out["blocks"] = stacked
    return out


def _stack(dicts):
    first = dicts[0]
    if isinstance(first, dict):
        return {k: _stack([d[k] for d in dicts]) for k in first}
    return np.stack(dicts)
