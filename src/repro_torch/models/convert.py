"""The reference's parameters carried across into the port.

``params_from_reference(tree, cfg)`` takes the pytree that the JAX
reference's ``Transformer.init`` returns, with every leaf already turned
into a numpy array by the caller (``np.asarray``; bf16 leaves arrive as
``ml_dtypes.bfloat16``), and returns this port's parameters: the same names,
with the reference's stacked layer axes split into one dict per layer
(``(L, ...)`` -> ``blocks[i]``; gemma2's ``(L/2, 2, ...)`` -> ``blocks[2i+j]``;
a mamba2 layer is ``{"ln", "mamba"}``).  The ``moe`` family's two layouts:
deepseek's ``dense0 (first_dense, ...)`` and ``blocks (L - first_dense,
...)`` become layers ``0 .. first_dense - 1`` and the rest; llama4's
``pair_dense (L/2, ...)`` and ``pair_moe (L/2, ...)`` become layers ``2i``
and ``2i + 1``.  The ``hybrid`` family's ``groups (ngroups, k, ...)`` and
``tail (tail, ...)`` of mamba2 layers become layers ``g k + j`` and then the
tail's; its unstacked ``shared_attn`` block is carried as it is.  Every leaf
keeps its reference dtype: mamba2's f32
``A_log``, ``D`` and ``dt_bias`` and the MoE router stay f32 under bf16
parameters, and bf16 goes through float32, so its values are carried bit for
bit.  Nothing of JAX is imported: the tree is plain dicts of numpy arrays.

The parameters land on ``device``; ``None`` means the card
(``core.service.resolve_device``), which raises without one unless the
caller asks for ``"cpu"``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.service import resolve_device

#: the reference's stacked layer groups of the ``moe`` family
MOE_GROUPS = ("dense0", "blocks", "pair_dense", "pair_moe")
#: and of the ``hybrid`` family
HYBRID_GROUPS = ("groups", "tail")


def _tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":           # ml_dtypes.bfloat16
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device=device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _layers(sub, n: int, device, inner: int = 0):
    """The first ``n`` layers of a stacked group as one dict each
    (``inner``: the size of a second stacked axis, as gemma2's ``(L/2, 2,
    ...)`` pairs or a hybrid model's ``(ngroups, k, ...)`` groups)."""
    def take(a, i):
        a = np.asarray(a)
        return a[i // inner, i % inner] if inner else a[i]
    return [_map(sub, lambda a, i=i: _tensor(take(a, i), device))
            for i in range(n)]


def params_from_reference(tree: Dict[str, Any], cfg, device=None
                          ) -> Dict[str, Any]:
    """See the module docstring.  ``cfg`` is the port's ``ModelConfig`` of
    the same architecture (any family)."""
    device = resolve_device(device)
    L = cfg.num_layers
    hybrid = cfg.family == "hybrid"
    groups = MOE_GROUPS if cfg.is_moe else \
        HYBRID_GROUPS if hybrid else ("blocks",)
    out: Dict[str, Any] = {key: _map(sub, lambda a: _tensor(a, device))
                           for key, sub in tree.items() if key not in groups}
    if hybrid:
        k = cfg.shared_attn_every
        ngroups, tail = divmod(L, k)
        out["blocks"] = _layers(tree["groups"], ngroups * k, device, k) \
            + (_layers(tree["tail"], tail, device) if tail else [])
    elif not cfg.is_moe:
        out["blocks"] = _layers(tree["blocks"], L, device,
                                2 if cfg.local_global else 0)
    elif cfg.moe_every == 2:
        dense = _layers(tree["pair_dense"], L // 2, device)
        moe = _layers(tree["pair_moe"], L // 2, device)
        out["blocks"] = [b for pair in zip(dense, moe) for b in pair]
    else:
        nd = cfg.first_dense
        out["blocks"] = (_layers(tree["dense0"], nd, device) if nd else []) \
            + _layers(tree["blocks"], L - nd, device)
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
    blocks = [_map(b, f32) for b in params["blocks"]]
    if cfg.family == "hybrid":
        k = cfg.shared_attn_every
        ngroups, tail = divmod(cfg.num_layers, k)
        out["groups"] = _map(_stack(blocks[:ngroups * k]),
                             lambda a: a.reshape((ngroups, k) + a.shape[1:]))
        if tail:
            out["tail"] = _stack(blocks[ngroups * k:])
        return out
    if cfg.is_moe and cfg.moe_every == 2:
        out["pair_dense"] = _stack(blocks[0::2])
        out["pair_moe"] = _stack(blocks[1::2])
        return out
    if cfg.is_moe and cfg.first_dense:
        out["dense0"] = _stack(blocks[:cfg.first_dense])
        blocks = blocks[cfg.first_dense:]
    stacked = _stack(blocks)
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
