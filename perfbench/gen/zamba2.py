"""A published Zamba2 model's parameters, made from a seed (its token
batches are ``perfbench.gen.mamba2.batch``'s).

The layout (``layout``) is the configuration's held layers: each a Mamba2
layer as ``perfbench.gen.mamba2.layout`` gives it (its RMS norm and block),
the hybrid layers (``hybrid_ids``: the ``layers_block_type`` entries
"hybrid" among the first ``num_layers``) with their own adapter of the
shared MLP's ``gate_up`` (``adapter/a (d, rank)``, ``adapter/b (rank, 2,
ff)``) and output linear (``linear (d, d)``); the token table (tied to the
head) and the final norm; and ``num_mem_blocks`` shared blocks, each the
norm of its ``2 d``-wide input, q/k/v ``(2 d, heads, hd)``, o ``(heads,
hd, d)``, the norm before the MLP, ``wi (d, 2, ff)`` (gate, up) and ``wo
(ff, d)``.  Paths and order are the program's parameter tree
(``models.transformer.param_leaves``).  It imports nothing of the program.

Weights are drawn on the device as ``perfbench.gen.mamba2.make_weights``
draws them: ``A_log`` and ``dt_bias`` from one uniform draw (A in [1, 16],
dt log-uniform in [1e-3, 1e-1]), every matrix from one stream of standard
normals in layout order scaled by ``1/sqrt(fan in)`` (``fan_in``), the conv
kernels by ``1/sqrt(width)``; norm scales and ``D`` ones, conv biases
zeros.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from perfbench.gen import mamba2 as gm

Leaf = gm.Leaf


def hybrid_ids(cfg: Dict) -> Tuple[int, ...]:
    """The hybrid layers among the ``num_layers`` held."""
    L = int(cfg["num_layers"])
    return tuple(i for i, t in enumerate(cfg["layers_block_type"][:L])
                 if t == "hybrid")


def attention_dims(cfg: Dict) -> Tuple[int, int, int]:
    """(heads, kv heads, head dim) of the shared attention: q/k/v read
    ``concat(x, e)``, ``2 d_model`` wide, in heads of ``2 d_model /
    heads`` (the published ``attention_head_dim``)."""
    d, heads = int(cfg["d_model"]), int(cfg["num_attention_heads"])
    return heads, int(cfg["num_key_value_heads"]), 2 * d // heads


def layout(cfg: Dict) -> List[Leaf]:
    """Every parameter as ``(path, shape, dtype, init)`` in the program's
    order (module docstring)."""
    d, dt = int(cfg["d_model"]), cfg["param_dtype"]
    ff, r = int(cfg["intermediate_size"]), int(cfg["adapter_rank"])
    heads, kv, hd = attention_dims(cfg)
    extras = [("adapter/a", (d, r), dt, "dense"),
              ("adapter/b", (r, 2, ff), dt, "dense"),
              ("linear", (d, d), dt, "dense")]
    ids = set(hybrid_ids(cfg))
    out: List[Leaf] = []
    for leaf in gm.layout(cfg):
        parts = leaf[0].split("/")
        if parts[0] == "blocks" and parts[2:] == ["ln", "scale"] \
                and int(parts[1]) in ids:
            out += [(f"blocks/{parts[1]}/{k}", s, t, init)
                    for k, s, t, init in extras]
        out.append(leaf)
    block = [("attn/wk", (2 * d, kv, hd), dt, "dense"),
             ("attn/wo", (heads, hd, d), dt, "dense"),
             ("attn/wq", (2 * d, heads, hd), dt, "dense"),
             ("attn/wv", (2 * d, kv, hd), dt, "dense"),
             ("ln1/scale", (2 * d,), dt, "ones"),
             ("ln2/scale", (d,), dt, "ones"),
             ("mlp/wi", (d, 2, ff), dt, "dense"),
             ("mlp/wo", (ff, d), dt, "dense")]
    for k in range(int(cfg["num_mem_blocks"])):
        out += [(f"shared/{k}/{p}", s, t, init) for p, s, t, init in block]
    return out


def n_params(cfg: Dict) -> int:
    return sum(math.prod(s) for _, s, _, _ in layout(cfg))


def fan_in(path: str, shape: Tuple[int, ...]) -> int:
    """The inputs of a matrix: its leading dim, the output projection's
    (heads, hd) together, and the token table's rows as
    ``perfbench.gen.mamba2`` takes them."""
    if path.endswith("attn/wo"):
        return math.prod(shape[:-1])
    return shape[0]


def make_weights(cfg: Dict, seed: int, device, dtype: str | None = None
                 ) -> Dict[str, torch.Tensor]:
    """``{path: tensor}`` of every parameter (module docstring), each in
    its layout dtype, or all in ``dtype`` (the values rounded to the layout
    dtype first)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    leaves = layout(cfg)
    small = [lf for lf in leaves if lf[3] in ("A_log", "dt_bias")]
    u = torch.rand(sum(math.prod(s) for _, s, _, _ in small), generator=gen,
                   device=device)
    pos = 0
    normals = gm._Normals(gen, device)
    out: Dict[str, torch.Tensor] = {}
    for path, shape, dt, init in leaves:
        n = math.prod(shape)
        if init in ("A_log", "dt_bias"):
            v = u[pos:pos + n]
            pos += n
            if init == "A_log":
                t = torch.log(1.0 + 15.0 * v)
            else:
                lo, hi = math.log(1e-3), math.log(1e-1)
                step = torch.exp(v * (hi - lo) + lo)
                t = step + torch.log(-torch.expm1(-step))
        elif init == "ones":
            t = torch.ones(n, device=device)
        elif init == "zeros":
            t = torch.zeros(n, device=device)
        else:
            fan = shape[-1] if init == "conv" else fan_in(path, shape)
            t = normals.take(n) / math.sqrt(fan)
        t = t.reshape(shape).to(gm.DTYPES[dt])
        out[path] = t if dtype is None else t.to(gm.DTYPES[dtype])
    return out
