"""A granite-4.0-h model's parameters, made from a seed (its token batches
are ``perfbench.gen.mamba2.batch``'s).

The layout (``layout``) is the configuration's held layers, each of the
kind ``layer_types`` gives it: its two RMS norms (``ln1``, ``ln2``), its
mixer (a Mamba2 block as ``perfbench.gen.mamba2.layout`` gives it, or
attention: q ``(d, heads, hd)``, k and v ``(d, kv heads, hd)``, o ``(heads,
hd, d)``, hd ``d / heads``), and its MoE: the router ``(d, E)`` in float32
over all ``num_local_experts_published`` experts, the held experts' ``wi
(held, d, 2, ff)`` (gate, up) and ``wo (held, ff, d)``, and the shared
expert's ``wi (d, 2, shared ff)`` and ``wo (shared ff, d)``; then the token
table (tied to the head) and the final norm.  Paths and order are the
program's parameter tree (``models.transformer.param_leaves``).  It imports
nothing of the program.

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


def layer_kinds(cfg: Dict) -> Tuple[str, ...]:
    """The kinds of the ``num_layers`` layers held."""
    return tuple(cfg["layer_types"][:int(cfg["num_layers"])])


def attention_dims(cfg: Dict) -> Tuple[int, int, int]:
    """(heads, kv heads, head dim) of the attention layers."""
    heads = int(cfg["num_attention_heads"])
    return heads, int(cfg["num_key_value_heads"]), \
        int(cfg["d_model"]) // heads


def layout(cfg: Dict) -> List[Leaf]:
    """Every parameter as ``(path, shape, dtype, init)`` in the program's
    order (module docstring)."""
    d, dt = int(cfg["d_model"]), cfg["param_dtype"]
    ff, sff = int(cfg["intermediate_size"]), \
        int(cfg["shared_intermediate_size"])
    E, held = int(cfg["num_local_experts_published"]), \
        int(cfg["num_local_experts"])
    heads, kv, hd = attention_dims(cfg)
    mamba = [(k.split("/", 2)[2], s, t, init)
             for k, s, t, init in gm.layout({**cfg, "num_layers": 1})
             if k.startswith("blocks/0/mamba/")]
    attn = [("attn/wk", (d, kv, hd), dt, "dense"),
            ("attn/wo", (heads, hd, d), dt, "dense"),
            ("attn/wq", (d, heads, hd), dt, "dense"),
            ("attn/wv", (d, kv, hd), dt, "dense")]
    out: List[Leaf] = []
    for i, kind in enumerate(layer_kinds(cfg)):
        leaves = (attn if kind == "attention" else []) + [
            ("ln1/scale", (d,), dt, "ones"),
            ("ln2/scale", (d,), dt, "ones")] + (
            mamba if kind == "mamba" else []) + [
            ("moe/router", (d, E), "float32", "dense"),
            ("moe/shared/wi", (d, 2, sff), dt, "dense"),
            ("moe/shared/wo", (sff, d), dt, "dense"),
            ("moe/wi", (held, d, 2, ff), dt, "dense"),
            ("moe/wo", (held, ff, d), dt, "dense")]
        out += [(f"blocks/{i}/{k}", s, t, init) for k, s, t, init in leaves]
    out.append(("embed/table", (gm.padded_vocab(cfg), d), dt, "dense"))
    out.append(("final_norm/scale", (d,), dt, "ones"))
    return out


def n_params(cfg: Dict) -> int:
    return sum(math.prod(s) for _, s, _, _ in layout(cfg))


def fan_in(path: str, shape: Tuple[int, ...]) -> int:
    """The inputs of a matrix: its leading dim, the attention's output
    projection's (heads, hd) together, an expert's dim after the expert
    axis, and the token table's rows as ``perfbench.gen.mamba2`` takes
    them."""
    if path.endswith("attn/wo"):
        return shape[0] * shape[1]
    if path.endswith(("moe/wi", "moe/wo")):
        return shape[1]
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
