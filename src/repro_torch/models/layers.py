"""Core neural-net building blocks in PyTorch (port of the reference's
``repro/models/layers.py``).

Conventions:
  * params are nested dicts of tensors with the reference's names;
  * ``init_*`` take a ``torch.Generator`` and return params (the values
    differ from the reference's ``jax.random`` draws; tests carry the
    reference's own init across with ``models.convert``);
  * norm/softmax run in fp32 regardless of activation dtype; on a CUDA
    tensor that is not a DTensor the RMS norm is K4
    (``repro_torch.kernels.rms_norm``), which computes the same function;
  * a stacked layer axis does not exist here: every layer holds its own
    tensors (the reference's ``scan`` becomes a Python loop).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import rms_norm as K4

Tensor = torch.Tensor

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


#: above this many fp32 bytes, ``dense_init`` draws slices of the leading
#: axis one after another, so its fp32 draw never holds a whole tensor
#: (llama4-maverick's experts ``wi`` would take 43 GB in fp32 on the card)
INIT_SLICE_BYTES = 1 << 32


def _trunc_normal(gen, shape, std: float, dtype, device) -> Tensor:
    if gen is None:
        # the init under a fake mode (``Transformer.init``): nothing drawn
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(std).to(dtype)


def dense_init(gen: torch.Generator, shape, dtype=torch.float32,
               scale: float = 1.0, device=None) -> Tensor:
    """Truncated-normal (+-2 sigma) fan-in init, drawn in fp32."""
    shape = tuple(shape)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(fan_in)
    if math.prod(shape) * 4 <= INIT_SLICE_BYTES:
        return _trunc_normal(gen, shape, std, dtype, device)
    out = torch.empty(shape, dtype=dtype, device=device)
    step = max(1, INIT_SLICE_BYTES // (4 * math.prod(shape[1:])))
    for i in range(0, shape[0], step):
        part = out[i:i + step]
        part.copy_(_trunc_normal(gen, part.shape, std, dtype, device))
    return out


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def init_norm(kind: str, d: int, dtype=torch.float32, device=None):
    p = {"scale": torch.ones(d, dtype=dtype, device=device)}
    if kind == "layer":
        p["bias"] = torch.zeros(d, dtype=dtype, device=device)
    return p


def apply_norm(p, x: Tensor, kind: str, eps: float) -> Tensor:
    """RMS norm or layernorm over the last dim in fp32, returned in x's
    dtype.  The RMS norm of a tensor K4 takes (``K4.takes``) runs K4; every
    other tensor runs its composed ops (``K4.rms_norm_reference``)."""
    if kind == "rms":
        if K4.takes(x):
            return K4.rms_norm(x, p["scale"], eps)
        return K4.rms_norm_reference(x.float(), p["scale"], eps)[0].to(
            x.dtype)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., S, H, D); positions: (..., S) integer."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (D/2,)
    ang = positions[..., None].float() * freqs              # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / plain GELU)
# ---------------------------------------------------------------------------

def init_mlp(gen, d: int, ff: int, kind: str, use_bias: bool,
             dtype=torch.float32, device=None):
    gated = kind in ("swiglu", "geglu")
    p = {"wi": dense_init(gen, (d, 2, ff) if gated else (d, ff), dtype,
                          device=device),
         "wo": dense_init(gen, (ff, d), dtype, device=device)}
    if use_bias:
        p["bi"] = torch.zeros((2, ff) if gated else (ff,), dtype=dtype,
                              device=device)
        p["bo"] = torch.zeros(d, dtype=dtype, device=device)
    return p


class _EvenReshape(torch.autograd.Function):
    """A DTensor reshape that first replicates what it would shard
    unevenly, in the forward and in the backward
    (``dist.sharding.even_for_reshape``)."""

    @staticmethod
    def forward(ctx, x, shape):
        from repro_torch.dist.sharding import even_for_reshape
        ctx.shape = x.shape
        return even_for_reshape(x, shape).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.dist.sharding import even_for_reshape
        return even_for_reshape(g, ctx.shape).reshape(ctx.shape), None


def reshape(t: Tensor, shape) -> Tensor:
    """``t.reshape(shape)``; under a mesh (a DTensor) the reshape cannot
    fail on a dim that DTensor chose to shard unevenly for it
    (``_EvenReshape``)."""
    shape = tuple(shape)
    if type(t).__name__ == "DTensor":
        return _EvenReshape.apply(t, shape)
    return t.reshape(shape)


def gelu(x: Tensor) -> Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(p, x: Tensor, kind: str) -> Tensor:
    wi = p["wi"]
    if kind in ("swiglu", "geglu"):
        d, _, ff = wi.shape
        h = x @ reshape(wi, (d, 2 * ff))
        h = reshape(h, h.shape[:-1] + (2, ff))
        if "bi" in p:
            h = h + p["bi"]
        gate, up = h[..., 0, :], h[..., 1, :]
        act = F.silu(gate) if kind == "swiglu" else gelu(gate)
        h = act * up
    else:
        h = x @ wi
        if "bi" in p:
            h = h + p["bi"]
        h = gelu(h)
    y = h @ p["wo"]
    if "bo" in p:
        y = y + p["bo"]
    return y


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def init_embed(gen, vocab: int, d: int, dtype=torch.float32, device=None):
    return {"table": dense_init(gen, (vocab, d), dtype, scale=1.0,
                                device=device)}


def embed_lookup(p, ids: Tensor, scale: bool, d: int) -> Tensor:
    out = p["table"][ids]
    if scale:
        out = out * torch.tensor(math.sqrt(d), dtype=out.dtype,
                                 device=out.device)
    return out


def lm_logits(table_or_head: Tensor, x: Tensor, softcap: float) -> Tensor:
    """fp32 logits: the product in the activation dtype, then cast, then
    the tanh softcap (the reference's order, ``layers.py:133-137``)."""
    logits = (x @ table_or_head.t()).float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


def softcap(x: Tensor, cap: float) -> Tensor:
    return torch.tanh(x / cap) * cap if cap else x


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def cross_entropy(logits: Tensor, labels: Tensor, vocab_size: int
                  ) -> Tuple[Tensor, Tensor]:
    """Mean next-token NLL over non-pad labels (label < 0 is padding).
    logits fp32 (..., V_padded); padded vocab positions are masked out.
    Returns (mean NLL, the count of non-pad labels, at least 1)."""
    nll_sum, count = cross_entropy_sums(logits, labels, vocab_size)
    total = count.clamp(min=1.0)
    return nll_sum / total, total


def cross_entropy_sums(logits: Tensor, labels: Tensor, vocab_size: int
                       ) -> Tuple[Tensor, Tensor]:
    """``cross_entropy``'s two sums: the NLL summed over non-pad labels,
    and their count."""
    v = logits.shape[-1]
    keep = torch.arange(v, device=logits.device) < vocab_size
    logits = torch.where(keep, logits,
                         torch.finfo(torch.float32).min)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      labels.clamp(min=0).long()[..., None])[..., 0]
    nll = lse - ll
    mask = (labels >= 0).float()
    return (nll * mask).sum(), mask.sum()


def param_bytes(tree: Dict) -> int:
    """Bytes held by every tensor of a nested dict/list of tensors."""
    if isinstance(tree, Tensor):
        return tree.numel() * tree.element_size()
    items = tree.values() if isinstance(tree, dict) else tree
    return sum(param_bytes(t) for t in items)
