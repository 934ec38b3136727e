"""Mixture-of-Experts layer (port of the reference's ``repro/models/moe.py``,
single device).

Capacity-bounded, sort-based dispatch, as the reference's ``_moe_local``:
the f32 router's softmax and top-k pick ``k`` experts a token; the (token,
expert) pairs are sorted stably by expert, each pair's rank within its
expert comes from the exclusive cumsum of the per-expert counts, and pairs
ranked past the capacity are dropped.  Kept rows are scattered into an
``(E, C, d)`` buffer (dropped rows add zeros at ``[0, 0]``), every expert's
SwiGLU/GeGLU FFN runs over its whole buffer as two batched matrix products
(the reference's ``einsum``, outside any Pallas kernel), and the outputs are
gathered back and added to their tokens with the gate weights.  Every shape
is static and nothing reads a value back to the host, so on the card the
dispatch stays on the stream.

On the card, ``index_add_`` in bf16 accumulates with atomics in no fixed
order, so an MoE layer there is reproducible only to rounding.

The reference's expert-parallel ``shard_map`` branch (``dist`` with a mesh)
is not ported: ROADMAP Queue 1 item 2.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

Tensor = torch.Tensor


def init_moe(gen, cfg, dtype=torch.float32, device=None):
    """Router ``(d, E)`` in f32 whatever ``dtype`` is (as the reference),
    experts ``wi (E, d, 2, ff)`` and ``wo (E, ff, d)``, and the shared
    experts as one MLP of width ``ff * num_shared_experts``."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": L.dense_init(gen, (d, E), torch.float32, device=device),
        "wi": L.dense_init(gen, (E, d, 2, ff), dtype, device=device),
        "wo": L.dense_init(gen, (E, ff, d), dtype, device=device),
    }
    if cfg.num_shared_experts:
        p["shared"] = L.init_mlp(gen, d, ff * cfg.num_shared_experts,
                                 cfg.mlp, cfg.use_bias, dtype, device)
    return p


def _capacity(tokens_local: int, cfg) -> int:
    c = int(math.ceil(tokens_local * cfg.top_k / cfg.num_experts
                      * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)


def route(p, x: Tensor, cfg, capacity: int):
    """The router and the dispatch plan for tokens ``x (T, d)``: returns
    ``(probs (T, E) f32, eid_s, tid_s, gate_s, counts (E,) int64, pos,
    keep)``, the pairs sorted stably by expert id."""
    T = x.shape[0]
    E, k = cfg.num_experts, cfg.top_k
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, k, dim=-1)          # (T, k)
    eid = idx.reshape(-1)
    tid = torch.arange(T * k, device=x.device) // k
    gate = gate_vals.reshape(-1)
    order = torch.sort(eid, stable=True).indices
    eid_s, tid_s, gate_s = eid[order], tid[order], gate[order]
    counts = torch.zeros(E, dtype=torch.int64, device=x.device).scatter_add_(
        0, eid_s, torch.ones_like(eid_s))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=x.device) - starts[eid_s]
    keep = pos < capacity
    return probs, eid_s, tid_s, gate_s, counts, pos, keep


def _moe_local(p, x: Tensor, cfg, capacity: int) -> Tuple[Tensor, Tensor]:
    """Dispatch and grouped expert FFN over every expert for tokens
    ``x (T, d)``.  Returns (y (T, d), stats (2E,): tokens per expert, then
    the router probabilities summed over the tokens)."""
    T, d = x.shape
    E = cfg.num_experts
    probs, eid_s, tid_s, gate_s, counts, pos, keep = route(p, x, cfg,
                                                           capacity)
    le = torch.where(keep, eid_s, 0)
    sp = torch.where(keep, pos, 0)
    vals = torch.where(keep[:, None], x[tid_s], 0)
    buf = torch.zeros((E, capacity, d), dtype=x.dtype,
                      device=x.device).index_put((le, sp), vals,
                                                 accumulate=True)
    wi = p["wi"]
    ff = wi.shape[-1]
    h = torch.bmm(buf, wi.reshape(E, d, 2 * ff)).unflatten(-1, (2, ff))
    act = F.silu if cfg.mlp == "swiglu" else L.gelu
    h = act(h[..., 0, :]) * h[..., 1, :]
    out = torch.bmm(h, p["wo"])                             # (E, C, d)
    tok_out = out[le, sp]                                   # gather combine
    w = torch.where(keep, gate_s, 0.0).to(x.dtype)
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device).index_add(
        0, tid_s, tok_out * w[:, None])
    return y, torch.cat([counts.float(), probs.sum(dim=0)])


def aux_loss_from_stats(stats: Tensor, cfg, total_tokens: float) -> Tensor:
    E = cfg.num_experts
    f = stats[:E] / max(total_tokens * cfg.top_k, 1.0)
    pbar = stats[E:] / max(total_tokens, 1.0)
    return E * torch.sum(f * pbar) * cfg.aux_loss_weight


def apply_moe(p, x: Tensor, cfg, dist=None) -> Tuple[Tensor, Tensor]:
    """x: (B, S, d).  Returns (y, aux stats (2E,))."""
    if dist is not None:
        raise NotImplementedError("expert parallelism is not ported: "
                                  "ROADMAP Queue 1 item 2")
    B, S, d = x.shape
    y, stats = _moe_local(p, x.reshape(B * S, d), cfg,
                          _capacity(B * S, cfg))
    routed = y.reshape(B, S, d)
    if "shared" in p:
        routed = routed + L.apply_mlp(p["shared"], x, cfg.mlp)
    return routed, stats
