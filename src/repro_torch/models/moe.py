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
gathered back and added to their tokens with the gate weights
(``combine``: each token's ``k`` rows one at a time in the reference's
order, with no atomics, so a layer gives the same bits on every run).
Every shape is static and nothing reads a value back to the host, so on
the card the dispatch stays on the stream.

Expert parallelism (``dist`` with a mesh; the reference's "replicated-token
EP", DESIGN.md §4): activations are sharded over the data dims and
replicated over the model dim; experts are sharded over the model dim.  In
a ``dist.compat.shard_map`` region each model shard dispatches the tokens
it holds to its ``E / tp`` experts from ``e0 = rank_tp * E / tp``, the
experts' weights FSDP-gathered over the data dims (unless ``zero1_moe`` or
fsdp is off), and the partial outputs are summed over the model dim; the
router stats are summed over every dim and divided by the model dim's
size.  Only all-reduces and all-gathers: no all-to-all.
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


def combine(contrib: Tensor, tid_s: Tensor, T: int, k: int) -> Tensor:
    """Each token's ``k`` rows of ``contrib`` (rows in the sorted order of
    ``tid_s``) added in ``contrib``'s dtype, one slot at a time from zeros,
    in the order the rows stand in the sort: ``((0 + s0) + s1) + ...``, the
    order of the reference's ``y.at[tid_s].add(...)``.  Nothing is atomic,
    so the sum is the same on every run and device.  ``sum(dim=1)`` would
    accumulate bf16 in f32 and round once, a different result."""
    # each token's places in the sort, ascending; the sort is stable by
    # expert, so that is the token's ascending expert id
    rows = contrib[torch.argsort(tid_s, stable=True).view(T, k)]
    y = torch.zeros((T,) + contrib.shape[1:], dtype=contrib.dtype,
                    device=contrib.device)
    for j in range(k):
        y = y + rows[:, j]
    return y


def _moe_local(p, x: Tensor, cfg, e_start: int, e_count: int,
               capacity: int) -> Tuple[Tensor, Tensor]:
    """Dispatch and grouped expert FFN over the local expert slice
    ``[e_start, e_start + e_count)`` for tokens ``x (T, d)``; ``p["wi"]`` is
    ``(e_count, d, 2, ff)``.  Returns (y (T, d): those experts' part of
    the layer's output, stats (2E,): tokens per expert, then the router
    probabilities summed over the tokens)."""
    T, d = x.shape
    k = cfg.top_k
    probs, eid_s, tid_s, gate_s, counts, pos, keep = route(p, x, cfg,
                                                           capacity)
    keep = keep & (eid_s >= e_start) & (eid_s < e_start + e_count)
    le = torch.where(keep, eid_s - e_start, 0)
    sp = torch.where(keep, pos, 0)
    vals = torch.where(keep[:, None], x[tid_s], 0)
    buf = torch.zeros((e_count, capacity, d), dtype=x.dtype,
                      device=x.device).index_put((le, sp), vals,
                                                 accumulate=True)
    wi = p["wi"]
    ff = wi.shape[-1]
    h = torch.bmm(buf, wi.reshape(e_count, d, 2 * ff)).unflatten(-1, (2, ff))
    act = F.silu if cfg.mlp == "swiglu" else L.gelu
    h = act(h[..., 0, :]) * h[..., 1, :]
    out = torch.bmm(h, p["wo"])                       # (e_count, C, d)
    tok_out = out[le, sp]                             # gather combine
    w = torch.where(keep, gate_s, 0.0).to(x.dtype)
    y = combine(tok_out * w[:, None], tid_s, T, k)
    return y, torch.cat([counts.float(), probs.sum(dim=0)])


def aux_loss_from_stats(stats: Tensor, cfg, total_tokens: float) -> Tensor:
    E = cfg.num_experts
    f = stats[:E] / max(total_tokens * cfg.top_k, 1.0)
    pbar = stats[E:] / max(total_tokens, 1.0)
    return E * torch.sum(f * pbar) * cfg.aux_loss_weight


def apply_moe(p, x: Tensor, cfg, dist=None) -> Tuple[Tensor, Tensor]:
    """x: (B, S, d).  Returns (y, aux stats (2E,) summed over the fleet)."""
    B, S, d = x.shape
    E = cfg.num_experts
    if dist is None or dist.mesh is None:
        y, stats = _moe_local(p, x.reshape(B * S, d), cfg, 0, E,
                              _capacity(B * S, cfg))
        routed = y.reshape(B, S, d)
    else:
        routed, stats = _moe_expert_parallel(p, x, cfg, dist)
    if "shared" in p:
        routed = routed + L.apply_mlp(p["shared"], x, cfg.mlp)
    return routed, stats


def _moe_expert_parallel(p, x: Tensor, cfg, dist):
    """The expert-parallel branch of ``apply_moe`` (module docstring)."""
    from torch.distributed.tensor import Partial

    from repro_torch.dist.compat import (all_gather_fwd, all_reduce_fwd,
                                         shard_map)
    from repro_torch.dist.sharding import P
    B, S, d = x.shape
    E = cfg.num_experts
    mesh = dist.mesh
    dp, tp = dist.dp_axes, dist.tp_axis
    ep = dist.tp_size
    if E % ep:
        raise ValueError(f"{E} experts do not split over {ep} model shards")
    e_loc = E // ep
    cap = _capacity((B // dist.dp_size) * S, cfg)
    names = dist.axis_names
    # a mesh dim of size 1 shards nothing: leave it replicated (DTensor
    # will not fold a size-1 dim it holds as sharded)
    dpe = dist._dp_entry() if dist.dp_size > 1 else None
    # ZeRO-1 experts, and serving (fsdp off): weights resident, no
    # per-layer gathers
    zero1 = dist.zero1_moe or not dist.fsdp
    pspec = {"router": P(None, None),
             "wi": P(tp, None, None, None) if zero1 else P(tp, dpe, None, None),
             "wo": P(tp, None, None) if zero1 else P(tp, None, dpe)}

    def grad_of(spec, partial_over):
        """``spec``'s placements, with ``Partial`` on the mesh dims whose
        shards each hold only part of the gradient."""
        pl = list(dist.placements(spec))
        for i, a in enumerate(names):
            if a in partial_over:
                pl[i] = Partial()
        return tuple(pl)

    gspec = {"router": grad_of(pspec["router"], names),
             "wi": grad_of(pspec["wi"], dp if zero1 else ()),
             "wo": grad_of(pspec["wo"], dp if zero1 else ())}
    xspec = P(dpe, None, None)
    xgrad = grad_of(xspec, (tp,) if tp else ())
    groups = {a: mesh.get_group(a) for a in names}

    def body(pl, xl):
        wi, wo = pl["wi"], pl["wo"]
        if not zero1:
            # FSDP-gather the local experts' weights over the data dims,
            # innermost first (a tensor dim over (pod, data) is pod-major)
            for a in reversed(dp):
                wi = all_gather_fwd(wi, groups[a], 1)
                wo = all_gather_fwd(wo, groups[a], 2)
        e0 = (mesh.get_local_rank(tp) if tp else 0) * e_loc
        T = xl.shape[0] * xl.shape[1]
        y, stats = _moe_local({"router": pl["router"], "wi": wi, "wo": wo},
                              xl.reshape(T, d), cfg, e0, e_loc, cap)
        if tp:
            y = all_reduce_fwd(y, groups[tp])   # combine expert partials
        # every model shard computes identical router stats for its data
        # shard's tokens -> divide the tp duplication out
        for a in names:
            stats = all_reduce_fwd(stats, groups[a])
        return y.reshape(xl.shape), stats / ep

    routed_p = {k: p[k] for k in ("router", "wi", "wo")}
    region = shard_map(body, mesh=mesh, in_specs=(pspec, xspec),
                       in_grad_specs=(gspec, xgrad),
                       out_specs=(xspec, P(None)))
    return region(routed_p, x)
