"""Attention: GQA/MQA/MHA over the blocked online-softmax core (kernel K2 on
the card), sliding-window and logit-softcap variants (gemma2), MLA
(deepseek-v2) with its per-head K/V materialized for training and prefill
(K2 at q/k head dim 192, v 128) and absorbed for decode, and the
single-token decode paths against a KV cache or MLA's latent cache (port of
the reference's ``repro/models/attention.py``).

With ``dist`` (a ``dist.sharding.DistCtx``) the activations are DTensors.
The attention core runs in a ``dist.compat.shard_map`` region with batch
over the data-parallel dims and heads over the model dim
(``constrain_heads``), because DTensor has no sharding rule for K2; the
rest propagates through DTensor's own rules.  ``pad_heads`` pads the heads
with phantoms to a multiple of the model dim, as the reference does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
from repro_torch.models.attention_core import (  # noqa: F401
    NEG_INF, AttnSpec, _mask, blocked_attention)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_gqa(gen, cfg, dtype=torch.float32, device=None):
    d, H, KV, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": L.dense_init(gen, (d, H, D), dtype, device=device),
        "wk": L.dense_init(gen, (d, KV, D), dtype, device=device),
        "wv": L.dense_init(gen, (d, KV, D), dtype, device=device),
        "wo": L.dense_init(gen, (H, D, d), dtype, device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, D), dtype=dtype, device=device)
        p["bk"] = torch.zeros((KV, D), dtype=dtype, device=device)
        p["bv"] = torch.zeros((KV, D), dtype=dtype, device=device)
    return p


def init_mla(gen, cfg, dtype=torch.float32, device=None):
    d, H = cfg.d_model, cfg.num_heads
    r, nope, ro, vd = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                       cfg.v_head_dim)
    return {
        "wq": L.dense_init(gen, (d, H, nope + ro), dtype, device=device),
        "wkv_down": L.dense_init(gen, (d, r + ro), dtype, device=device),
        "latent_norm": torch.ones(r, dtype=dtype, device=device),
        "wk_up": L.dense_init(gen, (r, H, nope), dtype, device=device),
        "wv_up": L.dense_init(gen, (r, H, vd), dtype, device=device),
        "wo": L.dense_init(gen, (H, vd, d), dtype, device=device),
    }


def _proj(x: Tensor, w: Tensor) -> Tensor:
    """``einsum("bsd,dhx->bshx")`` as one matrix product."""
    d, h, e = w.shape
    y = x @ L.reshape(w, (d, h * e))
    return L.reshape(y, y.shape[:-1] + (h, e))


def _qkv(p, x: Tensor, cfg, positions: Tensor):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (L.apply_rope(q, positions, cfg.rope_theta),
            L.apply_rope(k, positions, cfg.rope_theta), v)


def _out(o: Tensor, wo: Tensor) -> Tensor:
    """``einsum("bshx,hxd->bsd")`` as one matrix product."""
    h, e, d = wo.shape
    return L.reshape(o, o.shape[:-2] + (h * e,)) @ L.reshape(wo, (h * e, d))


def attention_ref(q, k, v, spec: AttnSpec, q_offset=0, kv_len=None):
    """Unblocked oracle for tests."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = spec.scale or 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, KV, G, D)
    s = torch.einsum("btkgd,bskd->btkgs", qg.float(), k.float()) * scale
    if spec.softcap:
        s = torch.tanh(s / spec.softcap) * spec.softcap
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = _mask(qpos, kpos, spec, kv_len)
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("btkgs,bskd->btkgd", p.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def attention_core(impl, q: Tensor, k: Tensor, v: Tensor, spec: AttnSpec,
                   dist=None) -> Tensor:
    """``impl(q, k, v, spec)``; under ``dist`` on DTensors, in a local-shard
    region with q and the output constrained to ``constrain_heads``, and k,
    v sharded alike (GQA k/v are first expanded to one head per q head
    where their own heads do not divide the model dim)."""
    if dist is None or dist.mesh is None:
        return impl(q, k, v, spec)
    from repro_torch.dist.compat import shard_map
    from repro_torch.dist.sharding import P
    q = dist.constrain_heads(q)
    qs = dist.heads_spec(q)
    H, KV = q.shape[2], k.shape[2]
    if qs[2] is not None and KV % dist.tp_size:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    ks = list(qs)
    core = shard_map(lambda ql, kl, vl: impl(ql, kl, vl, spec),
                     mesh=dist.mesh, in_specs=(P(*qs), P(*ks), P(*ks)),
                     out_specs=P(*qs))
    return dist.constrain_heads(core(q, k, v))


def _pad_heads(t: Tensor, Hp: int, dim: int) -> Tensor:
    """``t`` with zero heads appended along ``dim`` up to ``Hp``."""
    shape = list(t.shape)
    shape[dim] = Hp - shape[dim]
    return torch.cat([t, torch.zeros_like(t.narrow(dim, 0, 1)).expand(
        shape)], dim=dim)


# ---------------------------------------------------------------------------
# GQA block apply
# ---------------------------------------------------------------------------

def apply_gqa(p, x: Tensor, cfg, positions: Tensor, spec: AttnSpec,
              impl=blocked_attention, dist=None, pad_heads=False):
    """Returns (attention output (B, S, d), (k, v))."""
    q, k, v = _qkv(p, x, cfg, positions)
    H, KV = q.shape[2], k.shape[2]
    wo = p["wo"]
    tp = dist.tp_size if dist is not None else 1
    if pad_heads and dist is not None and tp > 1 and H % tp != 0:
        # PHANTOM-HEAD PADDING (the reference's EXPERIMENTS §Perf H2):
        # expand GQA kv to one head per q head and zero-pad q/k/v/wo to the
        # next multiple of tp so every attention tensor shards evenly.
        # Phantom heads have zero v and zero wo rows, so outputs and
        # gradients are exact.
        G = H // KV
        Hp = -(-H // tp) * tp
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
        q, k, v = (_pad_heads(t, Hp, 2) for t in (q, k, v))
        wo = _pad_heads(wo, Hp, 0)
    out = attention_core(impl, q, k, v, spec, dist)
    return _out(out, wo), (k, v)


def gqa_decode(p, x: Tensor, cfg, pos: int, k_cache: Tensor,
               v_cache: Tensor, spec: AttnSpec, ring: bool = False):
    """x: (B, 1, d); caches: (B, S_max, KV, D); pos: the current position.
    Writes the new k/v into the caches IN PLACE and returns
    (out, k_cache, v_cache)."""
    pos = int(pos)
    q, k, v = _qkv(p, x, cfg, torch.tensor([pos], device=x.device))
    S_max = k_cache.shape[1]
    slot = pos % S_max if ring else min(pos, S_max - 1)
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]

    B, _, H, D = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    scale = spec.scale or 1.0 / math.sqrt(D)
    qg = q.reshape(B, KV, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * scale
    if spec.softcap:
        s = torch.tanh(s / spec.softcap) * spec.softcap
    idx = torch.arange(S_max, device=x.device)
    if ring:
        # the ring holds the last S_max tokens; until it wraps, only
        # slots <= pos are live
        valid = torch.ones_like(idx, dtype=torch.bool) if pos >= S_max \
            else idx <= pos
    else:
        valid = idx <= pos
        if spec.window:
            valid &= idx > pos - spec.window
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", pr.to(v_cache.dtype), v_cache)
    out = out.reshape(B, 1, H, v_cache.shape[-1])
    return _out(out.to(x.dtype), p["wo"]), k_cache, v_cache


# ---------------------------------------------------------------------------
# MLA (deepseek-v2)
# ---------------------------------------------------------------------------

def _mla_scale(cfg):
    return (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5


def _mla_latent(p, x: Tensor, cfg, positions: Tensor):
    """The RMS-normed latent ``(B, S, r)`` and the roped ``k_rope`` ``(B, S,
    1, ro)``, one head shared by every q head."""
    r = cfg.kv_lora_rank
    down = x @ p["wkv_down"]
    latent = L.apply_norm({"scale": p["latent_norm"]}, down[..., :r], "rms",
                          cfg.norm_eps)
    k_rope = L.apply_rope(down[..., None, r:], positions, cfg.rope_theta)
    return latent, k_rope


def apply_mla(p, x: Tensor, cfg, positions: Tensor, spec: AttnSpec,
              impl=blocked_attention, dist=None):
    """Training/prefill MLA: per-head K and V materialized from the latent,
    the roped key dims shared across heads, scale ``(nope + rope)^-0.5``.
    q and k reach ``impl`` as ``(B, S, H, nope + rope)`` and v as ``(B, S,
    H, v_head_dim)``, all contiguous (K2's TMA reads them as they are).
    Returns (output (B, S, d), (latent, k_rope (B, S, ro)))."""
    B, S, _ = x.shape
    H, nope, ro = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = _proj(x, p["wq"])
    q_rope = L.apply_rope(q[..., nope:], positions, cfg.rope_theta)
    latent, k_rope = _mla_latent(p, x, cfg, positions)
    k_nope = _proj(latent, p["wk_up"])
    v = _proj(latent, p["wv_up"])
    qc = torch.cat([q[..., :nope], q_rope], dim=-1)
    kc = torch.cat([k_nope, k_rope.expand(B, S, H, ro)], dim=-1)
    if dist is not None:
        qc, kc, v = (dist.constrain_heads(t) for t in (qc, kc, v))
    out = attention_core(impl, qc, kc, v, spec._replace(scale=_mla_scale(cfg)),
                         dist)
    return _out(out, p["wo"]), (latent, k_rope[:, :, 0])


def mla_decode(p, x: Tensor, cfg, pos: int, latent_cache: Tensor,
               krope_cache: Tensor, spec: AttnSpec):
    """Absorbed MLA decode: the cache holds only the latent ``(B, S_max,
    r)`` and ``k_rope`` ``(B, S_max, ro)`` of each token; q's nope dims go
    through ``wk_up`` into the latent space, scores are f32, and the
    output leaves the latent space through ``wv_up``.  Writes the new
    token's latent and k_rope into the caches IN PLACE and returns (out,
    latent_cache, krope_cache)."""
    pos = int(pos)
    nope = cfg.qk_nope_dim
    positions = torch.tensor([pos], device=x.device)
    q = _proj(x, p["wq"])[:, 0]                             # (B, H, nope+ro)
    q_rope = L.apply_rope(q[:, None, :, nope:], positions,
                          cfg.rope_theta)[:, 0]
    latent, k_rope = _mla_latent(p, x, cfg, positions)
    S_max = latent_cache.shape[1]
    slot = min(pos, S_max - 1)
    latent_cache[:, slot] = latent[:, 0]
    krope_cache[:, slot] = k_rope[:, 0, 0]

    q_abs = torch.einsum("bhx,rhx->bhr", q[..., :nope], p["wk_up"])
    s = (torch.einsum("bhr,bsr->bhs", q_abs.float(), latent_cache.float())
         + torch.einsum("bhx,bsx->bhs", q_rope.float(), krope_cache.float()))
    s = s * _mla_scale(cfg)
    valid = torch.arange(S_max, device=x.device) <= pos
    s = torch.where(valid[None, None, :], s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", pr.to(latent_cache.dtype),
                         latent_cache)
    out = torch.einsum("bhr,rhx->bhx", o_lat, p["wv_up"])   # (B, H, vd)
    y = torch.einsum("bhx,hxd->bd", out.to(x.dtype), p["wo"])
    return y[:, None], latent_cache, krope_cache
