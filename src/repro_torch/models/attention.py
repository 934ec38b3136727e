"""Attention: GQA/MQA/MHA over the blocked online-softmax core (kernel K2 on
the card), sliding-window and logit-softcap variants (gemma2), and the
single-token decode path against a KV cache (port of the reference's
``repro/models/attention.py``).

MLA (deepseek) is not ported yet: ``init_mla``, ``apply_mla`` and
``mla_decode`` raise ``NotImplementedError`` (ROADMAP Queue 1 item 1).
Distribution (``dist``) and phantom-head padding are not ported either.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
from repro_torch.models.attention_core import (  # noqa: F401
    NEG_INF, AttnSpec, _mask, blocked_attention)

Tensor = torch.Tensor

_MLA = "MLA attention (deepseek) is not ported yet: ROADMAP Queue 1 item 1"


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
    raise NotImplementedError(_MLA)


def _proj(x: Tensor, w: Tensor) -> Tensor:
    """``einsum("bsd,dhx->bshx")`` as one matrix product."""
    d, h, e = w.shape
    return (x @ w.reshape(d, h * e)).unflatten(-1, (h, e))


def _qkv(p, x: Tensor, cfg, positions: Tensor):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (L.apply_rope(q, positions, cfg.rope_theta),
            L.apply_rope(k, positions, cfg.rope_theta), v)


def _out(o: Tensor, wo: Tensor) -> Tensor:
    """``einsum("bshx,hxd->bsd")`` as one matrix product."""
    h, e, d = wo.shape
    return o.flatten(-2) @ wo.reshape(h * e, d)


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


# ---------------------------------------------------------------------------
# GQA block apply
# ---------------------------------------------------------------------------

def apply_gqa(p, x: Tensor, cfg, positions: Tensor, spec: AttnSpec,
              impl=blocked_attention, dist=None, pad_heads=False):
    """Returns (attention output (B, S, d), (k, v))."""
    if dist is not None or pad_heads:
        raise NotImplementedError("distributed attention is not ported: "
                                  "ROADMAP Queue 1 item 2")
    q, k, v = _qkv(p, x, cfg, positions)
    out = impl(q, k, v, spec)
    return _out(out, p["wo"]), (k, v)


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
# MLA (deepseek-v2): not ported yet
# ---------------------------------------------------------------------------

def apply_mla(p, x, cfg, positions, spec, impl=blocked_attention, dist=None):
    raise NotImplementedError(_MLA)


def mla_decode(p, x, cfg, pos, latent_cache, krope_cache, spec):
    raise NotImplementedError(_MLA)
