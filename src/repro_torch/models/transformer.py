"""Model assembly for the ``dense``, ``vlm``, ``audio``, ``ssm`` and ``moe``
families, gemma2's local/global layer pairs and MLA attention included (port
of the reference's ``repro/models/transformer.py``).

Parameters are nested dicts of tensors with the reference's names.  The
reference stacks layers on a leading axis and runs them with ``lax.scan``;
here ``params["blocks"]`` is a list with one dict per layer, in layer order
(gemma2's pair ``i`` is layers ``2i``, local, and ``2i + 1``, global), and a
Python loop runs them.  ``models.convert.params_from_reference`` carries the
reference's own parameters across.  An ``ssm`` layer (mamba2) is
``{"ln", "mamba"}`` and runs K3 through ``models.ssm.apply_mamba2``.  A
``moe`` layer is ``{"attn", "mlp"}`` (dense) or ``{"attn", "moe"}``, in one
of the reference's two layouts (``moe_layer``): deepseek's
``first_dense`` dense layers of width ``dense_d_ff`` and then MoE, or
llama4's (dense, MoE) pairs (``moe_every = 2``).

``Transformer.init`` and ``init_cache`` put their tensors on ``device``;
``None`` means the card (``core.service.resolve_device``), and they raise
without one unless the caller asks for ``"cpu"``.

Not ported yet (each raises ``NotImplementedError``): the ``hybrid`` family,
remat other than ``"none"`` and balanced causal folding (ROADMAP Queue 1
item 1), and the ``dist`` context (Queue 1 item 2).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.core.service import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

Tensor = torch.Tensor

FAMILIES = ("dense", "vlm", "audio", "ssm", "moe")


def _not_ported(what: str, item: int = 1) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP Queue 1 "
                               f"item {item}")


def attn_spec(cfg, window: int, folded: bool = False) -> A.AttnSpec:
    return A.AttnSpec(causal=True, window=window, softcap=cfg.attn_softcap,
                      scale=cfg.attn_scale, folded=folded)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def moe_layer(cfg, i: int) -> bool:
    """Whether layer ``i`` of a ``moe``-family model is an MoE layer: the
    odd layers of llama4's (dense, MoE) pairs, else every layer past
    deepseek's ``first_dense``."""
    if cfg.moe_every == 2:
        return i % 2 == 1
    return i >= cfg.first_dense


def n_moe_layers(cfg) -> int:
    """The MoE layers the aux loss averages over (the reference's
    ``n_moe``)."""
    if cfg.moe_every > 1:
        return cfg.num_layers // cfg.moe_every
    return cfg.num_layers - cfg.first_dense


def init_attn_block(gen, cfg, device=None, d_ff=None, moe=False):
    dt = L.dtype_of(cfg.param_dtype)
    p = {"ln1": L.init_norm(cfg.norm, cfg.d_model, dt, device),
         "ln2": L.init_norm(cfg.norm, cfg.d_model, dt, device)}
    if cfg.post_norms:
        p["ln1p"] = L.init_norm(cfg.norm, cfg.d_model, dt, device)
        p["ln2p"] = L.init_norm(cfg.norm, cfg.d_model, dt, device)
    if cfg.attention == "mla":
        p["attn"] = A.init_mla(gen, cfg, dt, device)
    else:
        p["attn"] = A.init_gqa(gen, cfg, dt, device)
    if moe:
        p["moe"] = M.init_moe(gen, cfg, dt, device)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, d_ff or cfg.d_ff, cfg.mlp,
                              cfg.use_bias, dt, device)
    return p


def _ffn(bp, h, cfg):
    """The block's MLP or MoE: (output, MoE stats or None)."""
    if "moe" in bp:
        return M.apply_moe(bp["moe"], h, cfg)
    return L.apply_mlp(bp["mlp"], h, cfg.mlp), None


def apply_attn_block(bp, x, cfg, positions, spec, impl=A.blocked_attention):
    """Returns (x, MoE stats or None, (k, v)-like cache entries)."""
    h = L.apply_norm(bp["ln1"], x, cfg.norm, cfg.norm_eps)
    if cfg.attention == "mla":
        a, kv = A.apply_mla(bp["attn"], h, cfg, positions, spec, impl)
    else:
        a, kv = A.apply_gqa(bp["attn"], h, cfg, positions, spec, impl)
    if cfg.post_norms:
        a = L.apply_norm(bp["ln1p"], a, cfg.norm, cfg.norm_eps)
    x = x + a
    h = L.apply_norm(bp["ln2"], x, cfg.norm, cfg.norm_eps)
    m, stats = _ffn(bp, h, cfg)
    if cfg.post_norms:
        m = L.apply_norm(bp["ln2p"], m, cfg.norm, cfg.norm_eps)
    return x + m, stats, kv


def decode_attn_block(bp, x, cfg, pos, cache, spec, ring=False):
    """One token through the block; the layer's cache is written in
    place."""
    h = L.apply_norm(bp["ln1"], x, cfg.norm, cfg.norm_eps)
    if cfg.attention == "mla":
        a, _, _ = A.mla_decode(bp["attn"], h, cfg, pos, cache["latent"],
                               cache["krope"], spec)
    else:
        a, _, _ = A.gqa_decode(bp["attn"], h, cfg, pos, cache["k"],
                               cache["v"], spec, ring=ring)
    if cfg.post_norms:
        a = L.apply_norm(bp["ln1p"], a, cfg.norm, cfg.norm_eps)
    x = x + a
    h = L.apply_norm(bp["ln2"], x, cfg.norm, cfg.norm_eps)
    m, _ = _ffn(bp, h, cfg)
    if cfg.post_norms:
        m = L.apply_norm(bp["ln2p"], m, cfg.norm, cfg.norm_eps)
    return x + m, cache


def init_mamba_block(gen, cfg, device=None):
    dt = L.dtype_of(cfg.param_dtype)
    return {"ln": L.init_norm(cfg.norm, cfg.d_model, dt, device),
            "mamba": S.init_mamba2(gen, cfg, dt, device)}


def apply_mamba_block(bp, x, cfg):
    h = L.apply_norm(bp["ln"], x, cfg.norm, cfg.norm_eps)
    return x + S.apply_mamba2(bp["mamba"], h, cfg)


def decode_mamba_block(bp, x, cfg, cache):
    h = L.apply_norm(bp["ln"], x, cfg.norm, cfg.norm_eps)
    y, new_cache = S.mamba2_decode(bp["mamba"], h, cfg, cache)
    return x + y, new_cache


# ---------------------------------------------------------------------------
# Transformer
# ---------------------------------------------------------------------------

class Transformer:
    """Functional model wrapper for one ModelConfig."""

    def __init__(self, cfg, dist=None, attn_impl=None, remat: str = "none",
                 folded: bool = False, pad_heads: bool = False):
        if cfg.family not in FAMILIES:
            raise _not_ported(f"the {cfg.family!r} family")
        if remat != "none":
            raise _not_ported(f"remat={remat!r}")
        if folded:
            raise _not_ported("balanced causal folding")
        if dist is not None or pad_heads:
            raise _not_ported("the distribution context", 2)
        self.cfg = cfg
        self.attn_impl = attn_impl or A.blocked_attention
        self.remat = remat
        self.folded = folded

    # -- init ---------------------------------------------------------------
    def init(self, seed: int = 0, device=None) -> Dict[str, Any]:
        """Fresh parameters from ``torch.Generator(seed)`` on ``device``
        (``None``: the card; module docstring)."""
        cfg = self.cfg
        device = resolve_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        dt = L.dtype_of(cfg.param_dtype)
        p: Dict[str, Any] = {
            "embed": L.init_embed(gen, cfg.padded_vocab, cfg.d_model, dt,
                                  device),
            "final_norm": L.init_norm(cfg.norm, cfg.d_model, dt, device),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = L.dense_init(gen, (cfg.padded_vocab, cfg.d_model),
                                        dt, device=device)
        if cfg.frontend:
            p["frontend"] = L.dense_init(gen, (cfg.d_model, cfg.d_model), dt,
                                         device=device)
        if cfg.local_global and cfg.num_layers % 2:
            raise ValueError("local/global pairs need an even layer count")
        if cfg.family == "ssm":
            p["blocks"] = [init_mamba_block(gen, cfg, device)
                           for _ in range(cfg.num_layers)]
        elif cfg.family == "moe":
            p["blocks"] = [
                init_attn_block(gen, cfg, device, moe=True)
                if moe_layer(cfg, i) else
                init_attn_block(gen, cfg, device, d_ff=cfg.dense_d_ff)
                for i in range(cfg.num_layers)]
        else:
            p["blocks"] = [init_attn_block(gen, cfg, device)
                           for _ in range(cfg.num_layers)]
        return p

    # -- embedding ------------------------------------------------------------
    def _embed_inputs(self, p, batch):
        cfg = self.cfg
        dt = L.dtype_of(cfg.dtype)
        parts = []
        if cfg.frontend and "embeds" in batch:
            parts.append(batch["embeds"].to(dt) @ p["frontend"])
        if batch.get("tokens") is not None:
            parts.append(L.embed_lookup(p["embed"], batch["tokens"].long(),
                                        cfg.scale_embed, cfg.d_model).to(dt))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def layer_specs(self) -> List[A.AttnSpec]:
        """The attention spec of every layer, in order."""
        cfg = self.cfg
        sw, full = attn_spec(cfg, cfg.sliding_window), attn_spec(cfg, 0)
        if cfg.local_global:
            return [sw if i % 2 == 0 else full
                    for i in range(cfg.num_layers)]
        return [sw if cfg.sliding_window else full] * cfg.num_layers

    # -- forward (train / prefill) -------------------------------------------
    def forward(self, p, batch, collect_cache: bool = False):
        """Returns (hidden (B,S,d), the MoE stats (2E,) summed over the MoE
        layers (None for the other families), per-layer [(k, v)] (MLA:
        [(latent, k_rope)]) or None; an ``ssm`` model collects no cache, as
        in the reference)."""
        cfg = self.cfg
        x = self._embed_inputs(p, batch)
        if cfg.family == "ssm":
            for bp in p["blocks"]:
                x = apply_mamba_block(bp, x, cfg)
            x = L.apply_norm(p["final_norm"], x, cfg.norm, cfg.norm_eps)
            return x, None, ([] if collect_cache else None)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        kvs, stats_sum = [], None
        for bp, spec in zip(p["blocks"], self.layer_specs()):
            x, stats, kv = apply_attn_block(bp, x, cfg, positions, spec,
                                            self.attn_impl)
            if stats is not None:
                stats_sum = stats if stats_sum is None else stats_sum + stats
            if collect_cache:
                kvs.append(kv)
        x = L.apply_norm(p["final_norm"], x, cfg.norm, cfg.norm_eps)
        return x, stats_sum, (kvs if collect_cache else None)

    def logits(self, p, hidden):
        cfg = self.cfg
        head = p["embed"]["table"] if cfg.tie_embeddings else p["lm_head"]
        return L.lm_logits(head, hidden, cfg.logit_softcap)

    # -- losses ---------------------------------------------------------------
    def loss(self, p, batch):
        cfg = self.cfg
        hidden, stats, _ = self.forward(p, batch)
        logits = self.logits(p, hidden)
        labels = batch["labels"]
        nll, ntok = L.cross_entropy(logits, labels, cfg.vocab_size)
        aux = torch.zeros((), device=nll.device)
        if stats is not None and cfg.is_moe:
            total_tokens = labels.shape[0] * labels.shape[1] \
                * max(1, n_moe_layers(cfg))
            aux = M.aux_loss_from_stats(stats, cfg, float(total_tokens))
        return nll + aux, {"nll": nll, "aux": aux, "ntok": ntok}

    # -- decode ---------------------------------------------------------------
    def kv_len(self, max_len: int) -> int:
        cfg = self.cfg
        if cfg.sliding_window and max_len > cfg.sliding_window \
                and not cfg.local_global:
            return cfg.sliding_window
        return max_len

    def init_cache(self, batch: int, max_len: int, device=None
                   ) -> List[Dict[str, Tensor]]:
        """One ``{"k", "v"}`` cache ``(B, len, KV, D)`` per layer, on
        ``device`` (``None``: the card).  gemma2's global layers hold
        ``max_len``; a sliding-window model's layers hold the window (a
        ring) once ``max_len`` exceeds it.  An MLA layer holds
        ``{"latent" (B, max_len, kv_lora_rank), "krope" (B, max_len,
        qk_rope_dim)}``; an ``ssm`` layer its conv windows and its f32 state
        (``ssm.init_ssm_cache``)."""
        cfg = self.cfg
        dt = L.dtype_of(cfg.dtype)
        device = resolve_device(device)
        if cfg.family == "ssm":
            return [S.init_ssm_cache(cfg, batch, dt, device)
                    for _ in range(cfg.num_layers)]
        if cfg.attention == "mla":
            return [{"latent": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                           dtype=dt, device=device),
                     "krope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                          dtype=dt, device=device)}
                    for _ in range(cfg.num_layers)]
        kvl = self.kv_len(max_len)
        shape = (batch, kvl, cfg.num_kv_heads, cfg.head_dim)
        return [{"k": torch.zeros(shape, dtype=dt, device=device),
                 "v": torch.zeros(shape, dtype=dt, device=device)}
                for _ in range(cfg.num_layers)]

    def _ring_for(self, cache) -> bool:
        cfg = self.cfg
        if not cfg.sliding_window or cfg.local_global or not cache:
            return False
        return cache[0]["k"].shape[-3] == cfg.sliding_window

    def decode_step(self, p, cache, batch, pos: int):
        """One token for the whole batch.  batch: {'tokens': (B,1)} or
        {'embeds': (B,1,d)}; pos: the current position.  Updates ``cache``
        in place; returns (logits (B,1,V), cache)."""
        cfg = self.cfg
        x = self._embed_inputs(p, batch)
        if cfg.family == "ssm":
            for bp, c in zip(p["blocks"], cache):
                x, new = decode_mamba_block(bp, x, cfg, c)
                c.update(new)
            x = L.apply_norm(p["final_norm"], x, cfg.norm, cfg.norm_eps)
            return self.logits(p, x), cache
        ring = self._ring_for(cache)
        for bp, c, spec in zip(p["blocks"], cache, self.layer_specs()):
            x, _ = decode_attn_block(bp, x, cfg, pos, c, spec, ring=ring)
        x = L.apply_norm(p["final_norm"], x, cfg.norm, cfg.norm_eps)
        return self.logits(p, x), cache


def param_leaves(tree, prefix: str = ""):
    """``(path, tensor)`` for every tensor of a nested dict/list: dict keys
    in sorted order (as JAX flattens a pytree), list items in order.  The
    path joins keys and list indices with ``/``."""
    if isinstance(tree, Tensor):
        yield prefix, tree
        return
    items = sorted(tree.items()) if isinstance(tree, dict) \
        else enumerate(tree)
    for key, sub in items:
        yield from param_leaves(sub, f"{prefix}/{key}" if prefix
                                else str(key))


def map_params(fn, tree):
    """The same nested structure with ``fn`` applied to every tensor, in
    ``param_leaves`` order."""
    if isinstance(tree, Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in sorted(tree.items())}
    return [map_params(fn, v) for v in tree]


def unflatten_like(tree, leaves: Optional[list]):
    """``tree``'s structure with its tensors replaced by ``leaves``, taken
    in ``param_leaves`` order."""
    it = iter(leaves)
    return map_params(lambda _: next(it), tree)
