"""Model assembly for every family of the reference (``dense``, ``vlm``,
``audio``, ``ssm``, ``moe`` and ``hybrid``), gemma2's local/global layer
pairs and MLA attention included (port of the reference's
``repro/models/transformer.py``).

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
llama4's (dense, MoE) pairs (``moe_every = 2``).  A ``hybrid`` model
(zamba2) is ``num_layers`` mamba2 layers in ``params["blocks"]`` (the
reference's ``groups (ngroups, k, ...)`` flattened, then its ``tail``) and
one attention block ``params["shared_attn"]``, applied after the last layer
of each group of ``k = shared_attn_every`` and never after the tail; one set
of tensors, so autograd sums its gradient over the applications, as the
reference's scan does.

``remat`` (``"none"``, ``"full"``, ``"dots"``) runs the bodies the
reference wraps in ``jax.checkpoint`` under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: a layer, a
pair (gemma2's local/global, llama4's (dense, MoE)) or a hybrid group.
``"full"`` saves nothing inside the body; ``"dots"`` saves the outputs of
the matrix products without batch dims (``aten.mm``), as
``dots_with_no_batch_dims_saveable`` does.  K2's and K3's forwards run
again when the backward recomputes a body.  ``folded`` sets
``AttnSpec.folded`` in the forward's attention, as the reference does;
``models.attention_core`` runs it on the unfolded path, which does the
same work on the card.

``Transformer.init`` and ``init_cache`` put their tensors on ``device``;
``None`` means the card (``core.service.resolve_device``), and they raise
without one unless the caller asks for ``"cpu"``.

Not ported yet (raises ``NotImplementedError``): the ``dist`` context and
phantom-head padding (ROADMAP Queue 1 item 2).
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.service import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

Tensor = torch.Tensor

FAMILIES = ("dense", "vlm", "audio", "ssm", "moe", "hybrid")
REMATS = ("none", "full", "dots")


def _dots_saveable(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of matrix products without
    batch dims (``x @ w`` reaches ``aten.mm``; the einsums over heads,
    chunks or experts reach ``aten.bmm`` and are recomputed)."""
    return CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default \
        else CheckpointPolicy.PREFER_RECOMPUTE


def hybrid_layout(cfg):
    """``(ngroups, tail)`` of a hybrid model: groups of
    ``shared_attn_every`` mamba layers, each followed by the shared
    attention block, then ``tail`` mamba layers."""
    return divmod(cfg.num_layers, cfg.shared_attn_every)


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
            raise ValueError(f"unknown family {cfg.family!r}")
        if remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")
        if dist is not None or pad_heads:
            raise NotImplementedError("the distribution context is not "
                                      "ported yet: ROADMAP Queue 1 item 2")
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
        if cfg.family in ("ssm", "hybrid"):
            p["blocks"] = [init_mamba_block(gen, cfg, device)
                           for _ in range(cfg.num_layers)]
            if cfg.family == "hybrid":
                p["shared_attn"] = init_attn_block(gen, cfg, device)
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

    def layer_specs(self, folded: bool = False) -> List[A.AttnSpec]:
        """The attention spec of every attention layer, in order (a hybrid
        model's: each application of its shared block).  ``folded`` is the
        forward's balanced causal folding; decode never folds."""
        cfg = self.cfg
        sw = attn_spec(cfg, cfg.sliding_window, folded)
        full = attn_spec(cfg, 0, folded)
        if cfg.family == "ssm":
            return []
        if cfg.family == "hybrid":
            return [sw] * hybrid_layout(cfg)[0]
        if cfg.local_global:
            return [sw if i % 2 == 0 else full
                    for i in range(cfg.num_layers)]
        return [sw if cfg.sliding_window else full] * cfg.num_layers

    def _maybe_remat(self, fn):
        """``fn`` itself, or ``fn`` under activation checkpointing
        (module docstring)."""
        if self.remat == "none":
            return fn
        kw = {}
        if self.remat == "dots":
            kw["context_fn"] = partial(create_selective_checkpoint_contexts,
                                       _dots_saveable)
        return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)

    def _units(self) -> List[List[int]]:
        """The layers of each body the reference scans (and remats) as one:
        gemma2's and llama4's pairs, else single layers."""
        cfg = self.cfg
        n = 2 if cfg.local_global or (cfg.is_moe and cfg.moe_every == 2) \
            else 1
        return [list(range(i, i + n)) for i in range(0, cfg.num_layers, n)]

    # -- forward (train / prefill) -------------------------------------------
    def forward(self, p, batch, collect_cache: bool = False):
        """Returns (hidden (B,S,d), the MoE stats (2E,) summed over the MoE
        layers (None for the other families), per-attention-layer [(k, v)]
        (MLA: [(latent, k_rope)]; hybrid: one per application of the shared
        block) or None; an ``ssm`` model collects no cache, as in the
        reference)."""
        cfg = self.cfg
        x = self._embed_inputs(p, batch)
        blocks = p["blocks"]
        mamba = self._maybe_remat(partial(apply_mamba_block, cfg=cfg))
        if cfg.family == "ssm":
            for bp in blocks:
                x = mamba(bp, x)
            x = L.apply_norm(p["final_norm"], x, cfg.norm, cfg.norm_eps)
            return x, None, ([] if collect_cache else None)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        specs = self.layer_specs(self.folded)
        kvs, stats_sum = [], None
        if cfg.family == "hybrid":
            k = cfg.shared_attn_every
            ngroups, _ = hybrid_layout(cfg)

            def group_body(x, bps, sa, spec):
                for bp in bps:
                    x = apply_mamba_block(bp, x, cfg)
                x, _, kv = apply_attn_block(sa, x, cfg, positions, spec,
                                            self.attn_impl)
                return x, kv
            group = self._maybe_remat(group_body)
            for g in range(ngroups):
                x, kv = group(x, blocks[g * k:(g + 1) * k], p["shared_attn"],
                              specs[g])
                if collect_cache:
                    kvs.append(kv)
            for bp in blocks[ngroups * k:]:
                x = mamba(bp, x)
        else:
            def unit_body(x, bps, unit_specs):
                stats_u, kv_u = None, []
                for bp, spec in zip(bps, unit_specs):
                    x, stats, kv = apply_attn_block(bp, x, cfg, positions,
                                                    spec, self.attn_impl)
                    if stats is not None:
                        stats_u = stats if stats_u is None \
                            else stats_u + stats
                    kv_u.append(kv)
                return x, stats_u, kv_u
            unit = self._maybe_remat(unit_body)
            for idx in self._units():
                x, stats, kv_u = unit(x, [blocks[i] for i in idx],
                                      [specs[i] for i in idx])
                if stats is not None:
                    stats_sum = stats if stats_sum is None \
                        else stats_sum + stats
                if collect_cache:
                    kvs.extend(kv_u)
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
        (``ssm.init_ssm_cache``).  A ``hybrid`` model's list is its
        ``num_layers`` SSM caches in layer order, then one ``{"k", "v"}``
        for each application of the shared block, in order (its window's
        ring once ``max_len`` exceeds it)."""
        cfg = self.cfg
        dt = L.dtype_of(cfg.dtype)
        device = resolve_device(device)
        if cfg.family in ("ssm", "hybrid"):
            ssm = [S.init_ssm_cache(cfg, batch, dt, device)
                   for _ in range(cfg.num_layers)]
            if cfg.family == "ssm":
                return ssm
        n_attn = len(self.layer_specs())
        if cfg.attention == "mla":
            return [{"latent": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                           dtype=dt, device=device),
                     "krope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                          dtype=dt, device=device)}
                    for _ in range(cfg.num_layers)]
        kvl = self.kv_len(max_len)
        shape = (batch, kvl, cfg.num_kv_heads, cfg.head_dim)
        kv = [{"k": torch.zeros(shape, dtype=dt, device=device),
               "v": torch.zeros(shape, dtype=dt, device=device)}
              for _ in range(n_attn)]
        return ssm + kv if cfg.family == "hybrid" else kv

    def _ring_for(self, cache) -> bool:
        """Whether the attention caches are window-sized rings (the first
        ``{"k", "v"}`` of the list decides, as the reference's)."""
        cfg = self.cfg
        if not cfg.sliding_window or cfg.local_global:
            return False
        kv = next((c for c in cache if "k" in c), None)
        return kv is not None and kv["k"].shape[-3] == cfg.sliding_window

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
        if cfg.family == "hybrid":
            nl, k = cfg.num_layers, cfg.shared_attn_every
            attn, specs = cache[nl:], self.layer_specs()
            for i, (bp, c) in enumerate(zip(p["blocks"], cache[:nl])):
                x, new = decode_mamba_block(bp, x, cfg, c)
                c.update(new)
                if (i + 1) % k == 0:        # a group's last layer (the
                    g = i // k              # tail is shorter than k)
                    x, _ = decode_attn_block(p["shared_attn"], x, cfg, pos,
                                             attn[g], specs[g], ring=ring)
            x = L.apply_norm(p["final_norm"], x, cfg.norm, cfg.norm_eps)
            return self.logits(p, x), cache
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
