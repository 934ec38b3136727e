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

The published Zamba2 layout (``cfg.published_hybrid``: ``hybrid_layer_ids``
set, as in ``configs/zamba2_7b_instruct.py``) is ``num_layers`` mamba2
layers in ``params["blocks"]`` and ``num_mem_blocks`` shared attention+MLP
blocks in ``params["shared"]``.  Hybrid layer ``i``, the ``j``-th of
``cfg.hybrid_ids``, also holds its own adapter (``"adapter"``, added to the
shared MLP's ``gate_up``) and output linear (``"linear"``), and applies
shared block ``j % num_mem_blocks`` (``apply_hybrid_layer``): the block
reads ``rms(concat(x, e))`` with e the token embedding, and its output
enters the layer's normed input only, ``x + mamba(rms(x + m W_l))``.  Each
application is the span ``hybrid.shared_block``.  Training only: decode,
the cache and ``dist`` raise ``NotImplementedError`` on this layout.

The granite-4.0-h layout (``cfg.moe_hybrid``: ``layer_types`` set, as in
``configs/granite_4_0_h_small.py``) is one layer a kind in
``params["blocks"]``: ``{"ln1", "mamba" | "attn", "ln2", "moe"}``, the
mixer a Mamba2 block or GQA (NoPE), then the MoE and its shared expert
(``models.moe``'s held-expert layer), each branch scaled by
``residual_multiplier`` before its residual add
(``apply_moe_hybrid_layer``; the FFN block is the span ``moe.layer``).
The embedding is multiplied by ``embedding_multiplier`` and the head's
input divided by ``logits_scaling`` (a power of two divides exactly, so
the bf16 logits are the published ``logits / logits_scaling``).  Training
only, as the published Zamba2 layout.

``remat`` (``"none"``, ``"full"``, ``"dots"``) runs the bodies the
reference wraps in ``jax.checkpoint`` under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: a layer, a
pair (gemma2's local/global, llama4's (dense, MoE)), a hybrid group, a
published hybrid layer (its shared block and its mamba layer) or a
granite-4.0-h layer (its mixer and its FFN).
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

``dist`` (a ``dist.sharding.DistCtx``) enters as in the reference: the
activations are constrained (``constrain_act``) after the embedding and
after each residual add, the logits to ``constrain_logits`` (the head
vocab-parallel), the attention core, the SSD scan, the embedding lookup,
mamba2's causal conv and the loss run in local-shard regions, and the MoE
layer runs expert-parallel.  Under ``dist`` the parameters and the batch are DTensors
(the trainer places them); plain tensors made inside the forward, such as
positions and masks, count as replicated (``implicit_replication``).
``pad_heads`` turns on the reference's phantom-head padding.

The training loss (``_loss``) of a hidden state on the card with no mesh
runs K6 (``kernels.cross_entropy``) from the head's product on, in its
type: no f32 (tokens x vocab) logits.  Every other loss, and ``logits``
(serving and decode), runs the composed ops of ``layers.lm_logits`` and
``layers.cross_entropy``, which are K6's plain versions.
"""
from __future__ import annotations

from contextlib import nullcontext
from functools import partial
from typing import Any, Dict, List, Optional

import torch
from torch._guards import active_fake_mode
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.service import resolve_device
from repro_torch.instrument.tracer import span
from repro_torch.kernels import cross_entropy as K6
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


def _device(device) -> torch.device:
    """``core.service.resolve_device``, except under a fake mode, where a
    tensor needs no device to exist (a dry run traces the card's route on
    a host without one)."""
    if active_fake_mode() is None:
        return resolve_device(device)
    return torch.device("cuda" if device is None else device)


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
    if cfg.moe_hybrid:
        return cfg.num_layers
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


def _constrain(x, dist):
    return dist.constrain_act(x) if dist is not None else x


def _ffn(bp, h, cfg, dist=None):
    """The block's MLP or MoE: (output, MoE stats or None)."""
    if "moe" in bp:
        return M.apply_moe(bp["moe"], h, cfg, dist)
    return L.apply_mlp(bp["mlp"], h, cfg.mlp), None


def apply_attn_block(bp, x, cfg, positions, spec, impl=A.blocked_attention,
                     dist=None, pad_heads=False):
    """Returns (x, MoE stats or None, (k, v)-like cache entries)."""
    h = L.apply_norm(bp["ln1"], x, cfg.norm, cfg.norm_eps)
    if cfg.attention == "mla":
        a, kv = A.apply_mla(bp["attn"], h, cfg, positions, spec, impl, dist)
    else:
        a, kv = A.apply_gqa(bp["attn"], h, cfg, positions, spec, impl, dist,
                            pad_heads)
    if cfg.post_norms:
        a = L.apply_norm(bp["ln1p"], a, cfg.norm, cfg.norm_eps)
    x = _constrain(x + a, dist)
    h = L.apply_norm(bp["ln2"], x, cfg.norm, cfg.norm_eps)
    m, stats = _ffn(bp, h, cfg, dist)
    if cfg.post_norms:
        m = L.apply_norm(bp["ln2p"], m, cfg.norm, cfg.norm_eps)
    return _constrain(x + m, dist), stats, kv


def decode_attn_block(bp, x, cfg, pos, cache, spec, ring=False, dist=None):
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
    m, _ = _ffn(bp, h, cfg, dist)
    if cfg.post_norms:
        m = L.apply_norm(bp["ln2p"], m, cfg.norm, cfg.norm_eps)
    return x + m, cache


def init_mamba_block(gen, cfg, device=None):
    dt = L.dtype_of(cfg.param_dtype)
    return {"ln": L.init_norm(cfg.norm, cfg.d_model, dt, device),
            "mamba": S.init_mamba2(gen, cfg, dt, device)}


def apply_mamba_block(bp, x, cfg, dist=None):
    h = L.apply_norm(bp["ln"], x, cfg.norm, cfg.norm_eps)
    return _constrain(x + S.apply_mamba2(bp["mamba"], h, cfg, dist=dist),
                      dist)


def init_shared_block(gen, cfg, device=None):
    """One shared block of the published Zamba2 layout: the norm of its
    input ``concat(x, e)``, ``2 d_model`` wide, GQA reading that input, the
    norm before the MLP and the MLP."""
    dt = L.dtype_of(cfg.param_dtype)
    d_in = 2 * cfg.d_model
    return {"ln1": L.init_norm(cfg.norm, d_in, dt, device),
            "attn": A.init_gqa(gen, cfg, dt, device, d_in=d_in),
            "ln2": L.init_norm(cfg.norm, cfg.d_model, dt, device),
            "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp,
                              cfg.use_bias, dt, device)}


def init_hybrid_extras(gen, cfg, device=None):
    """A hybrid layer's own leaves beside its mamba block: the adapter of
    the shared MLP's ``gate_up`` and the output linear."""
    dt = L.dtype_of(cfg.param_dtype)
    return {"adapter": L.init_adapter(gen, cfg.d_model, cfg.adapter_rank,
                                      cfg.d_ff, dt, device),
            "linear": L.dense_init(gen, (cfg.d_model, cfg.d_model), dt,
                                   device=device)}


def apply_shared_block(sp, x, e, cfg, positions, spec,
                       impl=A.blocked_attention, adapter=None):
    """The shared block on the hybrid layer's input x and the embedding e:
    ``m = mlp(rms(attn(rms(concat(x, e)))))``, no residual inside it."""
    with span("hybrid.shared_block"):
        h = L.apply_norm(sp["ln1"], torch.cat([x, e], dim=-1), cfg.norm,
                         cfg.norm_eps)
        a, _ = A.apply_gqa(sp["attn"], h, cfg, positions, spec, impl)
        h = L.apply_norm(sp["ln2"], a, cfg.norm, cfg.norm_eps)
        return L.apply_mlp(sp["mlp"], h, cfg.mlp, cfg.gelu_exact, adapter)


def apply_hybrid_layer(bp, sp, x, e, cfg, positions, spec,
                       impl=A.blocked_attention):
    """A hybrid layer: its shared block's output through the layer's
    linear enters the mamba layer's normed input, ``x + mamba(rms(x +
    t))``."""
    t = apply_shared_block(sp, x, e, cfg, positions, spec, impl,
                           bp["adapter"]) @ bp["linear"]
    h = L.apply_norm(bp["ln"], x + t, cfg.norm, cfg.norm_eps)
    return x + S.apply_mamba2(bp["mamba"], h, cfg)


def init_moe_hybrid_layer(gen, cfg, kind: str, device=None):
    """A granite-4.0-h layer: its norms, its mixer of ``kind`` ("mamba" or
    "attention") and the MoE with its shared expert."""
    dt = L.dtype_of(cfg.param_dtype)
    p = {"ln1": L.init_norm(cfg.norm, cfg.d_model, dt, device),
         "ln2": L.init_norm(cfg.norm, cfg.d_model, dt, device),
         "moe": M.init_moe(gen, cfg, dt, device)}
    if kind == "mamba":
        p["mamba"] = S.init_mamba2(gen, cfg, dt, device)
    else:
        p["attn"] = A.init_gqa(gen, cfg, dt, device)
    return p


def apply_moe_hybrid_layer(bp, x, spec, cfg, positions,
                           impl=A.blocked_attention):
    """``x + r mixer(rms(x))``, then ``x + r (moe(h) + shared(h))`` with
    ``h = rms(x)`` and r the residual multiplier.  Returns (x, MoE
    stats)."""
    r = cfg.residual_multiplier
    h = L.apply_norm(bp["ln1"], x, cfg.norm, cfg.norm_eps)
    if "mamba" in bp:
        a = S.apply_mamba2(bp["mamba"], h, cfg)
    else:
        a, _ = A.apply_gqa(bp["attn"], h, cfg, positions, spec, impl)
    x = x + a * r
    h = L.apply_norm(bp["ln2"], x, cfg.norm, cfg.norm_eps)
    with span("moe.layer"):
        m, stats = M.apply_moe(bp["moe"], h, cfg)
    return x + m * r, stats


def decode_mamba_block(bp, x, cfg, cache, dist=None):
    h = L.apply_norm(bp["ln"], x, cfg.norm, cfg.norm_eps)
    y, new_cache = S.mamba2_decode(bp["mamba"], h, cfg, cache, dist)
    return x + y, new_cache


def _embed_lookup(table, ids, cfg, dist=None):
    """``layers.embed_lookup``; under a mesh, on local shards: the table
    gathered whole, each data-parallel shard looking up its own tokens (a
    DTensor index by a batch sharded over two data-parallel dims is not
    run by every PyTorch), the table's gradient a partial sum over those
    dims."""
    def lookup(t, i):
        return L.embed_lookup({"table": t}, i, cfg.scale_embed, cfg.d_model)
    if dist is None or dist.mesh is None:
        return lookup(table, ids)
    from repro_torch.dist.compat import shard_map
    from repro_torch.dist.sharding import P
    dpe = dist.batch_entry(ids)
    ispec = P(dpe, None)
    region = shard_map(lookup, mesh=dist.mesh, in_specs=(P(None, None), ispec),
                       in_grad_specs=(dist.dp_partial(dpe is not None), ispec),
                       out_specs=P(dpe, None, None))
    return region(table, ids)


def _cross_entropy(logits, labels, vocab_size: int, dist=None):
    """``layers.cross_entropy``; under a mesh, on local shards, the vocab
    sharded over the model dim as ``constrain_logits`` leaves it
    (``_vocab_parallel_sums``) and the batch over the data-parallel dims:
    each shard sums its tokens, and the two sums meet as partial sums over
    those dims.  On DTensors the loss would gather the vocab on every rank,
    and the gather's backward would build a zero gradient of the global
    logits' shape there (DTensor replicates ``new_zeros``): 1.07 TB at
    gemma2-2b's train_4k cell."""
    if dist is None or dist.mesh is None:
        return L.cross_entropy(logits, labels, vocab_size)
    from repro_torch.dist.compat import shard_map
    from repro_torch.dist.sharding import P
    dpe = dist.batch_entry(logits)
    tp = dist.tp_axis if dist.tp_size > 1 \
        and logits.shape[-1] % dist.tp_size == 0 else None
    group = dist.mesh.get_group(tp) if tp else None
    rank = dist.mesh.get_local_rank(tp) if tp else 0
    summed = dist.dp_partial(dpe is not None)
    region = shard_map(
        lambda lg, lb: _vocab_parallel_sums(lg, lb, vocab_size, group, rank),
        mesh=dist.mesh, in_specs=(P(dpe, None, tp), P(dpe, None)),
        out_specs=(summed, summed))
    return L.mean_nll(*region(logits, labels))


def _vocab_parallel_sums(logits, labels, vocab_size: int, group, rank: int):
    """``layers.cross_entropy_sums`` over logits whose last dim is this
    rank's slice ``[rank V_l, (rank + 1) V_l)`` of the padded vocab, the
    other slices on the ranks of ``group`` (None: the whole vocab here).
    The log-sum-exp takes the group's max and sums the exponentials over
    the group; the label's logit comes from the slice that holds it."""
    if group is None:
        return L.cross_entropy_sums(logits, labels, vocab_size)
    import torch.distributed as tdist

    from repro_torch.dist.compat import all_reduce_fwd
    Vl = logits.shape[-1]
    v0 = rank * Vl
    ids = v0 + torch.arange(Vl, device=logits.device)
    logits = torch.where(ids < vocab_size, logits,
                         torch.finfo(torch.float32).min)
    m = logits.amax(dim=-1).detach()
    tdist.all_reduce(m, op=tdist.ReduceOp.MAX, group=group)
    se = all_reduce_fwd(torch.exp(logits - m[..., None]).sum(dim=-1), group)
    lse = m + torch.log(se)
    idx = labels.clamp(min=0).long() - v0
    inside = (idx >= 0) & (idx < Vl)
    ll = torch.gather(logits, -1, idx.clamp(0, Vl - 1)[..., None])[..., 0]
    ll = all_reduce_fwd(torch.where(inside, ll, 0.0), group)
    mask = (labels >= 0).float()
    return ((lse - ll) * mask).sum(), mask.sum()


# ---------------------------------------------------------------------------
# Transformer
# ---------------------------------------------------------------------------

class Transformer:
    """Functional model wrapper for one ModelConfig."""

    def __init__(self, cfg, dist=None, attn_impl=None, remat: str = "none",
                 folded: bool = False, pad_heads: bool = False):
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}")
        if (cfg.published_hybrid or cfg.moe_hybrid) and dist is not None \
                and dist.mesh is not None:
            raise NotImplementedError(
                f"the {cfg.name} layout runs on one device: no mesh")
        if remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")
        self.cfg = cfg
        self.dist = dist
        self.attn_impl = attn_impl or A.blocked_attention
        self.remat = remat
        self.folded = folded
        self.pad_heads = pad_heads

    def replicating(self):
        """Under ``dist``, plain tensors meet DTensors as replicated ones
        (``dist.sharding.replicating``); a null context otherwise."""
        if self.dist is None or self.dist.mesh is None:
            return nullcontext()
        from repro_torch.dist.sharding import replicating
        return replicating()

    # -- init ---------------------------------------------------------------
    def init(self, seed: int = 0, device=None) -> Dict[str, Any]:
        """Fresh parameters from ``torch.Generator(seed)`` on ``device``
        (``None``: the card; module docstring).  Under a fake mode (the dry
        run's, ``launch.dryrun``) nothing is drawn: the tensors have the
        shapes, dtypes and device of a real init and no storage."""
        cfg = self.cfg
        device = _device(device)
        gen = None
        if active_fake_mode() is None:
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
        if cfg.moe_hybrid:
            p["blocks"] = [init_moe_hybrid_layer(gen, cfg, kind, device)
                           for kind in cfg.layer_kinds]
        elif cfg.family in ("ssm", "hybrid"):
            p["blocks"] = [init_mamba_block(gen, cfg, device)
                           for _ in range(cfg.num_layers)]
            if cfg.published_hybrid:
                for i in cfg.hybrid_ids:
                    p["blocks"][i].update(init_hybrid_extras(gen, cfg,
                                                             device))
                p["shared"] = [init_shared_block(gen, cfg, device)
                               for _ in range(cfg.num_mem_blocks)]
            elif cfg.family == "hybrid":
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
            parts.append(_embed_lookup(p["embed"]["table"],
                                       batch["tokens"].long(), cfg,
                                       self.dist).to(dt))
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        if cfg.embedding_multiplier != 1.0:
            x = x * cfg.embedding_multiplier
        return _constrain(x, self.dist)

    def layer_specs(self, folded: bool = False) -> List[A.AttnSpec]:
        """The attention spec of every attention layer, in order (a hybrid
        model's: each application of its shared block).  ``folded`` is the
        forward's balanced causal folding; decode never folds."""
        cfg = self.cfg
        sw = attn_spec(cfg, cfg.sliding_window, folded)
        full = attn_spec(cfg, 0, folded)
        if cfg.family == "ssm":
            return []
        if cfg.moe_hybrid:
            return [full] * cfg.layer_kinds.count("attention")
        if cfg.published_hybrid:
            return [sw] * len(cfg.hybrid_ids)
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
        with self.replicating():
            return self._forward(p, batch, collect_cache)

    def _forward(self, p, batch, collect_cache: bool = False):
        """Returns (hidden (B,S,d), the MoE stats (2E,) summed over the MoE
        layers (None for the other families), per-attention-layer [(k, v)]
        (MLA: [(latent, k_rope)]; hybrid: one per application of the shared
        block) or None; an ``ssm`` model collects no cache, as in the
        reference)."""
        cfg = self.cfg
        x = self._embed_inputs(p, batch)
        blocks = p["blocks"]
        dist, impl = self.dist, self.attn_impl
        mamba = self._maybe_remat(partial(apply_mamba_block, cfg=cfg,
                                          dist=dist))
        if cfg.family == "ssm":
            for bp in blocks:
                x = mamba(bp, x)
            x = L.apply_norm(p["final_norm"], x, cfg.norm, cfg.norm_eps)
            return x, None, ([] if collect_cache else None)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        specs = self.layer_specs(self.folded)
        kvs, stats_sum = [], None
        if cfg.moe_hybrid:
            if collect_cache:
                raise NotImplementedError(
                    f"the {cfg.name} layout runs training only: no cache is "
                    f"collected")
            layer = self._maybe_remat(partial(
                apply_moe_hybrid_layer, cfg=cfg, positions=positions,
                impl=impl))
            spec = specs[0] if specs else None
            for bp in blocks:
                x, stats = layer(bp, x, spec)
                stats_sum = stats if stats_sum is None else stats_sum + stats
        elif cfg.published_hybrid:
            if collect_cache:
                raise NotImplementedError(
                    "the published Zamba2 layout runs training only: no "
                    "cache is collected")
            def hybrid_body(x, e, bp, sp, spec):
                return apply_hybrid_layer(bp, sp, x, e, cfg, positions, spec,
                                          impl)
            hybrid = self._maybe_remat(hybrid_body)
            e, ids = x, cfg.hybrid_ids
            for i, bp in enumerate(blocks):
                if i in ids:
                    j = ids.index(i)
                    x = hybrid(x, e, bp, p["shared"][j % cfg.num_mem_blocks],
                               specs[j])
                else:
                    x = mamba(bp, x)
        elif cfg.family == "hybrid":
            k = cfg.shared_attn_every
            ngroups, _ = hybrid_layout(cfg)

            def group_body(x, bps, sa, spec):
                for bp in bps:
                    x = apply_mamba_block(bp, x, cfg, dist)
                x, _, kv = apply_attn_block(sa, x, cfg, positions, spec,
                                            impl, dist, self.pad_heads)
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
                                                    spec, impl, dist,
                                                    self.pad_heads)
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

    def _head(self, p):
        return p["embed"]["table"] if self.cfg.tie_embeddings \
            else p["lm_head"]

    def _head_input(self, hidden):
        """The head's input: ``hidden`` divided by ``logits_scaling``."""
        s = self.cfg.logits_scaling
        return hidden if s == 1.0 else hidden / s

    def logits(self, p, hidden):
        cfg = self.cfg
        head = self._head(p)
        if self.dist is not None:
            # the vocab-parallel head: the product's output, its cast and
            # softcap stay sharded over the model dim, where a replicated
            # head would hold every rank's logits whole (and gather their
            # gradient back whole)
            head = self.dist.shard_vocab(head)
        out = L.lm_logits(head, self._head_input(hidden), cfg.logit_softcap)
        return self.dist.constrain_logits(out) if self.dist is not None \
            else out

    # -- losses ---------------------------------------------------------------
    def loss(self, p, batch):
        with self.replicating():
            return self._loss(p, batch)

    def _loss(self, p, batch):
        cfg = self.cfg
        hidden, stats, _ = self.forward(p, batch)
        labels = batch["labels"]
        if (self.dist is None or self.dist.mesh is None) \
                and K6.takes(hidden):
            # K6 from the product in its type: no f32 logits
            rows = K6.cross_entropy(
                self._head_input(hidden) @ self._head(p).t(), labels,
                cfg.vocab_size, cfg.logit_softcap)
            nll, ntok = L.mean_nll(*L.masked_sums(rows, labels))
        else:
            nll, ntok = _cross_entropy(self.logits(p, hidden), labels,
                                       cfg.vocab_size, self.dist)
        aux = torch.zeros_like(nll)
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
        if cfg.published_hybrid or cfg.moe_hybrid:
            raise NotImplementedError(
                f"the {cfg.name} layout runs training only: no cache")
        dt = L.dtype_of(cfg.dtype)
        device = _device(device)
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
        with self.replicating():
            return self._decode_step(p, cache, batch, pos)

    def _decode_step(self, p, cache, batch, pos: int):
        """One token for the whole batch.  batch: {'tokens': (B,1)} or
        {'embeds': (B,1,d)}; pos: the current position.  Updates ``cache``
        in place; returns (logits (B,1,V), cache)."""
        cfg = self.cfg
        if cfg.published_hybrid or cfg.moe_hybrid:
            raise NotImplementedError(
                f"the {cfg.name} layout runs training only: no decode")
        x = self._embed_inputs(p, batch)
        if cfg.family == "ssm":
            for bp, c in zip(p["blocks"], cache):
                x, new = decode_mamba_block(bp, x, cfg, c, self.dist)
                c.update(new)
            x = L.apply_norm(p["final_norm"], x, cfg.norm, cfg.norm_eps)
            return self.logits(p, x), cache
        ring = self._ring_for(cache)
        if cfg.family == "hybrid":
            nl, k = cfg.num_layers, cfg.shared_attn_every
            attn, specs = cache[nl:], self.layer_specs()
            for i, (bp, c) in enumerate(zip(p["blocks"], cache[:nl])):
                x, new = decode_mamba_block(bp, x, cfg, c, self.dist)
                c.update(new)
                if (i + 1) % k == 0:        # a group's last layer (the
                    g = i // k              # tail is shorter than k)
                    x, _ = decode_attn_block(p["shared_attn"], x, cfg, pos,
                                             attn[g], specs[g], ring=ring,
                                             dist=self.dist)
            x = L.apply_norm(p["final_norm"], x, cfg.norm, cfg.norm_eps)
            return self.logits(p, x), cache
        for bp, c, spec in zip(p["blocks"], cache, self.layer_specs()):
            x, _ = decode_attn_block(bp, x, cfg, pos, c, spec, ring=ring,
                                     dist=self.dist)
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
