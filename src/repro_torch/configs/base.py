"""Model / shape configuration system.

Every assigned architecture is expressed as a ``ModelConfig``; input-shape
cells are ``ShapeConfig``.  A data copy of the JAX reference's
``repro/configs/base.py`` (the port imports nothing of it): plain frozen
dataclasses with the same fields, defaults and derived properties.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    # -- identity -----------------------------------------------------------
    name: str = "model"
    family: str = "dense"  # dense | ssm | moe | hybrid | vlm | audio
    source: str = ""       # citation tag, e.g. "arXiv:2408.00118; hf"

    # -- trunk --------------------------------------------------------------
    num_layers: int = 2
    d_model: int = 128
    vocab_size: int = 512
    norm: str = "rms"          # rms | layer
    norm_eps: float = 1e-6
    mlp: str = "swiglu"        # swiglu | geglu | gelu (non-gated)
    d_ff: int = 512
    use_bias: bool = False
    tie_embeddings: bool = True
    scale_embed: bool = False  # gemma: embeddings scaled by sqrt(d_model)
    post_norms: bool = False   # gemma2: post-attn / post-ffn norms
    qkv_bias: bool = False     # qwen2/internvl
    logit_softcap: float = 0.0 # gemma2 final logit soft-capping

    # -- attention ----------------------------------------------------------
    attention: str = "gqa"     # gqa | mla | none
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 32
    rope_theta: float = 10_000.0
    attn_softcap: float = 0.0          # gemma2 attention logit soft-capping
    sliding_window: int = 0            # 0 = full attention
    local_global: bool = False         # gemma2: alternate local(sliding)/global
    attn_scale: float = 0.0            # 0 -> default 1/sqrt(head_dim)

    # -- MLA (deepseek) ------------------------------------------------------
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # -- MoE ------------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_every: int = 1          # every k-th layer is MoE (llama4: 2)
    first_dense: int = 0        # first k layers use a dense MLP (deepseek: 1)
    dense_d_ff: int = 0         # d_ff of interleaved/first dense MLPs
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    aux_loss_weight: float = 0.001
    gate_topk_first: bool = False   # granite: top-k of the logits, then softmax
    shared_d_ff: int = 0        # shared expert width (0: d_ff * num_shared_experts)
    moe_dropless: bool = False  # every routed pair computed, no capacity
    experts_start: int = 0      # the experts held here: [start, start + held)
    experts_held: int = 0       # 0: all num_experts (the router keeps them all)

    # -- SSM (mamba2 / zamba2) -------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_chunk: int = 256
    conv_width: int = 4
    shared_attn_every: int = 0  # zamba2: shared-weight attn block every k ssm layers
    ssm_grouped_norm: bool = False  # the gated norm per group of d_inner / ssm_groups

    # -- published zamba2 layout (``hybrid_layer_ids`` non-empty) -----------
    # each shared block reads rms(concat(x, embedding)); each hybrid layer
    # holds a gate_up adapter and a d x d linear on the block's output
    hybrid_layer_ids: Tuple[int, ...] = ()  # layers that apply a shared block
    num_mem_blocks: int = 1     # shared blocks, taken in turn: A, B, A, ...
    adapter_rank: int = 0       # rank of the hybrid layers' gate_up adapters
    gelu_exact: bool = False    # erf GELU (else the tanh approximation)

    # -- granite-4.0-h layout (``layer_types`` non-empty) -----------------
    # each layer a mixer of its kind, then an FFN of MoE plus shared expert
    layer_types: Tuple[str, ...] = ()   # "mamba" | "attention", per layer
    residual_multiplier: float = 1.0    # scales both residual branches
    embedding_multiplier: float = 1.0   # scales the token embedding
    logits_scaling: float = 1.0         # the head's logits divided by it
    position_embedding: str = "rope"    # rope | nope (no position encoding)

    # -- modality frontend stubs -------------------------------------------
    frontend: str = ""          # "" | vision | audio
    frontend_tokens: int = 0    # number of precomputed embedding positions

    # -- numerics -----------------------------------------------------------
    dtype: str = "bfloat16"       # activation/compute dtype
    param_dtype: str = "bfloat16"

    # -- notes / applicability ----------------------------------------------
    long_context_ok: bool = False  # True => supports long_500k cell
    notes: str = ""

    # ---------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (Megatron-standard) so the
        embedding / LM head shard evenly over a 16-way model axis."""
        return _round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def published_hybrid(self) -> bool:
        """The published Zamba2 layout: mamba layers, some of them hybrid
        (``hybrid_layer_ids``), and ``num_mem_blocks`` shared blocks."""
        return self.family == "hybrid" and bool(self.hybrid_layer_ids)

    @property
    def moe_hybrid(self) -> bool:
        """The granite-4.0-h layout: every layer a Mamba2 or attention mixer
        (``layer_types``), each followed by an MoE and a shared expert."""
        return bool(self.layer_types)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """The kinds of the ``num_layers`` layers held."""
        return tuple(self.layer_types[:self.num_layers])

    @property
    def held_experts(self) -> Tuple[int, int]:
        """``(start, count)`` of the experts this device holds."""
        return self.experts_start, self.experts_held or self.num_experts

    @property
    def hybrid_ids(self) -> Tuple[int, ...]:
        """The hybrid layers among the ``num_layers`` held."""
        return tuple(i for i in self.hybrid_layer_ids if i < self.num_layers)

    # Parameter count (analytic; the reference checks it against its init) --
    def param_counts(self) -> dict:
        """Returns dict with total / active / embedding parameter counts."""
        if self.published_hybrid:
            return self._published_hybrid_counts()
        if self.moe_hybrid:
            return self._moe_hybrid_counts()
        d, ff, V = self.d_model, self.d_ff, self.padded_vocab
        counts = {"embed": V * d}
        L = self.num_layers
        per_layer_attn = 0
        if self.attention == "gqa":
            q = d * self.num_heads * self.head_dim
            kv = 2 * d * self.num_kv_heads * self.head_dim
            o = self.num_heads * self.head_dim * d
            per_layer_attn = q + kv + o
        elif self.attention == "mla":
            qk = self.qk_nope_dim + self.qk_rope_dim
            q = d * self.num_heads * qk
            kv_down = d * (self.kv_lora_rank + self.qk_rope_dim)
            kv_up = self.kv_lora_rank * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
            o = self.num_heads * self.v_head_dim * d
            per_layer_attn = q + kv_down + kv_up + o

        def mlp_params(dff: int) -> int:
            gates = 2 if self.mlp in ("swiglu", "geglu") else 1
            return d * dff * gates + dff * d

        # layer layout
        n_moe, n_dense, n_ssm, n_shared_attn = 0, 0, 0, 0
        if self.family in ("ssm",):
            n_ssm = L
        elif self.family == "hybrid":
            n_ssm = L
            if self.shared_attn_every:
                n_shared_attn = 1  # shared weights, applied many times
        elif self.is_moe:
            for i in range(L):
                if i < self.first_dense or (i % self.moe_every) != (self.moe_every - 1):
                    n_dense += 1
                else:
                    n_moe += 1
        else:
            n_dense = L

        total = counts["embed"]
        active = counts["embed"]
        if not self.tie_embeddings:
            total += V * d
            active += V * d
        # ssm layers
        if n_ssm:
            di, G, S = self.d_inner, self.ssm_groups, self.ssm_state
            conv_ch = di + 2 * G * S
            per_ssm = (d * (2 * di + 2 * G * S + self.ssm_heads)  # in_proj
                       + conv_ch * self.conv_width                 # conv
                       + self.ssm_heads * 2                        # A_log, D
                       + di * d)                                   # out_proj
            total += n_ssm * per_ssm
            active += n_ssm * per_ssm
        if n_shared_attn:
            sa = per_layer_attn if per_layer_attn else (
                d * self.num_heads * self.head_dim * 2
                + 2 * d * self.num_kv_heads * self.head_dim)
            sa += mlp_params(ff)
            total += sa
            # applied L // shared_attn_every times; active counts once per app
            napp = L // max(1, self.shared_attn_every)
            active += sa * 0 + sa  # weights exist once; FLOPs counted separately
        dense_ff = self.dense_d_ff or ff
        total += n_dense * (per_layer_attn + mlp_params(dense_ff))
        active += n_dense * (per_layer_attn + mlp_params(dense_ff))
        if n_moe:
            router = d * self.num_experts
            experts = self.num_experts * mlp_params(ff)
            shared = self.num_shared_experts * mlp_params(ff)
            total += n_moe * (per_layer_attn + router + experts + shared)
            active += n_moe * (per_layer_attn + router
                               + (self.top_k * mlp_params(ff))
                               + shared)
        counts["total"] = total
        counts["active"] = active
        return counts

    def _published_hybrid_counts(self) -> dict:
        """Every leaf ``Transformer.init`` makes for the published layout,
        norm scales, conv biases and the SSM's per-head vectors included;
        the shared blocks once."""
        d, V, ff = self.d_model, self.padded_vocab, self.d_ff
        di, GN, H = self.d_inner, self.ssm_groups * self.ssm_state, \
            self.ssm_heads
        mamba = (d                                   # ln
                 + d * (2 * di + 2 * GN + H)         # w_z, w_x, w_B, w_C, w_dt
                 + (di + 2 * GN) * (self.conv_width + 1)   # convs, biases
                 + 3 * H                             # A_log, D, dt_bias
                 + di                                # gate_norm
                 + di * d)                           # out_proj
        gates = 2 if self.mlp in ("swiglu", "geglu") else 1
        hybrid = self.adapter_rank * (d + gates * ff) + d * d   # adapter, linear
        d_in = 2 * d                                # concat(x, embedding)
        hd, nh, kv = self.head_dim, self.num_heads, self.num_kv_heads
        block = (d_in + d_in * (nh + 2 * kv) * hd + nh * hd * d   # ln1, attn
                 + d + d * ff * gates + ff * d)                    # ln2, mlp
        total = V * d * (1 if self.tie_embeddings else 2) + d \
            + self.num_layers * mamba + len(self.hybrid_ids) * hybrid \
            + self.num_mem_blocks * block
        return {"embed": V * d, "total": total, "active": total}

    def _moe_hybrid_counts(self) -> dict:
        """Every leaf ``Transformer.init`` makes for the granite-4.0-h
        layout: per layer two norms, its mixer (a Mamba2 block as the
        published layout counts it, or GQA), the f32 router over all
        ``num_experts``, the held experts and the shared expert; ``active``
        counts ``top_k`` experts a layer."""
        d, V, ff, sff = self.d_model, self.padded_vocab, self.d_ff, \
            self.shared_d_ff
        di, GN, H = self.d_inner, self.ssm_groups * self.ssm_state, \
            self.ssm_heads
        mamba = (d * (2 * di + 2 * GN + H) + (di + 2 * GN) * (
            self.conv_width + 1) + 3 * H + di + di * d)
        hd, nh, kv = self.head_dim, self.num_heads, self.num_kv_heads
        attn = d * (nh + 2 * kv) * hd + nh * hd * d
        expert = 3 * d * ff
        ffn = d * self.num_experts + 3 * d * sff
        total = active = V * d * (1 if self.tie_embeddings else 2) + d
        for kind in self.layer_kinds:
            mixer = mamba if kind == "mamba" else attn
            total += 2 * d + mixer + ffn + self.held_experts[1] * expert
            active += 2 * d + mixer + ffn + self.top_k * expert
        return {"embed": V * d, "total": total, "active": active}


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode
    notes: str = ""

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode",
                         "one new token against a 32k KV/state cache")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode",
                        "long-context decode; sub-quadratic archs only")

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """Shape cells that apply to this architecture (long_500k is restricted
    to SSM/hybrid archs; see DESIGN.md §6)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.long_context_ok:
        out.append(LONG_500K)
    return tuple(out)
