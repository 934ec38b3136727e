"""Architecture registry: ``--arch <id>`` resolution + reduced configs for
CPU smoke tests (a copy of the reference's ``repro/configs/registry.py``)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig, ALL_SHAPES, shapes_for

from repro_torch.configs import (  # noqa: F401
    gemma2_2b,
    granite_34b,
    phi3_medium_14b,
    starcoder2_3b,
    mamba2_2p7b,
    deepseek_v2_lite_16b,
    llama4_maverick_400b_a17b,
    internvl2_1b,
    musicgen_medium,
    zamba2_7b,
    zamba2_7b_instruct,
    granite_4_0_h_small,
)

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        gemma2_2b,
        granite_34b,
        phi3_medium_14b,
        starcoder2_3b,
        mamba2_2p7b,
        deepseek_v2_lite_16b,
        llama4_maverick_400b_a17b,
        internvl2_1b,
        musicgen_medium,
        zamba2_7b,
    )
}


#: configurations the JAX reference has no counterpart of (``ARCHS`` stays
#: its list, which the parity tests walk): models as published
PUBLISHED: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (zamba2_7b_instruct,
                                       granite_4_0_h_small)
}


def get_arch(name: str) -> ModelConfig:
    if name in PUBLISHED:
        return PUBLISHED[name]
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: "
                       f"{sorted(ARCHS) + sorted(PUBLISHED)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}")


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
            vocab: int = 512) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests: small layers/width, few
    experts, tiny embedding tables — structure preserved."""
    head_dim = 16
    n_heads = max(2, min(4, cfg.num_heads)) if cfg.num_heads else 0
    n_kv = max(1, min(n_heads, cfg.num_kv_heads)) if cfg.num_kv_heads else 0
    kw = dict(
        num_layers=layers,
        d_model=d_model,
        vocab_size=vocab,
        d_ff=4 * d_model if cfg.d_ff else 0,
        dense_d_ff=4 * d_model if cfg.dense_d_ff else 0,
        num_heads=n_heads,
        num_kv_heads=n_kv,
        head_dim=head_dim,
        dtype="float32",
        param_dtype="float32",
    )
    if cfg.attention == "mla":
        kw.update(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                  v_head_dim=16, head_dim=24)
    if cfg.is_moe:
        kw.update(num_experts=8, top_k=min(2, cfg.top_k),
                  num_shared_experts=min(1, cfg.num_shared_experts),
                  first_dense=min(cfg.first_dense, 1),
                  moe_every=cfg.moe_every,
                  d_ff=2 * d_model)
        if cfg.moe_every > 1 or cfg.first_dense:
            kw["num_layers"] = max(layers, 2 * cfg.moe_every)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32,
                  ssm_groups=min(cfg.ssm_groups, 2))
    if cfg.shared_attn_every:
        kw.update(num_layers=max(4, layers), shared_attn_every=2)
    if cfg.sliding_window:
        kw.update(sliding_window=64)
    if cfg.frontend_tokens:
        kw.update(frontend_tokens=8)
    return cfg.with_overrides(**kw)


__all__ = ["ARCHS", "PUBLISHED", "get_arch", "get_shape", "reduced",
           "shapes_for"]
