"""deepseek-v2-lite-16b — MLA (kv_lora=512) + MoE (2 shared + 64 routed,
top-6), first layer dense. [arXiv:2405.04434; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    source="arXiv:2405.04434; hf",
    num_layers=27,
    d_model=2048,
    vocab_size=102_400,
    attention="mla",
    num_heads=16,
    num_kv_heads=16,   # MLA: latent-shared; head count for attention core
    head_dim=192,      # qk_nope + qk_rope
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    d_ff=1408,                 # per routed/shared expert
    dense_d_ff=10_944,         # layer-0 dense MLP
    first_dense=1,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_every=1,
    capacity_factor=1.25,
    mlp="swiglu",
    norm="rms",
    tie_embeddings=False,
    rope_theta=10_000.0,
    long_context_ok=False,
    notes="long_500k skipped: full attention (MLA compresses KV but is still "
          "quadratic).",
)
