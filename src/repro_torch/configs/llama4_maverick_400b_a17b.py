"""llama4-maverick-400b-a17b — MoE 128 routed experts top-1 + shared expert,
interleaved dense/MoE layers (every 2nd layer MoE), GQA kv=8.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Parameter budget check (ModelConfig.param_counts): 24 MoE layers x 128
experts x 3*5120*8192 ~= 386B routed + dense/attn/shared ~= 400B total,
~17B active (top-1 + shared expert + interleaved dense) — matches 400b-a17b.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    num_layers=48,
    d_model=5120,
    vocab_size=202_048,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,              # per expert
    dense_d_ff=16_384,      # interleaved dense layers
    num_experts=128,
    num_shared_experts=1,
    top_k=1,
    moe_every=2,            # layers 1,3,5,... are MoE
    capacity_factor=1.25,
    mlp="swiglu",
    norm="rms",
    tie_embeddings=False,
    rope_theta=500_000.0,
    long_context_ok=False,
    notes="long_500k skipped: full attention. Early-fusion multimodal "
          "frontend out of scope (text trunk only, per assignment).",
)
