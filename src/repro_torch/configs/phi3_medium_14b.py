"""phi3-medium-14b — dense decoder, RoPE + SwiGLU + GQA (kv=10).
[arXiv:2404.14219; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    source="arXiv:2404.14219; unverified",
    num_layers=40,
    d_model=5120,
    vocab_size=100_352,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17_920,
    mlp="swiglu",
    norm="rms",
    tie_embeddings=False,
    rope_theta=10_000.0,
    long_context_ok=False,
    notes="long_500k skipped: pure full attention.",
)
