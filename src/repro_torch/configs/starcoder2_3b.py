"""starcoder2-3b — dense decoder, GQA (kv=2) + RoPE, non-gated GELU MLP with
biases and LayerNorm (BigCode family). [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    source="arXiv:2402.19173; hf",
    num_layers=30,
    d_model=3072,
    vocab_size=49_152,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12_288,
    mlp="gelu",
    norm="layer",
    use_bias=True,
    tie_embeddings=True,
    rope_theta=100_000.0,
    sliding_window=4096,
    long_context_ok=False,
    notes="long_500k skipped: full/sliding attention hybrid trained at 16k.",
)
