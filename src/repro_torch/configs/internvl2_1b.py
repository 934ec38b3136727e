"""internvl2-1b — VLM: InternViT frontend (STUB: precomputed patch
embeddings) + Qwen2-0.5B language trunk (GQA kv=2, qkv bias).
[arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    source="arXiv:2404.16821; hf",
    num_layers=24,
    d_model=896,
    vocab_size=151_655,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    mlp="swiglu",
    norm="rms",
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    frontend="vision",
    frontend_tokens=256,   # one 448x448 tile -> 256 patch embeddings (stub)
    long_context_ok=False,
    notes="vocab 151655 padded to 151808 for 16-way TP (DESIGN.md §4). "
          "long_500k skipped: full attention.",
)
