"""granite-34b-code — llama-architecture dense decoder with MQA (kv=1).
[arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    source="arXiv:2405.04324; hf",
    num_layers=88,
    d_model=6144,
    vocab_size=49_152,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24_576,
    mlp="swiglu",
    norm="rms",
    tie_embeddings=True,
    rope_theta=10_000.0,
    long_context_ok=False,
    notes="long_500k skipped: pure full attention.",
)
