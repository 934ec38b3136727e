"""musicgen-medium — decoder-only transformer over EnCodec tokens (frontend
STUB: precomputed frame embeddings), MHA (kv=24), LayerNorm + GELU.
[arXiv:2306.05284; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    source="arXiv:2306.05284; hf",
    num_layers=48,
    d_model=1536,
    vocab_size=2048,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    mlp="gelu",
    norm="layer",
    use_bias=True,
    tie_embeddings=False,
    rope_theta=10_000.0,   # positional handling simplified to RoPE trunk-side
    frontend="audio",
    frontend_tokens=0,     # frame embeddings replace token embeddings 1:1
    long_context_ok=False,
    notes="EnCodec codebook interleaving handled by the stub frontend; trunk "
          "sees one embedding per frame. long_500k skipped: full attention.",
)
