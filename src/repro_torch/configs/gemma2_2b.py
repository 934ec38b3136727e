"""gemma2-2b — dense decoder, local+global alternating attention, logit
softcaps. [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    source="arXiv:2408.00118; hf",
    num_layers=26,
    d_model=2304,
    vocab_size=256_000,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    mlp="geglu",
    norm="rms",
    post_norms=True,
    scale_embed=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    sliding_window=4096,
    local_global=True,
    attn_softcap=50.0,
    logit_softcap=30.0,
    attn_scale=256 ** -0.5,
    long_context_ok=False,
    notes=("long_500k skipped: alternating *global* layers are full attention "
           "and need a dense 500k KV cache (see DESIGN.md §6)."),
)
