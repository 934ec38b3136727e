"""mamba2-2.7b — attention-free SSM with SSD (state-space duality).
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    source="arXiv:2405.21060; unverified",
    num_layers=64,
    d_model=2560,
    vocab_size=50_280,
    attention="none",
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    ssm_chunk=256,
    conv_width=4,
    norm="rms",
    tie_embeddings=True,
    long_context_ok=True,
    notes="long_500k runs: recurrent state is O(1) in sequence length.",
)
