"""zamba2-7b — the JAX reference's simplified hybrid, not the published
Zamba2-7B: a Mamba2 backbone and one shared attention+SwiGLU block (heads
of 112, ``kv_channels``) applied after every 6 mamba layers into the
residual stream, the gated norm over the whole row (6,672,161,504
parameters).  The published model, two shared blocks in turn over
``concat(x, embedding)`` with heads of 224 and per-layer adapters, is
``zamba2_7b_instruct.py``. [arXiv:2411.15242; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    source="arXiv:2411.15242; unverified",
    num_layers=81,              # mamba2 layers
    d_model=3584,
    vocab_size=32_000,
    attention="gqa",            # the shared attention block
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,               # 3584 / 32
    d_ff=14_336,                # shared block's MLP
    shared_attn_every=6,        # one shared-weight attn block per 6 ssm layers
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=2,
    ssm_chunk=256,
    conv_width=4,
    mlp="swiglu",
    norm="rms",
    tie_embeddings=True,
    rope_theta=10_000.0,
    long_context_ok=True,
    notes="long_500k runs: SSM state is O(1); the shared attention blocks use "
          "a sliding KV window of 4096 in long-context serving (Zamba2-style "
          "hybrid serving; full KV at 500k would defeat the SSM).",
    sliding_window=4096,
)
