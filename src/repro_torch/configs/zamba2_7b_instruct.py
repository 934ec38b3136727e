"""zamba2-7b-instruct — Zamba2-7B as published (Zyphra/Zamba2-7B-Instruct's
config.json; Zamba2, arXiv:2411.15242; the shared block of Zamba,
arXiv:2405.16712 fig. 2, eq. 6).

81 Mamba2 layers (state 64, 2 groups, 112 heads of 64, chunk 256, conv 4,
the gated norm per group of 3584); 13 of them, ``hybrid_layer_ids``, first
apply one of two shared attention+MLP blocks, in turn.  Call the hybrid
layer's input x and the token embedding e:

    c = rms(concat(x, e))                      (7168 columns)
    a = attn(c)    32 heads of 224, q/k/v 7168 -> 7168, o 7168 -> 3584,
                   scale (224/2)^-0.5, RoPE over all 224 dims, causal
    h = rms(a);  [g, u] = h W_gu + (h A_l) B_l   (rank-128 adapter of layer l)
    m = down(gelu(g) u)                        (exact GELU, width 14336)
    x <- x + mamba(rms(x + m W_l))             (W_l: 3584 x 3584, layer l's)

The block has no residual of its own; its output enters only the mamba
layer's normed input.  Tied 32,000-token head (a multiple of 256: no pad
rows).  Not the port's ``zamba2-7b``, which is the JAX reference's
simplified hybrid.  Training only: decode, the cache and a mesh raise
``NotImplementedError`` on this layout (``models.transformer``).
"""
from repro_torch.configs.base import ModelConfig

#: the published ``hybrid_layer_ids``
HYBRID_LAYER_IDS = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)

CONFIG = ModelConfig(
    name="zamba2-7b-instruct",
    family="hybrid",
    source="hf:Zyphra/Zamba2-7B-Instruct config.json; arXiv:2411.15242",
    num_layers=81,
    d_model=3584,
    vocab_size=32_000,
    norm="rms",
    norm_eps=1e-5,
    mlp="geglu",
    gelu_exact=True,
    d_ff=14_336,
    tie_embeddings=True,
    attention="gqa",
    num_heads=32,
    num_kv_heads=32,
    head_dim=224,                  # attention_head_dim: 2 * 3584 / 32
    attn_scale=112 ** -0.5,        # (head_dim / 2) ** -0.5
    rope_theta=10_000.0,
    sliding_window=0,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=2,
    ssm_chunk=256,
    conv_width=4,
    ssm_grouped_norm=True,
    hybrid_layer_ids=HYBRID_LAYER_IDS,
    num_mem_blocks=2,
    adapter_rank=128,
    notes="training only (no decode or mesh on this layout)",
)
