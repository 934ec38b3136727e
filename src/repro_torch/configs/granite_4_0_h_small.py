"""granite-4.0-h-small — IBM's Granite 4.0-H Small (32B total, 9B active) as
published (ibm-granite/granite-4.0-h-small's config.json; ``transformers``'
``GraniteMoeHybridForCausalLM``).

40 layers, ``LAYER_TYPES``: attention at 5, 15, 25 and 35, Mamba2
everywhere else (d 4096, d_inner 8192, 128 heads of 64, state 128, 1 group,
chunk 256, conv 4 with bias, the gated norm over the whole d_inner).  Each
layer, with x its input and r the residual multiplier 0.22:

    x <- x + r mixer(rms(x))
    h = rms(x);  x <- x + r (moe(h) + shared(h))

The attention mixer is GQA, 32 query heads and 8 KV heads of 128, with no
position encoding (NoPE), scale 1/128, causal.  The MoE's f32 router takes
the top 10 of its 72 logits and a softmax over those 10; each expert is a
SwiGLU of width 768 and routing is dropless.  The shared expert is a SwiGLU
of width 1536.  The embedding is multiplied by 12, the tied head's logits
divided by 16.  100,352 tokens (a multiple of 256: no pad rows).

Training only: decode, the cache and a mesh raise ``NotImplementedError``
on this layout (``models.transformer``).  ``experts_start`` and
``experts_held`` cut the experts a device holds (the benchmark's cell holds
8 of the 72, ``perfbench/configs/granite-4.0-h-small.json``).
"""
from repro_torch.configs.base import ModelConfig

#: the published ``layer_types``
LAYER_TYPES = tuple("attention" if i % 10 == 5 else "mamba"
                    for i in range(40))

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    source="hf:ibm-granite/granite-4.0-h-small config.json",
    num_layers=40,
    d_model=4096,
    vocab_size=100_352,
    norm="rms",
    norm_eps=1e-5,
    mlp="swiglu",
    d_ff=768,                      # intermediate_size: one expert's width
    tie_embeddings=True,
    attention="gqa",
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,                  # hidden_size / num_attention_heads
    attn_scale=0.0078125,          # attention_multiplier, 1/128
    position_embedding="nope",
    num_experts=72,
    top_k=10,
    num_shared_experts=1,
    shared_d_ff=1536,              # shared_intermediate_size
    gate_topk_first=True,
    moe_dropless=True,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    ssm_chunk=256,
    conv_width=4,
    layer_types=LAYER_TYPES,
    residual_multiplier=0.22,
    embedding_multiplier=12.0,
    logits_scaling=16.0,
    notes="training only (no decode or mesh on this layout)",
)
