"""The granite-4.0-h layout's model operations in one training step, from
the configuration's shapes alone (``perfbench.gen.granite_moe_hybrid``), so
that any implementation of the same step reads the same count.

The forward takes 2 FLOPs a token for each element of every matrix the
token passes through: each Mamba2 layer's projections, each attention
layer's q, k, v and o, each layer's router (over all the published
experts) and shared expert, and the tied head (the token table).  A held
expert's matrices count for the pairs routed to it, at the rate of a
router that spreads a layer's ``T k`` pairs evenly over its published
experts, ``T k held / E`` pairs a layer (``perfbench/expert_bound.py``'s
``6 d ff`` FLOPs a pair).  To that come the attention core of each
attention layer (``perfbench/k2_bound.py``) and the SSD scan of each Mamba2
layer (``perfbench.flops.ssd_flops``).  The backward takes twice the
forward, so a step is three forwards.  Left out: recompute, the norms,
gates and activations, the causal conv, routing and AdamW.
"""
from __future__ import annotations

import math
from typing import Dict

from perfbench.expert_bound import expert_flops
from perfbench.flops import ssd_flops
from perfbench.gen import granite_moe_hybrid as gg
from perfbench.k2_bound import k2_flops

#: the held experts' matrices, counted by the pairs routed to them
EXPERTS = ("moe/wi", "moe/wo")


def step_flops(cfg: Dict, B: int, S: int) -> float:
    """A training step's operations over ``B`` sequences of ``S`` tokens."""
    T = B * S
    per_token = sum(2 * math.prod(shape)
                    for path, shape, _, init in gg.layout(cfg)
                    if init == "dense" and not path.endswith(EXPERTS))
    kinds = gg.layer_kinds(cfg)
    pairs = T * int(cfg["num_experts_per_tok"]) \
        * int(cfg["num_local_experts"]) / int(cfg["num_local_experts_published"])
    experts = len(kinds) * expert_flops(pairs, int(cfg["d_model"]),
                                        int(cfg["intermediate_size"]))
    heads, _, hd = gg.attention_dims(cfg)
    di = int(cfg["expand"]) * int(cfg["d_model"])
    P = int(cfg["head_dim"])
    ssd = ssd_flops(B, S, di // P, P, int(cfg["n_groups"]),
                    int(cfg["d_state"]), int(cfg["chunk_size"]))
    forward = T * per_token + experts \
        + kinds.count("attention") * k2_flops(B, S, heads, hd, hd) \
        + kinds.count("mamba") * ssd
    return 3.0 * forward
