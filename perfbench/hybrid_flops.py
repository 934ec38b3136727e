"""The published Zamba2 layout's model operations in one training step,
from the configuration's shapes alone (``perfbench.gen.zamba2.layout``), so
that any implementation of the same step reads the same count.

The forward takes 2 FLOPs a token for each element of every matrix the
token passes through: each Mamba2 layer's projections, each hybrid layer's
adapter and output linear, the tied head (the token table), and a shared
block's matrices once for each application (two blocks taken in turn over
the hybrid layers held: at 24 layers, four applications, each block
twice).  To that come the attention core of each application
(``perfbench/k2_bound.py``) and the SSD scan of each layer
(``perfbench.flops.ssd_flops``).  The backward takes twice the forward, so
a step is three forwards.  Left out: recompute, the norms, gates and
activations, the causal conv (8 FLOPs a channel and token) and AdamW.
"""
from __future__ import annotations

import math
from typing import Dict

from perfbench.flops import ssd_flops
from perfbench.gen import zamba2 as gz
from perfbench.k2_bound import k2_flops


def step_flops(cfg: Dict, B: int, S: int) -> float:
    """A training step's operations over ``B`` sequences of ``S`` tokens."""
    ids, blocks = gz.hybrid_ids(cfg), int(cfg["num_mem_blocks"])
    uses = [sum(1 for j in range(len(ids)) if j % blocks == k)
            for k in range(blocks)]
    per_token = 0
    for path, shape, _, init in gz.layout(cfg):
        if init != "dense":
            continue
        n = math.prod(shape)
        if path.startswith("shared/"):
            n *= uses[int(path.split("/")[1])]
        per_token += 2 * n
    heads, _, hd = gz.attention_dims(cfg)
    di = int(cfg["expand"]) * int(cfg["d_model"])
    P = int(cfg["head_dim"])
    ssd = ssd_flops(B, S, di // P, P, int(cfg["n_groups"]),
                    int(cfg["d_state"]), int(cfg["chunk_size"]))
    forward = B * S * per_token + len(ids) * k2_flops(B, S, heads, hd, hd) \
        + int(cfg["num_layers"]) * ssd
    return 3.0 * forward
