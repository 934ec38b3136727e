"""The held experts' least time in a forward, from the pairs routed to them
alone, so that any implementation of the same layer reads the same bound.

Each (token, held expert) pair passes its expert's SwiGLU once: ``[g, u] =
x W_in`` (``2 d 2 ff`` FLOPs) and ``(silu(g) u) W_out`` (``2 ff d``), so
``6 d ff`` FLOPs a pair, at the bf16 peak of one H100
(``perfbench.flops``).  The activation, the gate's product, the gathers
and the combine count nothing.
"""
from __future__ import annotations

from perfbench.flops import PEAK_FLOPS


def expert_flops(pairs: float, d: int, ff: int) -> float:
    """The held experts' operations over ``pairs`` routed pairs."""
    return 6.0 * d * ff * pairs


def expert_bound_s(pairs: float, d: int, ff: int, dtype: str) -> float:
    """``expert_flops`` at the dtype's peak, in seconds."""
    return expert_flops(pairs, d, ff) / PEAK_FLOPS[dtype]
