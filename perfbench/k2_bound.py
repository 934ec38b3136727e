"""K2's least time a call, from shapes alone: the operations of causal
attention at the bf16 peak of one H100 (``perfbench.flops``), so that any
implementation of the same attention reads the same bound.

``2 (D + Dv)`` FLOPs per unmasked (q, k) pair and head (``Q K^T`` and
``P V``), with the heads' real widths (224 at the published Zamba2-7B,
not the 256-wide tiles K2 runs them on); a causal sequence of S keeps
``S (S + 1) / 2`` pairs.  (The same count as the port's
``kernels/flash_attention.py::bound_ms``; its bytes are two orders of
magnitude below the operations' time at these shapes and are left out.)
"""
from __future__ import annotations

from perfbench.flops import PEAK_FLOPS


def k2_flops(B: int, S: int, H: int, D: int, Dv: int) -> float:
    """A causal self-attention call's operations."""
    return 2.0 * (D + Dv) * B * H * (S * (S + 1) // 2)


def k2_bound_s(B: int, S: int, H: int, D: int, Dv: int, dtype: str
               ) -> float:
    """``k2_flops`` at the dtype's peak, in seconds."""
    return k2_flops(B, S, H, D, Dv) / PEAK_FLOPS[dtype]
