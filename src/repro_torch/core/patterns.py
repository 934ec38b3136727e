"""Runtime behavior patterns P_{f,w} = (beta, mu, sigma) — paper §4.2.

beta: fraction of the profiling window the function spends on the critical
      path (Eq. 2-3).
mu:   duration-weighted mean resource utilization over the *critical
      execution duration* L(e) of each execution (Eq. 4), where L(e) is found
      by Algorithm 1 — the subinterval holding >=80% of the utilization mass
      with the smallest allowed run of consecutive zero samples (binary
      search over the gap bound g).
sigma: same weighting for the utilization std-dev (Eq. 5).

``critical_duration`` here is the scalar oracle for Algorithm 1; the batched
execution lives in ``repro_torch.summarize`` behind a pluggable backend protocol
(python oracle loop / vectorized numpy / plain torch / the CUDA kernel
K1 in ``repro_torch.kernels.pattern_summary``).
``summarize_worker`` delegates there and keeps its historical signature.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.events import Kind, WorkerProfile

MASS_FRACTION = 0.8


def critical_duration(u: np.ndarray, mass: float = MASS_FRACTION
                      ) -> Tuple[int, int]:
    """Algorithm 1: smallest max-zero-gap subinterval with >= mass of the
    total utilization. Returns [l, r) sample indices (r exclusive).

    For a gap bound g, the feasible subintervals that avoid any zero-run
    longer than g are exactly the maximal regions obtained by splitting at
    zero-runs of length > g; feasibility <=> some region holds >= mass*S.
    Binary search over g in [0, n]."""
    n = len(u)
    if n == 0:
        return (0, 0)
    # f64 accumulation: exact for f32 inputs, so the mass target (and hence
    # the selected region) is independent of trailing zero-padding width
    total = float(u.sum(dtype=np.float64))
    if total <= 0.0:
        return (0, n)
    target = mass * total

    zero = u <= 0.0
    # zero-run ids and lengths
    csum = np.concatenate([[0.0], np.cumsum(u)])

    def best_region(g: int) -> Optional[Tuple[int, int]]:
        # split points: zero-runs strictly longer than g
        regions = []
        start = 0
        run = 0
        for i in range(n):
            if zero[i]:
                run += 1
            else:
                if run > g and i - run >= start:
                    regions.append((start, i - run))
                    start = i
                run = 0
        regions.append((start, n))
        best = None
        best_mass = -1.0
        for lo, hi in regions:
            # trim leading/trailing zeros
            while lo < hi and zero[lo]:
                lo += 1
            while hi > lo and zero[hi - 1]:
                hi -= 1
            if hi <= lo:
                continue
            s = csum[hi] - csum[lo]
            # among feasible regions keep the max-mass one (leftmost tie) —
            # matches the batched backends' and kernel K1's selection rule
            if s >= target - 1e-9 and s > best_mass + 1e-12:
                best = (lo, hi)
                best_mass = s
        return best

    lo_g, hi_g = 0, n
    result = (0, n)
    while lo_g <= hi_g:
        g = (lo_g + hi_g) // 2
        reg = best_region(g)
        if reg is not None:
            result = reg
            hi_g = g - 1
        else:
            lo_g = g + 1
    return result


@dataclass
class Pattern:
    beta: float
    mu: float
    sigma: float

    def as_array(self) -> np.ndarray:
        return np.array([self.beta, self.mu, self.sigma], np.float32)


def summarize_worker(profile: WorkerProfile,
                     kinds: Optional[Dict[str, Kind]] = None,
                     backend=None) -> Dict[str, Pattern]:
    """Per-function behavior patterns for one worker (paper §4.2).

    ``kinds`` overrides the per-event function kinds (stream routing +
    uploaded kind map); ``backend`` picks the batched Algorithm-1 executor
    (name, instance, or None for env/auto — see repro_torch.summarize).
    """
    from repro_torch.summarize.engine import summarize_profile
    pats, _ = summarize_profile(profile, kind_of=kinds, backend=backend)
    return pats


def pattern_size_bytes(patterns: Dict[str, Pattern]) -> int:
    """Serialized size: full function identity (call stack) + 3 floats."""
    return sum(len(name.encode()) + 12 for name in patterns)
