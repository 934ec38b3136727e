"""The four summarize backends (DESIGN.md §3).

``python``  — the reference implementation: a per-row loop around the exact
              Algorithm-1 binary search in ``repro_torch.core.patterns`` (the
              oracle every other backend is tested against).
``numpy``   — batched: all E rows advance one shared binary-search step per
              pass, in *segment space* (one entry per nonzero run instead of
              per sample).  Same selection rules as kernel K1 (max-mass
              feasible region, leftmost tie).
``torch``   — the plain torch version of kernel K1
              (``pattern_summary_reference``), on the backend's CPU or CUDA
              device.
``cuda``    — kernel K1 (``repro_torch.kernels.pattern_summary``), the
              hand-written CUDA kernel, on the card.

``python`` and ``numpy`` are copies of the JAX reference package's backends
and run on the host whatever the device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.summarize.base import register_backend


class PythonBackend:
    """Row-at-a-time oracle (the pre-refactor hot loop, kept as ground truth)."""

    name = "python"

    def batch_stats(self, u: np.ndarray) -> np.ndarray:
        from repro_torch.core.patterns import critical_duration
        u = np.asarray(u)
        out = np.zeros((u.shape[0], 3), np.float64)
        for i, row in enumerate(u):
            if float(row.sum()) <= 0.0:
                out[i] = (0.0, 0.0, len(row))
                continue
            lo, hi = critical_duration(row)
            seg = row[lo:hi].astype(np.float64)
            out[i] = (seg.mean(), seg.std(), hi - lo)
        return out


class NumpyBackend:
    """Vectorized Algorithm 1 in *segment space*.

    Each row is compressed once into its nonzero runs (segments): per
    segment, the prefix sum at its end, the prefix sum just before its
    start, and the zero-gap separating it from the previous segment.  The
    binary search over gap bounds then runs entirely on the ``(E, S)``
    segment arrays (S = max segments per row — usually a small fraction of
    n), with each region-start prefix sum recovered gather-free by a cummax
    over the monotone per-segment prefix sums.  Region masses are exactly
    the f32 prefix-sum differences the sample-space formulation computes,
    and segment boundaries are nonzero samples, so region trimming is free.
    Galloping probes (0, then ~doubling from below, capped by the bisection
    midpoint) finish dense rows — whose optimal gap bound is 0-2 — in one
    or two passes."""

    name = "numpy"

    def __init__(self, mass_fraction: float | None = None):
        self.mass_fraction = mass_fraction

    def _mass_fraction(self) -> float:
        if self.mass_fraction is None:
            # single source of truth; late import (patterns imports us back)
            from repro_torch.core.patterns import MASS_FRACTION
            self.mass_fraction = MASS_FRACTION
        return self.mass_fraction

    def batch_stats(self, u: np.ndarray) -> np.ndarray:
        u = np.ascontiguousarray(u, np.float32)
        E, n = u.shape
        if E == 0 or n == 0:
            return np.zeros((E, 3))
        nz = u > 0.0
        csum = np.cumsum(u, axis=1, dtype=np.float32)
        # float64 row sum, NOT csum[:, -1]: the python oracle's target
        # comes from the same f64 sum (exact for f32 addends, so identical
        # under any zero-padding width), while sequential-f32 cumsum drifts
        # from it by enough to flip borderline feasibility on long rows
        total = u.sum(axis=1, dtype=np.float64)
        target = self._mass_fraction() * total - 1e-9
        empty = total <= 0.0
        all_empty = np.stack([np.zeros(E), np.zeros(E),
                              np.full(E, float(n))], axis=1)

        # -- one-time segmentation: nonzero runs as (row, start, end) -----
        prev = np.empty_like(nz)
        prev[:, 0] = False
        prev[:, 1:] = nz[:, :-1]
        nxt = np.empty_like(nz)
        nxt[:, -1] = False
        nxt[:, :-1] = nz[:, 1:]
        r_st, c_st = np.nonzero(nz & ~prev)          # row-major order
        c_en = np.nonzero(nz & ~nxt)[1]              # pairs with c_st
        if r_st.size == 0:
            return all_empty
        K = np.bincount(r_st, minlength=E)           # segments per row
        S = int(K.max())
        off = np.concatenate([[0], np.cumsum(K)[:-1]])
        o = np.arange(r_st.size) - off[r_st]         # segment ordinal

        BIG = np.int32(n + 1)
        gapb = np.full((E, S), BIG, np.int32)        # zero-gap before seg k
        cs_end = np.full((E, S), -1.0, np.float32)   # csum at segment end
        cs_st0 = np.zeros((E, S), np.float32)        # csum before seg start
        st_col = np.zeros((E, S), np.int32)
        en_col = np.zeros((E, S), np.int32)
        st_col[r_st, o] = c_st
        en_col[r_st, o] = c_en
        cs_end[r_st, o] = csum[r_st, c_en]
        cs_st0[r_st, o] = np.where(
            c_st > 0, csum[r_st, np.maximum(c_st - 1, 0)], np.float32(0.0))
        j = np.flatnonzero(o > 0)  # row-major: entry j-1 is segment o-1
        gapb[r_st[j], o[j]] = c_st[j] - c_en[j - 1] - 1

        # -- binary search over gap bounds, all rows in parallel ----------
        # g* <= the row's largest interior gap (no splits there => one
        # region holding all mass); single-segment rows need no search
        max_gap = np.where(gapb == BIG, 0, gapb).max(axis=1).astype(np.int32)
        best_g = max_gap.copy()
        lo_g = np.zeros((E,), np.int32)
        hi_g = np.where(empty, np.int32(-1), max_gap - 1)

        while True:
            act = lo_g <= hi_g
            if not act.any():
                break
            g = np.minimum((lo_g + hi_g) >> 1,
                           np.where(lo_g == 0, 0, 2 * lo_g))
            split = gapb > g[:, None]                # k=0 always splits
            base = np.maximum.accumulate(
                np.where(split, cs_st0, np.float32(0.0)), axis=1)
            mass = cs_end - base                     # padded entries <= -1
            feas = act & (mass.max(axis=1).astype(np.float64) >= target)
            miss = act & ~feas
            best_g[feas] = g[feas]
            hi_g[feas] = g[feas] - 1
            lo_g[miss] = g[miss] + 1

        # -- best region at g*: max-mass group, leftmost on ties ----------
        split = gapb > best_g[:, None]
        kidx = np.broadcast_to(np.arange(S, dtype=np.int32), (E, S))
        first_k = np.maximum.accumulate(
            np.where(split, kidx, np.int32(0)), axis=1)
        base = np.maximum.accumulate(
            np.where(split, cs_st0, np.float32(0.0)), axis=1)
        best_k = np.argmax(cs_end - base, axis=1)
        ar = np.arange(E)
        lo = st_col[ar, first_k[ar, best_k]]         # already zero-trimmed
        hi = en_col[ar, best_k] + 1

        # -- duration-weighted moments over [lo, hi) ----------------------
        idx = np.broadcast_to(np.arange(n, dtype=np.int32), (E, n))
        inside = (idx >= lo[:, None]) & (idx < hi[:, None])
        cnt = np.maximum((hi - lo).astype(np.float64), 1.0)
        mean = np.where(inside, u, 0).sum(axis=1, dtype=np.float64) / cnt
        var = np.where(inside,
                       np.square(u - mean[:, None].astype(np.float32)),
                       0).sum(axis=1, dtype=np.float64) / cnt
        return np.where(empty[:, None], all_empty,
                        np.stack([mean, np.sqrt(var),
                                  (hi - lo).astype(np.float64)], axis=1))


class TorchBackend:
    """The plain torch version of K1 on the backend's device."""

    name = "torch"

    def __init__(self, device="cpu"):
        self.device = torch.device(device)

    def batch_stats(self, u: np.ndarray) -> np.ndarray:
        # late: the kernel module reads MASS_FRACTION from core.patterns
        from repro_torch.kernels.pattern_summary import \
            pattern_summary_reference
        t = torch.from_numpy(np.ascontiguousarray(u, np.float32))
        return pattern_summary_reference(t.to(self.device)).cpu().numpy()


class CudaBackend:
    """Kernel K1 on the card: moves ``u`` to the device, launches the kernel
    once and returns its ``(E, 3)`` float64 ``[mean, std, count]``.  No
    fallback: a kernel that does not build or launch raises."""

    name = "cuda"

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"the cuda backend runs on a CUDA device, "
                             f"not {self.device}")

    def batch_stats(self, u: np.ndarray) -> np.ndarray:
        from repro_torch.kernels.pattern_summary import pattern_summary
        t = torch.from_numpy(np.ascontiguousarray(u, np.float32))
        return pattern_summary(t.to(self.device)).cpu().numpy()


# the host backends ignore the device they are resolved for
register_backend("python", lambda device: PythonBackend())
register_backend("numpy", lambda device: NumpyBackend())
register_backend("torch", TorchBackend)
register_backend("cuda", CudaBackend)
