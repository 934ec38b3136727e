"""Ring-collective behavior model (paper §3, Figs. 3-5).

Chunked ring transfer: at every stage each worker forwards one chunk to its
neighbor, then waits for the slowest link before the next stage. With a link
degraded to a fraction rho of nominal bandwidth:

  * workers on rings that avoid the slow link: continuous ~max throughput
    (Fig. 5a);
  * workers on the affected ring but not driving the slow link: bursts at
    max for rho of each stage, idle otherwise -> mean ~rho, HIGH std
    (Fig. 5b);
  * the worker driving the slow link: continuous ~rho throughput, LOW std
    (Fig. 5c).

On TPU the same signature appears on ICI collective-permute schedules; the
(mu, sigma) differential is what the localizer consumes (DESIGN.md §2).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class RingConfig:
    n_workers: int = 32
    n_rings: int = 2            # NCCL builds multiple rings over the NICs
    stage_s: float = 0.004      # nominal chunk stage time
    noise: float = 0.02


def ring_utilization(cfg: RingConfig, duration_s: float, rate_hz: float,
                     slow_worker: Optional[int] = None, rho: float = 0.5,
                     slow_ring: int = 0, rng=None) -> np.ndarray:
    """Per-worker GPU->NIC utilization traces during a ring collective.
    Returns (n_workers, n_samples) in [0, 1].

    Ring r contains all workers (head-to-tail), but each ring uses a
    different NIC/bond; only ``slow_ring`` is affected by the degraded bond
    of ``slow_worker``. A worker's observed GPU-NIC throughput is the mean
    over its rings (they share the measured GPU-NIC path).
    """
    rng = rng or np.random.default_rng(0)
    n = int(duration_s * rate_hz)
    t = np.arange(n) / rate_hz
    out = np.zeros((cfg.n_workers, n), np.float64)

    for r in range(cfg.n_rings):
        affected = slow_worker is not None and r == slow_ring
        stage = cfg.stage_s / rho if affected else cfg.stage_s
        phase = (t % stage) / stage              # position within stage
        for w in range(cfg.n_workers):
            if not affected:
                u = np.ones(n)
            elif w == slow_worker:
                u = np.full(n, rho)              # continuous, low sigma
            else:
                u = (phase < rho).astype(np.float64)  # burst then wait
            out[w] += u
    out /= cfg.n_rings
    out += rng.normal(0, cfg.noise, out.shape)
    return np.clip(out, 0.0, 1.0)
