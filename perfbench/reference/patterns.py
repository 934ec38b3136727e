"""Plain reference of EROICA's summary of one worker's profiling window.

Worked out from the window's raw record alone, the function executions
(name, kind, start, end, call depth, thread, stream) and the resource
streams' samples, read as plain values; it imports nothing of the program.
The definitions (EROICA, arXiv 2506.08528, §4.2-4.3):

* An execution reads its stream (its own, else its kind's: GPU ``gpu_sm``,
  memory ``membw``, collectives ``pcie_tx``, Python ``cpu``) over its
  window: samples ``[max(0, trunc((start - t0) r)), min(n, ceil((end - t0)
  r)))``, stored as float32 (the sample type of the summary).  Executions
  whose stream is missing or which get no samples are dropped.
* Algorithm 1: the critical execution duration of a row is the region,
  between zero-runs longer than the smallest gap bound ``g`` for which some
  region holds at least 80% of the row's mass, that holds the most mass
  (zeros trimmed at both ends).  An all-zero row has mean and std 0 and its
  whole length as count.
* mu and sigma of a function are the means of its rows' mean and std over
  their critical durations, weighted by the durations in seconds (an
  all-zero row weighs its whole window), capped at 1.
* beta is the share of the window a function spends on the critical path:
  of the executions running at an instant, the GPU kind wins over memory,
  memory over collectives, collectives over Python; Python executions count
  only on the training thread, and among Python winners the deepest frame
  wins.  Capped at 1.

``sample_dtype`` is the precision the samples are read in: ``float32`` as
the summary states, ``bfloat16`` for the control.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

GPU, MEM, COMM, PYTHON = 0, 1, 2, 3
STREAM_OF_KIND = {GPU: "gpu_sm", MEM: "membw", COMM: "pcie_tx",
                  PYTHON: "cpu"}
MASS = 0.8


@dataclass(frozen=True)
class Execution:
    """One function execution of the window, in seconds from its start."""
    name: str
    kind: int
    start: float
    end: float
    depth: int = 0
    thread: str = "train"
    stream: str = ""          # the stream it reads, if not its kind's


@dataclass(frozen=True)
class Stream:
    """A resource's samples at a fixed rate, the first at ``t0``."""
    rate_hz: float
    t0: float
    values: np.ndarray


def cast(x: np.ndarray, sample_dtype: str) -> np.ndarray:
    """float32 samples, rounded first to ``sample_dtype``'s precision."""
    x32 = np.asarray(x, np.float32)
    if sample_dtype == "float32":
        return x32
    dt = {"bfloat16": torch.bfloat16, "float16": torch.float16}[sample_dtype]
    return torch.from_numpy(x32).to(dt).float().numpy()


def samples(e: Execution, s: Stream) -> np.ndarray:
    """The samples of ``s`` that execution ``e`` reads."""
    n = len(s.values)
    i0 = max(0, int(np.trunc((e.start - s.t0) * s.rate_hz)))
    i1 = min(n, int(np.ceil((e.end - s.t0) * s.rate_hz)))
    return s.values[i0:max(i0, i1)]


def critical_region(u: np.ndarray, mass: float = MASS) -> Tuple[int, int]:
    """Algorithm 1 for one row, plainly: ``[lo, hi)`` of the region.

    Feasibility grows with the gap bound, and changes only where the bound
    passes a zero-run's length, so the smallest feasible bound is 0 or a
    run's length: the candidates are tried in increasing order."""
    u = np.asarray(u, np.float32)
    n = len(u)
    total = float(u.sum(dtype=np.float64))
    if total <= 0.0:
        return 0, n
    nz = np.flatnonzero(u > 0)
    # nonzero segments [s_k, e_k) and the zero-run before each
    brk = np.flatnonzero(np.diff(nz) > 1)
    seg_s = nz[np.concatenate([[0], brk + 1])]
    seg_e = nz[np.concatenate([brk, [len(nz) - 1]])] + 1
    gap = seg_s[1:] - seg_e[:-1]
    csum = np.concatenate([[0.0], np.cumsum(u, dtype=np.float64)])
    seg_mass = csum[seg_e] - csum[seg_s]
    target = mass * total - 1e-9
    for g in np.unique(np.concatenate([[0], gap])):
        cut = np.concatenate([[0], np.flatnonzero(gap > g) + 1,
                              [len(seg_s)]])
        masses = np.add.reduceat(seg_mass, cut[:-1])
        best = int(np.argmax(masses))        # leftmost on ties
        if masses[best] >= target:
            return int(seg_s[cut[best]]), int(seg_e[cut[best + 1] - 1])
    raise AssertionError("the whole row is always feasible")


def row_stats(u: np.ndarray) -> Tuple[float, float, float]:
    """Mean, std and count over one row's critical region; an all-zero row
    gives ``(0, 0, length)``."""
    if not (u > 0).any():
        return 0.0, 0.0, float(len(u))
    lo, hi = critical_region(u)
    seg = u[lo:hi].astype(np.float64)
    return float(seg.mean()), float(seg.std()), float(hi - lo)


def critical_seconds(kind: np.ndarray, depth: np.ndarray,
                     eligible: np.ndarray, start: np.ndarray,
                     end: np.ndarray, window_s: float) -> np.ndarray:
    """Seconds each execution spends on the critical path (module
    docstring): the window is cut at every event boundary, and each piece
    goes to its winners among the eligible executions."""
    s = np.clip(start, 0.0, window_s)
    e = np.clip(end, 0.0, window_s)
    pts = np.unique(np.concatenate([[0.0, window_s], s, e]))
    lo, hi = pts[:-1], pts[1:]
    on = (s[:, None] <= lo[None, :]) & (e[:, None] >= hi[None, :]) \
        & eligible[:, None]
    k = np.where(on, kind[:, None], 99)
    best = k.min(axis=0)
    win = on & (kind[:, None] == best[None, :])
    d = np.where(win, depth[:, None], -1)
    py = best == PYTHON
    win &= ~py[None, :] | (depth[:, None] == d.max(axis=0)[None, :])
    return (win * (hi - lo)[None, :]).sum(axis=1)


def worker_patterns(events: Sequence[Execution], streams: Dict[str, Stream],
                    window_s: float, sample_dtype: str = "float32"
                    ) -> Dict[str, np.ndarray]:
    """``{function: (beta, mu, sigma)}`` of one worker's window, float64,
    for every function that has an execution in it."""
    names: List[str] = list(dict.fromkeys(e.name for e in events))
    num_mu = dict.fromkeys(names, 0.0)
    num_sig = dict.fromkeys(names, 0.0)
    den = dict.fromkeys(names, 0.0)
    for e in events:
        s = streams.get(e.stream or STREAM_OF_KIND[e.kind])
        if s is None:
            continue
        u = cast(samples(e, s), sample_dtype)
        if len(u) == 0:
            continue
        mean, std, cnt = row_stats(u)
        w = min(cnt, len(u)) / s.rate_hz
        num_mu[e.name] += w * mean
        num_sig[e.name] += w * std
        den[e.name] += w
    crit = critical_seconds(
        np.array([e.kind for e in events]),
        np.array([e.depth for e in events]),
        np.array([e.kind != PYTHON or e.thread == "train" for e in events]),
        np.array([e.start for e in events], np.float64),
        np.array([e.end for e in events], np.float64), window_s)
    beta = dict.fromkeys(names, 0.0)
    for e, c in zip(events, crit):
        beta[e.name] += c
    T = max(window_s, np.finfo(float).tiny)
    return {n: np.minimum([beta[n] / T,
                           num_mu[n] / den[n] if den[n] else 0.0,
                           num_sig[n] / den[n] if den[n] else 0.0], 1.0)
            for n in names}


def pattern_gap(got: Dict[str, Sequence[float]],
                want: Dict[str, np.ndarray]) -> float:
    """The largest gap of any beta, mu or sigma between a summary and the
    reference's; infinite when they name different functions."""
    if set(got) != set(want):
        return float("inf")
    return max((float(np.abs(np.asarray(got[k], np.float64) - want[k]).max())
                for k in want), default=0.0)
