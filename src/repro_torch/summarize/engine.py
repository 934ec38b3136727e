"""Batched per-worker summarization (DESIGN.md §3): pack -> backend -> reduce.

Replaces the per-event loop of the old ``core.patterns.summarize_worker``:
every execution of every function becomes one row of a single ``(E, n)``
matrix, the selected backend computes all critical-duration statistics in one
batched call, and the duration-weighted per-function reduction (Eq. 4-5) is a
pair of ``bincount`` scatters.  Beta (Eq. 2-3) still comes from the critical
path sweep, which is already event-parallel-free and cheap.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np

from repro_torch.core.critical_path import critical_time_by_function
from repro_torch.core.events import Kind, WorkerProfile
from repro_torch.summarize.base import SummarizeBackend, get_backend
from repro_torch.summarize.packing import pack_profile, resolve_kinds

BackendLike = Union[str, SummarizeBackend, None]


def _resolve_backend(backend: BackendLike,
                     device="cuda") -> SummarizeBackend:
    if backend is None or isinstance(backend, str):
        return get_backend(backend, device)
    return backend


def row_weights(u: np.ndarray, stats: np.ndarray, lengths: np.ndarray,
                rates) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-row ``(mean, std, weight)`` under the padding-independence
    conventions every summarization path must share float-exactly (the
    fleet==wire byte-identity invariant hangs on it): all-zero rows weigh
    their true (unpadded) window with zeroed moments, no row can outweigh
    its own window, and the weight is ``|L(e)|`` seconds (count / rate).
    ``rates`` may be a per-row array or a scalar."""
    mean, std, cnt = stats[:, 0], stats[:, 1], stats[:, 2]
    lengths = lengths.astype(np.float64)
    empty = u.sum(axis=1) <= 0.0
    cnt = np.where(empty, lengths, np.minimum(cnt, lengths))
    mean = np.where(empty, 0.0, mean)
    std = np.where(empty, 0.0, std)
    return mean, std, cnt / rates


def summarize_profile(profile: WorkerProfile,
                      kind_of: Optional[Dict[str, Kind]] = None,
                      backend: BackendLike = None,
                      ) -> Tuple[Dict[str, "Pattern"], Dict[str, Kind]]:
    """Per-function behavior patterns + resolved kinds for one worker.

    This is the one summarization entry point: kinds resolve once
    (``kind_of`` overrides beat event kinds) and steer both stream selection
    and the returned kind map the daemon uploads.
    """
    from repro_torch.core.patterns import Pattern   # late: patterns delegates here

    be = _resolve_backend(backend)
    kinds = resolve_kinds(profile, kind_of)
    t0, t1 = profile.window
    # degenerate (zero-width) windows: beta is 0/tiny = 0, matching the
    # fleet-batched path instead of dying on a ZeroDivisionError
    T = max(t1 - t0, np.finfo(float).tiny)
    beta = critical_time_by_function(profile.events, profile.window)

    # every function named by an event gets a pattern, even if all its
    # executions were dropped at pack time (missing stream / empty window)
    names = []
    index: Dict[str, int] = {}
    for e in profile.events:
        if e.name not in index:
            index[e.name] = len(names)
            names.append(e.name)
    F = len(names)
    num_mu = np.zeros((F,))
    num_sig = np.zeros((F,))
    den = np.zeros((F,))

    packed = pack_profile(profile, kind_of)
    if packed.n_events and packed.u.shape[1]:
        stats = np.asarray(be.batch_stats(packed.u), np.float64)
        mean, std, w = row_weights(packed.u, stats, packed.lengths,
                                   packed.rates)
        gid = np.asarray([index[nm] for nm in packed.names],
                         np.int64)[packed.fn_ids]
        num_mu = np.bincount(gid, weights=w * mean, minlength=F)
        num_sig = np.bincount(gid, weights=w * std, minlength=F)
        den = np.bincount(gid, weights=w, minlength=F)

    out: Dict[str, Pattern] = {}
    for j, nm in enumerate(names):
        mu = num_mu[j] / den[j] if den[j] else 0.0
        sigma = num_sig[j] / den[j] if den[j] else 0.0
        out[nm] = Pattern(beta=min(1.0, beta.get(nm, 0.0) / T),
                          mu=min(1.0, mu), sigma=min(1.0, sigma))
    return out, kinds
