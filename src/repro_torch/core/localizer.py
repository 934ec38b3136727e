"""Root-cause localization (paper §4.3).

Given aggregated behavior patterns {function -> (W, 3) array}, computes per
(f, w):
  D_{f,w}     — Manhattan distance to the expected box R_f (Eq. 6-7);
  Delta_{f,w} — differential distance: fraction of N (=100) sampled peers
                whose max-normalized pattern differs by >= delta (=0.4)
                Manhattan (Eq. 8-10);
and flags (f, w) abnormal iff
  beta > 0.01  AND  ( D > 0  OR  Delta > median(Delta) + k*MAD(Delta) ),
with k=5 (Eq. 11). Fully vectorized in numpy — scales to 1,000,000 workers
on one CPU core (benchmarks/localization_scaling.py reproduces Fig. 17c).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import channels
from repro_torch.core.events import Kind
from repro_torch.core.expectations import expected_box

BETA_MIN = 0.01
DELTA_THRESHOLD = 0.4
K_MAD = 5.0
N_PEERS = 100


@dataclass
class Abnormality:
    function: str
    workers: np.ndarray           # abnormal worker ids
    kind: Kind
    d_expect: np.ndarray          # D_{f,w} for those workers
    delta: np.ndarray             # Delta_{f,w}
    patterns: np.ndarray          # (n_abnormal, 3)
    typical: np.ndarray           # median pattern across fleet (3,)
    reason: str = ""              # 'expectation' | 'differential' | both
    channel: str = channels.PERF  # detector channel (a registered
    #                               repro_torch.core.channels name) — numerics
    #                               abnormalities are synthesized from the
    #                               numerics detector stream, not from
    #                               profile patterns (DESIGN.md §12a); serve
    #                               profiles are retagged 'slo' by the
    #                               pipeline (§13)

    def __post_init__(self):
        channels.validate_channel(self.channel)


class Localizer:
    def __init__(self, family: str = "dense", n_peers: int = N_PEERS,
                 delta_threshold: float = DELTA_THRESHOLD, k_mad: float = K_MAD,
                 seed: int = 0):
        self.family = family
        self.n_peers = n_peers
        self.delta_threshold = delta_threshold
        self.k_mad = k_mad
        self.seed = seed
        self.rng = np.random.default_rng(seed)   # kept for API compat

    def _fn_rng(self, function: str) -> np.random.Generator:
        """Peer sampling is seeded per function (base seed + name hash) so
        Delta_{f,w} never depends on dict iteration order or on how many
        functions were localized before this one."""
        return np.random.default_rng(
            (self.seed, zlib.crc32(function.encode("utf-8"))))

    def delta_distance(self, pats: np.ndarray, function: str = ""
                       ) -> np.ndarray:
        """Delta_{f,w} for one function. pats: (W, 3).

        Workers drawn into their own peer sample are masked out of the
        (W, n) distance matrix: a self-pair contributes a guaranteed-zero
        distance, deflating Delta_{f,w} by up to 1/n — Eq. 9-10 count
        disagreement with *other* workers."""
        W = pats.shape[0]
        mx = pats.max(axis=0)
        mx[mx <= 0] = 1.0
        norm = pats / mx                               # Eq. 8
        n = min(self.n_peers, W)
        peers = self._fn_rng(function).choice(W, size=n, replace=False)
        # (W, n) Manhattan distances
        d = np.abs(norm[:, None, :] - norm[peers][None, :, :]).sum(axis=2)
        not_self = peers[None, :] != np.arange(W)[:, None]
        hits = ((d >= self.delta_threshold) & not_self).sum(axis=1)
        return hits / np.maximum(not_self.sum(axis=1), 1)  # Eq. 9-10

    def localize(self, patterns: Dict[str, np.ndarray],
                 kinds: Dict[str, Kind],
                 present: Optional[np.ndarray] = None) -> List[Abnormality]:
        """Localize abnormal (function, worker) pairs.

        ``present`` (bool mask over the fleet's worker rows) restricts the
        statistics to workers whose patterns actually arrived — the wire
        transport's partial-window semantics (DESIGN.md §8).  Absent
        workers contribute no peers, no median, and can never be flagged;
        with fewer peers Delta_{f,w} quantizes coarser, so localization
        confidence degrades gracefully instead of the missing rows' zeros
        poisoning the fleet median.  Reported worker ids stay GLOBAL."""
        if present is not None:
            present = np.asarray(present, bool)
            idx_global = np.flatnonzero(present)
            if idx_global.size == present.size:
                present = None        # full fleet: identical to the default
        if present is None:
            return self._localize_full(patterns, kinds)
        sub = {name: np.asarray(p)[idx_global] for name, p in
               patterns.items()}
        out = self._localize_full(sub, kinds)
        for a in out:
            a.workers = idx_global[a.workers]
        return out

    def _localize_full(self, patterns: Dict[str, np.ndarray],
                       kinds: Dict[str, Kind]) -> List[Abnormality]:
        out: List[Abnormality] = []
        for name, pats in patterns.items():
            kind = kinds.get(name, Kind.PYTHON)
            W = pats.shape[0]
            beta = pats[:, 0]
            if beta.max() <= BETA_MIN:
                continue                                # Eq. 11 gate
            box = expected_box(kind, name, self.family)
            lo = np.array([b[0] for b in box])
            hi = np.array([b[1] for b in box])
            d_exp = (np.maximum(lo - pats, 0)
                     + np.maximum(pats - hi, 0)).sum(axis=1)
            delta = self.delta_distance(pats, function=name)
            med = np.median(delta)
            mad = np.median(np.abs(delta - med))
            thr = med + self.k_mad * mad
            differential = delta > thr
            if mad == 0:
                differential = delta > max(med, 0.5)
            abnormal = (beta > BETA_MIN) & ((d_exp > 0) | differential)
            if not abnormal.any():
                continue
            idx = np.where(abnormal)[0]
            reasons = []
            if (d_exp[idx] > 0).any():
                reasons.append("expectation")
            if differential[idx].any():
                reasons.append("differential")
            out.append(Abnormality(
                function=name, workers=idx, kind=kind,
                d_expect=d_exp[idx], delta=delta[idx],
                patterns=pats[idx],
                typical=np.median(pats, axis=0),
                reason="+".join(reasons)))
        out.sort(key=lambda a: -float(a.patterns[:, 0].max()))
        return out
