"""Fleet-batched summarization: one packed pass across all workers.

``summarize_and_upload`` runs Algorithm 1 per worker — W backend calls, W
msgpack round-trips, W transient pattern dicts — which is the right shape
when every worker's daemon summarizes on its own host and only ~KB payloads
cross the network (DESIGN.md §1).  When the whole fleet's raw profiles are
already in one process (simulation, replay, single-host scaling runs), that
per-worker loop is pure overhead: this module instead

  1. extracts every worker's events into one flat, worker-major table
     (one pass over ΣE events — the only per-event Python left);
  2. packs all executions into ragged ``(ΣE, n)`` batches grouped by stream
     rate (and length-bucketed inside a group to bound padding waste) with
     a single gather from the fleet's concatenated sample streams;
  3. runs the selected backend's ``batch_stats`` once per group;
  4. extracts every worker's critical path in one padded ``(W, E, S)``
     sweep (``repro_torch.core.critical_path``);
  5. scatter-reduces per ``(worker, function)`` straight into the
     ``PatternAggregator``'s columnar ``(W, F, 3)`` buffer — msgpack never
     runs.

The fast path is float-exact against the per-worker loop: backends are
padding-inert, every reduction accumulates sequentially in the same
(worker, event) order via ``bincount``, and moment sums use float64
accumulators (exact for float32 addends at these magnitudes), so diagnoses
are byte-identical between the two paths (tested).  The one documented
exception: a function whose executions land in *different* rate groups or
length buckets (events on differently-sampled or wildly different-duration
streams) accumulates per group first, which can differ from strict event
order in the last ulp.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.critical_path import batched_event_times
from repro_torch.core.events import Kind, RESOURCE_FOR_KIND, WorkerProfile
from repro_torch.summarize.aggregate import PatternAggregator
from repro_torch.summarize.base import SummarizeBackend

#: length-bucket upper bounds inside one rate group (geometric, x4): rows
#: pad to the smallest bucket holding them instead of the group max
_BUCKETS = (32, 128, 512, 2048, 8192, 32768)

_N_KINDS = len(RESOURCE_FOR_KIND)
_KIND_BY_VALUE = [Kind(k) for k in range(_N_KINDS)]


@dataclass
class FleetEvents:
    """Flat worker-major event table for a whole fleet (ΣE rows)."""
    worker: np.ndarray       # (ΣE,) int64 profile index
    starts: np.ndarray       # (ΣE,) float64 raw (unclipped) start
    ends: np.ndarray         # (ΣE,) float64
    kinds: np.ndarray        # (ΣE,) int8
    depth: np.ndarray        # (ΣE,) int16
    train: np.ndarray        # (ΣE,) bool (thread == 'train')
    fid: np.ndarray          # (ΣE,) int64 first-seen id within the worker
    counts: np.ndarray       # (W,) events per worker
    names_w: List[List[str]]           # per worker first-seen names
    windows: np.ndarray      # (W, 2) float64
    resource_fix: List[Tuple[int, str]]  # flat idx -> explicit resource

    @property
    def n_events(self) -> int:
        return int(self.worker.shape[0])


@dataclass
class RateGroup:
    """One ``batch_stats`` batch: rows of one rate and length bucket."""
    rate: float
    u: np.ndarray            # (R, n) float32 zero-padded
    lengths: np.ndarray      # (R,) int64 true sample counts
    rows: np.ndarray         # (R,) int64 index into the flat event table


@dataclass
class FleetBatch:
    """Everything ``summarize_fleet`` needs after the one packing pass."""
    events: FleetEvents
    groups: List[RateGroup]
    col: np.ndarray          # (ΣE,) int64 aggregator column per event
    cols_w: List[np.ndarray]  # per worker: local fid -> aggregator column
    agg: PatternAggregator
    base: int                # first aggregator row of this fleet
    rows: Optional[np.ndarray] = None  # explicit aggregator rows (partial
    #                                    fleets: profile i -> row rows[i])


@dataclass
class FleetSummary:
    """Result of one fleet-batched summarization pass."""
    agg: PatternAggregator
    n_rows: int              # ΣE executions batched across the fleet
    n_groups: int            # (rate, length-bucket) batches
    pattern_bytes: int       # serialized size had the patterns crossed the wire


def extract_events(profiles: Sequence[WorkerProfile]) -> FleetEvents:
    """One pass over every event of every worker into flat numpy columns."""
    W = len(profiles)
    counts = np.fromiter((len(p.events) for p in profiles), np.int64, W)
    total = int(counts.sum())
    all_ev = [e for p in profiles for e in p.events]
    starts = np.array([e.start for e in all_ev], np.float64)
    ends = np.array([e.end for e in all_ev], np.float64)
    kinds = np.array([int(e.kind) for e in all_ev], np.int8)
    depth = np.array([e.depth for e in all_ev], np.int16)
    train = np.array([e.thread == "train" for e in all_ev], bool)
    resource_fix = [(i, e.resource) for i, e in enumerate(all_ev)
                    if e.resource]

    fid_l: List[int] = []
    names_w: List[List[str]] = []
    for p in profiles:
        index: Dict[str, int] = {}
        fid_l += [index.setdefault(e.name, len(index)) for e in p.events]
        names_w.append(list(index))
    fid = np.array(fid_l, np.int64) if total else np.zeros(0, np.int64)
    windows = np.array([p.window for p in profiles], np.float64) \
        if W else np.zeros((0, 2))
    return FleetEvents(
        worker=np.repeat(np.arange(W, dtype=np.int64), counts),
        starts=starts, ends=ends, kinds=kinds, depth=depth, train=train,
        fid=fid, counts=counts, names_w=names_w, windows=windows,
        resource_fix=resource_fix)


def _route_rows(profiles: Sequence[WorkerProfile], ev: FleetEvents,
                kind_of: Optional[Dict[str, Kind]]
                ) -> Tuple[np.ndarray, ...]:
    """Resolve each execution to its stream and sample range.

    Returns flat ``(offset, length, rate, valid)`` arrays — ``offset``
    indexes the fleet-wide concatenation of all sample streams — plus that
    concatenation itself.  Routing precedence matches ``pack_profile``:
    explicit ``resource`` field, else ``kind_of`` override, else the
    event's own kind.
    """
    W = len(profiles)
    resources = [RESOURCE_FOR_KIND[Kind(k)] for k in range(_N_KINDS)]
    # per (worker, kind): the stream a kind-routed event reads — built as
    # flat scalar lists (cheaper than W x K numpy item assignments)
    m_rate: List[float] = []
    m_len: List[int] = []
    m_t0: List[float] = []
    m_base: List[int] = []
    m_ok: List[bool] = []
    chunks: List[np.ndarray] = []
    base = 0
    bases: List[Dict[str, Tuple[int, float, int, float]]] = []
    for p in profiles:
        by_name: Dict[str, Tuple[int, float, int, float]] = {}
        for name, st in p.streams.items():
            by_name[name] = (base, st.rate_hz, len(st.values), st.t0)
            v = np.asarray(st.values)
            chunks.append(v)
            base += len(v)
        bases.append(by_name)
        for sname in resources:
            meta = by_name.get(sname)
            if meta is None:
                m_base.append(0)
                m_rate.append(1.0)
                m_len.append(0)
                m_t0.append(0.0)
                m_ok.append(False)
            else:
                b, r, n, t0 = meta
                m_base.append(b)
                m_rate.append(r)
                m_len.append(n)
                m_t0.append(t0)
                m_ok.append(True)
    s_rate = np.array(m_rate).reshape(W, _N_KINDS)
    s_len = np.array(m_len, np.int64).reshape(W, _N_KINDS)
    s_t0 = np.array(m_t0).reshape(W, _N_KINDS)
    s_base = np.array(m_base, np.int64).reshape(W, _N_KINDS)
    s_ok = np.array(m_ok, bool).reshape(W, _N_KINDS)
    flat = np.concatenate(chunks) if chunks else np.zeros(0)
    if flat.dtype != np.float32:   # one fleet-wide cast (f64->f32 is the
        flat = flat.astype(np.float32)   # same rounding rows get per-worker)

    route = ev.kinds.astype(np.int64)
    if kind_of:
        off = 0
        for w in range(W):
            E = int(ev.counts[w])
            over = np.fromiter(
                (int(kind_of.get(nm, -1)) for nm in ev.names_w[w]),
                np.int64, len(ev.names_w[w]))
            if (over >= 0).any():
                o = over[ev.fid[off:off + E]]
                sl = route[off:off + E]
                route[off:off + E] = np.where(o >= 0, o, sl)
            off += E
    wk = ev.worker
    rate = s_rate[wk, route]
    n_len = s_len[wk, route]
    t0 = s_t0[wk, route]
    offset0 = s_base[wk, route]
    ok = s_ok[wk, route]
    for i, rname in ev.resource_fix:       # explicit resource field wins
        meta = bases[int(wk[i])].get(rname)
        if meta is None:
            ok[i] = False
        else:
            offset0[i], rate[i], n_len[i], t0[i] = meta
            ok[i] = True

    # SampleStream.window semantics, vectorized: i0 = max(0, int(...)),
    # i1 = min(len, int(ceil(...))) — int() truncates toward zero
    i0 = np.maximum(0, np.trunc((ev.starts - t0) * rate).astype(np.int64))
    i1 = np.minimum(n_len,
                    np.ceil((ev.ends - t0) * rate).astype(np.int64))
    lengths = np.maximum(0, i1 - i0)
    valid = ok & (lengths > 0)
    return offset0 + i0, lengths, rate, valid, flat


def pack_fleet(profiles: Sequence[WorkerProfile],
               kind_of: Optional[Dict[str, Kind]] = None,
               agg: Optional[PatternAggregator] = None,
               workers: Optional[Sequence[int]] = None,
               fleet_size: Optional[int] = None) -> FleetBatch:
    """Pack all W workers into per-(rate, length-bucket) ragged batches and
    intern every function into ``agg``'s columns (worker order, so
    first-seen kinds match the streaming upload path).

    ``workers``/``fleet_size`` is the partial-fleet path (wire transport,
    DESIGN.md §8): ``profiles`` covers only the workers whose windows
    arrived, ``workers[i]`` is profile i's GLOBAL worker id, and the
    aggregator reserves the full ``fleet_size`` rows — absent workers keep
    zero rows instead of renumbering the fleet."""
    W = len(profiles)
    rows: Optional[np.ndarray] = None
    if workers is not None:
        rows = np.asarray(list(workers), np.int64)
        if rows.shape != (W,):
            raise ValueError(f"workers {rows.shape} must map each of the "
                             f"{W} profiles to its fleet row")
        n_rows = int(fleet_size if fleet_size is not None
                     else (rows.max() + 1 if W else 0))
        if W and not (0 <= int(rows.min())
                      and int(rows.max()) < n_rows):
            raise ValueError(
                f"worker ids [{int(rows.min())}, {int(rows.max())}] "
                f"outside fleet [0, {n_rows}) — negative ids would "
                "silently wrap into another worker's row")
    else:
        n_rows = W
    if agg is None:
        agg = PatternAggregator(expected_workers=max(1, n_rows))
    base = agg.reserve_workers(n_rows)
    if rows is not None:
        rows = base + rows
    ev = extract_events(profiles)

    # resolve_kinds semantics without a per-event pass: one reversed flat
    # assignment leaves each function's FIRST event kind in place
    n_names = np.fromiter((len(n) for n in ev.names_w), np.int64, W)
    name_off = np.concatenate([[0], np.cumsum(n_names)])
    gidx = (ev.fid + name_off[ev.worker]) if ev.n_events \
        else np.zeros(0, np.int64)
    kfirst = np.zeros(int(name_off[-1]), np.int8)
    kfirst[gidx[::-1]] = ev.kinds[::-1]
    kof = kind_of or {}
    kfirst_l = kfirst.tolist()
    off_l = name_off.tolist()
    cols_flat = np.array(
        [agg.intern(nm, kof[nm] if nm in kof
                    else _KIND_BY_VALUE[kfirst_l[off_l[w] + j]])
         for w, names in enumerate(ev.names_w)
         for j, nm in enumerate(names)], np.int64)
    col = cols_flat[gidx] if ev.n_events else gidx
    cols_w = [cols_flat[name_off[w]:name_off[w + 1]] for w in range(W)]

    offsets, lengths, rates, valid, flat = _route_rows(profiles, ev, kind_of)
    groups: List[RateGroup] = []
    vrows = np.flatnonzero(valid)
    if vrows.size:
        for rate in np.unique(rates[vrows]):
            in_rate = vrows[rates[vrows] == rate]
            glen = lengths[in_rate]
            g_max = int(glen.max())
            caps = [c for c in _BUCKETS if c < g_max] + [g_max]
            lo = 0
            for cap in caps:
                sel = in_rate[(glen > lo) & (glen <= cap)]
                if sel.size == 0:
                    lo = cap
                    continue
                n_b = int(lengths[sel].max())
                ar = np.arange(n_b, dtype=np.int64)
                mask = ar[None, :] < lengths[sel, None]
                idx = (offsets[sel, None] + ar[None, :]) * mask
                u = np.where(mask, flat[idx], np.float32(0.0))
                groups.append(RateGroup(rate=float(rate), u=u,
                                        lengths=lengths[sel], rows=sel))
                lo = cap
    return FleetBatch(events=ev, groups=groups, col=col, cols_w=cols_w,
                      agg=agg, base=base, rows=rows)


def summarize_fleet(profiles: Sequence[WorkerProfile],
                    kind_of: Optional[Dict[str, Kind]] = None,
                    backend=None,
                    agg: Optional[PatternAggregator] = None,
                    workers: Optional[Sequence[int]] = None,
                    fleet_size: Optional[int] = None) -> FleetSummary:
    """The fleet-batched equivalent of W ``summarize_and_upload`` calls.

    Returns a ``FleetSummary`` whose aggregator holds the same ``(W, F, 3)``
    pattern block the streaming upload path would have produced, without
    serializing anything.  ``workers``/``fleet_size`` place a PARTIAL
    fleet's profiles at their global rows (see ``pack_fleet``) so a wire
    window with missing workers aggregates without renumbering.
    """
    from repro_torch.summarize.engine import _resolve_backend, row_weights
    be: SummarizeBackend = _resolve_backend(backend)
    W = len(profiles)
    fb = pack_fleet(profiles, kind_of, agg, workers=workers,
                    fleet_size=fleet_size)
    ev, agg, base = fb.events, fb.agg, fb.base
    F = agg.n_functions
    if W == 0 or F == 0:
        return FleetSummary(agg=agg, n_rows=0, n_groups=0, pattern_bytes=0)

    # -- one batch_stats per group, scatter-reduced over (w, f) bins -------
    num_mu = np.zeros(W * F)
    num_sig = np.zeros(W * F)
    den = np.zeros(W * F)
    n_rows = 0
    for g in fb.groups:
        n_rows += g.u.shape[0]
        stats = np.asarray(be.batch_stats(g.u), np.float64)
        mean, std, wgt = row_weights(g.u, stats, g.lengths, g.rate)
        bins = ev.worker[g.rows] * F + fb.col[g.rows]
        num_mu += np.bincount(bins, weights=wgt * mean, minlength=W * F)
        num_sig += np.bincount(bins, weights=wgt * std, minlength=W * F)
        den += np.bincount(bins, weights=wgt, minlength=W * F)

    den = den.reshape(W, F)
    mu = np.divide(num_mu.reshape(W, F), den,
                   out=np.zeros((W, F)), where=den != 0)
    sig = np.divide(num_sig.reshape(W, F), den,
                    out=np.zeros((W, F)), where=den != 0)
    np.minimum(mu, 1.0, out=mu)
    np.minimum(sig, 1.0, out=sig)

    # -- beta: the whole fleet's critical paths in one padded sweep --------
    eligible = (ev.kinds != int(Kind.PYTHON)) | ev.train
    times = batched_event_times(ev.starts, ev.ends, ev.kinds, ev.depth,
                                eligible, ev.worker, ev.counts, ev.windows)
    T = ev.windows[:, 1] - ev.windows[:, 0]
    beta = np.bincount(ev.worker * F + fb.col, weights=times,
                       minlength=W * F).reshape(W, F)
    beta /= np.maximum(T, np.finfo(float).tiny)[:, None]
    np.minimum(beta, 1.0, out=beta)

    pattern_bytes = _wire_payload_bytes(ev.names_w)
    block = np.stack([beta, mu, sig], axis=2)
    if fb.rows is not None:
        agg.scatter_rows(fb.rows, block)
    else:
        agg.scatter_block(base, block)
    return FleetSummary(agg=agg, n_rows=n_rows, n_groups=len(fb.groups),
                        pattern_bytes=pattern_bytes)


def _wire_payload_bytes(names_w: List[List[str]]) -> int:
    """Exact size of the msgpack uploads the wire path would have sent:
    per worker a map of {name: (float64 beta, mu, sigma, fixint kind)} —
    fixarray(4) + 3 x (0xcb + 8) + 1 = 29 value bytes per function."""
    total = 0
    for names in names_w:
        n = len(names)
        total += 1 if n < 16 else (3 if n < 65536 else 5)   # map header
        for nm in names:
            ln = len(nm.encode())
            total += ln + (1 if ln < 32 else (2 if ln < 256 else 3))
            total += 29
    return total
