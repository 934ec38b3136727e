"""Fleet simulator: synthesizes per-worker event timelines + 10 kHz-class
resource sample streams for an LMT job, with fault injection (repro of the
paper's §3 / §6 cases; the paper itself uses simulated patterns for its
1M-GPU scaling result, Fig. 17c).

Two modes:
  * raw mode  — full WorkerProfile (events + sample streams) for small
    fleets; exercised end-to-end through critical-path + Algorithm 1;
  * pattern mode — direct (W, 3) pattern synthesis for 100k-1M-worker
    scaling benchmarks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.events import FunctionEvent, Kind, SampleStream, WorkerProfile
from repro_torch.core import faults as F
from repro_torch.core.ring import RingConfig, ring_utilization

DATALOADER_STACK = ("train.py:train_loop/dataloader.py:__next__/"
                    "socket.py:recv_into")
FORWARD_STACK = "train.py:train_loop/model.py:forward"
GC_STACK = "train.py:train_loop/gradmode.py:__init__"
GEMM = "CUDA_GEMM_kernel"
ALLREDUCE = "AllReduce_RING"
ALLGATHER = "AllGather_RING"
H2D = "memcpy_h2d"
OPT_STACK = "train.py:train_loop/optimizer.py:step"

# serve-mode canonical names (DESIGN.md §13): one continuous-batched decode
# iteration = dequeue wait -> decode GEMMs -> KV block fetch -> token sync
SERVE_QUEUE_STACK = ("serve.py:serve_loop/scheduler.py:dequeue_wait")
DECODE_GEMM = "CUDA_DECODE_GEMM_kernel"
KV_FETCH = "kv_cache.py:read_block"
TOKEN_SYNC = "AllGather_TOKEN"


@dataclass
class SimConfig:
    n_workers: int = 32
    iteration_s: float = 1.0
    n_fwd_gemms: int = 6
    n_bwd_gemms: int = 6
    rate_hz: float = 2000.0
    window_s: float = 2.0
    dp_group_size: int = 16
    seed: int = 0
    family: str = "dense"
    #: cold-spare hosts (ids n_workers..n_workers+n_standby-1) that start
    #: inactive and join the fleet when ``replace_hosts`` re-meshes onto
    #: them (DESIGN.md §9)
    n_standby: int = 0
    #: 'train' (the historical behavior, byte-identical) or 'serve': a
    #: continuous-batched inference fleet whose anchors are request
    #: dequeue/complete pairs, whose profiles paint the serve iteration,
    #: and whose job-level sample stream is ``slo_window`` (DESIGN.md §13)
    workload: str = "train"


class FleetSimulator:
    def __init__(self, cfg: SimConfig, faults: Sequence[F.Fault] = ()):
        self.cfg = cfg
        self.faults = list(faults)
        self.rng = np.random.default_rng(cfg.seed)
        #: end of the last anchor_events span (continuous-timeline cursor)
        self.anchor_clock = 0.0
        #: workers currently in the training mesh; standbys start outside
        self.active = list(range(cfg.n_workers))
        self.standbys = list(range(cfg.n_workers,
                                   cfg.n_workers + cfg.n_standby))

    # -- fleet membership (elastic re-mesh, DESIGN.md §9) ------------------
    @property
    def total_workers(self) -> int:
        """Fleet row space: in-mesh workers + cold standbys."""
        return self.cfg.n_workers + self.cfg.n_standby

    @property
    def active_workers(self) -> List[int]:
        return list(self.active)

    def replace_hosts(self, workers: Sequence[int]
                      ) -> Dict[int, Optional[int]]:
        """Drop the given workers from the mesh and re-mesh elastically:
        each dropped worker is replaced by the next standby (None when the
        standby pool is exhausted — the fleet simply shrinks).  Returns
        {dropped worker -> replacement id or None}.  Dropped workers stop
        producing profiles; downstream, the present-mask machinery
        (DESIGN.md §8) carries diagnosis on the partial fleet."""
        mapping: Dict[int, Optional[int]] = {}
        for w in sorted({int(x) for x in workers}):
            if w not in self.active:
                continue
            self.active.remove(w)
            repl = self.standbys.pop(0) if self.standbys else None
            if repl is not None:
                self.active.append(repl)
            mapping[w] = repl
        self.active.sort()
        return mapping

    # -- helpers ----------------------------------------------------------
    def _fault(self, kind):
        return [f for f in self.faults if isinstance(f, kind)]

    def iteration_multiplier(self) -> float:
        """Job-level slowdown factor from active faults (all workers are
        gated by collectives, so the slowest worker sets the pace).  A
        fault pinned to workers that all left the mesh no longer gates
        anything."""
        m = 1.0
        in_mesh = set(self.active)
        for f in self.faults:
            pinned = F.affected_workers(f)
            if pinned is not None and not (pinned & in_mesh):
                continue
            if isinstance(f, F.GpuThrottle):
                m = max(m, 1 + 0.45 * (f.slowdown - 1))
            elif isinstance(f, F.NvlinkDown):
                m = max(m, 1 + 0.25 * (f.slowdown - 1))
            elif isinstance(f, F.RingSlowLink):
                m = max(m, 1 + 0.35 * (1 / f.rho - 1))
            elif isinstance(f, F.SlowDataloader):
                m = max(m, 1 + 0.005 * f.slowdown)
            elif isinstance(f, F.CpuBoundForward):
                m = max(m, 1 + 0.1 * f.slowdown)
            elif isinstance(f, F.AsyncGc):
                m = max(m, 1 + f.probability * f.pause_s
                        / self.cfg.iteration_s)
            elif isinstance(f, F.CgroupCpuThrottle):
                m = max(m, 1 + 0.012 * f.slowdown)
            elif isinstance(f, F.PageCacheThrash):
                m = max(m, 1 + 0.005 * f.slowdown)
            elif isinstance(f, F.DriverMismatch):
                m = max(m, 1 + 0.45 * (f.slowdown - 1))
            elif isinstance(f, F.DegradedNic):
                m = max(m, 1 + 0.35 * (1 / f.rho - 1))
            elif isinstance(f, F.ArrivalBurst):
                m = max(m, 1 + 0.005 * f.queue_mult)
            elif isinstance(f, F.KvCacheThrash):
                m = max(m, 1 + 0.08 * f.slowdown)
            # numerics faults (LossSpike / GradExplosion) are deliberately
            # absent: they never slow an iteration (DESIGN.md §12a)
        return m

    # -- anchor event stream (feeds the §4.1 detector) --------------------
    def anchor_events(self, n_iters: int, degrade_after: Optional[int] = None,
                      t0: float = 0.0) -> List[Tuple[str, float]]:
        """(name, t) stream of dataloader.next / optimizer.step anchors
        starting at ``t0``.  Faults kick in after iteration ``degrade_after``
        (None = from the first iteration).  The end of the generated span is
        left in ``self.anchor_clock`` so a scenario runner can chain calls
        into one continuous timeline (fault sets may change between calls)."""
        out = []
        t = t0
        mult = self.iteration_multiplier()
        # serve mode: the anchor pair is a request's dequeue->completion —
        # same cadence and draw count, so injecting a serve fault can never
        # shift any other stream.  (The iteration detector never locks on
        # these names; serve detection rides the SLO channel instead.)
        first, second = (("request.dequeue", "request.complete")
                         if self.cfg.workload == "serve"
                         else ("dataloader.next", "optimizer.step"))
        for i in range(n_iters):
            m = mult if degrade_after is None or i >= degrade_after else 1.0
            dur = self.cfg.iteration_s * m \
                * (1 + 0.01 * self.rng.standard_normal())
            out.append((first, t))
            out.append((second, t + dur * 0.97))
            t += dur
        self.anchor_clock = t
        return out

    # -- raw profiling window ---------------------------------------------
    def _ring_by_rate(self, rates: Optional[np.ndarray],
                      seed: Optional[int]) -> Dict[float, np.ndarray]:
        """Ring-collective traces per distinct sample rate.

        With a per-window ``seed`` the draw is seeded from it — NOT from
        the simulator's own rng — so the traces are a pure function of
        (seed, rates): every worker process of a multi-process run
        (DESIGN.md §8) reproduces the same ring, regardless of how many
        anchor draws its local simulator has made.  ``seed=None`` keeps
        the historical shared-rng behavior byte-identical."""
        cfg = self.cfg
        ring_fault = self._fault(F.RingSlowLink)
        if not ring_fault:
            return {}
        rf = ring_fault[0]
        rng = self.rng if seed is None \
            else np.random.default_rng((seed, 1 << 20))
        distinct = [cfg.rate_hz] if rates is None else \
            sorted({float(r) for r in rates})
        return {r: ring_utilization(
            RingConfig(n_workers=cfg.n_workers), cfg.window_s,
            r, slow_worker=rf.slow_worker, rho=rf.rho, rng=rng)
            for r in distinct}

    def profile_window(self, rates: Optional[Sequence[float]] = None,
                       seed: Optional[int] = None) -> List[WorkerProfile]:
        """One fleet of raw profiling windows — the ACTIVE fleet.

        Until ``replace_hosts`` runs, the active fleet is workers
        ``0..n_workers-1`` (byte-identical to the historical behavior);
        after a re-mesh, dropped workers stop profiling and activated
        standbys start.  ``rates`` (per-worker sample rates in Hz, length
        ``total_workers``) is the differential-escalation knob
        (DESIGN.md §7): workers may be sampled at different rates, and
        ``summarize_fleet``'s rate grouping batches them without
        re-padding.  ``seed`` varies the per-worker noise draw window to
        window (None keeps the config seed — byte-identical to the
        historical single-window behavior)."""
        return self.profile_window_slice(self.active_workers,
                                         rates=rates, seed=seed)

    def profile_window_slice(self, workers: Sequence[int],
                             rates: Optional[Sequence[float]] = None,
                             seed: Optional[int] = None
                             ) -> List[WorkerProfile]:
        """Raw profiling windows for a SLICE of the fleet.

        The per-worker noise is already seeded by (seed, worker), so a
        worker process materializing only its own workers produces
        bit-identical profiles to the full-fleet call — this is what each
        daemon process of ``ScenarioRunner.run_multiprocess`` runs over
        its share of the fleet.  ``rates`` stays FULL-fleet-shaped (the
        escalation decision is global); each worker reads its own entry."""
        cfg = self.cfg
        total = self.total_workers
        if rates is not None:
            rates = np.asarray(rates, np.float64)
            if rates.shape != (total,):
                raise ValueError(
                    f"rates must have shape ({total},), "
                    f"got {rates.shape}")
        ring_by_rate = self._ring_by_rate(rates, seed)
        profiles = []
        for w in workers:
            w = int(w)
            if not 0 <= w < total:
                raise ValueError(f"worker {w} outside fleet "
                                 f"[0, {total})")
            r = cfg.rate_hz if rates is None else float(rates[w])
            profiles.append(self._worker_profile(
                w, ring_by_rate.get(r), rate_hz=r, seed=seed))
        return profiles

    def _worker_profile(self, w: int, ring_traces,
                        rate_hz: Optional[float] = None,
                        seed: Optional[int] = None) -> WorkerProfile:
        cfg = self.cfg
        rate = cfg.rate_hz if rate_hz is None else float(rate_hz)
        rng = np.random.default_rng(
            (cfg.seed if seed is None else seed, w))
        if cfg.workload == "serve":
            return self._serve_worker_profile(w, rate, rng)
        n = int(cfg.window_s * rate)
        streams = {
            "gpu_sm": np.zeros(n),
            "cpu": np.zeros(n),
            "pcie_tx": np.zeros(n),
            "membw": np.zeros(n),
        }
        events: List[FunctionEvent] = []

        throttle = next((f for f in self._fault(F.GpuThrottle)
                         if w in f.workers), None)
        nvlink = self._fault(F.NvlinkDown)
        nv_self = any(w in f.workers for f in nvlink)
        nv_group = any((w // f.group_size) in {x // f.group_size
                                               for x in f.workers}
                       for f in nvlink)
        dl = self._fault(F.SlowDataloader)
        cpufwd = next((f for f in self._fault(F.CpuBoundForward)
                       if not f.workers or w in f.workers), None)
        gc = self._fault(F.AsyncGc)
        cgroup = next((f for f in self._fault(F.CgroupCpuThrottle)
                       if w in f.workers), None)
        thrash = next((f for f in self._fault(F.PageCacheThrash)
                       if not f.workers or w in f.workers), None)
        driver = next((f for f in self._fault(F.DriverMismatch)
                       if w in f.workers), None)
        # a degraded NIC manifests on the bad host itself (its recv stalls);
        # DP-group peers wait at the NEXT barrier, which is job-level
        # (iteration_multiplier) rather than a profile signature
        degnic = next((f for f in self._fault(F.DegradedNic)
                       if w in f.workers), None)

        def paint(stream: str, t0: float, t1: float, level: float,
                  jitter: float = 0.03):
            i0, i1 = int(t0 * rate), int(t1 * rate)
            i0, i1 = max(0, i0), min(n, i1)
            if i1 > i0:
                streams[stream][i0:i1] = np.clip(
                    level + rng.normal(0, jitter, i1 - i0), 0, 1)

        t = 0.0
        iter_s = cfg.iteration_s
        while t < cfg.window_s:
            # 1) dataloader
            dl_mult = (dl[0].slowdown if dl
                       else (thrash.slowdown if thrash else 1.0))
            d = 0.005 * iter_s * dl_mult
            events.append(FunctionEvent(DATALOADER_STACK, Kind.PYTHON,
                                        t, t + d, w, depth=3))
            if thrash:
                # page-cache thrash: long reads spent WAITING on disk —
                # low CPU, bursty (DESIGN.md §12b)
                paint("cpu", t, t + d, 0.15, jitter=0.18)
            else:
                paint("cpu", t, t + d, 0.35 if dl else 0.5)
            t += d
            # 2) forward: python wrapper + GEMMs (+ h2d)
            fwd_mult = (cpufwd.slowdown if cpufwd else 1.0)
            if cgroup:
                fwd_mult *= cgroup.slowdown
            fwd_py = 0.004 * iter_s * fwd_mult
            events.append(FunctionEvent(FORWARD_STACK, Kind.PYTHON,
                                        t, t + fwd_py, w, depth=2))
            if cgroup:
                # cgroup quota: utilization CLAMPED FLAT at the ceiling —
                # the scheduler enforces it exactly (near-zero jitter)
                paint("cpu", t, t + fwd_py, cgroup.quota, jitter=0.005)
            else:
                paint("cpu", t, t + fwd_py, 0.9 if cpufwd else 0.4)
            t += fwd_py
            gpu_slow = (throttle.slowdown if throttle
                        else (driver.slowdown if driver else 1.0))
            gpu_util = (throttle.util if throttle
                        else (driver.util if driver else 0.92))
            # driver/kernel mismatch: the mis-tuned stack picks varying
            # kernels, so SM utilization is ERRATIC (high sigma) at a
            # moderate mean — vs a throttled clock's stable low mean
            gpu_jit = 0.10 if (driver and not throttle) else 0.03
            g = 0.33 * iter_s / cfg.n_fwd_gemms
            for _ in range(cfg.n_fwd_gemms):
                gd = g * gpu_slow
                events.append(FunctionEvent(GEMM, Kind.GPU, t, t + gd, w))
                paint("gpu_sm", t, t + gd, gpu_util, jitter=gpu_jit)
                t += gd
            # 3) h2d memcpy
            md = 0.01 * iter_s
            events.append(FunctionEvent(H2D, Kind.MEM, t, t + md, w))
            paint("membw", t, t + md, 0.7)
            t += md
            # 4) backward GEMMs
            for _ in range(cfg.n_bwd_gemms):
                gd = g * gpu_slow
                events.append(FunctionEvent(GEMM, Kind.GPU, t, t + gd, w))
                paint("gpu_sm", t, t + gd, gpu_util, jitter=gpu_jit)
                t += gd
            # 5) collectives (AllGather + AllReduce)
            cd = 0.1 * iter_s
            if nv_group:
                cd *= nvlink[0].slowdown
            if degnic:
                cd *= 1.0 / degnic.rho
            if ring_traces is not None:
                cd *= 1.0 / self._fault(F.RingSlowLink)[0].rho * 0.8
            events.append(FunctionEvent(ALLGATHER, Kind.COMM, t, t + cd, w))
            if ring_traces is not None and w < ring_traces.shape[0]:
                i0, i1 = int(t * rate), min(n, int((t + cd) * rate))
                seg = ring_traces[w][i0:i1]
                streams["pcie_tx"][i0:i0 + len(seg)] = seg
            elif ring_traces is not None:
                # standby joined a ring that still has the slow bond: it
                # bursts like any non-driving member (§3 Fig. 5b)
                paint("pcie_tx", t, t + cd,
                      self._fault(F.RingSlowLink)[0].rho, jitter=0.15)
            elif degnic:
                # degraded NIC: collectives crawl at low, STABLE link
                # utilization while the fleet is healthy (DESIGN.md §12c)
                paint("pcie_tx", t, t + cd, 0.18, jitter=0.01)
            else:
                paint("pcie_tx", t, t + cd,
                      0.85 if nv_self else (0.35 if nv_group else 0.55))
            t += cd
            # 6) async GC pause (random python frame, low CPU)
            if gc and rng.random() < gc[0].probability:
                gd = gc[0].pause_s
                events.append(FunctionEvent(GC_STACK, Kind.PYTHON,
                                            t, t + gd, w, depth=2))
                paint("cpu", t, t + gd, 0.08)
                t += gd
            # 7) optimizer.step
            od = 0.004 * iter_s
            events.append(FunctionEvent(OPT_STACK, Kind.PYTHON, t, t + od,
                                        w, depth=2))
            paint("cpu", t, t + od, 0.6)
            t += od

        t0 = 0.0
        return WorkerProfile(
            worker=w, window=(t0, self.cfg.window_s),
            events=[e for e in events if e.start < self.cfg.window_s],
            streams={k: SampleStream(rate, 0.0, v)
                     for k, v in streams.items()})

    # -- serve-mode profile (DESIGN.md §13) --------------------------------
    def _serve_worker_profile(self, w: int, rate: float,
                              rng: np.random.Generator) -> WorkerProfile:
        """One serving worker's raw window: a continuous-batched decode
        iteration painted per the serve fault signatures.

          1. dequeue wait  (PYTHON, low idle CPU; an ``ArrivalBurst``
             stretches it fleet-wide — queue buildup);
          2. decode GEMMs  (GPU; a pinned ``GpuThrottle`` stretches them at
             low SM util — the hot-worker-slow-decode case);
          3. KV block fetch (MEM; ``KvCacheThrash`` stretches it fleet-wide
             at saturated memory bandwidth);
          4. token sync    (COMM; a pinned ``DegradedNic`` collapses it to
             rho at low, stable link utilization).

        Healthy betas sit inside the dense-family expectation boxes, so a
        healthy serving fleet localizes nothing — the same property the
        train iteration has."""
        cfg = self.cfg
        n = int(cfg.window_s * rate)
        streams = {
            "gpu_sm": np.zeros(n),
            "cpu": np.zeros(n),
            "pcie_tx": np.zeros(n),
            "membw": np.zeros(n),
        }
        events: List[FunctionEvent] = []

        burst = self._fault(F.ArrivalBurst)
        kv = self._fault(F.KvCacheThrash)
        throttle = next((f for f in self._fault(F.GpuThrottle)
                         if w in f.workers), None)
        degnic = next((f for f in self._fault(F.DegradedNic)
                       if w in f.workers), None)

        def paint(stream: str, t0: float, t1: float, level: float,
                  jitter: float = 0.03):
            i0, i1 = int(t0 * rate), int(t1 * rate)
            i0, i1 = max(0, i0), min(n, i1)
            if i1 > i0:
                streams[stream][i0:i1] = np.clip(
                    level + rng.normal(0, jitter, i1 - i0), 0, 1)

        t = 0.0
        iter_s = cfg.iteration_s
        n_gemms = cfg.n_fwd_gemms
        while t < cfg.window_s:
            # 1) dequeue wait: idle scheduler spin, low CPU either way —
            # a burst makes it LONG, not busy
            qd = 0.005 * iter_s * (burst[0].queue_mult if burst else 1.0)
            events.append(FunctionEvent(SERVE_QUEUE_STACK, Kind.PYTHON,
                                        t, t + qd, w, depth=3))
            paint("cpu", t, t + qd, 0.12)
            t += qd
            # 2) decode GEMMs (continuous-batched step)
            gpu_slow = throttle.slowdown if throttle else 1.0
            gpu_util = throttle.util if throttle else 0.92
            g = 0.45 * iter_s / n_gemms
            for _ in range(n_gemms):
                gd = g * gpu_slow
                events.append(FunctionEvent(DECODE_GEMM, Kind.GPU,
                                            t, t + gd, w))
                paint("gpu_sm", t, t + gd, gpu_util)
                t += gd
            # 3) KV block fetch
            md = 0.08 * iter_s * (kv[0].slowdown if kv else 1.0)
            events.append(FunctionEvent(KV_FETCH, Kind.MEM, t, t + md, w))
            if kv:
                # working set blew past device memory: fetch path saturated
                # and BURSTY
                paint("membw", t, t + md, 0.95, jitter=0.1)
            else:
                paint("membw", t, t + md, 0.7)
            t += md
            # 4) token sync collective
            cd = 0.1 * iter_s
            if degnic:
                cd *= 1.0 / degnic.rho
            events.append(FunctionEvent(TOKEN_SYNC, Kind.COMM,
                                        t, t + cd, w))
            if degnic:
                # degraded NIC: low, STABLE link utilization (§12c)
                paint("pcie_tx", t, t + cd, 0.18, jitter=0.01)
            else:
                paint("pcie_tx", t, t + cd, 0.55)
            t += cd

        return WorkerProfile(
            worker=w, window=(0.0, cfg.window_s),
            events=[e for e in events if e.start < cfg.window_s],
            streams={k: SampleStream(rate, 0.0, v)
                     for k, v in streams.items()})

    # -- numerics channel (DESIGN.md §12a) ---------------------------------
    def numerics_window(self, n_iters: int, seed: int, t0: float,
                        t1: float) -> List[Tuple[float, float, float]]:
        """One window of job-level (t, loss, grad_norm) samples.

        Seeded from ``(seed, 1 << 21)`` (the ring traces own ``1 << 20``)
        with exactly two draws per iteration REGARDLESS of active faults,
        so the stream is a pure function of (seed, n_iters): every worker
        process reproduces it, ``self.rng`` is never touched, and injecting
        or curing a numerics fault cannot shift any other stream — the six
        original faults stay byte-identical.
        """
        rng = np.random.default_rng((seed, 1 << 21))
        spike = self._fault(F.LossSpike)
        grad = self._fault(F.GradExplosion)
        samples: List[Tuple[float, float, float]] = []
        for i in range(n_iters):
            t = t0 + (i + 1) * (t1 - t0) / max(1, n_iters)
            loss = 2.5 * (1 + 0.01 * rng.standard_normal())
            g = 1.0 * (1 + 0.02 * rng.standard_normal())
            if spike:
                loss *= spike[0].magnitude
            if grad:
                g = float("nan") if grad[0].nan else g * grad[0].magnitude
            samples.append((float(t), float(loss), float(g)))
        return samples

    # -- serving latency-SLO channel (DESIGN.md §13) -----------------------
    def slo_window(self, n_iters: int, seed: int, t0: float,
                   t1: float) -> List[Tuple[float, float, float]]:
        """One window of job-level (t, p99_ttft, p99_tbt) samples.

        Seeded from ``(seed, 1 << 22)`` (ring traces own ``1 << 20``, the
        numerics lane ``1 << 21``) with exactly two draws per sample
        REGARDLESS of active faults, so the stream is a pure function of
        (seed, n_iters) and injecting or curing a serve fault cannot shift
        any other stream.

        Fault effects mirror how serving latency actually degrades: a
        queue backlog explodes TTFT (requests wait to be admitted), while
        hot decode / KV thrash / a degraded token-sync link stretch TBT.
        A fault pinned to workers that all left the mesh (drained and
        replaced) stops gating latency, like ``iteration_multiplier``."""
        rng = np.random.default_rng((seed, 1 << 22))
        in_mesh = set(self.active)

        def gates(f) -> bool:
            pinned = F.affected_workers(f)
            return pinned is None or bool(pinned & in_mesh)

        ttft_mult = 1.0
        tbt_mult = 1.0
        for f in self.faults:
            if not gates(f):
                continue
            if isinstance(f, F.ArrivalBurst):
                ttft_mult = max(ttft_mult, f.queue_mult)
            elif isinstance(f, F.KvCacheThrash):
                tbt_mult = max(tbt_mult, 1 + 0.1 * f.slowdown)
            elif isinstance(f, F.GpuThrottle):
                tbt_mult = max(tbt_mult, 1 + 0.75 * (f.slowdown - 1))
            elif isinstance(f, F.DegradedNic):
                tbt_mult = max(tbt_mult, 1 + 0.5 * (1 / f.rho - 1))
        samples: List[Tuple[float, float, float]] = []
        for i in range(n_iters):
            t = t0 + (i + 1) * (t1 - t0) / max(1, n_iters)
            ttft = 0.08 * (1 + 0.03 * rng.standard_normal())
            tbt = 0.020 * (1 + 0.02 * rng.standard_normal())
            samples.append((float(t), float(ttft * ttft_mult),
                            float(tbt * tbt_mult)))
        return samples

    # -- pattern mode (scaling benchmarks) ---------------------------------
    def synth_patterns(self, n_functions: int = 20
                       ) -> Tuple[Dict[str, np.ndarray], Dict[str, Kind]]:
        """Direct (W, 3) pattern synthesis for very large fleets.

        Uses the same canonical function names as raw mode and injects
        every fault model's §3/§6 pattern signature, so the scaling
        benchmarks and the scenario-matrix tests can exercise localization
        on all six production cases without materializing raw windows."""
        W = self.cfg.n_workers
        rng = self.rng
        patterns: Dict[str, np.ndarray] = {}
        kinds: Dict[str, Kind] = {}

        def add(name, kind, beta0, mu0, sig0):
            # BOUNDED (uniform) jitter: worst-case pairwise Manhattan after
            # Eq. 8 max-normalization is 2*(.05+.05+.08)*(1+j) < 0.4, so a
            # healthy fleet can never cross the delta threshold at any W
            patterns[name] = np.stack([
                np.clip(beta0 * (1 + 0.05 * rng.uniform(-1, 1, W)), 0, 1),
                np.clip(mu0 * (1 + 0.05 * rng.uniform(-1, 1, W)), 0, 1),
                np.clip(sig0 * (1 + 0.08 * rng.uniform(-1, 1, W)), 0, 1),
            ], axis=1).astype(np.float32)
            kinds[name] = kind
            return patterns[name]

        gemm = add(GEMM, Kind.GPU, 0.55, 0.92, 0.03)
        allg = add(ALLGATHER, Kind.COMM, 0.15, 0.55, 0.05)
        add(H2D, Kind.MEM, 0.01, 0.7, 0.03)
        dl = add(DATALOADER_STACK, Kind.PYTHON, 0.005, 0.5, 0.05)
        fwd = add(FORWARD_STACK, Kind.PYTHON, 0.004, 0.4, 0.05)
        gc = add(GC_STACK, Kind.PYTHON, 0.0005, 0.1, 0.03)
        for i in range(len(patterns), n_functions):
            kind = [Kind.GPU, Kind.COMM, Kind.PYTHON, Kind.MEM][i % 4]
            beta0 = {Kind.GPU: 0.5, Kind.COMM: 0.15, Kind.PYTHON: 0.005,
                     Kind.MEM: 0.05}[kind] / max(1, n_functions // 8)
            add(f"{kind.name.lower()}_func_{i}", kind, beta0, 0.8, 0.05)

        # -- fault signatures (one per production case) --------------------
        for f in self._fault(F.GpuThrottle):
            # C1P1: longer GEMMs (beta up) at LOW SM utilization (mu down)
            idx = np.asarray(list(f.workers), np.int64)
            gemm[idx, 0] = np.clip(gemm[idx, 0] * f.slowdown, 0, 1)
            gemm[idx, 1] = f.util
        for f in self._fault(F.NvlinkDown):
            # C1P2: fallback traffic at HIGH PCIe mu on the fault workers;
            # everyone in their DP groups stalls (beta above the COMM box)
            idx = np.asarray(list(f.workers), np.int64)
            groups = {w // f.group_size for w in f.workers}
            member = np.isin(np.arange(W) // f.group_size, list(groups))
            allg[member, 0] = np.clip(allg[member, 0] * f.slowdown, 0, 1)
            allg[member, 1] = 0.35
            allg[idx, 1] = 0.9
        for f in self._fault(F.RingSlowLink):
            # §3 Fig. 5b/5c: every worker's mean drops to ~rho; the slow
            # worker is STABLE while the rest of the ring fluctuates
            allg[:, 1] = np.clip(
                f.rho * (1 + 0.03 * rng.standard_normal(W)), 0, 1)
            allg[:, 2] = np.clip(
                0.2 * (1 + 0.2 * rng.standard_normal(W)), 0.05, 1)
            allg[f.slow_worker, 2] = 0.01
        for f in self._fault(F.SlowDataloader):
            # C2P1: socket recv dominates on ALL workers
            dl[:, 0] = np.clip(dl[:, 0] * f.slowdown, 0, 1)
            dl[:, 1] = 0.35
        for f in self._fault(F.CpuBoundForward):
            # C2P2: CPU-bound forward() on the affected workers
            idx = np.asarray(list(f.workers) if f.workers
                             else list(range(W)))
            fwd[idx, 0] = np.clip(fwd[idx, 0] * f.slowdown, 0, 1)
            fwd[idx, 1] = 0.9
        for f in self._fault(F.AsyncGc):
            # C2P3: random workers pause in non-CPU-intensive frames
            hit = np.flatnonzero(rng.random(W) < f.probability)
            if hit.size == 0:
                hit = np.array([int(rng.integers(0, W))])
            gc[hit, 0] = np.clip(
                f.probability * f.pause_s / self.cfg.iteration_s, 0, 1)
            gc[hit, 1] = 0.08
        return patterns, kinds
