"""Multi-window scenario runner: drives the ``OnlinePipeline`` over a
simulated training run with faults injected and removed mid-run
(DESIGN.md §7).

A scenario is a fault *schedule* over profiling windows: each
``ScheduledFault`` is active for windows ``[start_window, end_window)``.
Every window the runner

  1. sets the simulator's active fault set from the schedule (the anchor
     stream's iteration durations and the profiling window's resource
     signatures both follow);
  2. streams ``iters_per_window`` anchors into the pipeline's detector
     (continuous timeline across windows via ``FleetSimulator.anchor_clock``);
  3. asks the escalation policy for per-worker rates and materializes the
     fleet's raw profiling windows at those rates;
  4. ticks the pipeline (fleet-batched summarize -> EMA fold -> localize ->
     incident transitions -> next escalation decision).

``run_multiprocess`` is the same loop across REAL process boundaries
(DESIGN.md §8): ``n_procs`` spawned worker processes each run a
``PerfTrackerDaemon`` + simulator over their slice of the fleet and upload
~KB patterns over the wire transport; the parent runs detection, window
assembly (loss-tolerant), localization, and incident lifecycles.

Overlapping schedules exercise the distinct-incident path: the detector
only fires once at job level, but each fault's abnormal *function* gets its
own incident.

Profile production is pluggable (DESIGN.md §11): the runner drives any
``WorkloadSource``.  With no explicit workload it builds the historical
``FleetSimulator`` path (``SimWorkload``); pass a
``repro_torch.train.workload.TrainerWorkload`` to run the identical
detect -> summarize -> localize -> incident machinery over REAL training
jobs, whose measured iteration durations arrive (as ``anchors`` wire
frames across processes) and are merged (max per index) into the job-level
detector stream.

Device policy: the runner's pipeline summarizes on ``device`` (``None``
means ``"cuda"``, kernel K1 for every window) and raises without a CUDA
device unless the caller passes ``"cpu"``.  The simulator stays on numpy
RNG, so the port and the reference see the same profiles for the same
seeds.  ``run_multiprocess`` hands its children the backend's name and the
device: each child summarizes there (its own CUDA context on the card) and
raises without a CUDA device unless the device is ``"cpu"``; K1 is built in
the parent before the children start, so no two processes compile it.
Each child reports its kernels' launch counts when it exits
(``ScenarioResult.worker_launches``).
"""
from __future__ import annotations

import multiprocessing as mp
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.ckpt.recovery import RecoveryManager
from repro_torch.core import faults as F
from repro_torch.core.detector import DetectorConfig
from repro_torch.core.mitigation import Action
from repro_torch.core.simulation import FleetSimulator, SimConfig
from repro_torch.online.escalation import EscalationPolicy
from repro_torch.online.mitigation import MitigationEngine, plan_to_wire
from repro_torch.online.pipeline import OnlinePipeline, WindowReport
from repro_torch.online.workload import (SimWorkload, WorkloadSource,
                                         merge_anchor_durations,
                                         merge_numerics, merge_slo,
                                         synth_anchor_events)

#: per-window profile seed offset (the reference's, so both packages
#: profile the same windows; must match _mp_worker_main)
_WINDOW_SEED_STRIDE = 7919

#: the port's kernel wrappers whose launch counts a worker process reports
_KERNELS = ("pattern_summary", "flash_attention", "ssd_scan")


@dataclass(frozen=True)
class ScheduledFault:
    fault: F.Fault
    start_window: int
    end_window: int                 # exclusive
    #: which mitigation Actions actually cure this fault — the scenario's
    #: ground truth for the act->verify->escalate loop (DESIGN.md §9).
    #: None = the fault model's playbook default
    #: (``repro_torch.online.mitigation.DEFAULT_CURES``); an empty tuple = nothing
    #: cures it (the incident must end up ``escalated``)
    cures: Optional[Tuple[Action, ...]] = None
    #: partial fix: the weaker residual fault left behind after a cure
    on_cure: Optional[F.Fault] = None

    def active(self, window: int) -> bool:
        return self.start_window <= window < self.end_window


@dataclass
class ScenarioResult:
    pipeline: OnlinePipeline
    reports: List[WindowReport]
    spans: List[Tuple[float, float]]   # (t_start, t_end) per window
    #: kernel launches by variant summed over the worker processes of a
    #: ``run_multiprocess`` run (each child's counts at its exit; empty for
    #: in-process runs, whose launches the parent's wrappers count)
    worker_launches: Dict[str, Dict[str, int]] = field(default_factory=dict)

    def window_of(self, t: float) -> int:
        """Map a timeline instant (e.g. an incident transition time) to the
        profiling window it fell in.  Window ticks run at exactly the span
        end, so the upper boundary is inclusive."""
        for i, (t0, t1) in enumerate(self.spans):
            if t <= t1:
                return i
        return len(self.spans) - 1

    @property
    def incidents(self):
        return self.pipeline.incidents.incidents

    def timeline(self) -> str:
        return self.pipeline.timeline()

    def wire_summary(self) -> Optional[dict]:
        """Aggregate transport counters over the run (None for in-process
        runs): delivered/dropped/duplicate uploads and per-window holes."""
        stats = [r.transport for r in self.reports if r.transport]
        if not stats:
            return None
        return {
            "windows": len(stats),
            "delivered": sum(s["present"] for s in stats),
            "expected": sum(s["expected"] for s in stats),
            "duplicates": sum(s["duplicates"] for s in stats),
            "client_dropped": max(s["client_dropped"] for s in stats),
            "partial_windows": sum(1 for s in stats if s["missing"]),
        }

    def window_of(self, t: float) -> int:
        """Map a timeline instant (e.g. an incident transition time) to the
        profiling window it fell in.  Window ticks run at exactly the span
        end, so the upper boundary is inclusive."""
        for i, (t0, t1) in enumerate(self.spans):
            if t <= t1:
                return i
        return len(self.spans) - 1

    @property
    def incidents(self):
        return self.pipeline.incidents.incidents

    def timeline(self) -> str:
        return self.pipeline.timeline()


def default_detector_cfg(iters_per_window: int) -> DetectorConfig:
    """Windows-scale detector thresholds: lock fast, judge the slowdown
    over roughly half a window of iterations so both the trigger and the
    recovery re-arm land within a window or two of the fault edge.

    ``history_iters`` bounds the 'recent shortest' baseline: once a fault
    outlives the whole history, the pre-fault minimum ages out, the
    baseline drifts up to the degraded level, and the detector emits a
    spurious Recovery mid-fault (draining the pipeline's EMA).  50 windows
    of headroom keeps that horizon far beyond any scheduled scenario while
    still letting a production baseline drift eventually."""
    n_recent = max(5, min(20, iters_per_window // 2))
    return DetectorConfig(m_identical=5, n_recent=n_recent,
                          history_iters=50 * iters_per_window,
                          rearm_cooldown=0)


class ScenarioRunner:
    def __init__(self, sim_cfg: Optional[SimConfig],
                 schedule: Sequence[ScheduledFault],
                 n_windows: int = 8, iters_per_window: int = 24,
                 escalation: Optional[EscalationPolicy] = None,
                 detector_cfg: Optional[DetectorConfig] = None,
                 summarize_backend=None, alpha: float = 0.6,
                 clear_windows: int = 2, mitigation: bool = False,
                 verify_windows: int = 2, max_escalations: int = 2,
                 settle_windows: int = 1,
                 workload: Optional[WorkloadSource] = None,
                 recovery="auto", history=None, device=None):
        self.sim_cfg = sim_cfg
        self.schedule = list(schedule)
        self.n_windows = n_windows
        self.iters_per_window = iters_per_window
        if workload is None:
            if sim_cfg is None:
                raise ValueError("pass a SimConfig or a WorkloadSource")
            self.sim = FleetSimulator(sim_cfg, [])
            self.workload: WorkloadSource = SimWorkload(
                self.sim, sim_cfg.seed, _WINDOW_SEED_STRIDE)
        else:
            self.sim = getattr(workload, "sim", None)
            self.workload = workload
        # the pipeline's worker axis spans standbys too: their rows stay
        # absent (present-masked) until a re-mesh activates them
        self.pipeline = OnlinePipeline(
            n_workers=self.workload.total_workers,
            family=self.workload.family,
            detector_cfg=(detector_cfg if detector_cfg is not None
                          else default_detector_cfg(iters_per_window)),
            summarize_backend=summarize_backend, alpha=alpha,
            escalation=escalation, clear_windows=clear_windows,
            verify_windows=verify_windows,
            max_escalations=max_escalations,
            settle_windows=settle_windows,
            profile_channel=self.workload.channel,
            history=history, device=device)
        #: ``mitigation=True`` closes the loop (DESIGN.md §9): incidents'
        #: ladder rungs execute against the simulator each tick, and the
        #: schedule's live fault view follows cures/re-meshes.  A
        #: ``RecoveryManager`` (DESIGN.md §14) binds the checkpoint verbs
        #: to real on-disk state: ``recovery="auto"`` provisions one per
        #: run — the sim side-car state for simulator workloads, the live
        #: ``snapshot_state``/``install_state`` hooks for real workloads
        #: that expose them — pass None (or an explicit manager) to
        #: override
        self.engine: Optional[MitigationEngine] = None
        if mitigation:
            rec = recovery
            if isinstance(rec, str) and rec == "auto":
                if self.sim is not None and isinstance(self.workload,
                                                       SimWorkload):
                    rec = RecoveryManager.for_sim(
                        seed=self.sim.cfg.seed,
                        device=self.pipeline.service.device)
                elif hasattr(self.workload, "snapshot_state"):
                    rec = RecoveryManager.for_workload(self.workload)
                else:
                    rec = None
            self.engine = MitigationEngine(self.sim, self.schedule,
                                           recovery=rec)
            self.pipeline.attach_mitigator(self.engine)

    def faults_at(self, window: int) -> List[F.Fault]:
        if self.engine is not None:
            return self.engine.faults_at(window)
        return [sf.fault for sf in self.schedule if sf.active(window)]

    def run(self, verbose: bool = False) -> ScenarioResult:
        reports: List[WindowReport] = []
        spans: List[Tuple[float, float]] = []
        for i in range(self.n_windows):
            if self.engine is not None:
                self.engine.begin_window(i)
            faults = self.faults_at(i)
            # the escalation rates are a pure read (the policy only updates
            # at the previous window's tick), so sampling them before the
            # workload runs is byte-identical to the historical loop order
            rates = self.pipeline.rates()
            wd = self.workload.run_window(i, faults,
                                          self.iters_per_window, rates)
            self.pipeline.feed_anchors(wd.anchors)
            self.pipeline.feed_metrics(wd.metrics)
            self.pipeline.poll_blockage(wd.clock)
            # profiles come from the ACTIVE fleet only; with standbys
            # and/or after a re-mesh the absent rows are present-masked
            # and kept out of the mesh membership (the full-fleet path
            # stays byte-identical to the historical behavior when every
            # row is active)
            active = wd.workers
            self.pipeline.set_membership(active)
            report = self.pipeline.window_tick(
                wd.profiles, t=wd.clock, rates=rates,
                present_workers=(None if len(active)
                                 == self.pipeline.n_workers else active))
            spans.append((wd.t0, wd.clock))
            reports.append(report)
            if verbose:
                print(f"-- window {i} (t={report.t:.1f}s, "
                      f"faults={[type(f).__name__ for f in faults]},"
                      f" escalated={report.escalated})")
                for m in report.mitigations:
                    print(f"   mitigation: {m}")
                print(report.report(len(active)))
        return ScenarioResult(pipeline=self.pipeline, reports=reports,
                              spans=spans)

    def run_multiprocess(self, n_procs: int = 4, loss: float = 0.0,
                         loss_seed: Optional[int] = None,
                         window_timeout: float = 60.0,
                         log_path: Optional[str] = None,
                         max_queue: int = 64,
                         n_shards: Optional[int] = None,
                         auth_token: Optional[str] = None,
                         verbose: bool = False) -> ScenarioResult:
        """The same scenario across REAL process boundaries (DESIGN.md §8,
        §10).

        Spawns ``n_procs`` worker processes (``multiprocessing`` spawn
        context — a cold interpreter each, like a real per-host daemon).
        Each runs one ``PerfTrackerDaemon`` per fleet worker in its slice:
        per-window it materializes its workers' raw profiles, summarizes
        locally, and uploads ~KB patterns over its own socket.  The parent
        runs the anchor stream/detector, broadcasts ``window_start``
        control frames (carrying the escalation rates — and, with
        mitigation or standbys, the mesh membership plus the mitigation
        plans applied since the previous window), assembles each window
        loss-tolerantly, and ticks the online pipeline on the batches.

        ``mitigation=True`` works across the wire: the parent's engine
        executes incident ladders as usual, and each executed plan is
        serialized (``plan_to_wire``) into the next ``window_start``;
        every child replays it on its OWN ``MitigationEngine`` +
        ``FleetSimulator`` — both deterministic — so cures, residual
        faults, and ``replace_hosts`` re-meshes stay bit-identical across
        process boundaries, and collectors' expected sets follow the mesh.

        ``n_shards >= 1`` routes uploads through a two-tier collector
        tree (``transport.CollectorTree``): each worker daemon dials its
        rack's LEAF, leaves assemble + compact their slices, and the root
        ingests O(n_shards) frames per window instead of O(W).

        ``loss`` injects that fraction of upload-frame drops at the
        framing layer in every child (deterministic per (worker, window)
        via ``loss_seed``) — the collector's partial-window semantics and
        the EMA's frozen-row policy carry diagnosis through the holes.
        """
        from repro_torch.transport import (CollectorTree, DaemonServer,
                                           WindowCollector, framing,
                                           max_frame_bytes)
        if getattr(self.workload, "is_trainer", False):
            if n_shards is not None:
                raise ValueError("collector-tree sharding is not supported "
                                 "for trainer workloads (leaves compact "
                                 "uploads; anchors frames need the flat "
                                 "collector)")
            if loss > 0.0:
                raise ValueError("frame-loss injection is simulator-only; "
                                 "trainer workloads lose frames the honest "
                                 "way (kill the socket)")
            return self._run_trainer_mp(n_procs=n_procs,
                                        window_timeout=window_timeout,
                                        log_path=log_path,
                                        max_queue=max_queue,
                                        auth_token=auth_token,
                                        verbose=verbose)
        if self.sim is None:
            raise ValueError("run_multiprocess needs the sim or trainer "
                             "workload (custom WorkloadSources run "
                             "in-process via run())")
        backend, device = self._child_backend()
        # the wire spans the TOTAL worker axis: standby daemons connect
        # and idle outside the mesh until a re-mesh activates them
        W_total = self.sim.total_workers
        active = [int(w) for w in self.sim.active_workers]
        #: the control plane carries membership/plan deltas only when the
        #: mesh can actually change mid-run — the static-mesh wire format
        #: (and its byte-for-byte behavior) is untouched otherwise
        need_membership = self.engine is not None \
            or bool(self.sim_cfg.n_standby)
        max_frame = max_frame_bytes(W_total)
        n_procs = max(1, min(int(n_procs), W_total))
        slices = np.array_split(np.arange(W_total), n_procs)
        tree: Optional[CollectorTree] = None
        if n_shards is not None:
            tree = CollectorTree(range(W_total), n_shards,
                                 auth_token=auth_token, max_frame=max_frame,
                                 window_timeout=window_timeout,
                                 log_path=log_path).start()
            hub, server = tree, tree.root
            addr_of = {w: tree.address_of(w) for w in range(W_total)}
        else:
            collector = WindowCollector(active)
            server = DaemonServer(collector, log_path=log_path,
                                  auth_token=auth_token,
                                  max_frame=max_frame).start()
            hub = collector
            addr_of = {w: server.address for w in range(W_total)}
        ctx = mp.get_context("spawn")
        stats = ctx.SimpleQueue()
        procs = [
            ctx.Process(
                target=_mp_worker_main,
                args=([addr_of[int(w)] for w in sl],
                      [int(w) for w in sl], self.sim_cfg,
                      self.schedule, _WINDOW_SEED_STRIDE, float(loss),
                      (self.sim_cfg.seed if loss_seed is None
                       else int(loss_seed)),
                      backend, int(max_queue),
                      self.engine is not None, auth_token, max_frame,
                      device, stats),
                daemon=True)
            for sl in slices if len(sl)]
        reports: List[WindowReport] = []
        spans: List[Tuple[float, float]] = []
        pending_plans: List[dict] = []
        try:
            for p in procs:
                p.start()
            connected = (tree.wait_connections(W_total,
                                               timeout=window_timeout)
                         if tree is not None else
                         server.wait_connections(W_total,
                                                 timeout=window_timeout))
            if not connected:
                raise RuntimeError(
                    f"fewer than {W_total} daemons connected within "
                    f"{window_timeout}s (see {log_path or 'log'})")
            for i in range(self.n_windows):
                if self.engine is not None:
                    self.engine.begin_window(i)
                self.sim.faults = self.faults_at(i)
                t0 = self.sim.anchor_clock
                anchors = self.sim.anchor_events(self.iters_per_window,
                                                 t0=t0)
                self.pipeline.feed_anchors(anchors)
                # the sample streams (numerics / slo) are job-level and
                # deterministic per (seed, window) — the parent generates
                # them itself, same as the anchor stream (children never
                # ship them for sims)
                wseed = self.sim_cfg.seed + _WINDOW_SEED_STRIDE * (i + 1)
                if self.sim_cfg.workload == "serve":
                    self.pipeline.feed_slo(self.sim.slo_window(
                        self.iters_per_window, wseed, t0,
                        self.sim.anchor_clock))
                else:
                    self.pipeline.feed_numerics(self.sim.numerics_window(
                        self.iters_per_window, wseed, t0,
                        self.sim.anchor_clock))
                self.pipeline.poll_blockage(self.sim.anchor_clock)
                rates = self.pipeline.rates()
                active = [int(w) for w in self.sim.active_workers]
                if need_membership:
                    # expected sets follow the mesh BEFORE the window
                    # opens (the tree root re-keys inside broadcast();
                    # leaves re-key from the frame's membership field)
                    if tree is None:
                        hub.set_expected(active)
                    msg = framing.window_start_msg(
                        i, rates, membership=active, plans=pending_plans)
                else:
                    msg = framing.window_start_msg(i, rates)
                pending_plans = []
                (tree if tree is not None else server).broadcast(msg)
                batch = hub.wait_window(i, timeout=window_timeout)
                server.log(f"window {i} assembled: {len(batch.present)}/"
                           f"{len(batch.expected)} uploads, "
                           f"missing={batch.missing}, "
                           f"dups={batch.duplicates}")
                report = self.pipeline.window_tick_batch(
                    batch, t=self.sim.anchor_clock, rates=rates)
                # plans the engine just executed reach the children on the
                # NEXT window_start — same cadence as the in-process loop,
                # where window i's mitigations first shape window i+1
                pending_plans = [plan_to_wire(m)
                                 for m in report.mitigations]
                spans.append((t0, self.sim.anchor_clock))
                reports.append(report)
                if verbose:
                    print(f"-- window {i} (t={report.t:.1f}s, "
                          f"present={len(batch.present)}/"
                          f"{len(batch.expected)}, "
                          f"escalated={report.escalated})")
                    for m in report.mitigations:
                        print(f"   mitigation: {m}")
                    print(report.report(len(active)))
        finally:
            (tree if tree is not None else server).broadcast(
                framing.stop_msg())
            started = [p for p in procs if p.pid is not None]
            for p in started:
                p.join(timeout=30)
            for p in started:
                if p.is_alive():          # wedged child: don't hang the CI
                    p.terminate()
                    p.join(timeout=5)
            if tree is not None:
                tree.stop()
            else:
                server.stop()
        return ScenarioResult(pipeline=self.pipeline, reports=reports,
                              spans=spans,
                              worker_launches=_drain_launches(stats))

    def _run_trainer_mp(self, n_procs: int, window_timeout: float,
                        log_path: Optional[str], max_queue: int,
                        auth_token: Optional[str],
                        verbose: bool) -> ScenarioResult:
        """REAL training processes over the wire (DESIGN.md §11): each
        spawned child runs actual ``Trainer`` instances for its fleet slice
        (cold interpreter, its own CUDA context on the workload's device),
        profiles them with the ``Tracer``, and ships BOTH the pattern
        upload and the measured iteration durations (``anchors`` frames).
        The parent has no simulator and builds no model — it merges the
        fleet's anchors into the job-level detector stream and ticks the
        pipeline on assembled batches, exactly as it does for simulated
        uploads."""
        from repro_torch.train.workload import trainer_worker_main
        from repro_torch.transport import (DaemonServer, WindowCollector,
                                           framing, max_frame_bytes)
        backend, device = self._child_backend()
        wl = self.workload
        W = wl.total_workers
        max_frame = max_frame_bytes(W)
        collector = WindowCollector(range(W))
        server = DaemonServer(collector, log_path=log_path,
                              auth_token=auth_token,
                              max_frame=max_frame).start()
        n_procs = max(1, min(int(n_procs), W))
        slices = np.array_split(np.arange(W), n_procs)
        ctx = mp.get_context("spawn")
        stats = ctx.SimpleQueue()
        procs = [
            ctx.Process(
                target=trainer_worker_main,
                args=([server.address] * len(sl), [int(w) for w in sl], W,
                      wl.cfgs, self.schedule, backend, int(max_queue),
                      auth_token, max_frame, int(self.iters_per_window),
                      wl.rate_hz, str(wl.device), device, stats),
                daemon=True)
            for sl in slices if len(sl)]
        reports: List[WindowReport] = []
        spans: List[Tuple[float, float]] = []
        clock = 0.0
        try:
            for p in procs:
                p.start()
            # the children compile + warm up BEFORE dialing, so the
            # connection wait doubles as the compile barrier — give it
            # headroom beyond the steady-state window timeout
            if not server.wait_connections(
                    W, timeout=max(window_timeout, 120.0)):
                raise RuntimeError(
                    f"fewer than {W} trainer daemons connected "
                    f"(see {log_path or 'log'})")
            for i in range(self.n_windows):
                rates = self.pipeline.rates()
                server.broadcast(framing.window_start_msg(i, rates))
                batch = collector.wait_window(i, timeout=window_timeout)
                server.log(f"window {i} assembled: {len(batch.present)}/"
                           f"{len(batch.expected)} uploads, "
                           f"anchors from {sorted(batch.anchors)}, "
                           f"missing={batch.missing}")
                t0 = clock
                merged = merge_anchor_durations(
                    [batch.anchors[w] for w in sorted(batch.anchors)])
                anchors, clock = synth_anchor_events(merged, t0)
                self.pipeline.feed_anchors(anchors)
                num = getattr(batch, "numerics", None) or {}
                if num:
                    self.pipeline.feed_numerics(merge_numerics(
                        [num[w] for w in sorted(num)], merged, t0))
                slo = getattr(batch, "slo", None) or {}
                if slo:
                    self.pipeline.feed_slo(merge_slo(
                        [slo[w] for w in sorted(slo)], merged, t0))
                self.pipeline.poll_blockage(clock)
                report = self.pipeline.window_tick_batch(batch, t=clock,
                                                         rates=rates)
                spans.append((t0, clock))
                reports.append(report)
                if verbose:
                    print(f"-- window {i} (t={report.t:.2f}s, "
                          f"present={len(batch.present)}/"
                          f"{len(batch.expected)}, "
                          f"escalated={report.escalated})")
                    print(report.report(W))
        finally:
            server.broadcast(framing.stop_msg())
            started = [p for p in procs if p.pid is not None]
            for p in started:
                p.join(timeout=30)
            for p in started:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5)
            server.stop()
        return ScenarioResult(pipeline=self.pipeline, reports=reports,
                              spans=spans,
                              worker_launches=_drain_launches(stats))

    def _child_backend(self) -> Tuple[str, str]:
        """The pipeline's backend as a picklable name, and its device, for
        the worker processes.  A backend instance that its name does not
        resolve to (a wrapped or custom one) cannot cross the process
        boundary and raises.  K1 is built here, before any child starts."""
        from repro_torch.summarize.base import get_backend
        svc = self.pipeline.service
        backend = svc.summarize_backend
        try:
            same = get_backend(backend.name, svc.device) is backend
        except KeyError:
            same = False
        if not same:
            raise ValueError("run_multiprocess needs a registered backend, "
                             "picklable by name; got the instance "
                             f"{backend!r}")
        if backend.name == "cuda":
            from repro_torch.kernels.pattern_summary import pattern_summary
            pattern_summary.library()
        return backend.name, str(svc.device)


def _kernel_launches() -> Dict[str, Dict[str, int]]:
    """This process's launch counts by variant of every kernel wrapper it
    imported."""
    out = {}
    for name in _KERNELS:
        mod = sys.modules.get(f"repro_torch.kernels.{name}")
        if mod is not None:
            out[name] = dict(getattr(mod, name).launches_by_variant)
    return out


def _drain_launches(stats) -> Dict[str, Dict[str, int]]:
    """Sum the launch counts the exited worker processes reported.  Read
    after the joins: each child writes one small dict straight into the
    pipe (a ``SimpleQueue`` has no feeder thread), far below the pipe's
    buffer, so a child never blocks on it before it exits."""
    total: Dict[str, Dict[str, int]] = {}
    while not stats.empty():
        for name, by_variant in stats.get().items():
            acc = total.setdefault(name, {})
            for v, n in by_variant.items():
                acc[v] = acc.get(v, 0) + int(n)
    return total


def _mp_worker_main(addresses, worker_ids, sim_cfg, schedule,
                    seed_stride, loss, loss_seed, backend,
                    max_queue, mitigation=False, auth_token=None,
                    max_frame=None, device="cuda", stats=None) -> None:
    """Entry point of one spawned worker process: daemons for a fleet
    slice, driven by the parent's ``window_start`` broadcasts.

    ``addresses[i]`` is the collector endpoint worker ``worker_ids[i]``
    dials — the flat server, or that worker's rack LEAF in tree mode.

    With ``mitigation`` the child owns its own ``MitigationEngine`` over
    its own ``FleetSimulator`` and REPLAYS the plan deltas each
    ``window_start`` carries (``plan_from_wire`` -> ``engine.apply``):
    plan execution is deterministic, so the child's live-fault view and
    mesh match the parent's exactly, one window behind the decision —
    the same cadence the in-process loop has.

    The daemons summarize with ``backend`` on ``device`` (no CUDA device
    and a device other than ``"cpu"`` raises).  ``stats``, when given,
    receives this process's kernel launch counts as it exits."""
    from repro_torch.core.daemon import PerfTrackerDaemon
    from repro_torch.online.mitigation import MitigationEngine as _Engine
    from repro_torch.online.mitigation import plan_from_wire
    frame_filter = None
    if loss > 0.0:
        def frame_filter(msg, frame):
            if msg.get("t") != "upload":
                return None
            r = np.random.default_rng(
                (loss_seed, int(msg["worker"]), int(msg["window"])))
            return [] if r.random() < loss else None
    sim = FleetSimulator(sim_cfg, [])
    engine = _Engine(sim, schedule) if mitigation else None
    daemons = [PerfTrackerDaemon(int(w), addr, backend=backend,
                                 max_queue=max_queue,
                                 frame_filter=frame_filter,
                                 auth_token=auth_token,
                                 max_frame=max_frame, device=device)
               for w, addr in zip(worker_ids, addresses)]
    daemon_of = {int(w): d for w, d in zip(worker_ids, daemons)}
    control = daemons[0]
    try:
        while True:
            msg = control.recv_control(timeout=120.0)
            if msg is None or msg.get("t") == "stop":
                return
            if msg.get("t") != "window_start":
                continue
            i = int(msg["window"])
            rates = msg.get("rates")
            rates = None if rates is None else np.asarray(rates, np.float64)
            if engine is not None:
                for d in msg.get("plans", []):
                    plan, applied_at = plan_from_wire(d)
                    # cures must match the parent bit-for-bit: a rollback's
                    # outcome depends on the parent's on-disk checkpoints,
                    # so it rides the wire instead of being re-decided here
                    engine.apply(plan, applied_at,
                                 rollback_failed=d.get("rollback_failed",
                                                       False))
                sim.faults = engine.faults_at(i)
            else:
                sim.faults = [sf.fault for sf in schedule if sf.active(i)]
            members = msg.get("membership")
            mine = (list(worker_ids) if members is None
                    else [w for w in worker_ids if w in set(members)])
            seed = sim_cfg.seed + seed_stride * (i + 1)
            profiles = sim.profile_window_slice(mine, rates=rates,
                                                seed=seed)
            for w, p in zip(mine, profiles):
                daemon_of[int(w)].process_window(i, p)
    finally:
        for d in daemons:
            d.close()
        if stats is not None:
            stats.put(_kernel_launches())
