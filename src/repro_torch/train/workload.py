"""TrainerWorkload: the EROICA loop over REAL PyTorch training jobs
(DESIGN.md §11; port of the reference's ``repro/train/workload.py``).

Profiles are not simulated: each fleet worker is a real ``Trainer`` running
``train_iteration`` on its device, with the ``Tracer`` recording every phase
(``dataloader.next`` / ``train.step`` / ``optimizer.step``) and a per-process
CPU sampler supplying the cpu stream.  Anchors are the measured
per-iteration wall times, merged across workers (max per index: a
synchronous step is gated by its slowest worker) into the job-level
detector stream.

The in-process workload runs the workers' windows SEQUENTIALLY, so every
cpu sample is attributable to the worker being profiled (and, on one card,
each worker has the card to itself while it runs).

Live faults perturb the REAL loop (no synthesis anywhere):

  * ``DataloaderBurn``  — CPU spin inside ``dataloader.next`` (slow
    storage / preprocessing, paper C2P1);
  * ``StepThrottle``    — stall inside the fenced ``train.step`` span
    (degraded device, paper C1P1);
  * ``GcPause``         — ``gc.collect()`` + stall on a worker subset
    (unsynchronized garbage collection, paper C2P3).

Fault magnitudes default to multiples of the worker's measured warmup
iteration time, so scenarios stay detectable on any machine speed.

``ParamCorruption`` damages the live parameters instead; only a
``ROLLBACK_TO_CHECKPOINT`` through ``snapshot_state``/``install_state``
(``repro_torch.ckpt.recovery.RecoveryManager.for_workload``) undoes it.

Not ported yet: ``trainer_worker_main``, the multi-process worker, waits
for the transport slice (ROADMAP Queue 1 item 5) and raises
``NotImplementedError``.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.detector import DetectorConfig
from repro_torch.online.workload import (WindowData, WorkloadSource,
                                         merge_anchor_durations,
                                         merge_numerics, synth_anchor_events)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def tiny_train_setup(steps: Optional[int] = None):
    """Smoke-scale real-training configs (a shrunk ``gemma2-2b``), sized by
    the reference's env knobs:

      REPRO_TRAIN_ARCH / REPRO_TRAIN_LAYERS / REPRO_TRAIN_D_MODEL /
      REPRO_TRAIN_VOCAB / REPRO_TRAIN_BATCH / REPRO_TRAIN_SEQ_LEN /
      REPRO_TRAIN_STEPS

    Returns ``(model_cfg, data_cfg, opt_cfg, train_cfg)``."""
    from repro_torch.configs.registry import ARCHS, reduced
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.loop import TrainConfig
    arch = os.environ.get("REPRO_TRAIN_ARCH", "gemma2-2b")
    cfg = reduced(ARCHS[arch],
                  layers=_env_int("REPRO_TRAIN_LAYERS", 2),
                  d_model=_env_int("REPRO_TRAIN_D_MODEL", 64),
                  vocab=_env_int("REPRO_TRAIN_VOCAB", 512))
    data = DataConfig(batch=_env_int("REPRO_TRAIN_BATCH", 4),
                      seq_len=_env_int("REPRO_TRAIN_SEQ_LEN", 32))
    opt = OptConfig(lr_peak=5e-3, warmup_steps=2, total_steps=10_000)
    tc = TrainConfig(steps=(steps if steps is not None
                            else _env_int("REPRO_TRAIN_STEPS", 24)),
                     log_every=10_000, perftracker=False)
    return cfg, data, opt, tc


def default_trainer_detector_cfg(iters_per_window: int) -> DetectorConfig:
    """Detector thresholds for REAL (noisy) iteration times: a 2.0x
    slowdown threshold against >= 3x injected faults, locking fast (m=3)
    because a warmed-up loop emits an identical (D, O) pair every
    iteration."""
    n_recent = max(3, min(8, iters_per_window // 2))
    return DetectorConfig(m_identical=3, n_recent=n_recent,
                          slowdown_ratio=2.0,
                          history_iters=50 * max(1, iters_per_window),
                          rearm_cooldown=0)


# -- live faults --------------------------------------------------------------

@dataclass(frozen=True)
class LiveFault:
    """A perturbation of the real loop on a worker subset."""
    workers: Tuple[int, ...]

    def apply(self, worker: "_TrainWorker") -> None:
        raise NotImplementedError


@dataclass(frozen=True)
class DataloaderBurn(LiveFault):
    """CPU burn inside ``dataloader.next`` (slow storage/preprocess, C2P1)."""
    factor: float = 3.0          # burn = factor x measured base iteration
    burn_s: float = 0.0          # absolute override

    def apply(self, worker: "_TrainWorker") -> None:
        worker.trainer.data_burn_s = \
            self.burn_s or self.factor * worker.base_iter_s


@dataclass(frozen=True)
class StepThrottle(LiveFault):
    """Stall inside the fenced ``train.step`` span (degraded device, C1P1)."""
    factor: float = 3.0          # iteration grows to ~factor x baseline
    pad_s: float = 0.0

    def apply(self, worker: "_TrainWorker") -> None:
        worker.trainer.step_pad_s = \
            self.pad_s or max(0.0, self.factor - 1.0) * worker.base_iter_s


@dataclass(frozen=True)
class GcPause(LiveFault):
    """``gc.collect()`` + stall on a worker subset (async GC, C2P3).  The
    default pause is long (8x an iteration), so the idle wait dominates the
    collection work and mu reads low."""
    factor: float = 8.0
    pause_s: float = 0.0
    every: int = 1               # fire every N-th iteration

    def apply(self, worker: "_TrainWorker") -> None:
        worker.trainer.gc_pause_s = \
            self.pause_s or self.factor * worker.base_iter_s
        worker.trainer.gc_every = max(1, int(self.every))


@dataclass(frozen=True)
class ParamCorruption(LiveFault):
    """Corrupt the LIVE model state (a bad batch / optimizer blow-up,
    FLARE-style): every parameter is scaled so the REAL loss and gradient
    norm explode on the numerics channel.  Unlike the timing faults above
    this is state damage, not a hook — ``clear_faults`` cannot undo it;
    only restoring a checkpoint can, which is exactly what the
    ``ROLLBACK_TO_CHECKPOINT`` rung must prove it does.  While the fault
    stays scheduled it re-corrupts each window, so a rollback alone (with
    the underlying cause uncured) does not fake a recovery."""
    scale: float = 1e3
    nan: bool = False            # plant a NaN too (the immediate trigger)

    def apply(self, worker: "_TrainWorker") -> None:
        worker.corrupt_params(self.scale, self.nan)


def _install_faults(workers: Sequence["_TrainWorker"],
                    faults: Sequence[LiveFault]) -> None:
    for tw in workers:
        tw.clear_faults()
    for f in faults or []:
        for tw in workers:
            if tw.worker in f.workers:
                f.apply(tw)


# -- one real worker ----------------------------------------------------------

class _TrainWorker:
    """One fleet worker: a real ``Trainer`` + its ``Tracer``."""

    def __init__(self, worker: int, model_cfg, data_cfg, opt_cfg, train_cfg,
                 n_shards: int, rate_hz: float = 100.0, bundle=None,
                 device=None):
        from repro_torch.instrument.tracer import ProcessSampler, Tracer
        from repro_torch.train.loop import Trainer
        self.worker = int(worker)
        data = replace(data_cfg, shard=self.worker % max(1, n_shards),
                       num_shards=max(1, n_shards))
        self.trainer = Trainer(model_cfg, data, opt_cfg,
                               replace(train_cfg, perftracker=False),
                               device=device)
        if bundle is not None:
            self.trainer.bundle = bundle
        # per-process CPU: an idle wait in THIS trainer reads mu~0 even on
        # a busy shared host, which the playbook's mu rules depend on
        self.tracer = Tracer(worker=self.worker, samplers={
            "cpu": ProcessSampler(rate_hz=rate_hz)})
        self.params, self.opt_state, _ = self.trainer.init_state()
        self.base_iter_s = 0.0
        self.last_metrics: dict = {}

    def step(self) -> float:
        """One instrumented iteration; returns its wall duration."""
        t0 = time.perf_counter()
        self.params, self.opt_state, self.last_metrics = \
            self.trainer.train_iteration(self.params, self.opt_state,
                                         tracer=self.tracer)
        return time.perf_counter() - t0

    def warmup(self, iters: int = 3):
        """First steps (tracer inactive, faults off) to measure the healthy
        iteration baseline; the first is dropped.  Returns the trainer's
        step bundle so same-shape siblings can share it."""
        durs = [self.step() for _ in range(max(2, iters))]
        self.base_iter_s = float(np.median(durs[1:]))
        return self.trainer.bundle

    def clear_faults(self) -> None:
        t = self.trainer
        t.data_burn_s = t.step_pad_s = t.gc_pause_s = 0.0
        t.gc_every = 1

    def corrupt_params(self, scale: float, nan: bool = False) -> None:
        """State-damage fault hook: blow up the live parameters in place
        (and with ``nan``, plant a non-finite value in the first leaf) so
        the next real train steps diverge for real.  The optimizer's fp32
        master weights are left as they are, as in the reference: the
        damaged step's gradients carry the divergence into them."""
        import torch

        from repro_torch.models.transformer import param_leaves
        leaves = [t for _, t in param_leaves(self.params)]
        with torch.no_grad():
            for t in leaves:
                t.mul_(scale)
            if nan:
                leaves[0].view(-1)[0] = float("nan")

    def run_window(self, iters: int, rate: Optional[float] = None):
        """One profiling window: returns (durations, WorkerProfile).

        Side effect: ``self.window_numerics`` holds the window's REAL
        per-iteration (loss, grad_norm) pairs (DESIGN.md §12a)."""
        if rate is not None:
            self.tracer.set_rate(float(rate))
        self.tracer.start_window()
        durs: List[float] = []
        self.window_numerics: List[Tuple[float, float]] = []
        for _ in range(iters):
            durs.append(self.step())
            m = self.last_metrics or {}
            self.window_numerics.append(
                (float(m.get("loss", 0.0)),
                 float(m.get("grad_norm", 0.0))))
        return durs, self.tracer.stop_window()

    def close(self) -> None:
        self.trainer.loader.close()
        if self.trainer.ckpt is not None:
            self.trainer.ckpt.wait()


# -- the in-process workload --------------------------------------------------

class TrainerWorkload(WorkloadSource):
    """Real-trainer profile source.  Workers build lazily on the first
    window; all share ONE ``StepBundle``.  ``device`` is where every
    worker trains (``None`` means ``"cuda"``)."""

    is_trainer = True

    @property
    def family(self) -> str:
        """All-host workload: the localizer's Python expectation box uses
        the calibrated ``host`` ceiling (``core/expectations.py``)."""
        return "host"

    def __init__(self, n_workers: int = 2, setup=None,
                 rate_hz: float = 100.0, warmup_iters: int = 3,
                 device=None):
        from repro_torch.core.service import resolve_device
        self.n = int(n_workers)
        self.cfgs = setup if setup is not None else tiny_train_setup()
        self.rate_hz = float(rate_hz)
        self.warmup_iters = int(warmup_iters)
        self.device = resolve_device(device)
        self.workers: List[_TrainWorker] = []
        self._clock = 0.0

    @property
    def total_workers(self) -> int:
        return self.n

    @property
    def active_workers(self) -> np.ndarray:
        return np.arange(self.n)

    def _ensure_workers(self) -> None:
        if self.workers:
            return
        mc, dc, oc, tc = self.cfgs
        bundle = None
        for w in range(self.n):
            tw = _TrainWorker(w, mc, dc, oc, tc, n_shards=self.n,
                              rate_hz=self.rate_hz, bundle=bundle,
                              device=self.device)
            bundle = tw.warmup(self.warmup_iters)
            self.workers.append(tw)

    @property
    def base_iter_s(self) -> float:
        self._ensure_workers()
        return float(np.median([tw.base_iter_s for tw in self.workers]))

    # -- recovery hooks (DESIGN.md §14) ------------------------------------
    def snapshot_state(self):
        """Gather the fleet's LIVE training state for a checkpoint:
        ``(step, tree)`` with one ``{params, opt}`` subtree per worker.
        The step is the trainers' iteration counter (identical across
        workers — they run the same windows).  The tree holds the live
        tensors, which the optimizer updates in place: a checkpoint copies
        them when it saves."""
        self._ensure_workers()
        step = int(self.workers[0].trainer._iter)
        tree = {str(tw.worker): {"params": tw.params, "opt": tw.opt_state}
                for tw in self.workers}
        return step, tree

    def install_state(self, step: int, tree) -> None:
        """Push a restored checkpoint back into the running trainers
        (the ROLLBACK_TO_CHECKPOINT landing): live params/opt_state and
        the iteration counters rewind to the saved step."""
        self._ensure_workers()
        for tw in self.workers:
            st = tree[str(tw.worker)]
            tw.params, tw.opt_state = st["params"], st["opt"]
            tw.trainer._iter = int(step)

    def run_window(self, window: int, faults: Sequence, iters: int,
                   rates: Optional[np.ndarray]) -> WindowData:
        self._ensure_workers()
        _install_faults(self.workers, faults)
        t0 = self._clock
        per_durs, per_num, profiles = [], [], []
        for tw in self.workers:       # sequential: per-worker cpu streams
            r = None if rates is None else float(rates[tw.worker])
            durs, prof = tw.run_window(iters, rate=r)
            per_durs.append(durs)
            per_num.append(tw.window_numerics)
            profiles.append(prof)
        merged = merge_anchor_durations(per_durs)
        anchors, self._clock = synth_anchor_events(merged, t0)
        return WindowData(anchors=anchors, profiles=profiles,
                          workers=np.arange(self.n), clock=self._clock,
                          t0=t0, metrics={"numerics": merge_numerics(
                              per_num, merged, t0)})

    def close(self) -> None:
        for tw in self.workers:
            tw.close()
        self.workers = []


def trainer_worker_main(*args, **kwargs) -> None:
    """The multi-process worker entry point: waits for the daemon and the
    socket transport (ROADMAP Queue 1 item 5)."""
    raise NotImplementedError("trainer_worker_main waits for the transport "
                              "slice of the port: ROADMAP Queue 1 item 5")
