"""ServeWorkload: the EROICA loop over the REAL PyTorch serving engine
(DESIGN.md §13; port of the reference's ``repro/serve/workload.py``).

The third ``WorkloadSource``: each fleet worker runs a real
continuous-batched decode loop — the same ``make_serve_step`` the
``Engine`` serves with, fenced per token by a device synchronize — under a
seeded Poisson request generator with configurable burst phases
(``RequestGen``).  Anchors are request dequeue -> completion pairs;
profiles come from the ``Tracer`` + per-process ``ProcessSampler`` path
(dequeue wait as a PYTHON frame, decode steps as fenced GPU spans, KV
block reads as MEM spans); the ``slo`` metrics stream carries per-request
(t, p99_ttft, p99_tbt) samples merged across workers (worst per index —
the user-visible tail is the slowest replica).

Continuous-batching-lite: one global KV position cursor per worker —
requests append to the live cache back-to-back and the cache resets only
when the cursor would overrun ``max_len`` — so decode never pays a
per-request cache re-init, the property continuous batching exists to
buy.

Live faults perturb the REAL loop (no synthesis anywhere), magnitudes
relative to the worker's measured healthy request/token times:

  * ``BurstArrivals`` — multiply the generator's arrival rate: the
    backlog model makes dequeue waits grow window over window (queue
    buildup), blowing p99 TTFT while decode stays healthy;
  * ``DecodeStall``  — stall inside the fenced decode step on a worker
    subset (hot/throttled decode device): p99 TBT blows on those hosts;
  * ``CacheThrash``  — every token pays a KV block read stall (working
    set exceeding device memory): fleet-wide TBT + MEM-frame stretch.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.events import Kind
from repro_torch.instrument.tracer import sync
from repro_torch.online.workload import (WindowData, WorkloadSource,
                                         merge_anchor_durations)

#: fraction of the request span at which the completion anchor lands
#: (mirrors ``_OPT_ANCHOR_FRAC``; the serve anchor names never lock the
#: perf iteration detector — SLO incidents open on the ``slo`` channel)
_COMPLETE_ANCHOR_FRAC = 0.97

#: tracer function names (what localization reports; the serving playbook
#: and ``root_cause_hint`` key on the generic queue/kv/decode patterns)
QUEUE_WAIT = "serve.queue:dequeue_wait"
DECODE_STEP = "decode.step"
KV_READ = "kv_cache.read_block"

#: dequeue/admission frame shape: a poll of ``_POLL_FRAC`` x service per
#: request, plus scheduler work growing with the backlog (queue scans /
#: batch formation) once the queueing delay exceeds the half-service
#: slack a healthy queue rides at
_POLL_FRAC = 0.005
_SCHED_BACKLOG_FRAC = 0.15


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def tiny_serve_setup():
    """Smoke-scale real-serving configs (a shrunk ``gemma2-2b``), sized by
    env knobs so CI runners can shrink further:

      REPRO_SERVE_ARCH / REPRO_SERVE_LAYERS / REPRO_SERVE_D_MODEL /
      REPRO_SERVE_VOCAB / REPRO_SERVE_BATCH / REPRO_SERVE_MAX_LEN /
      REPRO_SERVE_PROMPT / REPRO_SERVE_NEW_TOKENS

    Returns ``(model_cfg, serve_cfg, prompt_len, n_new)``."""
    from repro_torch.configs.registry import ARCHS, reduced
    from repro_torch.serve.engine import ServeConfig
    arch = os.environ.get("REPRO_SERVE_ARCH", "gemma2-2b")
    cfg = reduced(ARCHS[arch],
                  layers=_env_int("REPRO_SERVE_LAYERS", 2),
                  d_model=_env_int("REPRO_SERVE_D_MODEL", 32),
                  vocab=_env_int("REPRO_SERVE_VOCAB", 256))
    sc = ServeConfig(batch=_env_int("REPRO_SERVE_BATCH", 2),
                     max_len=_env_int("REPRO_SERVE_MAX_LEN", 128))
    return (cfg, sc, _env_int("REPRO_SERVE_PROMPT", 4),
            _env_int("REPRO_SERVE_NEW_TOKENS", 8))


class RequestGen:
    """Seeded Poisson request arrivals with burst phases.

    ``delay(service_s)`` advances one request through an M/D/1-lite
    backlog on a VIRTUAL timeline: exponential inter-arrival gaps at
    ``rate_rps * burst_mult`` against a single server busy for
    ``service_s`` per request.  It returns the request's queueing delay —
    how long it sat in the queue before the server picked it up.  At
    utilization < 1 delays stay small; a burst phase (``burst_mult``
    pushing utilization past 1) makes the backlog — and every later
    request's delay — GROW window over window, which is what "queue
    buildup" means.  State persists across windows; delays are capped so
    an injected burst degrades the loop detectably, not unboundedly.
    Given a fixed seed and constant ``service_s`` the delay sequence is
    fully deterministic."""

    def __init__(self, rate_rps: float, seed: int = 0,
                 max_delay_s: Optional[float] = None):
        self.rate_rps = float(rate_rps)
        self.burst_mult = 1.0
        self.max_delay_s = max_delay_s
        self._rng = np.random.default_rng((int(seed), 0x5E17E))
        self._clock = 0.0            # last arrival time (virtual)
        self._free_at = 0.0          # server free time (virtual)

    def delay(self, service_s: float) -> float:
        """Queueing delay of the next request given its service time."""
        gap = self._rng.exponential(
            1.0 / max(1e-9, self.rate_rps * self.burst_mult))
        self._clock += gap
        start = max(self._clock, self._free_at)
        self._free_at = start + float(service_s)
        d = start - self._clock
        if self.max_delay_s is not None:
            d = min(d, self.max_delay_s)
        return d


# -- live faults --------------------------------------------------------------

@dataclass(frozen=True)
class ServeFault:
    """A perturbation of the real serving loop on a worker subset."""
    workers: Tuple[int, ...]

    def apply(self, worker: "_ServeWorker") -> None:
        raise NotImplementedError


@dataclass(frozen=True)
class BurstArrivals(ServeFault):
    """Arrival-rate burst: the generator's rate multiplies, the backlog
    grows, dequeue waits (and p99 TTFT) explode while decode stays
    healthy."""
    factor: float = 8.0

    def apply(self, worker: "_ServeWorker") -> None:
        worker.gen.burst_mult = float(self.factor)


@dataclass(frozen=True)
class DecodeStall(ServeFault):
    """Stall inside the fenced decode step (hot/throttled decode device):
    each token stretches to ~``factor`` x the measured healthy TBT."""
    factor: float = 4.0
    pad_s: float = 0.0

    def apply(self, worker: "_ServeWorker") -> None:
        worker.decode_pad_s = \
            self.pad_s or max(0.0, self.factor - 1.0) * worker.base_tbt_s


@dataclass(frozen=True)
class CacheThrash(ServeFault):
    """Every token pays a KV block read stall (working set exceeds
    device memory): TBT stretches and the MEM frame dominates."""
    factor: float = 4.0
    stall_s: float = 0.0

    def apply(self, worker: "_ServeWorker") -> None:
        worker.kv_stall_s = \
            self.stall_s or self.factor * worker.base_tbt_s


def _install_faults(workers: Sequence["_ServeWorker"],
                    faults: Sequence[ServeFault]) -> None:
    for sw in workers:
        sw.clear_faults()
    for f in faults or []:
        for sw in workers:
            if not f.workers or sw.worker in f.workers:
                f.apply(sw)


# -- one real serving worker --------------------------------------------------

class _ServeWorker:
    """One fleet worker: a real decode loop + its ``Tracer``."""

    def __init__(self, worker: int, model_cfg, serve_cfg, prompt_len: int,
                 n_new: int, rate_hz: float = 1000.0, params=None,
                 device="cpu"):
        from repro_torch.instrument.tracer import ProcessSampler, Tracer
        from repro_torch.models.transformer import Transformer
        from repro_torch.train.step import make_serve_step
        self.worker = int(worker)
        self.device = torch.device(device)
        self.cfg, self.sc = model_cfg, serve_cfg
        self.prompt_len, self.n_new = int(prompt_len), int(n_new)
        self.model = Transformer(model_cfg)
        self.params = (params if params is not None
                       else self.model.init(0, device=self.device))
        self._step = make_serve_step(self.model)
        # on a CPU host there IS no gpu_sm/membw sampler: route the
        # decode/KV frames to the honest cpu stream (same convention as
        # ``Trainer._step_resource``), keeping their Kinds for the boxes
        self._res = "cpu" if self.device.type == "cpu" else ""
        # per-process CPU: a dequeue wait in THIS worker reads mu~0 even
        # on a busy shared host (the queue hint's non-CPU-intensive rule)
        self.tracer = Tracer(worker=self.worker, samplers={
            "cpu": ProcessSampler(rate_hz=rate_hz)})
        self._prompt_rng = np.random.default_rng((self.worker, 0x9E3))
        # continuous-batching-lite: cache + global position cursor persist
        # across requests, reset only at max_len overrun
        self.cache = None
        self.pos = 0
        self.gen: Optional[RequestGen] = None
        self.base_tbt_s = 0.0
        self.base_request_s = 0.0
        self.clear_faults()

    def clear_faults(self) -> None:
        self.decode_pad_s = 0.0
        self.kv_stall_s = 0.0
        if self.gen is not None:
            self.gen.burst_mult = 1.0

    def _decode_tokens(self, tracer=None) -> List[float]:
        """One request through the live cache: ``prompt_len`` prefill +
        ``n_new`` decode tokens, token-by-token on the global position
        cursor, fencing every step.  Tokens run inside long fenced
        ``decode.step`` spans (per-token frames would be shorter than the
        cpu sampling period, erasing the mu contrast localization keys
        on).  KV stalls must be depth-1 MEM frames BETWEEN those spans,
        not nested inside: the critical path hands every segment to the
        highest-priority covering event (GPU beats MEM), so a MEM frame
        inside a GPU span can never earn beta.  Under a thrash fault the
        token loop therefore splits into chunks, each chunk's tokens
        paying one aggregated ``kv_cache.read_block`` frame — the
        mid-request one still lands BETWEEN token completions, which is
        the TBT signal.  Returns the per-generated-token completion times
        (perf_counter)."""
        steps = self.prompt_len + self.n_new - 1
        if self.cache is None or self.pos + steps > self.sc.max_len:
            self.cache = self.model.init_cache(self.sc.batch,
                                               self.sc.max_len,
                                               device=self.device)
            self.pos = 0
        prompt = self._prompt_rng.integers(
            0, self.cfg.vocab_size,
            (self.sc.batch, self.prompt_len)).astype(np.int32)
        prompt_dev = torch.from_numpy(prompt.astype(np.int64)).to(
            self.device)
        nxt = None
        done: List[float] = []
        chunk = (steps + 1) // 2 if self.kv_stall_s else steps
        lo = 0
        while lo < steps:
            hi = min(steps, lo + chunk)
            span = (tracer.phase(DECODE_STEP, Kind.GPU, depth=1,
                                 resource=self._res)
                    if tracer else contextlib.nullcontext())
            with span:
                for t in range(lo, hi):
                    cur = (prompt_dev[:, t:t + 1]
                           if t < self.prompt_len else nxt[:, None])
                    logits, self.cache = self._step(
                        self.params, self.cache, {"tokens": cur}, self.pos)
                    # the next token stays on the device as the next
                    # step's input; the fence waits for it
                    nxt = torch.argmax(
                        logits[:, 0, :self.cfg.vocab_size], dim=-1)
                    sync(nxt)
                    if self.decode_pad_s:
                        time.sleep(self.decode_pad_s)
                    self.pos += 1
                    if t >= self.prompt_len - 1:
                        done.append(time.perf_counter())
            if self.kv_stall_s:
                stall = self.kv_stall_s * (hi - lo)
                if tracer:
                    with tracer.phase(KV_READ, Kind.MEM, depth=1,
                                      resource=self._res):
                        time.sleep(stall)
                else:
                    time.sleep(stall)
            lo = hi
        return done

    def serve_request(self, tracer=None) -> Tuple[float, float, float]:
        """Dequeue + serve one request; returns (duration_s, ttft_s,
        p99_tbt_s).

        The generator's queueing delay is VIRTUAL (the synthetic arrival
        timeline): it counts toward TTFT — the user waited that long —
        but the server does not sleep it (while a request queues, the
        server is busy with earlier ones).  What the server DOES pay is
        the dequeue/admission frame: a small poll plus scheduler work
        that grows with the backlog (batch formation scans the queue), so
        under a burst the PYTHON ``dequeue_wait`` frame is what
        localization sees stretch.  TBT percentiles come from the
        request's own measured token intervals."""
        service = self.base_request_s or 1e-3
        qd = self.gen.delay(service) if self.gen is not None else 0.0
        sched = (_POLL_FRAC * service
                 + _SCHED_BACKLOG_FRAC * max(0.0, qd - 0.5 * service))
        t_deq = time.perf_counter()
        if tracer:
            with tracer.phase(QUEUE_WAIT, Kind.PYTHON, depth=1):
                time.sleep(sched)
        else:
            time.sleep(sched)
        done = self._decode_tokens(tracer=tracer)
        t_end = time.perf_counter()
        ttft = qd + (done[0] - t_deq)
        gaps = np.diff(done)
        tbt = float(np.percentile(gaps, 99)) if len(gaps) else ttft
        return t_end - t_deq, ttft, tbt

    def warmup(self, requests: int = 3):
        """Warm up (first request: kernel builds, allocator) + measure the
        healthy baselines (tracer inactive, generator off).  Returns
        ``params`` so same-shape siblings share one parameter tree."""
        durs, tbts = [], []
        for _ in range(max(2, requests)):
            dur, _, tbt = self.serve_request(tracer=None)
            durs.append(dur)
            tbts.append(tbt)
        self.base_request_s = float(np.median(durs[1:]))  # drop warm-up
        self.base_tbt_s = float(np.median(tbts[1:]))
        return self.params

    def run_window(self, requests: int, rate: Optional[float] = None):
        """One profiling window of ``requests`` requests.

        Returns (durations, WorkerProfile); side effect:
        ``self.window_slo`` holds the window's per-request (ttft, tbt)
        pairs — the slo channel's raw material."""
        if rate is not None:
            self.tracer.set_rate(float(rate))
        self.tracer.start_window()
        durs: List[float] = []
        self.window_slo: List[Tuple[float, float]] = []
        for _ in range(requests):
            dur, ttft, tbt = self.serve_request(tracer=self.tracer)
            durs.append(dur)
            self.window_slo.append((ttft, tbt))
        return durs, self.tracer.stop_window()

    def close(self) -> None:
        self.cache = None


# -- merging ------------------------------------------------------------------

def merge_slo_samples(per_worker: Sequence[Sequence[Tuple[float, float]]],
                      durations: Sequence[float], t0: float
                      ) -> List[Tuple[float, float, float]]:
    """Job-level (t, p99_ttft, p99_tbt) samples from per-worker
    per-request (ttft, tbt) pairs: worst (max) per request index — the
    user-visible tail latency is the slowest replica's.  Timestamps chain
    the merged request ``durations`` on the job clock from ``t0`` (same
    clock as the anchors)."""
    n = max((len(d) for d in per_worker), default=0)
    out: List[Tuple[float, float, float]] = []
    t = float(t0)
    for i in range(n):
        t += float(durations[i]) if i < len(durations) else 0.0
        pairs = [d[i] for d in per_worker if i < len(d)]
        out.append((t, max(float(p[0]) for p in pairs),
                    max(float(p[1]) for p in pairs)))
    return out


def synth_serve_anchors(durations: Sequence[float], t0: float
                        ) -> Tuple[List[Tuple[str, float]], float]:
    """(dequeue, complete) anchor pairs for merged request durations,
    chained on a continuous clock from ``t0``."""
    out: List[Tuple[str, float]] = []
    t = float(t0)
    for dur in durations:
        out.append(("request.dequeue", t))
        out.append(("request.complete", t + dur * _COMPLETE_ANCHOR_FRAC))
        t += dur
    return out, t


# -- the in-process workload --------------------------------------------------

class ServeWorkload(WorkloadSource):
    """Real-serving profile source for ``ScenarioRunner``.

    Workers build lazily on the first window; all share ONE set of
    initialized params (identical configs).  Windows run each worker SEQUENTIALLY —
    ``ProcessSampler`` is per-process, so one-at-a-time keeps every cpu
    sample attributable to the worker being profiled (same contract as
    ``TrainerWorkload``; on one card each worker also has the card to
    itself while it runs).  ``utilization`` sets the generators' healthy
    arrival rate as a fraction of each worker's measured service rate
    (< 1 = slack; a ``BurstArrivals`` fault pushes it past 1).  ``device``
    is where every worker decodes (``None`` means ``"cuda"``)."""

    @property
    def family(self) -> str:
        return "host"

    @property
    def channel(self) -> str:
        """Profile abnormalities under a serving workload belong to the
        latency-SLO channel (DESIGN.md §13)."""
        return "slo"

    def __init__(self, n_workers: int = 2, setup=None,
                 rate_hz: float = 1000.0, warmup_requests: int = 3,
                 utilization: float = 0.3, seed: int = 0,
                 max_delay_factor: float = 6.0, device=None):
        from repro_torch.core.service import resolve_device
        self.n = int(n_workers)
        self.device = resolve_device(device)
        self.cfgs = setup if setup is not None else tiny_serve_setup()
        self.rate_hz = float(rate_hz)
        self.warmup_requests = int(warmup_requests)
        self.utilization = float(utilization)
        self.seed = int(seed)
        self.max_delay_factor = float(max_delay_factor)
        self.workers: List[_ServeWorker] = []
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
        mc, sc, prompt_len, n_new = self.cfgs
        params = None
        for w in range(self.n):
            sw = _ServeWorker(w, mc, sc, prompt_len, n_new,
                              rate_hz=self.rate_hz, params=params,
                              device=self.device)
            params = sw.warmup(self.warmup_requests)
            sw.gen = RequestGen(
                rate_rps=self.utilization / max(1e-9, sw.base_request_s),
                seed=self.seed + w,
                max_delay_s=self.max_delay_factor * sw.base_request_s)
            self.workers.append(sw)

    @property
    def base_request_s(self) -> float:
        self._ensure_workers()
        return float(np.median([sw.base_request_s for sw in self.workers]))

    def run_window(self, window: int, faults: Sequence, iters: int,
                   rates: Optional[np.ndarray]) -> WindowData:
        self._ensure_workers()
        _install_faults(self.workers, faults)
        t0 = self._clock
        per_durs, per_slo, profiles = [], [], []
        for sw in self.workers:      # sequential: per-worker cpu streams
            r = None if rates is None else float(rates[sw.worker])
            durs, prof = sw.run_window(iters, rate=r)
            per_durs.append(durs)
            per_slo.append(sw.window_slo)
            profiles.append(prof)
        merged = merge_anchor_durations(per_durs)
        anchors, self._clock = synth_serve_anchors(merged, t0)
        return WindowData(anchors=anchors, profiles=profiles,
                          workers=np.arange(self.n), clock=self._clock,
                          t0=t0, metrics={"slo": merge_slo_samples(
                              per_slo, merged, t0)})

    def close(self) -> None:
        for sw in self.workers:
            sw.close()
        self.workers = []
