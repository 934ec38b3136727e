"""Performance-degradation detection (paper §4.1, Fig. 8).

PerfTracker wraps exactly two anchors — ``dataloader.next()`` and
``optimizer.step()`` — and, with no access to user code:

 1. *Iteration detection*: after M (=10) identical event sequences that start
    with dataloader.next and end with optimizer.step, that sequence becomes
    the training iteration sequence.
 2. *Degradation detection*: each matched iteration records a duration;
    degradation fires when the mean of the last N (=50) durations exceeds the
    recent minimum by >5%, or when the in-flight sequence stalls for at least
    5x the average iteration duration (blockage).
 3. *Robustness*: K (=200) consecutive unmatched events re-enter iteration
    detection.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core import channels

DATALOADER_NEXT = "dataloader.next"
OPTIMIZER_STEP = "optimizer.step"


@dataclass(frozen=True)
class Trigger:
    reason: str               # 'slowdown' | 'blockage' | stream reasons
    time: float
    mean_duration: float      # sample channels: the offending sample value
    baseline: float
    detail: str = ""
    channel: str = channels.PERF   # which detector stream fired; incidents
    #                                keep the channels apart

    def __post_init__(self):
        channels.validate_channel(self.channel)


@dataclass(frozen=True)
class Recovery:
    """Emitted when a degradation the detector triggered on clears: the
    slowdown re-arm fires (recent mean back under threshold) or a blockage
    stall ends (anchor events flow again).  This is the signal the online
    incident pipeline resolves incidents on (DESIGN.md §7)."""
    reason: str               # 'slowdown' | 'blockage' | stream reasons
    time: float
    channel: str = channels.PERF

    def __post_init__(self):
        channels.validate_channel(self.channel)


@dataclass
class DetectorConfig:
    m_identical: int = 10     # M
    n_recent: int = 50        # N
    slowdown_ratio: float = 1.05
    blockage_factor: float = 5.0
    k_resync: int = 200       # K
    history_iters: int = 512  # window for the 'recent shortest' baseline
    #: slowdown re-arm: after a trigger, no new slowdown trigger until the
    #: recent mean recovers below threshold, or this many further matched
    #: iterations elapse while still degraded (0 = fire once per recovery)
    rearm_cooldown: int = 50


class IterationDetector:
    """Online automaton over (event_name, timestamp) pairs."""

    def __init__(self, cfg: Optional[DetectorConfig] = None):
        # None -> fresh config: a dataclass default would be one shared
        # module-level instance aliased across every detector
        self.cfg = cfg if cfg is not None else DetectorConfig()
        cfg = self.cfg
        self.phase = "detect"                 # detect -> monitor
        self.sequence: Optional[Tuple[str, ...]] = None
        self._events: Deque[Tuple[str, float]] = deque(maxlen=4096)
        self._match_pos = 0
        self._match_start = 0.0
        self._mismatches = 0
        self._last_event_t: Optional[float] = None
        self.durations: Deque[float] = deque(
            maxlen=cfg.history_iters)
        self.triggers: List[Trigger] = []
        self.recoveries: List[Recovery] = []
        # re-arm state: a degradation fires ONE trigger, then stays silent
        # until the metric recovers (or, for slowdown, a cooldown elapses)
        self._slowdown_armed = True
        self._iters_since_trigger = 0
        self._blockage_armed = True

    # -- phase 1: iteration detection -----------------------------------
    def _candidate_iterations(self) -> List[Tuple[Tuple[str, ...], float,
                                                  float]]:
        """Split history into candidate iterations: D...O maximal chunks
        (an iteration starts at a dataloader.next that follows an
        optimizer.step)."""
        evs = list(self._events)
        iters = []
        cur: List[Tuple[str, float]] = []
        for i, (name, t) in enumerate(evs):
            if name == DATALOADER_NEXT and cur \
                    and cur[-1][0] == OPTIMIZER_STEP:
                iters.append(cur)
                cur = []
            cur.append((name, t))
        if cur and cur[-1][0] == OPTIMIZER_STEP:
            iters.append(cur)
        out = []
        for chunk in iters:
            names = tuple(n for n, _ in chunk)
            if names and names[0] == DATALOADER_NEXT \
                    and names[-1] == OPTIMIZER_STEP:
                out.append((names, chunk[0][1], chunk[-1][1]))
        return out

    def _try_lock_sequence(self):
        cands = self._candidate_iterations()
        m = self.cfg.m_identical
        if len(cands) < m:
            return
        last = cands[-m:]
        names0 = last[0][0]
        if all(c[0] == names0 for c in last):
            self.sequence = names0
            self.phase = "monitor"
            self._match_pos = 0
            self._mismatches = 0
            # seed durations from the locked candidates
            for names, t0, t1 in last:
                self.durations.append(t1 - t0)

    # -- phase 2: monitoring --------------------------------------------
    def _record_iteration(self, t0: float, t1: float) -> Optional[Trigger]:
        self.durations.append(t1 - t0)
        cfg = self.cfg
        if len(self.durations) < cfg.n_recent:
            return None
        recent = list(self.durations)[-cfg.n_recent:]
        mean = sum(recent) / len(recent)
        baseline = min(self.durations)
        if mean <= baseline * cfg.slowdown_ratio:
            # recovered: the next degradation is a new incident
            if not self._slowdown_armed:
                self.recoveries.append(Recovery("slowdown", t1))
            self._slowdown_armed = True
            self._iters_since_trigger = 0
            return None
        if not self._slowdown_armed:
            # still degraded since the last trigger: stay silent until the
            # cooldown elapses (then remind once and restart the clock)
            self._iters_since_trigger += 1
            if cfg.rearm_cooldown <= 0 \
                    or self._iters_since_trigger < cfg.rearm_cooldown:
                return None
        trig = Trigger("slowdown", t1, mean, baseline,
                       f"mean {mean:.3f}s > {cfg.slowdown_ratio:.2f}x "
                       f"min {baseline:.3f}s over last {cfg.n_recent}")
        self.triggers.append(trig)
        self._slowdown_armed = False
        self._iters_since_trigger = 0
        return trig

    # -- public API ------------------------------------------------------
    def feed(self, name: str, t: float) -> Optional[Trigger]:
        """Feed one anchor event; returns a Trigger if degradation fired."""
        self._last_event_t = t
        if not self._blockage_armed:       # events flowing again: stall over
            self.recoveries.append(Recovery("blockage", t))
        self._blockage_armed = True
        self._events.append((name, t))
        if self.phase == "detect":
            self._try_lock_sequence()
            return None

        seq = self.sequence
        assert seq is not None
        if name == seq[self._match_pos]:
            if self._match_pos == 0:
                self._match_start = t
            self._match_pos += 1
            self._mismatches = 0
            if self._match_pos == len(seq):
                self._match_pos = 0
                return self._record_iteration(self._match_start, t)
            return None
        # mismatch
        self._mismatches += 1
        if name == seq[0]:
            self._match_pos = 1
            self._match_start = t
        else:
            self._match_pos = 0
        if self._mismatches >= self.cfg.k_resync:
            self.phase = "detect"
            self.sequence = None
            self._mismatches = 0
        return None

    def check_blockage(self, now: float) -> Optional[Trigger]:
        """Type-(2) detection: mid-sequence stall >= 5x avg iteration.

        Fires once per stall: after a blockage trigger, repeated polls stay
        silent until an anchor event arrives (``feed`` re-arms)."""
        if self.phase != "monitor" or not self.durations \
                or self._last_event_t is None or not self._blockage_armed:
            return None
        avg = sum(self.durations) / len(self.durations)
        if now - self._last_event_t >= self.cfg.blockage_factor * avg:
            trig = Trigger("blockage", now,
                           now - self._last_event_t, avg,
                           f"no events for {now - self._last_event_t:.3f}s "
                           f">= {self.cfg.blockage_factor}x avg {avg:.3f}s")
            self.triggers.append(trig)
            self._blockage_armed = False
            return trig
        return None

    @property
    def locked(self) -> bool:
        return self.phase == "monitor"

    @property
    def healthy(self) -> bool:
        """True when no triggered degradation is outstanding: every fired
        trigger's re-arm condition has recovered (or nothing ever fired)."""
        return self._slowdown_armed and self._blockage_armed


# -- sample-stream channels (DESIGN.md §12a, §13) -----------------------------

class _StreamDetector:
    """Shared per-signal state machine for sample-stream detector
    channels: values judged against a rolling healthy-median baseline,
    one state machine per signal.

    Subclasses declare ``signals`` (feed order), ``reasons`` (per-signal
    trigger reason), ``channel`` (the registered detector channel stamped
    on every Trigger/Recovery) and implement ``_ratio``.

    Mirrors ``IterationDetector``'s contract — feeding returns Triggers,
    ``recoveries`` accumulates, ``healthy`` says nothing is outstanding —
    so the incident pipeline treats every channel identically.

    Robustness rules (shared by all stream channels):
      * abnormal samples (and non-finite ones) NEVER fold into the
        baseline — a spike must not poison the median it is judged by;
      * a single abnormal sample recovers silently (``confirm=2``): loss
        routinely jumps for one step on a hard batch, and p99 latency
        jumps for one chunk under a benign burst;
      * a NON-FINITE sample skips confirmation and fires immediately —
        there is no benign single-sample NaN.
    """

    signals: Tuple[str, ...] = ()
    reasons: Dict[str, str] = {}
    channel: str = channels.PERF

    def __init__(self, cfg):
        self.cfg = cfg
        self._hist = {s: deque(maxlen=self.cfg.history)
                      for s in self.signals}
        self._bad_streak = {s: 0 for s in self.signals}
        self._ok_streak = {s: 0 for s in self.signals}
        self._outstanding = {s: False for s in self.signals}
        self.triggers: List[Trigger] = []
        self.recoveries: List[Recovery] = []

    def _ratio(self, signal: str) -> float:
        raise NotImplementedError

    def _feed_signal(self, signal: str, t: float, value: float
                     ) -> Optional[Trigger]:
        cfg = self.cfg
        hist = self._hist[signal]
        reason = self.reasons[signal]
        finite = value == value and abs(value) != float("inf")
        baseline = (sorted(hist)[len(hist) // 2]) if hist else 0.0
        if not finite:
            abnormal = True
        elif len(hist) < cfg.warmup:
            hist.append(value)
            return None
        else:
            abnormal = value > baseline * self._ratio(signal)

        if not abnormal:
            hist.append(value)
            self._bad_streak[signal] = 0
            if self._outstanding[signal]:
                self._ok_streak[signal] += 1
                if self._ok_streak[signal] >= cfg.recover:
                    self._outstanding[signal] = False
                    self._ok_streak[signal] = 0
                    self.recoveries.append(
                        Recovery(reason, t, channel=self.channel))
            return None

        self._ok_streak[signal] = 0
        self._bad_streak[signal] += 1
        if self._outstanding[signal]:
            return None               # already fired; silent until recovery
        if finite and self._bad_streak[signal] < cfg.confirm:
            return None               # single spike: wait for confirmation
        self._outstanding[signal] = True
        trig = Trigger(
            reason, t, value, baseline,
            (f"{signal}={value!r} vs healthy median {baseline:.4g} "
             f"(x{self._ratio(signal):.1f} bound"
             + (", non-finite)" if not finite else ")")),
            channel=self.channel)
        self.triggers.append(trig)
        return trig

    def _feed_samples(self, t: float, *values: float) -> List[Trigger]:
        out = []
        for signal, value in zip(self.signals, values):
            trig = self._feed_signal(signal, t, float(value))
            if trig is not None:
                out.append(trig)
        return out

    def outstanding(self) -> List[str]:
        """Signals with a fired, not-yet-recovered trigger."""
        return [s for s in self.signals if self._outstanding[s]]

    @property
    def healthy(self) -> bool:
        return not any(self._outstanding.values())


# -- numerics channel (DESIGN.md §12a) ----------------------------------------

@dataclass
class NumericsConfig:
    warmup: int = 8           # healthy samples before a baseline exists
    history: int = 256        # rolling healthy-sample window per signal
    spike_ratio: float = 2.0  # loss > ratio x median(healthy) = abnormal
    grad_ratio: float = 3.0   # grad_norm ratio (norms jitter more)
    confirm: int = 2          # consecutive abnormal samples to trigger
    recover: int = 2          # consecutive healthy samples to recover


#: numerics signals in feed order; also the function-name suffixes the
#: pipeline uses when it synthesizes numerics abnormalities
NUMERICS_SIGNALS = ("loss", "grad_norm")

_NUMERICS_REASON = {"loss": "loss_spike", "grad_norm": "grad_explosion"}


class NumericsDetector(_StreamDetector):
    """FLARE-style divergence channel: job-level (loss, grad_norm) samples
    against a rolling healthy-median baseline (see ``_StreamDetector`` for
    the shared state machine); Triggers and Recoveries carry
    ``channel='numerics'``."""

    signals = NUMERICS_SIGNALS
    reasons = _NUMERICS_REASON
    channel = channels.NUMERICS

    def __init__(self, cfg: Optional[NumericsConfig] = None):
        super().__init__(cfg if cfg is not None else NumericsConfig())

    def _ratio(self, signal: str) -> float:
        return (self.cfg.spike_ratio if signal == "loss"
                else self.cfg.grad_ratio)

    def feed(self, t: float, loss: float, grad_norm: float
             ) -> List[Trigger]:
        """Feed one training step's (loss, grad_norm); returns any
        triggers that fired (one per signal at most)."""
        return self._feed_samples(t, loss, grad_norm)


# -- serving latency-SLO channel (DESIGN.md §13) ------------------------------

@dataclass
class SloConfig:
    warmup: int = 8           # healthy samples before a baseline exists
    history: int = 256        # rolling healthy-sample window per signal
    ttft_ratio: float = 2.5   # p99 TTFT > ratio x median = violation
    #                           (queueing amplifies tails; leave headroom)
    tbt_ratio: float = 1.5    # p99 time-between-tokens ratio (decode is
    #                           steady; a hot worker shows up fast)
    confirm: int = 2          # consecutive violating samples to trigger
    recover: int = 2          # consecutive healthy samples to recover


#: SLO signals in feed order: p99 time-to-first-token, p99
#: time-between-tokens — the two user-facing serving latencies
SLO_SIGNALS = ("ttft", "tbt")

_SLO_REASON = {"ttft": "ttft_violation", "tbt": "tbt_violation"}


class SloDetector(_StreamDetector):
    """Serving latency-SLO channel: per-chunk p99 (TTFT, TBT) samples
    against a rolling healthy-median baseline calibrated from the run
    itself (see ``_StreamDetector`` for the shared state machine);
    Triggers and Recoveries carry ``channel='slo'``.

    ``confirm=2`` is the burst tolerance: one bad p99 chunk from a benign
    arrival burst recovers silently, a sustained violation fires.
    """

    signals = SLO_SIGNALS
    reasons = _SLO_REASON
    channel = channels.SLO

    def __init__(self, cfg: Optional[SloConfig] = None):
        super().__init__(cfg if cfg is not None else SloConfig())

    def _ratio(self, signal: str) -> float:
        return (self.cfg.ttft_ratio if signal == "ttft"
                else self.cfg.tbt_ratio)

    def feed(self, t: float, ttft: float, tbt: float) -> List[Trigger]:
        """Feed one chunk's (p99 TTFT, p99 TBT); returns any triggers
        that fired (one per signal at most)."""
        return self._feed_samples(t, ttft, tbt)
