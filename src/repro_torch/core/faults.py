"""Fault models injected into the fleet simulator — the paper's production
cases (§3, §6.1, §6.2) plus the beyond-performance classes the ROADMAP's
scenario-diversity item names (DESIGN.md §12): cross-layer HOST faults
(cgroup CPU throttling, page-cache thrash), ENVIRONMENT faults that live
on specific hosts (driver/kernel mismatch, degraded NIC — including cold
standbys, so a ``replace_hosts`` re-mesh can land on a bad spare), and
NUMERICS faults (loss spikes, gradient-norm explosions) that never slow an
iteration and are only visible to the numerics detector channel.

``affected_workers`` / ``remap_workers`` are the hooks the mitigation
engine (DESIGN.md §9) uses to reason about host replacement: which workers
a fault is pinned to, and where a rank-pinned fault lands after an elastic
re-mesh moves its ranks onto standby hosts.  ``default_cures()`` is the
per-fault-model playbook ground truth for ``ScheduledFault.cures`` — part
of the fault DATA, not of the diagnosis path, which never mentions a fault
class by name.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Fault:
    pass


@dataclass(frozen=True)
class GpuThrottle(Fault):
    """§6.1 P1: intermittent GPU clock throttling on some hosts — GEMMs take
    longer (larger beta) at lower SM/frequency utilization (smaller mu)."""
    workers: Sequence[int]
    slowdown: float = 2.0
    util: float = 0.33


@dataclass(frozen=True)
class NvlinkDown(Fault):
    """§6.1 P2: NVLink NS error — traffic falls back to PCIe. The affected
    workers' collectives show high PCIe mu; every worker in their DP groups
    shows larger beta."""
    workers: Sequence[int]
    group_size: int = 16
    slowdown: float = 3.0


@dataclass(frozen=True)
class RingSlowLink(Fault):
    """§3: one NIC bond degraded to ``rho`` of nominal."""
    slow_worker: int
    rho: float = 0.5
    ring_workers: Optional[Sequence[int]] = None  # None = all


@dataclass(frozen=True)
class SlowDataloader(Fault):
    """§6.2 P1: slow storage — socket recv_into dominates on ALL workers."""
    slowdown: float = 20.0


@dataclass(frozen=True)
class CpuBoundForward(Fault):
    """§6.2 P2: inefficient Python forward() — CPU-bound on some workers."""
    workers: Sequence[int] = ()
    slowdown: float = 6.0


@dataclass(frozen=True)
class AsyncGc(Fault):
    """§6.2 P3: unsynchronized Python GC — random workers pause on random
    iterations in non-CPU-intensive Python frames; peers wait."""
    probability: float = 0.15
    pause_s: float = 0.25


# -- cross-layer host faults (DESIGN.md §12b) ---------------------------------

@dataclass(frozen=True)
class CgroupCpuThrottle(Fault):
    """OS-level CPU quota throttling on some hosts: the Python forward
    wrapper stretches while the cpu stream sits CLAMPED FLAT at the cgroup
    quota (tiny sigma — the scheduler enforces the ceiling exactly)."""
    workers: Sequence[int]
    quota: float = 0.35          # cpu utilization ceiling the cgroup allows
    slowdown: float = 8.0


@dataclass(frozen=True)
class PageCacheThrash(Fault):
    """Page-cache thrash / IO contention: dataloader reads that should hit
    cache go to disk — long, BURSTY, non-CPU-intensive dataloader frames
    (low mu, large sigma).  ``workers=()`` = fleet-wide (a shared
    filesystem melting down, cured by migrating the data, not by replacing
    hosts)."""
    workers: Sequence[int] = ()
    slowdown: float = 14.0


# -- environment faults (DESIGN.md §12c) --------------------------------------

@dataclass(frozen=True)
class DriverMismatch(Fault):
    """Driver/kernel version mismatch on specific hosts (the llm-self-
    hosting post-mortem): GEMMs run at MODERATE SM utilization — not the
    near-zero of a throttled clock, just a mis-tuned stack — and take
    longer.  Pinned to hosts; pin it to a cold standby to model a
    ``replace_hosts`` rung landing on a bad spare."""
    workers: Sequence[int]
    slowdown: float = 2.0
    util: float = 0.55


@dataclass(frozen=True)
class DegradedNic(Fault):
    """A degraded NIC on specific hosts: the host's collectives collapse to
    ``rho`` of nominal at low, STABLE link utilization while the rest of
    the fleet stays healthy (unlike ``RingSlowLink``, which drags the whole
    ring down with it)."""
    workers: Sequence[int]
    rho: float = 0.25
    group_size: int = 8          # DP-group peers wait on the slow host


# -- serving faults (DESIGN.md §13) -------------------------------------------

@dataclass(frozen=True)
class ArrivalBurst(Fault):
    """Sustained request-arrival burst beyond the fleet's serving capacity:
    every worker's admission queue backs up, TTFT explodes while decode
    stays healthy.  Fleet-wide — no host replacement helps; the cure is
    shedding load (reject/route the excess)."""
    queue_mult: float = 20.0     # dequeue-wait stretch factor


@dataclass(frozen=True)
class KvCacheThrash(Fault):
    """KV-cache working set exceeds device memory: block reads that should
    hit cache go to fetch path, stretching every decode step (TBT) across
    the fleet.  Fleet-wide — cured by shedding load until the working set
    fits again."""
    slowdown: float = 20.0       # kv block-read stretch factor


# -- numerics faults (DESIGN.md §12a) -----------------------------------------

@dataclass(frozen=True)
class LossSpike(Fault):
    """Training-loss spike: the loss jumps to ``magnitude``x its healthy
    level.  Job-level — iterations run at full speed, profiles stay
    healthy; only the numerics detector channel sees it."""
    magnitude: float = 8.0


@dataclass(frozen=True)
class GradExplosion(Fault):
    """Gradient-norm explosion (``nan=True`` = the norm goes non-finite).
    Job-level, perf-invisible, numerics-channel only."""
    magnitude: float = 50.0
    nan: bool = False


def affected_workers(f: Fault) -> Optional[frozenset]:
    """The worker set a fault is pinned to, or None for fleet-wide faults
    (slow storage, unsynchronized GC, fleet-wide CPU-bound forward,
    numerics anomalies): those cannot be cured or dodged by replacing
    hosts."""
    if isinstance(f, (GpuThrottle, NvlinkDown, CgroupCpuThrottle,
                      DriverMismatch, DegradedNic)):
        return frozenset(int(w) for w in f.workers)
    if isinstance(f, (CpuBoundForward, PageCacheThrash)):
        if not f.workers:
            return None
        return frozenset(int(w) for w in f.workers)
    if isinstance(f, RingSlowLink):
        return frozenset({int(f.slow_worker)})
    return None


def remap_workers(f: Fault, mapping: Dict[int, Optional[int]]
                  ) -> Optional[Fault]:
    """Re-pin a worker-pinned fault through a replace-hosts mapping
    (dropped worker -> standby id, or None when no standby was left).

    Returns the same object when nothing changes, a new Fault on the
    remapped workers, or None when every pinned worker dropped out of the
    fleet without replacement (the fault has nowhere left to manifest).
    Fleet-wide faults and ``RingSlowLink`` (the degraded NIC bond stays
    where it is) are returned unchanged.
    """
    if isinstance(f, (GpuThrottle, NvlinkDown, CpuBoundForward,
                      CgroupCpuThrottle, PageCacheThrash, DriverMismatch,
                      DegradedNic)):
        if not f.workers:
            return f
        new = []
        changed = False
        for w in f.workers:
            w = int(w)
            if w in mapping:
                changed = True
                if mapping[w] is not None:
                    new.append(int(mapping[w]))
            else:
                new.append(w)
        if not changed:
            return f
        if not new:
            return None
        return replace(f, workers=tuple(new))
    return f


def default_cures() -> Dict[type, Tuple]:
    """Which ``Action`` actually cures each fault model, per the paper's §6
    case studies plus the DESIGN.md §12 classes — the scenario-level default
    for ``ScheduledFault.cures``.  Ground truth about the WORLD (fault data),
    never consulted by the diagnosis path.

    A function (not a module constant) so importing this module never pulls
    in the mitigation layer; the mapping is memoized on first call.
    """
    global _DEFAULT_CURES
    if _DEFAULT_CURES is None:
        from repro_torch.core.mitigation import Action
        _DEFAULT_CURES = {
            GpuThrottle: (Action.REPLACE_HOSTS,),
            NvlinkDown: (Action.REPLACE_HOSTS,),
            RingSlowLink: (Action.REPLACE_HOSTS,),
            SlowDataloader: (Action.MIGRATE_DATALOADER,),
            CpuBoundForward: (Action.FLAG_CODE,),
            AsyncGc: (Action.SYNCHRONIZE_GC,),
            # host faults: pinned ones leave with their hosts; fleet-wide
            # page-cache thrash needs the data moved, not hosts replaced
            CgroupCpuThrottle: (Action.REPLACE_HOSTS,),
            PageCacheThrash: (Action.REPLACE_HOSTS,
                              Action.MIGRATE_DATALOADER),
            # environment faults live on specific hosts
            DriverMismatch: (Action.REPLACE_HOSTS,),
            DegradedNic: (Action.REPLACE_HOSTS,),
            # numerics faults: only restoring a good checkpoint helps
            LossSpike: (Action.ROLLBACK_TO_CHECKPOINT,),
            GradExplosion: (Action.ROLLBACK_TO_CHECKPOINT,),
            # serving faults: fleet-wide overload sheds load; host-pinned
            # serve faults are declared per scenario (DRAIN_AND_REPLACE)
            ArrivalBurst: (Action.SHED_LOAD,),
            KvCacheThrash: (Action.SHED_LOAD,),
        }
    return _DEFAULT_CURES


_DEFAULT_CURES: Optional[Dict[type, Tuple]] = None
