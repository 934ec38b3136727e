#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds kernel K1 (``src/repro_torch/csrc/pattern_summary.cu``, nvcc for
sm_90a), holds it against its plain torch version on the card, drives the
port's fleet-mode diagnosis path through ``PerfTrackerService`` on the ring
fault of ``examples/diagnose_ring_fault.py`` and on a 256-worker fleet at the
paper's profiling window (20 s at 10 kHz), and checks the diagnoses.  It
prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``.  Any failed check raises
and the script exits non-zero without the last line.  It imports nothing of
JAX or of the JAX reference package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

ATOL = 1e-5          # kernel vs plain version: float64 sums in another order
PATTERN_ATOL = 1e-6  # cuda vs host numpy backend, per (beta, mu, sigma)
TIMED_LAUNCHES = 10
L2_FLUSH_BYTES = 256 << 20   # > the H100's 50 MB L2


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def timed_ms(fn, reps: int, flush: torch.Tensor | None = None) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, by CUDA events, after
    one warm-up run; with ``flush`` the L2 cache is overwritten before each
    run so every run starts cold."""
    fn()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def adversarial_matrices(rng: np.random.Generator):
    """Edge rows and shapes beside the fleet's groups."""
    edge = np.zeros((7, 64), np.float32)
    edge[1, 10] = 0.9                          # single sample
    edge[2, :] = 0.25                          # full mass: the whole row
    edge[3, :20] = 0.8                         # one burst
    edge[4, 5:10] = edge[4, 40:45] = 0.5       # two equal bursts
    edge[5, 0] = edge[5, 63] = 1.0             # mass at both ends only
    edge[6] = rng.random(64, dtype=np.float32)

    def bursty(E, n):
        u = np.clip(rng.normal(0.45, 0.3, (E, n)), 0, 1).astype(np.float32)
        for i in range(E):
            for _ in range(8):
                a = int(rng.integers(0, n))
                u[i, a:a + int(rng.integers(1, max(2, n // 10)))] = 0
        return u

    n1 = np.array([[0.0], [0.4], [1.0], [0.0], [0.7]], np.float32)
    # isolated samples at 1%..60% density: many gaps, many bisection passes
    keep = rng.random((33, 2500)) < np.linspace(0.01, 0.6, 33)[:, None]
    sparse = (keep * rng.random((33, 2500))).astype(np.float32)
    return {
        "edge_rows(7,64)": edge,
        "n1(5,1)": n1,
        "E1(1,1)": np.array([[0.3]], np.float32),
        "E1(1,97)": bursty(1, 97),
        "odd_E(13,333)": bursty(13, 333),
        "sparse(33,2500)": sparse,
        "rows_40000(3,40000)": bursty(3, 40000),
        "row_200000(1,200000)": bursty(1, 200000),
    }


def compare(K, u_np: np.ndarray, stage):
    """Kernel vs plain version on the card: (count-mismatch rows, max abs
    error of mean/std)."""
    u = torch.from_numpy(u_np).cuda()
    ref = K.pattern_summary_reference(u)
    out = K.pattern_summary(u, stage=stage)
    torch.cuda.synchronize()
    mism = int((out[:, 2] != ref[:, 2]).sum())
    err = float((out[:, :2] - ref[:, :2]).abs().max())
    if not (torch.isfinite(out).all() and out.shape == ref.shape):
        raise AssertionError("kernel output not finite or misshapen")
    return mism, err


def same_diagnosis(a, b, fleet_size: int) -> None:
    """Functions, workers, kinds, hints, reasons and plan ladders equal;
    patterns within PATTERN_ATOL."""
    from repro_torch.core.mitigation import plan_ladder

    def ladders(res):
        return [[(p.action.value, list(p.workers), p.detail)
                 for p in plan_ladder(d, fleet_size)] for d in res.diagnoses]

    if a.functions() != b.functions():
        raise AssertionError(f"functions {a.functions()} != {b.functions()}")
    for da, db in zip(a.diagnoses, b.diagnoses):
        x, y = da.abnormality, db.abnormality
        if (x.workers.tolist(), int(x.kind), da.hint, x.reason) != \
                (y.workers.tolist(), int(y.kind), db.hint, y.reason):
            raise AssertionError(f"diagnosis of {x.function} differs")
        gap = float(np.abs(np.asarray(x.patterns, np.float64)
                           - np.asarray(y.patterns, np.float64)).max())
        if gap > PATTERN_ATOL or not np.isfinite(x.patterns).all():
            raise AssertionError(f"{x.function} patterns differ by {gap}")
    if ladders(a) != ladders(b):
        raise AssertionError("plan ladders differ")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.core import faults as F
        from repro_torch.core.critical_path import fleet_critical_times
        from repro_torch.core.mitigation import plan_mitigations
        from repro_torch.core.service import PerfTrackerService
        from repro_torch.core.simulation import (ALLGATHER, GEMM,
                                                 FleetSimulator, SimConfig)
        from repro_torch.kernels import pattern_summary as K
        from repro_torch.summarize.fleet import pack_fleet
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = gpu_line()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | {card}")

    # -- 1. build --------------------------------------------------------------
    t = time.perf_counter()
    lib = K.build()
    print(f"[build] {lib.name} in {time.perf_counter() - t:.2f}s")
    print(lib.with_suffix(".log").read_text().strip())
    K.pattern_summary.library()

    # the fleet at the paper's window: 256 workers, 20 s at 10 kHz
    t = time.perf_counter()
    sim = FleetSimulator(SimConfig(n_workers=256, window_s=20.0,
                                   rate_hz=10000.0, seed=7),
                         [F.GpuThrottle(workers=range(4))])
    profiles = sim.profile_window()
    sim_s = time.perf_counter() - t
    t = time.perf_counter()
    groups = pack_fleet(profiles).groups
    pack_s = time.perf_counter() - t
    t = time.perf_counter()
    fleet_critical_times(profiles)
    crit_s = time.perf_counter() - t
    print(f"[fleet] host layers: simulate {sim_s:.3f} s, pack_fleet "
          f"{pack_s:.3f} s, critical-path sweep {crit_s:.3f} s; groups "
          f"{[g.u.shape for g in groups]}")

    # -- 2. kernel vs plain version on the card ---------------------------------
    rng = np.random.default_rng(0)
    inputs = {f"fleet_group({g.u.shape[0]},{g.u.shape[1]})": g.u
              for g in groups}
    inputs.update(adversarial_matrices(rng))
    mismatch_rows, max_err = 0, 0.0
    for name, u in inputs.items():
        for stage in (None, False):
            m, e = compare(K, u, stage)
            mismatch_rows += m
            max_err = max(max_err, e)
            print(f"[check] {name} stage={stage}: count mismatches {m}, "
                  f"max |mean/std err| {e:.3g}")
    if mismatch_rows or max_err > ATOL:
        raise AssertionError(f"K1 disagrees with its plain version: "
                             f"{mismatch_rows} rows, err {max_err}")

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    k_ms = p_ms = h_ms = b_ms = 0.0
    for g in groups:
        E, n = g.u.shape
        u = torch.from_numpy(g.u).cuda()
        kms = timed_ms(lambda: K.pattern_summary(u), TIMED_LAUNCHES, flush)
        pms = timed_ms(lambda: K.pattern_summary_reference(u), 2, flush)
        hms = timed_ms(lambda: torch.from_numpy(g.u).to("cuda"), 3)
        bms = K.bound_ms(E, n)
        k_ms, p_ms, h_ms, b_ms = k_ms + kms, p_ms + pms, h_ms + hms, b_ms + bms
        print(f"[time] K1 ({E}, {n}) threads={K.threads_for(n)} "
              f"staged={n <= K.pattern_summary.stage_limit(u.device)}: "
              f"kernel {kms:.4f} ms, bound {bms:.4f} ms "
              f"({bms / kms:.1%} of bound), plain {pms:.3f} ms, "
              f"h2d {hms:.3f} ms")
        del u
    del flush
    print(f"[time] K1 per diagnosis (all groups): kernel {k_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms, plain {p_ms:.3f} ms, h2d {h_ms:.3f} ms")

    # -- 3. ring fault (examples/diagnose_ring_fault.py) -------------------------
    ring = FleetSimulator(SimConfig(n_workers=32, window_s=2.0, rate_hz=2000,
                                    seed=11),
                          [F.RingSlowLink(slow_worker=9, rho=0.5)])
    svc = PerfTrackerService()
    if svc.summarize_backend.name != "cuda":
        raise AssertionError(f"default backend {svc.summarize_backend.name}")
    trig = svc.feed_anchors(ring.anchor_events(80, degrade_after=40))
    if trig is None:
        raise AssertionError("the detector did not trigger on the ring fault")
    ring_profiles = ring.profile_window()
    n_ring_groups = len(pack_fleet(ring_profiles).groups)
    K.pattern_summary.launches = 0
    res = svc.diagnose_profiles(ring_profiles, trigger=trig)
    ring_launches = K.pattern_summary.launches
    flagged = {d.abnormality.function: d.abnormality.workers.tolist()
               for d in res.diagnoses}
    plans = [(p.action.value, p.workers)
             for p in plan_mitigations(res.diagnoses, 32)]
    print(f"[ring] trigger {trig.reason}: {trig.detail}; flagged {flagged}; "
          f"plans {plans}; K1 launches {ring_launches}")
    if flagged.get(ALLGATHER) != [9] or plans[0] != ("replace_hosts", [9]) \
            or ring_launches != n_ring_groups:
        raise AssertionError("ring fault not diagnosed as the reference does")

    # -- 4. fleet at the paper's window: the main path ------------------------
    svc = PerfTrackerService()
    torch.cuda.reset_peak_memory_stats()
    K.pattern_summary.launches = 0
    t = time.perf_counter()
    res = svc.diagnose_profiles(profiles)
    wall = time.perf_counter() - t
    launches = K.pattern_summary.launches
    peak = torch.cuda.max_memory_allocated()
    flagged = {d.abnormality.function: d.abnormality.workers.tolist()
               for d in res.diagnoses}
    plans = [(p.action.value, p.workers)
             for p in plan_mitigations(res.diagnoses, 256)]
    rows = sum(g.u.shape[0] for g in groups)
    samples = sum(g.u.size for g in groups)
    print(f"[fleet] W=256 20s x 10kHz: summarize_s "
          f"{res.timing['summarize_s']:.4f} localize_s "
          f"{res.timing['localize_s']:.4f} wall {wall:.4f} s; rows {rows} "
          f"samples {samples}; peak device memory {peak} bytes; "
          f"K1 launches {launches} for {len(groups)} groups")
    print(f"[fleet] flagged {flagged}; plans {plans}")
    if launches != len(groups) or launches == 0:
        raise AssertionError("the main path did not launch K1 once per group")
    want = [0, 1, 2, 3]
    if flagged.get(GEMM) != want or flagged.get(ALLGATHER) != want \
            or plans[0] != ("replace_hosts", want):
        raise AssertionError("fleet not diagnosed as the reference does")
    host = PerfTrackerService(summarize_backend="numpy")
    same_diagnosis(res, host.diagnose_profiles(profiles), 256)
    print("[fleet] cuda diagnosis == host numpy diagnosis")

    # -- 5. kernels line, card, contract line -----------------------------------
    print(json.dumps({"kernels": [{
        "name": "pattern_summary",
        "route": "cuda",
        "source": "src/repro_torch/csrc/pattern_summary.cu",
        "replaces": "src/repro/kernels/pattern_summary.py:73",
        "launches": launches,
        "count_mismatch_rows": mismatch_rows,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "h2d_ms": h_ms,
        "bound_ms": b_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }]}))
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
