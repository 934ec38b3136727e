#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds kernels K1 (``src/repro_torch/csrc/pattern_summary.cu``), K2
(``src/repro_torch/csrc/flash_attention.cu``: the wgmma/TMA kernel for bf16
at D 64-256 (112 on the tiles of 128) and at MLA's q/k 192 with v 128, and
the SIMT kernel for f32 and bf16 at D 16-32) and K3
(``src/repro_torch/csrc/ssd_scan.cu``: four wgmma/TMA passes for bf16 at
P 64/128, N and chunk multiples of 64 up to 256, and the SIMT kernel for the
rest), K4 (``src/repro_torch/csrc/rms_norm.cu``: the RMS norm, plain and
with mamba2's skip and gate, forward and backward) and K5
(``src/repro_torch/csrc/causal_conv.cu``: mamba2's causal conv and SiLU,
forward and backward) and K6 (``src/repro_torch/csrc/cross_entropy.cu``: the
training loss head's softcap, log-sum-exp and cross-entropy, forward and
backward) with nvcc for sm_90a,
all at once, prints their ptxas reports and how
many HGMMA and UTMALDG instructions K2's and K3's SASS hold, and then runs
these phases, each checked:

1. K1 against its plain torch version on the card under every variant that
   takes each input (``"warp"`` for rows up to 2048 samples, ``"block"`` for
   any), with each fleet group's count of one-run and general-path rows;
   timed per group by ``torch.profiler`` device time and by CUDA events,
   beside its bound, its plain version and the pageable and pinned H2D
   copies;
2. the port's fleet-mode diagnosis path through ``PerfTrackerService`` on the
   ring fault of ``examples/diagnose_ring_fault.py`` and on a 256-worker
   fleet at the paper's profiling window (20 s at 10 kHz);
3. K2 against its plain torch version, output and lse, at gemma2-2b's
   attention shapes (bf16, local and global layers, at the trainer's 2048
   tokens and at 8192, and a window of 512), bf16 at head dims 64 and 128,
   windowed cases with an odd number of q heads per kv head at D 128 and
   256, at the f32 shapes of the reference's kernel tests, and at
   deepseek-v2's MLA (q/k head dim 192, v 128, 16 heads: 2048 tokens, 4 x
   48, 200), and at zamba2-7b's shared attention (head dim 112, 32 heads,
   window 4096: 2048 tokens, 4 x 48, 200, 8192, strided views of one fused
   projection, f32 on the SIMT kernel; lse within 1e-5); K2 timed beside
   its bound, its plain version, the library call that computes the same
   function (``flex_attention`` under ``torch.compile``, with a tanh
   ``score_mod`` and the causal/window block mask) and, for softcap 0,
   ``scaled_dot_product_attention``; at MLA's and zamba2's shapes beside
   SDPA with ``is_causal``, naming the backend it picked;
4. ``[step cost]``: one reduced gemma2 step's cost (``launch.step_cost``)
   counted on the card (K4's and K6's ops among it) equal to its count on
   the CPU, where the norms and the loss are routed to K4's and K6's plain
   versions; then the full
   gemma2-2b trainer (26 layers, full width, bf16 with fp32 AdamW state)
   for 5 steps of batch 1 x 2048 tokens through
   ``Trainer.train_iteration``: 26 K2 launches a step, all of the wgmma
   variant, one K6 launch a step each way, finite losses.  Every trainer phase first counts its step's
   cost (FLOPs, bytes, collectives, ``gemm_frac``, the seconds the count
   took, FLOPs over ``model_flops``) and checks that each timed
   ``train.step`` holds one ``xla.gemm`` then one ``xla.other``;
   ``[dryrun]`` (``launch.dryrun``): that step traced on fake tensors
   through K2's fake implementation, its count equal to the real count on
   the card exactly, its peak of live bytes against
   ``max_memory_allocated`` (``DRYRUN_MEM_TOL``; the same check must fail
   without the optimizer state), and ``DRYRUN_CELLS`` through ``python -m
   repro_torch.launch.dryrun``, each in its own process on a fake
   256- or 512-rank group; ``[examples]``: ``examples_torch/``'s ring
   fault, ``train_lm`` and ``serve_lm`` on the card, their lines checked;
5. a 4-worker ``TrainerWorkload`` at gemma2-2b's full width cut to 2 layers,
   one window under ``DataloaderBurn`` and one under ``StepThrottle``, each
   diagnosed on the card (every K2 launch of the windows wgmma), the step
   throttle localized to one of the reference's step functions
   (``STEP_PHASES``, the ``xla.*`` sub-events included), which it names;
   then ``[dist one-rank]``: a one-rank NCCL group and a (1, 1) mesh,
   one gemma2-2b step at full width cut to 4 layers with ``dist`` against
   one without (the reference's test_dist bounds; K2 ``wgmma`` launches
   inside the attention core's local-shard region), deepseek-v2-lite-16b
   cut to 4 layers through the expert-parallel branch against the local
   one, ``psum_compressed`` in its three methods, and the
   ``launch.train`` CLI for 3 steps with its PerfTracker report;
6. K3 against its plain torch version (f32 on the shapes of the reference's
   kernel tests through the SIMT kernel; bf16 through the wgmma variant at
   mamba2-2.7b's layer shape, at a chunk whose upper-triangle decay
   overflows float32, and at zamba2-7b's SSM layer; and bf16 through the
   SIMT kernel at the [hybrid serve] forward's chunk of 48), timed beside
   its bound
   and its plain version, each wgmma pass's device time from one profiled
   call, with the plain SSD backward of one layer; then K4 against its
   plain versions (``K4_CASES``: mamba2-2.7b's pre-norm and gated norm in
   bf16 and f32, deepseek-v2's strided MLA latent, widths off the 16-byte
   vector), forward and backward, the backward the same bits three times,
   and each direction timed at mamba2-2.7b's two norms beside its bytes
   bound and the composed ops it replaces; then ``[k5 check]``, K5 (the
   causal conv and SiLU) against the composed ops and autograd through
   them (``K5_CASES``: mamba2-2.7b's and the published Zamba2-7B's xs and
   B/C convs, a batch-4 ragged serve prefill, rows fewer than W, channels
   off the vector, f32), the forward's differing elements counted (bf16
   steps), the backward the same bits three times, and ``[k5 time]``,
   each direction's device time at the main path's convs beside its bytes
   bound, the composed ops and ``F.conv1d(groups=C)`` with ``F.silu``;
   then ``[k6 check]``, K6 (the loss head) against the composed ops and
   autograd through them (``K6_CASES``: mamba2-2.7b's head padded as the
   port pads it and at the published vocabulary, the published
   Zamba2-7B's, gemma2-2b's softcap over padded columns, f32), the nll
   within 1e-5, dh within one bf16 step, the backward the same bits three
   times, and ``[k6 time]``, each direction's device time at the cells'
   heads beside its bytes bound, the composed ops and ``F.cross_entropy``
   on the f32 logits;
7. the full mamba2-2.7b trainer (64 layers, full width, bf16 with f32
   ``A_log``/``D``/``dt_bias`` and fp32 AdamW state) for 5 steps of batch
   1 x 2048 tokens: 64 K3 launches a step, all of the wgmma variant, 129
   K4 launches a step each way (64 plain, 64 gated, the final norm), 192
   K5 launches a step each way (xs, B and C of each layer), one K6
   launch a step each way, finite losses and grad norms;
8. the online loop (detect, summarize with K1 every window, localize, plan,
   mitigate): ``[online catalog]``, all 22 scenarios of
   ``online/catalog.py`` through ``run_scenario(sc)`` on the card, each
   equal to its run on the host ``numpy`` backend window by window, with
   the rows of several runs that reach ``k1_warp_general`` held against
   K1's plain version; ``[online fleet]``, one closed-loop scenario at the
   paper's window (256 workers + 16 standbys, 20 s windows at 1 kHz, 10 kHz
   when escalated) whose ``GpuThrottle`` resolves by ``replace_hosts``,
   per window ``summarize_s``, ``localize_s``, rows by K1 path and K1's
   device time; ``[online rollback]``, 2 real trainers at gemma2-2b's full
   width cut to 2 layers under ``ParamCorruption``, restored from a real
   checkpoint (``ROLLBACK_TO_CHECKPOINT``) bit for bit; every tick's K1
   launches are of the warp variant;
9. ``[wire]`` (right after the fleet of 2): the same 256 profiles through
   ``diagnose_profiles(mode="wire")``, one ``summarize_and_upload`` per
   worker on the card over ``LoopbackWire``: the diagnosis equal to fleet
   mode's bit for bit and its payload bytes to fleet mode's
   ``pattern_bytes``, four workers' uploads against K1's plain version;
10. serving: ``[serve engine]``, ``Engine.generate`` on the full gemma2-2b
   (26 layers, bf16, batch 4, 16-token prompts, 32 new tokens, greedy),
   its decode logits against one teacher-forced ``model.forward`` (K2's
   wgmma variant) within a limit set by a control forward with K2's plain
   version in its place, a profile of its decode steps and an A/B of the
   decode's per-layer position copy; ``[serve fleet]``, a
   4-worker ``ServeWorkload`` of the same model cut to 2 layers under
   ``BurstArrivals``, ``DecodeStall`` and ``CacheThrash`` (7 windows of 8
   requests, K1 every window), each opening the slo incident
   ``SERVE_EXPECT`` names (the stall with its pad in worker 2's TBT);
   between them the ``moe`` family: ``[moe serve]``, the same check of
   ``Engine.generate`` (two generates giving the same tokens) on
   deepseek-v2-lite-16b at its published widths and
   full depth (27 layers, 15.7 B parameters built on the card: MLA decode
   against the latent cache, 64 + 2 experts top-6), with its routing, cache
   bytes, bytes bound and decode profile; ``[moe pair]``, the check on one
   llama4-maverick (dense, MoE) pair at full width (18.7 B parameters, 128
   experts top-1); ``[moe trainer]``, deepseek-v2-lite-16b at full width cut
   to 4 layers (1 dense + 3 MoE), 5 steps of 1 x 2048 tokens, 4 K2 wgmma
   launches a step, finite losses and a positive aux loss; then the
   ``hybrid`` family: ``[hybrid serve]``, the same check of
   ``Engine.generate`` on zamba2-7b at its published widths and full depth
   (81 mamba2 layers, the shared attention block applied 13 times, 6.67 B
   parameters by ``param_counts``), its K3 forward at a chunk of 48 and K2
   at head dim 112 both held within the control limit (the control uses
   both plain versions), with its cache bytes, bytes bound (the shared
   block read once an application) and decode profile, then the same
   decode with f32 parameters and activations (26.7 GB), held to the f32
   forward through K2's and K3's SIMT kernels within 0.2% of the largest
   logit, greedy tokens equal where the margin exceeds that; ``[hybrid
   trainer]``, zamba2-7b at full width cut to 15 layers (2 groups of 6 and
   the 3-layer tail), 5 steps of 1 x 2048 tokens, 45 K5 launches each way
   a step, 2 K2 and 15 K3 wgmma
   launches a step, then 2 steps with ``remat="full"`` from the same
   weights and batches, equal within 1e-3 relative, with K2 rerun in the
   backward;
11. ``[multiprocess]``: ``run_multiprocess(n_procs=2)`` with K1 in the
   children on the C1P1 cell of tests/test_wire.py, flat and through 2
   collector shards, equal to the in-process run, two children's uploads
   against K1's plain version, and 4 trainers of the ``[trainer fleet]``
   model in 2 processes on the card under ``DataloaderBurn(1)``.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.  Any failed check
raises and the script exits non-zero without the last line.  It imports
nothing of JAX or of the JAX reference package.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# torch.compile (the flex_attention yardstick) keeps its caches inside the
# checkout's ignored build directory and compiles in this process
for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / "src/repro_torch/_build" / sub))
os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(ROOT / "src"))

ATOL = 1e-5          # kernel vs plain version: float64 sums in another order
PATTERN_ATOL = 1e-6  # cuda vs host numpy backend, per (beta, mu, sigma)
TIMED_LAUNCHES = 10
L2_FLUSH_BYTES = 256 << 20   # > the H100's 50 MB L2

#: bf16 K2 or K3 vs its plain version, elementwise: |err| <= ATOL + RTOL *
#: |ref|.  Both round an fp32 result to bf16, so they may differ by one bf16
#: step (2^-7 of the value at most) plus fp32 summation noise; a dropped kv
#: tile, a shifted window or a lost chunk of state moves an output by about
#: its own size.
BF16_ATOL = 1e-3
BF16_RTOL = 2.0 ** -7
K2_LIBRARY_TOL = 0.035   # the library yardstick vs the plain version: the
#                          reference's own bf16 kernel-test limit
K2_F32_TOL = 2e-5
K2_LSE_TOL = 1e-3        # K2's lse vs its plain version, every case (the
#                          card tests' limit): the backward reads it
GEMMA_ATTN = dict(softcap=50.0, scale=256 ** -0.5)   # gemma2-2b's layers
GEMMA_WINDOW = 4096
MLA_SCALE = 192 ** -0.5  # deepseek-v2's attention: (nope 128 + rope 64)^-0.5
TRAIN_SEQ = 2048     # the trainer's tokens per step (batch 1)
TRAIN_STEPS = 5
FLEET_ITERS = 8      # iterations per profiling window (the reference's IPW)
#: the phases of the fenced step a StepThrottle incident may localize to:
#: the reference's tests/test_train_workload.py STEP_FUNCTIONS, the
#: cost-model sub-events xla.gemm / xla.other included.  train.step alone
#: cannot be flagged in one window on the card: it fills most of a healthy
#: iteration (about 72% on an H100 80GB HBM3 at 700 W, this script's
#: [trainer fleet] lines), so however slow the step gets, its
#: max-normalized beta moves by less than 1 - 0.72 < 0.4, the localizer's
#: differential threshold; and it has no sampled stream to show a mu.
STEP_PHASES = ("train.step", "xla.gemm", "xla.other", "optimizer.step")

MAMBA = "mamba2-2.7b"
MAMBA_SEQ = 2048     # the mamba2 trainer's tokens per step (batch 1)
#: K3's inputs at mamba2-2.7b's layer: (B, S, H, P, G, N, chunk)
MAMBA_LAYER = (1, MAMBA_SEQ, 80, 64, 1, 128, 256)
#: and at zamba2-7b's SSM layer (112 heads of 64, 2 groups of state 64)
ZAMBA_LAYER = (1, MAMBA_SEQ, 112, 64, 2, 64, 256)
ZAMBA = "zamba2-7b"
ZAMBA_WINDOW = 4096  # its shared attention block's sliding window
#: [hybrid trainer]'s depth: 2 groups of 6 mamba2 layers, each followed by
#: the shared attention block, and the 3-layer tail.  Full depth needs 6.67
#: B x 16 bytes = 106.8 GB of bf16 weights and gradients and fp32 master, m
#: and v, which no card holds, with or without remat
ZAMBA_TRAIN_LAYERS = 15
ZAMBA_REMAT_STEPS = 2
REMAT_RTOL = 1e-3    # remat="full" losses and grad norms vs the run without
K2_112_LSE_TOL = 1e-5   # K2's lse at head dim 112 vs its plain version
#: the published Zamba2-7B's shared attention (zamba2-7b-instruct): 32
#: heads of 224, full causal, scale (224 / 2)^-0.5, 4096 tokens a step
INSTRUCT_HEADS, INSTRUCT_D, INSTRUCT_SEQ = 32, 224, 4096
INSTRUCT_SCALE = 112 ** -0.5
#: K3's wgmma passes, in launch order (device kernel names)
K3_PASSES = ("ssd_fwd_state", "ssd_fwd_pass", "ssd_fwd_cb", "ssd_fwd_scan")
K3_PROFILED_CALLS = 3
#: the reference's SSD kernel-test shapes (tests/test_kernels.py:48-51)
K3_TEST_SHAPES = [(1, 64, 2, 16, 1, 8, 16), (2, 128, 4, 32, 2, 16, 32),
                  (1, 128, 4, 64, 4, 32, 64), (1, 32, 2, 16, 2, 16, 32)]
K3_F32_TOL = 2e-5    # max |err| / max |ref|, the reference's own limit
#: [dryrun]'s cells through ``python -m repro_torch.launch.dryrun`` (arch,
#: shape, mesh), each in its own process, all at once
DRYRUN_CELLS = (("gemma2-2b", "train_4k", "single"),
                ("deepseek-v2-lite-16b", "decode_32k", "single"),
                ("mamba2-2.7b", "long_500k", "multi"))
DRYRUN_TIMEOUT = 240.0
#: the dry run's peak of live bytes of the gemma2-2b trainer step against
#: ``max_memory_allocated`` on the card: |ratio - 1| within this
DRYRUN_MEM_TOL = 0.02     # 0.9972 on an H100 80GB HBM3 at 700 W (PERF.md)
#: [examples]: each script of examples_torch/ with its arguments, and the
#: lines its output must hold
EXAMPLE_RUNS = {
    "diagnose_ring_fault": ["diagnose_ring_fault.py"],
    "train_lm": ["train_lm.py", "--steps", "40"],
    "serve_lm": ["serve_lm.py"],
}
EXAMPLE_EXPECT = {
    "diagnose_ring_fault": ["AllGather_RING                           {9}",
                            "mitigation: replace_hosts [9]"],
    "train_lm": ["(improved)", "checkpoints: [20, 30, 40]"],
    "serve_lm": ["generated (4, 48)"],
}
EXAMPLE_TIMEOUT = 120.0


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


class PhaseClock:
    """Wall seconds of each phase of the script, printed as it ends."""

    def __init__(self):
        self.t = time.perf_counter()
        self.times: dict[str, float] = {}

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.times[name] = round(now - self.t, 1)
        self.t = now
        print(f"[phase] {name} {self.times[name]} s")


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


def compare(K, u_np: np.ndarray, variant: str):
    """Kernel (forced to ``variant``) vs plain version on the card:
    (count-mismatch rows, max abs error of mean/std)."""
    u = torch.from_numpy(u_np).cuda()
    ref = K.pattern_summary_reference(u)
    out = K.pattern_summary(u, variant=variant)
    torch.cuda.synchronize()
    mism = int((out[:, 2] != ref[:, 2]).sum())
    err = float((out[:, :2] - ref[:, :2]).abs().max())
    if not (torch.isfinite(out).all() and out.shape == ref.shape):
        raise AssertionError("kernel output not finite or misshapen")
    return mism, err


def path_masks(u: np.ndarray) -> tuple:
    """Masks of the rows of ``u`` K1 finishes in pass 0: all-zero rows and
    one-run rows (positive samples count == last - first + 1).  The rest
    take the general path (``k1_warp_general`` in the warp variant)."""
    pos = u > 0
    count = pos.sum(axis=1)
    first = pos.argmax(axis=1)
    last = u.shape[1] - 1 - pos[:, ::-1].argmax(axis=1)
    zero = ~(u.sum(axis=1, dtype=np.float64) > 0)
    one = ~zero & (count == last - first + 1)
    return zero, one


def row_paths(u: np.ndarray) -> dict:
    """How many rows of ``u`` each path of K1 finishes."""
    zero, one = path_masks(u)
    return {"all_zero": int(zero.sum()), "one_run": int(one.sum()),
            "general": int((~zero & ~one).sum())}


def k1_device_ms(K, u: torch.Tensor, flush: torch.Tensor,
                 calls: int = 3) -> tuple:
    """K1's device time per call from ``torch.profiler``: each K1 kernel's
    mean duration over ``calls`` calls (L2 flushed before each), summed
    over the kernels one call runs; and the means by kernel name."""
    from torch.profiler import ProfilerActivity, profile
    K.pattern_summary(u)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            K.pattern_summary(u)
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in device_events(prof):
        if "k1_" in e.name():
            by_name.setdefault(e.name(), []).append(e.duration_ns() / 1e6)
    means = {name: sum(v) / len(v) for name, v in by_name.items()}
    return sum(means.values()), means


def share(bound: float, ms: float) -> str:
    """The bound as a share of a measured time ("not measured" for none)."""
    return f"{bound / ms:.1%}" if ms > 0 else "not measured"


def h2d_ms(u_np: np.ndarray) -> tuple:
    """(pageable, pinned) ms of moving ``u_np`` to the card, by CUDA events:
    the backend's route (``torch.from_numpy(u).to("cuda")``), and a copy
    into a pinned host buffer (allocated once, outside the timing) followed
    by a non-blocking copy to the card."""
    pinned = torch.empty(u_np.shape, dtype=torch.float32, pin_memory=True)

    def via_pinned():
        pinned.copy_(torch.from_numpy(u_np))
        pinned.to("cuda", non_blocking=True)

    return (timed_ms(lambda: torch.from_numpy(u_np).to("cuda"), 3),
            timed_ms(via_pinned, 3))


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


def reset_counts(K, K2, K3) -> None:
    """Set every kernel's launch count to 0 (K4's too), just before a path
    runs."""
    from repro_torch.kernels.rms_norm import rms_norm
    K.pattern_summary.reset_counts()
    K2.flash_attention.reset_counts()
    K3.ssd_scan.reset_counts()
    rms_norm.reset_counts()


def _rand(g, shape, dtype):
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def k2_checks(K2) -> dict:
    """K2 against its plain version, output and lse: gemma2-2b's shapes in
    bf16 (local and global, at the trainer's length, at 8192 and at the
    serve engine's forward over 4 x 48 tokens, and a window of 512 that
    bites at 2048), bf16 at the repo's head dims 64
    (internvl2-1b's heads) and 128 (starcoder2-3b's), windowed and capped
    cases of an odd number of q heads per kv head (llama4-maverick's at D
    128, and G 3 at D 256: one head a block), the reference's kernel-test
    shapes and variants in f32, and deepseek-v2's MLA at q/k head dim 192
    and v 128 (16 heads: the trainer's 2048 tokens, the serve forward's 4 x
    48 and 200 tokens, no multiple of the 64-row kv tile), and zamba2-7b's
    shared attention at head dim 112 (32 heads, 32 kv heads, window 4096:
    the trainer's 2048 tokens, the serve forward's 4 x 48, 200 tokens, 8192
    where the window bites, q/k/v as strided views of one fused projection,
    and f32 on the SIMT kernel), whose lse is held to 1e-5, and the
    published Zamba2-7B's at head dim 224 (32 heads, full causal, scale
    112^-0.5: its training step's 4096 tokens, 200 tokens, views of one
    fused qkv, and f32 on the SIMT kernel) under K2's bf16 and f32 limits,
    each counted at head dim 224.  Each case must run the variant
    ``variant_for`` names."""
    g = torch.Generator(device="cuda").manual_seed(0)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    worst_lse = 0.0
    bf16_ratio = 0.0      # worst |err| / (ATOL + RTOL * |ref|) in bf16
    mla_worst = 0.0       # worst |err| at MLA's (192, 128)
    z_worst = {"out": 0.0, "lse": 0.0}   # worst |err| at head dim 112
    i_worst = {"out": 0.0, "lse": 0.0}   # worst |err| at head dim 224
    cases = [(torch.bfloat16, (1, S, 8, 4, 256),
              dict(GEMMA_ATTN, window=w), name)
             for S in (TRAIN_SEQ, 8192)
             for w, name in ((GEMMA_WINDOW, "gemma2 local"),
                             (0, "gemma2 global"))]
    # the serve engine's teacher-forced forward: batch 4 over 48 tokens,
    # one partial 64-row tile
    cases += [(torch.bfloat16,
               (SERVE_BATCH, ENGINE_PROMPT + ENGINE_NEW, 8, 4, 256),
               dict(GEMMA_ATTN, window=w), f"{name} (serve engine forward)")
              for w, name in ((GEMMA_WINDOW, "gemma2 local"),
                              (0, "gemma2 global"))]
    cases += [(torch.bfloat16, (1, TRAIN_SEQ, 8, 4, 256),
               dict(GEMMA_ATTN, window=512), "gemma2 window 512"),
              (torch.bfloat16, (1, TRAIN_SEQ, 14, 2, 64), {},
               "internvl2-1b heads D=64"),
              (torch.bfloat16, (1, TRAIN_SEQ, 24, 2, 128), {},
               "starcoder2-3b heads D=128"),
              (torch.bfloat16, (1, TRAIN_SEQ, 40, 8, 128),
               dict(window=512, softcap=30.0),
               "llama4-maverick heads D=128 (G 5: one head a block)"),
              (torch.bfloat16, (1, TRAIN_SEQ, 3, 1, 256),
               dict(GEMMA_ATTN, window=512), "G 3 at D=256 (one head a block)")]
    cases += [(torch.float32, shape, {}, "kernel test")
              for shape in ((1, 128, 4, 4, 64), (2, 256, 6, 2, 64),
                            (1, 256, 8, 1, 128), (2, 128, 2, 2, 32))]
    cases += [(torch.float32, (2, 256, 4, 2, 32), kw, "kernel test variant")
              for kw in (dict(window=100), dict(softcap=20.0),
                         dict(causal=False), dict(window=64, softcap=10.0))]
    cases += [(torch.float32, (1, 2048, 8, 4, 256), dict(GEMMA_ATTN, window=w),
               "gemma2 f32") for w in (GEMMA_WINDOW, 0)]
    cases += [(torch.bfloat16, (B, S, 16, 16, 192, 128), dict(scale=MLA_SCALE),
               f"deepseek-v2 MLA {name}")
              for B, S, name in ((1, TRAIN_SEQ, "(trainer)"),
                                 (SERVE_BATCH, ENGINE_PROMPT + ENGINE_NEW,
                                  "(serve forward)"),
                                 (1, 200, "(200 tokens)"))]
    zkw = dict(window=ZAMBA_WINDOW)
    cases += [(dtype, (B, S, 32, 32, 112), zkw, f"zamba2-7b shared attention "
               f"{name}")
              for dtype, B, S, name in (
                  (torch.bfloat16, 1, TRAIN_SEQ, "(trainer)"),
                  (torch.bfloat16, SERVE_BATCH, ENGINE_PROMPT + ENGINE_NEW,
                   "(serve forward)"),
                  (torch.bfloat16, 1, 200, "(200 tokens)"),
                  (torch.bfloat16, 1, 8192, "(8192 tokens: the window bites)"),
                  (torch.bfloat16, 1, TRAIN_SEQ, "(views of one fused qkv)"),
                  (torch.float32, 1, TRAIN_SEQ, "(f32)"))]
    ikw = dict(scale=INSTRUCT_SCALE)
    IH, ID, IS = INSTRUCT_HEADS, INSTRUCT_D, INSTRUCT_SEQ
    cases += [(dtype, (1, S, IH, IH, ID), ikw, f"zamba2-7b-instruct shared "
               f"attention {name}")
              for dtype, S, name in (
                  (torch.bfloat16, IS, "(training step)"),
                  (torch.bfloat16, 200, "(200 tokens)"),
                  (torch.bfloat16, IS, "(views of one fused qkv)"),
                  (torch.float32, IS, "(f32)"))]
    for dtype, (B, S, H, KV, D, *Dv), kw, name in cases:
        Dv = Dv[0] if Dv else D
        if "fused" in name:       # strides of a (B, S, 3, H, D) projection
            qkv = _rand(g, (B, S, 3, H, D), dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            del qkv
        else:
            q = _rand(g, (B, S, H, D), dtype)
            k = _rand(g, (B, S, KV, D), dtype)
            v = _rand(g, (B, S, KV, Dv), dtype)
        variant = K2.variant_for(dtype, D, Dv)
        before = K2.flash_attention.launches_by_variant[variant]
        before_d = K2.flash_attention.launches_by_head_dim[D]
        out, lse = K2.flash_attention(q, k, v, return_lse=True, **kw)
        ref, ref_lse = K2.flash_attention_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        if K2.flash_attention.launches_by_variant[variant] != before + 1 \
                or K2.flash_attention.launches_by_head_dim[D] != before_d + 1:
            raise AssertionError(f"K2 case {name} did not run {variant} "
                                 f"at head dim {D}")
        if not (torch.isfinite(out).all() and out.shape == ref.shape
                and out.dtype == dtype):
            raise AssertionError(f"K2 output not finite or misshapen ({name})")
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        lse_err = float((lse - ref_lse).abs().max())
        worst[dtype] = max(worst[dtype], err)
        worst_lse = max(worst_lse, lse_err)
        extra = ""
        if dtype == torch.bfloat16:
            ratio = float((diff / (BF16_ATOL + BF16_RTOL
                                   * ref.float().abs())).max())
            bf16_ratio = max(bf16_ratio, ratio)
            extra = (f", max |ref| {float(ref.float().abs().max()):.3g}, "
                     f"worst err / limit {ratio:.3g}")
        dims = f"D={D}" if Dv == D else f"D={D} Dv={Dv}"
        print(f"[k2 check] {name} {dtype} ({variant}) B={B} S={S} H={H} "
              f"KV={KV} {dims} {kw}: max |out err| {err:.3g}, max |lse err| "
              f"{lse_err:.3g}{extra}")
        if Dv != D:
            mla_worst = max(mla_worst, err)
        if D in (112, INSTRUCT_D):
            zw = z_worst if D == 112 else i_worst
            zw["out"] = max(zw["out"], err)
            zw["lse"] = max(zw["lse"], lse_err)
        del q, k, v, out, lse, ref, ref_lse, diff
    print(f"[k2 check] worst bf16 {worst[torch.bfloat16]:.4g} at "
          f"{bf16_ratio:.3g} of its limit ({BF16_ATOL} + {BF16_RTOL} "
          f"* |ref|), worst f32 {worst[torch.float32]:.3g} (tolerance "
          f"{K2_F32_TOL}), worst lse {worst_lse:.3g} (tolerance "
          f"{K2_LSE_TOL}); at head dim 112: worst |out err| "
          f"{z_worst['out']:.4g}, worst lse {z_worst['lse']:.3g} (tolerance "
          f"{K2_112_LSE_TOL}); at head dim {INSTRUCT_D}: worst |out err| "
          f"{i_worst['out']:.4g}, worst lse {i_worst['lse']:.3g}")
    if bf16_ratio > 1.0 or worst[torch.float32] > K2_F32_TOL \
            or not worst_lse <= K2_LSE_TOL \
            or not z_worst["lse"] <= K2_112_LSE_TOL:
        raise AssertionError("K2 disagrees with its plain version")
    return {"bf16": worst[torch.bfloat16], "f32": worst[torch.float32],
            "lse": worst_lse, "mla": mla_worst, "zamba": z_worst,
            "instruct": i_worst}


def sass_counts(lib: Path) -> dict | None:
    """How many tensor-core (HGMMA) and TMA-load (UTMALDG) instructions the
    library's SASS holds, by cuobjdump; None where the toolkit lacks it."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HGMMA", "UTMALDG")}


def ptxas_summary(log: str) -> dict:
    """Registers and spill-store bytes of each kernel in an ``-Xptxas -v``
    report, by name (template arguments of K1's kernels kept as ``<K>``)."""
    out = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        mangled = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        m = re.search(r"(k1_[a-z_]+?)(?:ILi(\d+)E)?E", mangled)
        name = mangled if m is None else \
            m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
        if regs and spill:
            out[name] = {"registers": int(regs.group(1)),
                         "spill_bytes": int(spill.group(1))}
    return out


def _sdpa(q, k, v, window: int):
    """``scaled_dot_product_attention`` on (B, S, H, D) views, causal with
    the same window (no softcap: SDPA has none)."""
    F = torch.nn.functional
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    S = q.shape[1]
    mask = None
    if window and window < S:
        pos = torch.arange(S, device=q.device)
        mask = (pos[:, None] >= pos[None, :]) & \
            (pos[:, None] - pos[None, :] < window)
    if mask is None:
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                          enable_gqa=True)


def _flex(S: int, window: int):
    """``flex_attention`` under ``torch.compile`` computing K2's function at
    gemma2-2b's settings on (B, S, H, D) views: the scaled score through a
    tanh softcap (``score_mod``), a causal block mask with the window, GQA.
    The block mask is built here, once, outside the timed call."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    cap, scale = GEMMA_ATTN["softcap"], GEMMA_ATTN["scale"]

    def score_mod(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    def mask_mod(b, h, qi, ki):
        keep = qi >= ki
        return keep & (qi - ki < window) if window else keep

    block = create_block_mask(mask_mod, None, None, S, S, device="cuda")
    flex = torch.compile(flex_attention, dynamic=False)

    def run(q, k, v):
        out = flex(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   score_mod=score_mod, block_mask=block, scale=scale,
                   enable_gqa=True)
        return out.transpose(1, 2)
    return run


def k2_timing(K2, flush) -> dict:
    """K2 at the trainer's shape (and at 8192 tokens) by CUDA events, beside
    its bound, its plain version, the same function in ``flex_attention``
    and, with softcap 0, SDPA."""
    g = torch.Generator(device="cuda").manual_seed(1)
    res = {}
    for S in (TRAIN_SEQ, 8192):
        q = _rand(g, (1, S, 8, 256), torch.bfloat16)
        k = _rand(g, (1, S, 4, 256), torch.bfloat16)
        v = _rand(g, (1, S, 4, 256), torch.bfloat16)
        for w, name in ((GEMMA_WINDOW, "local"), (0, "global")):
            kw = dict(GEMMA_ATTN, window=w)
            kms = timed_ms(lambda: K2.flash_attention(q, k, v, **kw),
                           TIMED_LAUNCHES, flush)
            pms = timed_ms(lambda: K2.flash_attention_reference(q, k, v,
                                                                **kw), 3)
            bms, by = K2.bound_ms(q, k, window=w)
            kw0 = dict(kw, softcap=0.0)
            k0ms = timed_ms(lambda: K2.flash_attention(q, k, v, **kw0),
                            TIMED_LAUNCHES, flush)
            sdpa_ms = timed_ms(lambda: _sdpa(q, k, v, w), TIMED_LAUNCHES,
                               flush)
            gap = float((_sdpa(q, k, v, w).transpose(1, 2).float()
                         - K2.flash_attention(q, k, v, **kw0).float())
                        .abs().max())
            t = time.perf_counter()
            flex = _flex(S, w)
            ref = K2.flash_attention_reference(q, k, v, **kw)[0]
            lib_err = float((flex(q, k, v).float() - ref.float()).abs().max())
            del ref
            compile_s = time.perf_counter() - t
            if not lib_err <= K2_LIBRARY_TOL:
                raise AssertionError(f"flex_attention disagrees with K2's "
                                     f"plain version by {lib_err}")
            lib_ms = timed_ms(lambda: flex(q, k, v), TIMED_LAUNCHES, flush)
            print(f"[k2 time] S={S} {name} (window {w}): kernel {kms:.4f} ms, "
                  f"bound {bms:.4f} ms by {by} ({bms / kms:.2%} of bound), "
                  f"plain {pms:.3f} ms, flex_attention {lib_ms:.4f} ms "
                  f"(compiled in {compile_s:.1f} s, max |err| vs plain "
                  f"{lib_err:.3g}); softcap 0: kernel {k0ms:.4f} ms, "
                  f"sdpa {sdpa_ms:.4f} ms (max |diff| {gap:.3g})")
            res[(S, name)] = dict(ms=kms, plain_ms=pms, bound_ms=bms,
                                  bound_by=by, library_ms=lib_ms,
                                  library_err=lib_err, ms_softcap0=k0ms,
                                  sdpa_ms=sdpa_ms)
        del q, k, v
    return res


#: SDPA backends by a fragment of their device kernels' names, the first
#: that matches naming the backend
SDPA_KERNELS = (("cudnn", "cudnn"), ("efficient", "fmha"),
                ("flash", "flash"), ("math", "gemm"))


def k2_sdpa_timing(K2, flush, label: str, H: int, D: int, Dv: int,
                   scale: float, window: int = 0, seed: int = 4,
                   seq: int = TRAIN_SEQ) -> dict:
    """K2 at one model's attention as the trainer hands it over: bf16 q/k
    (1, seq, H, D), v (1, seq, H, Dv), causal, with the model's scale
    and window (one that does not bite at 2048 tokens); by CUDA events and
    by ``torch.profiler`` device time (3 calls), beside its bound, its
    plain version and ``scaled_dot_product_attention`` with
    ``is_causal=True`` and the same scale (the same function there), whose
    backend is named by the kernels it launched (at deepseek-v2's MLA, q/k
    and v of different head dims rule out FlashAttention-2)."""
    from torch.profiler import ProfilerActivity, profile
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = _rand(g, (1, seq, H, D), torch.bfloat16)
    k = _rand(g, (1, seq, H, D), torch.bfloat16)
    v = _rand(g, (1, seq, H, Dv), torch.bfloat16)
    kw = dict(scale=scale, window=window)
    kms = timed_ms(lambda: K2.flash_attention(q, k, v, **kw), TIMED_LAUNCHES,
                   flush)
    pms = timed_ms(lambda: K2.flash_attention_reference(q, k, v, **kw), 3)
    bms, by = K2.bound_ms(q, k, window=window, Dv=v.shape[-1])
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              scale=scale)
    lib_ms = timed_ms(sdpa, TIMED_LAUNCHES, flush)
    ref = K2.flash_attention_reference(q, k, v, **kw)[0].float()
    lib_err = float((sdpa().transpose(1, 2).float() - ref).abs().max())
    del ref
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            flush.zero_()
            K2.flash_attention(q, k, v, **kw)
        flush.zero_()
        sdpa()
        torch.cuda.synchronize()
    own = [e.duration_ns() / 1e6 for e in device_events(prof)
           if "flash_fwd_wgmma" in e.name()]
    names = [e.name() for e in device_events(prof)
             if "flash_fwd_wgmma" not in e.name()
             and "fill" not in e.name().lower()]
    backend = next((b for b, frag in SDPA_KERNELS
                    if any(frag in n.lower() for n in names)), "unknown")
    dev = sum(own) / len(own) if own else 0.0
    print(f"[k2 time] {label} bf16 q/k (1, {seq}, {H}, {D}) v "
          f"(1, {seq}, {H}, {Dv}) causal, window {window}, scale "
          f"{scale:.6g}: kernel {kms:.4f} ms (device "
          f"{dev:.4f} ms by torch.profiler over {len(own)} calls), bound "
          f"{bms:.4f} ms by {by} ({share(bms, kms)} of bound), plain "
          f"{pms:.3f} ms, sdpa is_causal {lib_ms:.4f} ms (backend "
          f"{backend}: {sorted(set(n[:60] for n in names))[:3]}; max |err| "
          f"vs plain {lib_err:.3g})")
    if not lib_err <= K2_LIBRARY_TOL:
        raise AssertionError(f"SDPA disagrees with K2's plain version by "
                             f"{lib_err}")
    del q, k, v, qt, kt, vt
    return dict(ms=kms, device_ms=dev, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms, library_backend=backend,
                library_err=lib_err)


def attention_backward_ms(C, K2, flush) -> dict:
    """The plain-torch attention backward of one gemma2-2b layer at the
    trainer's shape, by CUDA events (the step's other attention cost)."""
    g = torch.Generator(device="cuda").manual_seed(2)
    q = _rand(g, (1, TRAIN_SEQ, 8, 256), torch.bfloat16)
    k = _rand(g, (1, TRAIN_SEQ, 4, 256), torch.bfloat16)
    v = _rand(g, (1, TRAIN_SEQ, 4, 256), torch.bfloat16)
    dout = _rand(g, (1, TRAIN_SEQ, 8, 256), torch.bfloat16)
    out = {}
    for w, name in ((GEMMA_WINDOW, "local"), (0, "global")):
        spec = C.AttnSpec(window=w, **GEMMA_ATTN)
        o, lse = K2.flash_attention(q, k, v, return_lse=True, window=w,
                                    **GEMMA_ATTN)
        out[name] = timed_ms(lambda: C._backward(q, k, v, o, lse, dout, spec),
                             3, flush)
    return out


def logits_ce_ms(L, K6, flush) -> dict:
    """gemma2-2b's tied LM head, logit softcap and cross-entropy, forward
    and backward, at the trainer's shape: ``"k6"`` as
    ``Transformer._loss`` runs it on the card (the bf16 product, K6, then
    ``layers.masked_sums`` and ``mean_nll``), ``"composed"`` the composed
    ops K6 replaced there (``layers.lm_logits``, ``layers.cross_entropy``),
    which the CPU and a mesh still run."""
    g = torch.Generator(device="cuda").manual_seed(3)
    h = _rand(g, (1, TRAIN_SEQ, 2304), torch.bfloat16).requires_grad_(True)
    table = (_rand(g, (256000, 2304), torch.bfloat16) * 0.02
             ).requires_grad_(True)
    labels = torch.randint(0, 256000, (1, TRAIN_SEQ), generator=g,
                           device="cuda")

    def k6():
        rows = K6.cross_entropy(h @ table.t(), labels, 256000, 30.0)
        loss, _ = L.mean_nll(*L.masked_sums(rows, labels))
        torch.autograd.grad(loss, (h, table))

    def composed():
        loss, _ = L.cross_entropy(L.lm_logits(table, h, 30.0), labels, 256000)
        torch.autograd.grad(loss, (h, table))
    return {"k6": timed_ms(k6, 3, flush),
            "composed": timed_ms(composed, 3, flush)}


def k3_inputs(shape, seed: int, dtype, ranges: str = "model"):
    """x, B, C standard normal in ``dtype``; dt and A f32, drawn as the
    reference's kernel tests draw them (``ranges="test"``: softplus of a
    normal, -exp(U[0, 1])) or from mamba2's init ranges (``"model"``: dt
    log-uniform in [1e-3, 0.1], A in [-16, -1]), or at the far end of those
    ranges (``"overflow"``: dt 0.1, A -16)."""
    B, S, H, P, G, N, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = _rand(g, (B, S, H, P), dtype)
    Bm, Cm = _rand(g, (B, S, G, N), dtype), _rand(g, (B, S, G, N), dtype)
    if ranges == "test":
        dt = torch.nn.functional.softplus(_rand(g, (B, S, H), torch.float32))
        A = -torch.exp(torch.rand(H, generator=g, device="cuda"))
    elif ranges == "model":
        u = torch.rand((B, S, H), generator=g, device="cuda")
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        A = -(1.0 + 15.0 * torch.rand(H, generator=g, device="cuda"))
    else:
        dt = torch.full((B, S, H), 0.1, device="cuda")
        A = torch.full((H,), -16.0, device="cuda")
    return x, dt, A, Bm, Cm


def k3_checks(K3) -> dict:
    """K3 against its plain version: f32 on the reference's kernel-test
    shapes (max |err| / max |ref| < 2e-5, the SIMT kernel); bf16 at
    mamba2-2.7b's layer shape from its init ranges and at the overflow end
    of them, and at zamba2-7b's SSM layer (elementwise within one bf16 step,
    the wgmma variant), and at the [hybrid serve] forward's 4 x 48 tokens
    (a chunk of 48, no multiple of 64: the SIMT kernel in bf16), every case
    finite.  Each case must run the variant ``variant_for`` names."""
    worst_f32, worst_bf16, ratio_bf16 = 0.0, 0.0, 0.0

    def run(ins, shape):
        variant = K3.variant_for(ins[0].dtype, shape[3], shape[5],
                                 min(shape[6], shape[1]))
        before = K3.ssd_scan.launches_by_variant[variant]
        out = K3.ssd_scan.run(*ins, shape[-1])
        torch.cuda.synchronize()
        if K3.ssd_scan.launches_by_variant[variant] != before + 1:
            raise AssertionError(f"K3 case {shape} did not run {variant}")
        return out, variant

    for i, shape in enumerate(K3_TEST_SHAPES):
        ins = k3_inputs(shape, i, torch.float32, "test")
        ref = K3.ssd_scan_reference(*ins, shape[-1])
        out, variant = run(ins, shape)
        if not (torch.isfinite(out).all() and out.shape == ref.shape):
            raise AssertionError(f"K3 output not finite or misshapen {shape}")
        rel = float((out - ref).abs().max() / ref.abs().max())
        worst_f32 = max(worst_f32, rel)
        print(f"[k3 check] kernel test f32 (B,S,H,P,G,N,Q)={shape} "
              f"({variant}, P slice {K3.p_split_for(shape[3])}): max |err| / "
              f"max |ref| {rel:.3g}")
    serve = (SERVE_BATCH, ENGINE_PROMPT + ENGINE_NEW) + ZAMBA_LAYER[2:]
    for name, shape, ranges, want in (
            ("mamba2-2.7b", MAMBA_LAYER, "model", "wgmma"),
            ("mamba2-2.7b", MAMBA_LAYER, "overflow", "wgmma"),
            ("zamba2-7b", ZAMBA_LAYER, "model", "wgmma"),
            ("zamba2-7b serve forward", serve, "model", "simt")):
        ins = k3_inputs(shape, 7, torch.bfloat16, ranges)
        ref = K3.ssd_scan_reference(*ins, shape[-1]).float()
        out, variant = run(ins, shape)
        if variant != want:
            raise AssertionError(f"K3 at {name}'s layer ran {variant}")
        if not (torch.isfinite(out).all() and out.dtype == torch.bfloat16
                and out.shape == ref.shape):
            raise AssertionError(f"K3 output not finite or misshapen "
                                 f"({ranges})")
        diff = (out.float() - ref).abs()
        ratio = float((diff / (BF16_ATOL + BF16_RTOL
                               * ref.abs())).max())
        worst_bf16 = max(worst_bf16, float(diff.max()))
        ratio_bf16 = max(ratio_bf16, ratio)
        print(f"[k3 check] {name} layer bf16 ({variant}) (B,S,H,P,G,N,Q)="
              f"{shape}, {ranges} dt/A: finite, max |err| "
              f"{float(diff.max()):.3g}, max |ref| "
              f"{float(ref.abs().max()):.3g}, worst err / limit {ratio:.3g}")
        del ins, ref, out, diff
    print(f"[k3 check] worst f32 {worst_f32:.3g} (tolerance {K3_F32_TOL}), "
          f"worst bf16 {worst_bf16:.4g} at {ratio_bf16:.3g} of its limit "
          f"({BF16_ATOL} + {BF16_RTOL} * |ref|)")
    if worst_f32 >= K3_F32_TOL or ratio_bf16 > 1.0:
        raise AssertionError("K3 disagrees with its plain version")
    return {"f32": worst_f32, "bf16": worst_bf16}


def k3_timing(K3, flush) -> dict:
    """K3 at mamba2-2.7b's layer shape (bf16, the init's dt/A ranges) by
    CUDA events beside its bound and its plain version, each wgmma pass's
    device time from one call under ``torch.profiler``, and the plain SSD
    backward the trainer runs for one layer."""
    from torch.profiler import ProfilerActivity, profile
    ins = k3_inputs(MAMBA_LAYER, 11, torch.bfloat16, "model")
    Q = MAMBA_LAYER[-1]
    kms = timed_ms(lambda: K3.ssd_scan.run(*ins, Q), TIMED_LAUNCHES, flush)
    pms = timed_ms(lambda: K3.ssd_scan_reference(*ins, Q), 3, flush)
    bms, by = K3.bound_ms(ins[0], ins[1], ins[3], ins[4], Q)
    variant = K3.variant_for(torch.bfloat16, MAMBA_LAYER[3], MAMBA_LAYER[5],
                             Q)
    # each pass's mean device time over the calls the profiler recorded (a
    # trace may miss the first kernels after it starts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(K3_PROFILED_CALLS):
            flush.zero_()
            K3.ssd_scan.run(*ins, Q)
        torch.cuda.synchronize()
    seen = {name: [] for name in K3_PASSES}
    for e in device_events(prof):
        for name in K3_PASSES:
            if name in e.name():
                seen[name].append(e.duration_ns() / 1e6)
    passes = {name: sum(v) / len(v) if v else 0.0 for name, v in seen.items()}
    grad_ins = [t.detach().requires_grad_(True) for t in ins]
    dy = torch.randn_like(ins[0])

    def backward():
        with torch.enable_grad():
            y = K3.ssd_scan_reference(*grad_ins, Q)
            torch.autograd.grad(y, grad_ins, dy)
    bwd = timed_ms(backward, 3, flush)
    print(f"[k3 time] mamba2-2.7b layer bf16 (B,S,H,P,G,N,Q)={MAMBA_LAYER} "
          f"({variant}): kernel {kms:.4f} ms, bound {bms:.4f} ms by {by} "
          f"({bms / kms:.2%} of bound), plain {pms:.3f} ms; plain "
          f"SSD backward (recompute under autograd) {bwd:.3f} ms a layer; "
          f"library: none (no PyTorch call computes the SSD scan)")
    print(f"[k3 time] {K3_PROFILED_CALLS} calls under torch.profiler, mean "
          f"device ms by pass (kernels recorded): "
          + ", ".join(f"{k} {v:.4f} ({len(seen[k])})"
                      for k, v in passes.items())
          + f"; sum {sum(passes.values()):.4f}")
    if variant != "wgmma" or not all(passes.values()):
        raise AssertionError(f"K3 at mamba2-2.7b's layer ran {variant}, "
                             f"passes seen {passes}")
    del ins, grad_ins, dy
    return dict(ms=kms, plain_ms=pms, bound_ms=bms, bound_by=by,
                backward_ms=bwd, passes_ms=passes)


#: K4's cases on the card: (label, variant, activation dtype, scale dtype,
#: leading dims, width n or (H, P), columns past n in each row): mamba2-2.7b's
#: pre-norm and gated norm in bf16 and f32, deepseek-v2's MLA latent norm
#: (the first 512 of each 576-wide row of the down projection, a strided
#: view), widths that take the one-element vector, and the published
#: Zamba2-7B's gated norm per group (112 heads of 64 in 2 groups of 3584,
#: one rstd a row and group; an 8th field, the groups, 1 where absent)
K4_CASES = (
    ("mamba2 pre-norm", "plain", torch.bfloat16, torch.bfloat16,
     (1, MAMBA_SEQ), 2560, 0),
    ("mamba2 pre-norm f32", "plain", torch.float32, torch.float32,
     (1, MAMBA_SEQ), 2560, 0),
    ("mamba2 gated norm", "gated", torch.bfloat16, torch.bfloat16,
     (1, MAMBA_SEQ), (80, 64), 0),
    ("mamba2 gated norm f32", "gated", torch.float32, torch.float32,
     (1, MAMBA_SEQ), (80, 64), 0),
    ("MLA latent, strided", "plain", torch.bfloat16, torch.bfloat16,
     (1, MAMBA_SEQ), 512, 64),
    ("width 100, f32 scale", "plain", torch.bfloat16, torch.float32,
     (5, 3), 100, 0),
    ("gated 3 x 12", "gated", torch.bfloat16, torch.bfloat16, (2, 9),
     (3, 12), 0),
    ("zamba2-7b-instruct grouped gated norm", "gated", torch.bfloat16,
     torch.bfloat16, (1, INSTRUCT_SEQ), (112, 64), 0, 2),
)


def k4_groups(case) -> int:
    """A ``K4_CASES`` case's norm groups."""
    return case[7] if len(case) > 7 else 1
#: K4 vs its plain version, gradients: max |err| / max |ref| (bf16: both
#: round the same f32 value to bf16 after sums taken in another order, one
#: step is 2^-7 of a value at most; f32: the sums' order)
K4_BF16_TOL = 2.0 ** -6
K4_F32_TOL = 1e-4
#: cycles of ``torch.cuda._sleep`` queued before a timed launch, so the
#: host has enqueued it before the card reaches the start event (~1 ms)
QUEUE_CYCLES = 2_000_000


def queued_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` by CUDA events over ``reps`` runs, each
    after an L2 flush and queued behind a spin on the card, so that no host
    enqueue falls between the events (a launch's host side is tens of
    microseconds, more than K4's kernels)."""
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(QUEUE_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def k4_inputs(case, seed: int) -> list:
    """(x, scale) or (y, xs, D, z, scale) and the output's gradient, on the
    card, from the seed."""
    _, variant, dt, wdt, lead, width, pad = case[:7]
    g = torch.Generator(device="cuda").manual_seed(seed)
    if variant == "plain":
        base = _rand(g, (*lead, width + pad), dt)
        ins = [base[..., :width],
               (1 + 0.1 * _rand(g, (width,), torch.float32)).to(wdt)]
        n = width
    else:
        H, P = width
        n = H * P
        ins = [_rand(g, (*lead, H, P), dt), _rand(g, (*lead, H, P), dt),
               1 + 0.5 * _rand(g, (H,), torch.float32),
               2 * _rand(g, (*lead, n), dt),
               (1 + 0.1 * _rand(g, (n,), torch.float32)).to(wdt)]
    return ins, _rand(g, (*lead, n), dt)


def k4_call(K4, variant, ins, groups: int = 1):
    """K4's forward on ``ins`` as the op takes them: (out, rstd)."""
    if variant == "plain":
        return K4.rms_norm.forward(ins[0], ins[1], 1e-5)
    y, xs, D, z, scale = ins
    return K4.rms_norm.forward(y, scale, 1e-5, xs, D, z, groups)


def k4_backward(K4, variant, ins, g, rstd, groups: int = 1):
    if variant == "plain":
        return K4.rms_norm.backward(g, ins[0], ins[1], rstd)
    y, xs, D, z, scale = ins
    return K4.rms_norm.backward(g, y, scale, rstd, xs, D, z, groups)


def k4_reference(K4, variant, ins, g, groups: int = 1):
    """The plain versions on the card: (out, rstd, grads)."""
    if variant == "plain":
        out, rstd = K4.rms_norm_reference(ins[0], ins[1], 1e-5)
        return out, rstd, list(K4.rms_norm_backward_reference(
            g, ins[0], ins[1], rstd))
    out, rstd = K4.gated_rms_norm_reference(*ins, 1e-5, groups)
    y, xs, D, z, scale = ins
    return out, rstd, K4.gated_rms_norm_backward_reference(
        g, y, xs, D, z, scale, rstd, groups)


def k4_checks(K4) -> dict:
    """K4 against its plain versions on every ``K4_CASES`` case, forward and
    backward: the output within one bf16 step of the plain version's
    elementwise (f32: 1e-5 of the largest), rstd within 1e-5, each gradient
    within ``K4_BF16_TOL`` / ``K4_F32_TOL`` of the largest; the backward's
    outputs the same bits on three runs; one launch counted a call, of the
    case's variant and direction.  Returns the worst errors."""
    worst = {"out": 0.0, "rstd": 0.0, "grad": 0.0}
    for i, case in enumerate(K4_CASES):
        label, variant, dt = case[:3]
        G = k4_groups(case)
        ins, g = k4_inputs(case, 40 + i)
        before = (K4.rms_norm.launches_by_variant[variant],
                  dict(K4.rms_norm.launches_by_direction))
        out, rstd = k4_call(K4, variant, ins, G)
        grads = k4_backward(K4, variant, ins, g, rstd, G)
        again = [k4_backward(K4, variant, ins, g, rstd, G) for _ in range(2)]
        torch.cuda.synchronize()
        ref_out, ref_rstd, ref_grads = k4_reference(K4, variant, ins, g, G)
        if rstd.shape != ref_rstd.shape or tuple(rstd.shape) != tuple(
                out.shape[:-1]) + ((G,) if G > 1 else ()):
            raise AssertionError(f"[k4 check] {label}: rstd "
                                 f"{tuple(rstd.shape)}, not one a row and "
                                 f"group")
        if K4.rms_norm.launches_by_variant[variant] != before[0] + 4 or \
                K4.rms_norm.launches_by_direction != {
                    "forward": before[1]["forward"] + 1,
                    "backward": before[1]["backward"] + 3}:
            raise AssertionError(f"[k4 check] {label}: launches not counted")
        if dt == torch.bfloat16:
            d = (out.float() - ref_out.float()).abs()
            ok_out = bool((d <= 2.0 ** -7 * ref_out.float().abs()).all())
            out_err = float(d.max())
        else:
            out_err = float((out - ref_out).abs().max()
                            / ref_out.abs().max())
            ok_out = out_err < 1e-5
        rstd_err = float(((rstd - ref_rstd).abs() / ref_rstd).max())
        grad_errs = [float((a.float() - b.float()).abs().max()
                           / b.float().abs().max())
                     for a, b in zip(grads, ref_grads)]
        tol = K4_BF16_TOL if dt == torch.bfloat16 else K4_F32_TOL
        same = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                   for run in again for a, b in zip(grads, run))
        vec = "16 bytes" if _k4_vec(K4, variant, ins, G) > 1 \
            else "one element"
        print(f"[k4 check] {label} ({variant}, groups {G}, {dt}, scale "
              f"{case[3]}, "
              f"{tuple(out.shape)}, vector of {vec}): "
              f"out max |err| {out_err:.3g} (within one bf16 step: "
              f"{ok_out}), rstd {rstd_err:.3g}, gradients "
              f"{[f'{e:.3g}' for e in grad_errs]} (limit {tol:.3g}); "
              f"backward the same bits 3 times: {same}")
        if not (ok_out and rstd_err < 1e-5 and max(grad_errs) < tol
                and same and all(torch.isfinite(t).all() for t in grads)):
            raise AssertionError(f"[k4 check] {label} disagrees with K4's "
                                 f"plain version")
        worst["out"] = max(worst["out"], out_err)
        worst["rstd"] = max(worst["rstd"], rstd_err)
        worst["grad"] = max(worst["grad"], max(grad_errs))
    return worst


def _k4_vec(K4, variant, ins, groups: int = 1) -> int:
    """The vector K4's wrapper picks for ``ins``, in elements."""
    acts = [ins[0]] if variant == "plain" else [ins[0], ins[1], ins[3]]
    strides = K4.row_strides(*acts) if variant == "gated" \
        else K4.row_strides(ins[0], None, None)
    widths = (ins[0].shape[-1],) if variant == "plain" else (
        ins[0].shape[-1], ins[3].shape[-1] // groups)
    return K4._vec(acts + [ins[-1]], list(strides), ins[0].dtype, *widths)


def k4_timing(K4, flush) -> dict:
    """K4 at mamba2-2.7b's two norms (bf16) and at the published Zamba2-7B's
    grouped gated norm (``"gated_g2"``), each direction by CUDA events
    queued behind a spin, beside its bytes bound, the composed ops it
    replaces (its plain versions: the forward, and forward + backward
    under autograd) and, for the plain variant, PyTorch's own
    ``F.rms_norm`` (the same function; no PyTorch call computes the gated
    one) by the same clock."""
    out = {}
    for case in K4_CASES[:3:2] + K4_CASES[-1:]:
        label, variant = case[:2]
        G = k4_groups(case)
        key = variant if G == 1 else f"{variant}_g{G}"
        ins, g = k4_inputs(case, 7)
        fwd = queued_ms(lambda: k4_call(K4, variant, ins, G), TIMED_LAUNCHES,
                        flush)
        res, rstd = k4_call(K4, variant, ins, G)
        grads = k4_backward(K4, variant, ins, g, rstd, G)
        bwd = queued_ms(lambda: k4_backward(K4, variant, ins, g, rstd, G),
                        TIMED_LAUNCHES, flush)
        fwd_bound = K4.bound_ms(ins + [res, rstd])
        bwd_bound = K4.bound_ms([g, rstd] + ins + list(grads))
        grad_ins = [t.detach().requires_grad_(True) for t in ins]
        extra = () if variant == "plain" else (G,)
        reference = (K4.rms_norm_reference if variant == "plain"
                     else K4.gated_rms_norm_reference)
        plain_fwd = queued_ms(lambda: reference(*ins, 1e-5, *extra),
                              TIMED_LAUNCHES, flush)

        def plain_both():
            with torch.enable_grad():
                o = reference(*grad_ins, 1e-5, *extra)[0]
                torch.autograd.grad(o, grad_ins, g)
        plain_both_ms = queued_ms(plain_both, TIMED_LAUNCHES, flush)
        lib_ms = lib_both_ms = None
        library = "none (no PyTorch call computes this norm)"
        if variant == "plain":
            x, scale = ins
            F = torch.nn.functional
            lib_out = F.rms_norm(x, (x.shape[-1],), scale, 1e-5)
            d = (lib_out.float() - res.float()).abs()
            lib_ms = queued_ms(lambda: F.rms_norm(
                x, (x.shape[-1],), scale, 1e-5), TIMED_LAUNCHES, flush)

            def lib_both():
                with torch.enable_grad():
                    o = F.rms_norm(grad_ins[0], (x.shape[-1],), grad_ins[1],
                                   1e-5)
                    torch.autograd.grad(o, grad_ins, g)
            lib_both_ms = queued_ms(lib_both, TIMED_LAUNCHES, flush)
            library = (f"F.rms_norm forward {lib_ms:.4f} ms, forward + "
                       f"backward {lib_both_ms:.4f} ms (its output within "
                       f"one bf16 step of K4's: "
                       f"{bool((d <= 2.0 ** -7 * res.float().abs()).all())}"
                       f", max |diff| {float(d.max()):.3g})")
        print(f"[k4 time] {label} {tuple(res.shape)} bf16, groups {G}: "
              f"forward "
              f"{fwd:.4f} ms (bound {fwd_bound:.4f} ms by bytes, "
              f"{fwd_bound / fwd:.1%}), backward {bwd:.4f} ms (bound "
              f"{bwd_bound:.4f} ms, {bwd_bound / bwd:.1%}); the composed "
              f"ops: forward {plain_fwd:.4f} ms, forward + backward "
              f"{plain_both_ms:.4f} ms (K4 {fwd + bwd:.4f} ms); library: "
              f"{library}")
        out[key] = dict(ms=fwd, backward_ms=bwd, bound_ms=fwd_bound,
                            backward_bound_ms=bwd_bound, plain_ms=plain_fwd,
                            plain_fwd_bwd_ms=plain_both_ms, library_ms=lib_ms,
                            library_fwd_bwd_ms=lib_both_ms)
        del ins, g, res, rstd, grads, grad_ins
    return out


#: K5's cases on the card: (label, batch, rows, channels, type): the xs and
#: B / C convs of mamba2-2.7b (2048 rows) and of the published Zamba2-7B
#: (4096 rows), a batch-4 serve prefill of a ragged 37 rows, rows fewer
#: than W, channels off the forward's 8-byte vector, and f32
K5_CASES = (
    ("mamba2 xs", 1, MAMBA_SEQ, 5120, torch.bfloat16),
    ("mamba2 B/C", 1, MAMBA_SEQ, 128, torch.bfloat16),
    ("zamba2-7b-instruct xs", 1, INSTRUCT_SEQ, 7168, torch.bfloat16),
    ("zamba2-7b-instruct B/C", 1, INSTRUCT_SEQ, 128, torch.bfloat16),
    ("serve prefill xs", 4, 37, 7168, torch.bfloat16),
    ("serve prefill B/C", 4, 37, 128, torch.bfloat16),
    ("rows < W", 3, 2, 40, torch.bfloat16),
    ("channels 102", 2, 50, 102, torch.bfloat16),
    ("f32", 2, 300, 512, torch.float32),
)
#: K5 vs the composed ops' autograd, gradients: max |err| / max |ref|
#: (bf16: dpre and dx's four products in another order, dw's and db's rows
#: summed in another order, each rounded once; f32: the orders alone)
K5_BF16_TOL = 2.0 ** -7
K5_F32_TOL = 1e-4


def k5_inputs(B, S, C, dtype, seed: int) -> tuple:
    """x (B, S, C), the taps (C, 4) at the init's scale, a bias, and the
    output's gradient, on the card, from the seed."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ins = [_rand(g, (B, S, C), dtype),
           (_rand(g, (C, 4), torch.float32) / 2).to(dtype),
           (0.1 * _rand(g, (C,), torch.float32)).to(dtype)]
    return ins, _rand(g, (B, S, C), dtype)


def bf16_steps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance of two bf16 tensors in bf16 steps."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def k5_checks(K5) -> dict:
    """K5 against the composed ops it replaces (``models.ssm._causal_conv``
    then ``F.silu``, and autograd through them) on every ``K5_CASES`` case:
    the forward their bits, or each differing element within one bf16 step
    (the count printed; f32: 1e-6 of the largest), each gradient within
    ``K5_BF16_TOL`` / ``K5_F32_TOL`` of its largest, the backward the same
    bits three times, one launch counted a call and direction.  Returns the
    worst figures."""
    from repro_torch.models import ssm as S
    F = torch.nn.functional
    worst = {"forward_differ": 0, "forward_steps": 0, "grad": 0.0}
    for i, (label, B, Sq, C, dt) in enumerate(K5_CASES):
        ins, g = k5_inputs(B, Sq, C, dt, 60 + i)
        grad_ins = [t.detach().requires_grad_(True) for t in ins]
        k5 = K5.causal_conv_silu
        before = dict(k5.launches_by_direction)
        with torch.enable_grad():
            out = k5(*grad_ins)
            grads = torch.autograd.grad(out, grad_ins, g)
            ref = F.silu(S._causal_conv(*grad_ins))
            ref_grads = torch.autograd.grad(ref, grad_ins, g)
        again = [k5.backward(g, *ins) for _ in range(2)]
        torch.cuda.synchronize()
        if k5.launches_by_direction != {"forward": before["forward"] + 1,
                                        "backward": before["backward"] + 3}:
            raise AssertionError(f"[k5 check] {label}: launches not counted")
        if dt == torch.bfloat16:
            steps = bf16_steps(out, ref)
            differ, most = int((steps > 0).sum()), int(steps.max())
            ok_out = most <= 1
            fwd = f"{differ} of {out.numel()} elements differ, at most {most}"
            worst["forward_differ"] += differ
            worst["forward_steps"] = max(worst["forward_steps"], most)
        else:
            err = float((out - ref).abs().max() / ref.abs().max())
            ok_out, fwd = err < 1e-6, f"max |err| / max {err:.3g}"
        errs = [float((a.float() - b.float()).abs().max()
                      / b.float().abs().max())
                for a, b in zip(grads, ref_grads)]
        tol = K5_BF16_TOL if dt == torch.bfloat16 else K5_F32_TOL
        same = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                   for run in again for a, b in zip(grads, run))
        vec = [K5.vector(d, dt, C, [ins[0]], ins[0].stride()[:2])
               for d in K5.DIRECTIONS]
        print(f"[k5 check] {label} ({B}, {Sq}, {C}) {dt}, vectors of "
              f"{vec[0]} / {vec[1]} elements: forward {fwd} (bf16 steps); "
              f"gradients dx, dw, db {[f'{e:.3g}' for e in errs]} (limit "
              f"{tol:.3g}); backward the same bits 3 times: {same}")
        if not (ok_out and max(errs) < tol and same
                and all(torch.isfinite(t).all() for t in grads)):
            raise AssertionError(f"[k5 check] {label} disagrees with the "
                                 f"composed ops")
        worst["grad"] = max(worst["grad"], max(errs))
    return worst


def k5_timing(K5, flush) -> dict:
    """K5 at the main path's convs (mamba2-2.7b's xs and B/C at 2048 rows,
    the published Zamba2-7B's xs at 4096), bf16: each direction's device
    time by ``torch.profiler`` (the mean of ``TIMED_LAUNCHES`` calls, each
    after an L2 flush; the backward's two kernels summed) beside its bytes
    bound; the composed ops it replaces (forward, and forward + backward
    under autograd) and the library call that computes the same function,
    ``F.conv1d(groups=C)`` with ``F.silu`` (its output against K5's; only
    this script calls it), by CUDA events queued behind a spin."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import ssm as S
    F = torch.nn.functional
    out = {}
    for key, B, Sq, C in (("mamba2_xs", 1, MAMBA_SEQ, 5120),
                          ("mamba2_bc", 1, MAMBA_SEQ, 128),
                          ("zamba2_instruct_xs", 1, INSTRUCT_SEQ, 7168)):
        ins, g = k5_inputs(B, Sq, C, torch.bfloat16, 9)
        x, w, b = ins
        k5 = K5.causal_conv_silu
        res = k5.forward(*ins)
        grads = k5.backward(g, *ins)
        fwd_bound = K5.bound_ms([x, res])
        bwd_bound = K5.bound_ms([g, x] + grads)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TIMED_LAUNCHES):
                flush.zero_()
                k5.forward(*ins)
                flush.zero_()
                k5.backward(g, *ins)
            torch.cuda.synchronize()
        seen = {"conv_fwd": [], "conv_bwd": [], "conv_col_sum": []}
        for e in device_events(prof):
            for name in seen:
                if name in e.name():
                    seen[name].append(e.duration_ns() / 1e6)
        mean = {k: sum(v) / len(v) if v else float("nan")
                for k, v in seen.items()}
        dev_fwd, dev_bwd = mean["conv_fwd"], mean["conv_bwd"] \
            + mean["conv_col_sum"]
        grad_ins = [t.detach().requires_grad_(True) for t in ins]
        plain_fwd = queued_ms(lambda: F.silu(S._causal_conv(*ins)),
                              TIMED_LAUNCHES, flush)

        def plain_both():
            with torch.enable_grad():
                o = F.silu(S._causal_conv(*grad_ins))
                torch.autograd.grad(o, grad_ins, g)

        def library(x, w, b):
            y = F.conv1d(x.transpose(1, 2), w[:, None, :], b,
                         padding=w.shape[1] - 1, groups=C)[..., :Sq]
            return F.silu(y).transpose(1, 2)

        def lib_both():
            with torch.enable_grad():
                o = library(*grad_ins)
                torch.autograd.grad(o, grad_ins, g)
        plain_both_ms = queued_ms(plain_both, TIMED_LAUNCHES, flush)
        lib_ms = queued_ms(lambda: library(*ins), TIMED_LAUNCHES, flush)
        lib_both_ms = queued_ms(lib_both, TIMED_LAUNCHES, flush)
        lib_steps = bf16_steps(library(*ins), res)
        print(f"[k5 time] {key} ({B}, {Sq}, {C}) bf16: forward device "
              f"{dev_fwd:.4f} ms (bound {fwd_bound:.4f} ms by bytes, "
              f"{fwd_bound / dev_fwd:.1%}), backward device {dev_bwd:.4f} ms"
              f" (conv_bwd {mean['conv_bwd']:.4f} + conv_col_sum "
              f"{mean['conv_col_sum']:.4f}; bound {bwd_bound:.4f} ms, "
              f"{bwd_bound / dev_bwd:.1%}); kernels recorded "
              f"{ {k: len(v) for k, v in seen.items()} }; the composed ops: "
              f"forward {plain_fwd:.4f} ms, forward + backward "
              f"{plain_both_ms:.4f} ms (K5 {dev_fwd + dev_bwd:.4f} ms); library "
              f"F.conv1d(groups=C) + F.silu: forward {lib_ms:.4f} ms, "
              f"forward + backward {lib_both_ms:.4f} ms (its output within "
              f"{int(lib_steps.max())} bf16 steps of K5's, "
              f"{int((lib_steps > 0).sum())} elements differ)")
        out[key] = dict(device_ms=dev_fwd, backward_device_ms=dev_bwd,
                        bound_ms=fwd_bound, backward_bound_ms=bwd_bound,
                        plain_ms=plain_fwd,
                        plain_fwd_bwd_ms=plain_both_ms, library_ms=lib_ms,
                        library_fwd_bwd_ms=lib_both_ms)
        del ins, g, res, grads, grad_ins
    return out


#: K6's cases on the card: (label, rows, V, vocab size, softcap, type):
#: mamba2-2.7b's head as the port pads it (the cells') and at the
#: published vocabulary (rows off the 16-byte grid), the published
#: Zamba2-7B's (4096 tokens), gemma2-2b's softcap over padded columns, f32
K6_CASES = (
    ("mamba2", MAMBA_SEQ, 50_432, 50_277, 0.0, torch.bfloat16),
    ("mamba2 unaligned", MAMBA_SEQ, 50_277, 50_277, 0.0, torch.bfloat16),
    ("zamba2-7b-instruct", INSTRUCT_SEQ, 32_000, 32_000, 0.0,
     torch.bfloat16),
    ("gemma2 softcap", 512, 256_000, 255_900, 30.0, torch.bfloat16),
    ("f32", 300, 5_003, 4_999, 0.0, torch.float32),
)
#: K6 vs the composed ops: the nll's and lse's relative error; dh in bf16
#: steps (f32: relative to each element)
K6_NLL_TOL = 1e-5
K6_F32_TOL = 1e-5


def k6_inputs(rows, V, vocab, dtype, seed: int, pad: bool = True) -> tuple:
    """The head's product h (rows, V), labels below ``vocab`` (every fifth
    row padding when ``pad``), and the nll's gradient as the mean loss
    gives it, on the card, from the seed."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = (2 * _rand(g, (rows, V), torch.float32)).to(dtype)
    labels = torch.randint(0, vocab, (rows,), generator=g, device="cuda",
                           dtype=torch.int32)
    if pad:
        labels[::5] = -1
    dnll = torch.where(labels >= 0, 1.0 / rows, 0.0)
    return h, labels, dnll


def k6_checks(K6) -> dict:
    """K6 against the composed ops it replaces
    (``K6.cross_entropy_reference``, which ``models.layers`` runs, and
    autograd through it) on every ``K6_CASES`` case: the nll and lse within
    ``K6_NLL_TOL`` (relative), dh within one bf16 step (f32: ``K6_F32_TOL``
    of each element), the padded columns' dh 0, the backward the same bits
    three times, one launch counted a call and direction.  Returns the
    worst figures."""
    ce = K6.cross_entropy
    worst = {"nll": 0.0, "dh_steps": 0, "dh_differ": 0}
    for i, (label, rows, V, vocab, cap, dt) in enumerate(K6_CASES):
        h, labels, g = k6_inputs(rows, V, vocab, dt, 70 + i)
        before = dict(ce.launches_by_direction)
        with torch.enable_grad():
            hg = h.clone().requires_grad_(True)
            nll = ce(hg, labels, vocab, cap)
            (dh,) = torch.autograd.grad(nll, hg, g)
            hr = h.clone().requires_grad_(True)
            ref_lse, ref = K6.cross_entropy_reference(hr, labels, vocab, cap)
            (ref_dh,) = torch.autograd.grad(ref, hr, g)
        lse, _ = ce.forward(h, labels, vocab, cap)
        again = [ce.backward(g, h, lse, labels, vocab, cap)
                 for _ in range(2)]
        torch.cuda.synchronize()
        if ce.launches_by_direction != {"forward": before["forward"] + 2,
                                        "backward": before["backward"] + 3}:
            raise AssertionError(f"[k6 check] {label}: launches not counted")
        nll, ref = nll.detach(), ref.detach()
        err = float(((nll - ref).abs() / ref.abs()).max())
        lse_err = float(((lse - ref_lse).abs() / ref_lse.abs()).max())
        if dt == torch.bfloat16:
            steps = bf16_steps(dh, ref_dh)
            differ, most = int((steps > 0).sum()), int(steps.max())
            ok_dh = most <= 1
            dh_note = (f"{differ} of {dh.numel()} elements differ, at most "
                       f"{most} bf16 step")
            worst["dh_steps"] = max(worst["dh_steps"], most)
            worst["dh_differ"] += differ
        else:
            rel = float(((dh - ref_dh).abs()
                         / (ref_dh.abs() + 1e-30)).max())
            ok_dh = bool(((dh - ref_dh).abs()
                          <= K6_F32_TOL * ref_dh.abs() + 1e-12).all())
            dh_note = f"max relative error {rel:.3g}"
        same = all(torch.equal(run.view(torch.uint8), dh.view(torch.uint8))
                   for run in again)
        pad_zero = bool((dh[:, vocab:] == 0).all())
        print(f"[k6 check] {label} ({rows}, {V}) vocab {vocab} softcap {cap} "
              f"{dt}: nll max relative error {err:.3g}, lse {lse_err:.3g} "
              f"(limit {K6_NLL_TOL:.0e}); dh {dh_note}; padded columns 0: "
              f"{pad_zero}; backward the same bits 3 times: {same}")
        if not (err <= K6_NLL_TOL and lse_err <= K6_NLL_TOL and ok_dh
                and same and pad_zero and bool(torch.isfinite(dh).all())):
            raise AssertionError(f"[k6 check] {label} disagrees with the "
                                 f"composed ops")
        worst["nll"] = max(worst["nll"], err, lse_err)
        del h, labels, g, hg, hr, nll, dh, ref, ref_dh, again
        torch.cuda.empty_cache()
    return worst


def k6_timing(K6, flush) -> dict:
    """K6 at the cells' heads (mamba2-2.7b's 2048 x 50,432 with 50,277
    tokens kept, the published Zamba2-7B's 4096 x 32,000) and at mamba2's
    published 50,277 columns (rows off the 16-byte grid), bf16: each
    direction's device time by ``torch.profiler`` (the mean of
    ``TIMED_LAUNCHES`` calls, each after an L2 flush) beside its bytes
    bound; the composed ops it replaces (forward, and forward + backward
    under autograd) and the library call on the f32 logits they make,
    ``F.cross_entropy`` (only this script calls it; forward, and forward +
    backward), by CUDA events queued behind a spin."""
    from torch.profiler import ProfilerActivity, profile
    F = torch.nn.functional
    ce = K6.cross_entropy
    out = {}
    for key, rows, V, vocab in (("mamba2", MAMBA_SEQ, 50_432, 50_277),
                                ("mamba2_unaligned", MAMBA_SEQ, 50_277,
                                 50_277),
                                ("zamba2_instruct", INSTRUCT_SEQ, 32_000,
                                 32_000)):
        h, labels, g = k6_inputs(rows, V, vocab, torch.bfloat16, 11,
                                 pad=False)
        lse, nll = ce.forward(h, labels, vocab, 0.0)
        dh = ce.backward(g, h, lse, labels, vocab, 0.0)
        fwd_bound = K6.bound_ms([h, labels, lse, nll])
        bwd_bound = K6.bound_ms([g, h, lse, labels, dh])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TIMED_LAUNCHES):
                flush.zero_()
                ce.forward(h, labels, vocab, 0.0)
                flush.zero_()
                ce.backward(g, h, lse, labels, vocab, 0.0)
            torch.cuda.synchronize()
        seen = {"ce_fwd": [], "ce_bwd": []}
        for e in device_events(prof):
            for name in seen:
                if name in e.name():
                    seen[name].append(e.duration_ns() / 1e6)
        mean = {k: sum(v) / len(v) if v else float("nan")
                for k, v in seen.items()}
        dev_fwd, dev_bwd = mean["ce_fwd"], mean["ce_bwd"]
        hg = h.clone().requires_grad_(True)
        plain_fwd = queued_ms(
            lambda: K6.cross_entropy_reference(h, labels, vocab, 0.0),
            TIMED_LAUNCHES, flush)

        def plain_both():
            with torch.enable_grad():
                _, o = K6.cross_entropy_reference(hg, labels, vocab, 0.0)
                torch.autograd.grad(o, hg, g)
        logits = K6.logits_reference(h, 0.0)[:, :vocab]
        lg = logits.clone().requires_grad_(True)
        target = labels.long()

        def library():
            return F.cross_entropy(logits, target, reduction="none")

        def lib_both():
            with torch.enable_grad():
                o = F.cross_entropy(lg, target, reduction="none")
                torch.autograd.grad(o, lg, g)
        plain_both_ms = queued_ms(plain_both, TIMED_LAUNCHES, flush)
        lib_ms = queued_ms(library, TIMED_LAUNCHES, flush)
        lib_both_ms = queued_ms(lib_both, TIMED_LAUNCHES, flush)
        lib_err = float(((library() - nll).abs() / nll.abs()).max())
        print(f"[k6 time] {key} ({rows}, {V}) vocab {vocab} bf16: forward "
              f"device {dev_fwd:.4f} ms (bound {fwd_bound:.4f} ms by bytes, "
              f"{fwd_bound / dev_fwd:.1%}), backward device {dev_bwd:.4f} ms"
              f" (bound {bwd_bound:.4f} ms, {bwd_bound / dev_bwd:.1%}); "
              f"kernels recorded { {k: len(v) for k, v in seen.items()} }; "
              f"the composed ops: forward {plain_fwd:.4f} ms, forward + "
              f"backward {plain_both_ms:.4f} ms (K6 {dev_fwd + dev_bwd:.4f} "
              f"ms); library F.cross_entropy on the f32 logits: forward "
              f"{lib_ms:.4f} ms, forward + backward {lib_both_ms:.4f} ms (its "
              f"nll within {lib_err:.3g} of K6's)")
        out[key] = dict(device_ms=dev_fwd, backward_device_ms=dev_bwd,
                        bound_ms=fwd_bound, backward_bound_ms=bwd_bound,
                        plain_ms=plain_fwd, plain_fwd_bwd_ms=plain_both_ms,
                        library_ms=lib_ms, library_fwd_bwd_ms=lib_both_ms)
        del h, labels, g, lse, nll, dh, hg, logits, lg
        torch.cuda.empty_cache()
    return out


def k6_check_steps(tag, run) -> None:
    """K6 launched once each way in every counted step of a
    ``trainer_phase`` run: the training loss."""
    want = {"forward": 1, "backward": 1}
    print(f"{tag} K6 launches a step {run['k6_per_step'][0]} (the loss)")
    if run["k6_per_step"] != [want] * TRAIN_STEPS:
        raise AssertionError(f"{tag} K6 launches per step "
                             f"{run['k6_per_step']}, expected {want}")


def trainer_phase(tag, cfg, seq, kernels, label, counter, fragment, Trainer,
                  TrainConfig, DataConfig, OptConfig, Tracer) -> dict:
    """The full trainer of ``cfg``: 5 instrumented steps of batch 1 x
    ``seq`` tokens on the card.  ``counter`` is the wrapper of the kernel
    the path runs once a layer (``label`` names it, ``fragment`` is a piece
    of its device-side name for the profiler).  Returns, besides, K2's and
    K3's launches by variant over the counted steps, and K4's, K5's and
    K6's by direction in each step."""
    from repro_torch.kernels.causal_conv import causal_conv_silu
    from repro_torch.kernels.cross_entropy import cross_entropy
    from repro_torch.kernels.rms_norm import rms_norm
    tr = Trainer(cfg, DataConfig(batch=1, seq_len=seq), OptConfig(),
                 TrainConfig(perftracker=False), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params, opt_state, _ = tr.init_state()
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated()
    print(f"{tag} {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, batch 1 x {seq} "
          f"tokens; init {time.perf_counter() - t:.2f} s, state "
          f"{state_bytes} bytes on the card")
    # the step's cost, counted once per bundle (Trainer.ensure_bundle)
    # before any timed span: one extra forward and backward
    t = time.perf_counter()
    bundle = tr.ensure_bundle(params, tr._batch(tr.source.batch_at(0)))
    torch.cuda.synchronize()
    count_s = time.perf_counter() - t
    cost = step_cost_line(tag, cfg, seq, bundle, count_s)
    torch.cuda.reset_peak_memory_stats()     # the steps' peak, not the count's
    tracer = Tracer(worker=0)
    tracer.start_window()
    reset_counts(*kernels)
    per_step, rows, aux, k4_steps, k5_steps, k6_steps = [], [], [], [], [], []
    for i in range(TRAIN_STEPS):
        before = counter.launches
        k4_before = dict(rms_norm.launches_by_direction)
        k5_before = dict(causal_conv_silu.launches_by_direction)
        k6_before = dict(cross_entropy.launches_by_direction)
        params, opt_state, m = tr.train_iteration(params, opt_state,
                                                  tracer=tracer)
        per_step.append(counter.launches - before)
        k4_steps.append({d: rms_norm.launches_by_direction[d] - k4_before[d]
                         for d in k4_before})
        k5_steps.append({d: causal_conv_silu.launches_by_direction[d]
                         - k5_before[d] for d in k5_before})
        k6_steps.append({d: cross_entropy.launches_by_direction[d]
                         - k6_before[d] for d in k6_before})
        rows.append((float(m["loss"]), float(m["grad_norm"])))
        aux.append(float(m["aux"]))
    launches = counter.launches
    by_variant = dict(getattr(counter, "launches_by_variant", {}))
    k2_k3 = tuple(dict(w.launches_by_variant)
                  for w in (kernels[1].flash_attention, kernels[2].ssd_scan))
    k4_by_variant = dict(rms_norm.launches_by_variant)
    prof = tracer.stop_window()
    peak = torch.cuda.max_memory_allocated()
    top = sorted((e for e in prof.events if e.depth == 1),
                 key=lambda e: e.start)
    names = [e.name for e in top]
    if names != ["dataloader.next", "train.step",
                 "optimizer.step"] * TRAIN_STEPS:
        raise AssertionError(f"trainer phases {names}")
    check_step_split(tag, prof, top)
    steps = []
    for i, (loss, gnorm) in enumerate(rows):
        d, s, o = (top[3 * i + j].duration for j in range(3))
        steps.append(dict(dataloader_next_s=d, train_step_s=s,
                          optimizer_step_s=o, loss=loss, grad_norm=gnorm))
        aux_note = f" (aux {aux[i]:.6f})" if cfg.is_moe else ""
        print(f"{tag} step {i + 1}: dataloader.next {d:.4f} s, "
              f"train.step {s:.4f} s, optimizer.step {o:.4f} s; loss "
              f"{loss:.4f}{aux_note} grad norm {gnorm:.4f}; {label} launches "
              f"{per_step[i]}, K4 {k4_steps[i]}, K5 {k5_steps[i]}, K6 "
              f"{k6_steps[i]}; max memory "
              f"allocated {peak} bytes")
    if not all(math.isfinite(x) for r in rows for x in r):
        raise AssertionError("trainer loss or grad norm not finite")
    if cfg.is_moe and not all(math.isfinite(a) and a > 0 for a in aux):
        raise AssertionError(f"MoE aux losses {aux}")
    if per_step != [cfg.num_layers] * TRAIN_STEPS:
        raise AssertionError(f"{label} launches per step {per_step}, "
                             f"expected {cfg.num_layers}")
    profile = step_profile(tr, params, opt_state, tag, label, fragment)
    tr.loader.close()
    del tr, params, opt_state, m
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, by_variant=by_variant, steps=steps,
                peak=peak, state_bytes=state_bytes, profile=profile, aux=aux,
                k2_by_variant=k2_k3[0], k3_by_variant=k2_k3[1], cost=cost,
                step_cost=bundle.cost, k4_per_step=k4_steps,
                k4_by_variant=k4_by_variant, k5_per_step=k5_steps,
                k6_per_step=k6_steps)


def k5_check_steps(tag, run, mamba_layers: int) -> None:
    """K5 launched three times a mamba layer (xs, B, C) each way in every
    counted step of a ``trainer_phase`` run."""
    want = {"forward": 3 * mamba_layers, "backward": 3 * mamba_layers}
    print(f"{tag} K5 launches a step {run['k5_per_step'][0]} (xs, B and C "
          f"of each of {mamba_layers} mamba layers, each way)")
    if run["k5_per_step"] != [want] * TRAIN_STEPS:
        raise AssertionError(f"{tag} K5 launches per step "
                             f"{run['k5_per_step']}, expected {want}")


def step_cost_line(tag, cfg, seq, bundle, count_s) -> dict:
    """``[step cost]``: what ``launch.step_cost`` counted for the trainer's
    step (FLOPs, bytes, collectives, ``gemm_frac``), the seconds the count
    took, and the step's FLOPs over ``model_flops`` (6 N D)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.analysis import model_flops
    cost = bundle.cost
    if cost is None or bundle.gemm_frac is None:
        raise AssertionError(f"{tag} the step's cost was not counted")
    mf = model_flops(cfg, ShapeConfig("trainer", seq, 1, "train"))
    out = dict(flops=cost.flops, bytes=cost.bytes,
               coll_counts=dict(cost.coll_counts),
               coll_bytes=dict(cost.coll_bytes), gemm_frac=bundle.gemm_frac,
               count_s=count_s, model_flops=mf, ratio=cost.flops / mf,
               detail_flops=dict(cost.detail_flops))
    print(f"[step cost] {cfg.name} {cfg.num_layers} layers, 1 x {seq} "
          f"tokens: {cost.flops:.6g} FLOPs ({', '.join(f'{k} {v:.6g}' for k, v in sorted(cost.detail_flops.items()))}), "
          f"{cost.bytes:.6g} bytes, collectives {out['coll_counts']} "
          f"{out['coll_bytes']}; gemm_frac {bundle.gemm_frac:.4f}; counted "
          f"in {count_s:.2f} s; FLOPs / model_flops (6 N D = {mf:.6g}) "
          f"{out['ratio']:.4f}")
    if not (0.05 <= bundle.gemm_frac <= 0.95 and cost.flops > 0):
        raise AssertionError(f"{tag} step cost {out}")
    return out


def check_step_split(tag, prof, top) -> None:
    """Each fenced ``train.step`` holds one ``xla.gemm`` then one
    ``xla.other`` at depth 2, within its bounds (the reference's
    cost-model split)."""
    steps = [e for e in top if e.name == "train.step"]
    gemm = sorted((e for e in prof.events if e.name == "xla.gemm"),
                  key=lambda e: e.start)
    other = sorted((e for e in prof.events if e.name == "xla.other"),
                   key=lambda e: e.start)
    if not len(gemm) == len(other) == len(steps):
        raise AssertionError(f"{tag} {len(steps)} train.step, {len(gemm)} "
                             f"xla.gemm, {len(other)} xla.other")
    for st, g, o in zip(steps, gemm, other):
        if not (g.depth == o.depth == 2
                and st.start <= g.start < g.end <= o.start < o.end
                <= st.end):
            raise AssertionError(f"{tag} xla.gemm / xla.other outside "
                                 f"train.step")
    print(f"[step cost] {tag} each of the {len(steps)} train.step spans "
          f"holds one xla.gemm then one xla.other at depth 2: gemm "
          f"{[round(g.duration, 4) for g in gemm]} s, other "
          f"{[round(o.duration, 4) for o in other]} s")


#: kernel-name fragments of the matrix products (cuBLAS / CUTLASS kernels)
GEMM_NAMES = ("gemm", "Gemm", "GEMM", "cutlass", "xmma", "cublas", "nvjet")


def device_events(prof) -> list:
    """The raw device activities (kernels, copies, fills) of a
    ``torch.profiler`` trace, read without building the op tree that
    ``key_averages()`` builds (at mamba2-2.7b's 64 layers that took 29 s on
    the host)."""
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation()]


def device_ms_by_name(prof) -> dict:
    """Device milliseconds by kernel name in a ``torch.profiler`` trace."""
    by_name = {}
    for e in device_events(prof):
        by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns() / 1e6
    return by_name


def step_profile(tr, params, opt_state, tag, label, fragment) -> dict:
    """One more full-depth step (after the counted ones) under
    ``torch.profiler``: device busy time by kernel class against the step's
    wall time, whose difference is the card's idle share."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        tr.train_iteration(params, opt_state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    by_name = device_ms_by_name(prof)
    busy = sum(by_name.values())
    own = sum(v for k, v in by_name.items() if fragment in k)
    gemm = sum(v for k, v in by_name.items()
               if any(g in k for g in GEMM_NAMES))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    ptag = tag.replace("trainer", "profile")
    print(f"{ptag} reading the trace took {time.perf_counter() - t:.1f} s")
    if busy == 0:
        print(f"{ptag} the profiler recorded no device time: not measured")
    else:
        print(f"{ptag} one more step under torch.profiler: wall "
              f"{wall_ms:.2f} ms, device busy {busy:.2f} ms (idle share "
              f"{1 - busy / wall_ms:.2%}); {label} {own:.2f} ms, GEMM "
              f"kernels {gemm:.2f} ms, other kernels "
              f"{busy - own - gemm:.2f} ms")
        for name, ms in top:
            print(f"{ptag}   {ms:9.3f} ms  {name[:110]}")
    return dict(wall_ms=wall_ms, busy_ms=busy, kernel_ms=own, gemm_ms=gemm)


def trainer_fleet_phase(K, K2, K3, ARCHS, TrainerWorkload, DataloaderBurn,
                        StepThrottle, TrainConfig, DataConfig, OptConfig,
                        PerfTrackerService, plan_mitigations,
                        summarize_profile) -> dict:
    """Four full-width gemma2-2b trainers cut to 2 layers (one local/global
    pair), one window under each live fault, diagnosed on the card."""
    cfg = ARCHS["gemma2-2b"].with_overrides(num_layers=2)
    setup = (cfg, DataConfig(batch=1, seq_len=TRAIN_SEQ), OptConfig(),
             TrainConfig(perftracker=False))
    wl = TrainerWorkload(n_workers=4, setup=setup, device="cuda")
    t = time.perf_counter()
    wl._ensure_workers()
    print(f"[trainer fleet] 4 workers x gemma2-2b at 2 layers: warm-up "
          f"{time.perf_counter() - t:.2f} s, base iteration "
          f"{wl.base_iter_s:.4f} s, memory allocated "
          f"{torch.cuda.memory_allocated()} bytes")
    out = {}
    cases = [(DataloaderBurn(workers=(1,)), ("dataloader.next",), [1],
              "migrate_dataloader"),
             (StepThrottle(workers=(2,)), STEP_PHASES, [2],
              "replace_hosts")]
    for i, (fault, fns, workers, action) in enumerate(cases):
        name = type(fault).__name__
        reset_counts(K, K2, K3)
        wd = wl.run_window(i, [fault], FLEET_ITERS, None)
        k2 = K2.flash_attention.launches
        k2_wgmma = K2.flash_attention.launches_by_variant["wgmma"]
        samples = [len(p.streams["cpu"].values) for p in wd.profiles]
        for fname in ("dataloader.next", "train.step", "xla.gemm",
                      "xla.other", "optimizer.step"):
            pats = [summarize_profile(p, backend="numpy")[0][fname]
                    for p in wd.profiles]
            bms = [tuple(round(float(x), 4) for x in (p.beta, p.mu, p.sigma))
                   for p in pats]
            print(f"[trainer fleet] {name} {fname} (beta, mu, sigma) per "
                  f"worker: {bms}")
        svc = PerfTrackerService(family="host")
        reset_counts(K, K2, K3)
        res = svc.diagnose_profiles(wd.profiles)
        k1 = K.pattern_summary.launches
        flagged = {d.abnormality.function: d.abnormality.workers.tolist()
                   for d in res.diagnoses}
        rules = {d.abnormality.function: d.abnormality.reason
                 for d in res.diagnoses}
        plans = [(p.action.value, list(p.workers))
                 for p in plan_mitigations(res.diagnoses, 4)]
        print(f"[trainer fleet] {name}{fault.workers}: K2 launches {k2} "
              f"({k2_wgmma} wgmma); cpu "
              f"samples per worker {samples}; backend "
              f"{svc.summarize_backend.name}, K1 launches {k1}; flagged "
              f"{flagged} by rule {rules}; plans {plans}")
        if k2 != cfg.num_layers * 4 * FLEET_ITERS or k2_wgmma != k2:
            raise AssertionError(f"K2 launches in the window {k2}, "
                                 f"{k2_wgmma} of them wgmma")
        hit = [f for f in fns if flagged.get(f) == workers]
        print(f"[trainer fleet] {name}{fault.workers} fires on {hit} of "
              f"{list(fns)} (gemm_frac {wl.workers[0].trainer.bundle.gemm_frac:.4f})")
        planned = any(a == action and w in ([], workers) for a, w in plans)
        if not hit or not planned or k1 == 0:
            raise AssertionError(f"{name} not localized to {fns} on "
                                 f"{workers} with {action}")
        out[name] = dict(flagged=flagged, plans=plans, samples=samples,
                         fired=hit)
    wl.close()
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- the online loop: catalog, paper-window fleet, real rollback ---------------

ONLINE_FLEET_W = 256         # the paper's window over 256 workers ...
ONLINE_FLEET_STANDBY = 16    # ... plus a standby pool
ONLINE_FLEET_WINDOWS = 8
ONLINE_FLEET_FAULTY = (3, 129)
ROLLBACK_WINDOWS = 8
#: full-width trainers in the rollback: the restore holds the fleet's state
#: on the card twice (live and restored), 2 x 10.4 GB each
ROLLBACK_WORKERS = 2


class ObservedK1:
    """The ``cuda`` summarize backend, observed: each call goes to a
    ``CudaBackend`` as the path's does, and the observer adds the call's
    rows by K1 path (``path_masks``), K1's result on the rows with several
    runs (the rows ``k1_warp_general`` takes) held against the plain
    version on the card, and K1's device time on the same input: CUDA
    events around a second launch, queued behind a spin kernel so that the
    GPU runs the events and K1's memset and two kernels back to back and no
    host time falls between them (per-tick ``torch.profiler`` traces lost
    K1 kernels on the card).  ``timed=False`` leaves the second launch out,
    so a path observed that way keeps its own launch counts."""

    name = "cuda"
    SPIN_CYCLES = 1_000_000      # ~0.5 ms of GPU spin: longer than the enqueue

    def __init__(self, K, timed: bool = True):
        from repro_torch.summarize.backends import CudaBackend
        self.K, self.backend, self.timed = K, CudaBackend(), timed
        self.rows = dict.fromkeys(("all_zero", "one_run", "general"), 0)
        self.general_mismatch, self.general_err = 0, 0.0
        self.k1_ms = 0.0

    def batch_stats(self, u: np.ndarray) -> np.ndarray:
        out = self.backend.batch_stats(u)
        t = torch.from_numpy(np.ascontiguousarray(u, np.float32)).cuda()
        if self.timed:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(self.SPIN_CYCLES)
            start.record()
            self.K.pattern_summary(t)
            end.record()
            end.synchronize()
            self.k1_ms += start.elapsed_time(end)
        zero, one = path_masks(u)
        general = ~zero & ~one
        for key, m in (("all_zero", zero), ("one_run", one),
                       ("general", general)):
            self.rows[key] += int(m.sum())
        if general.any():
            ref = self.K.pattern_summary_reference(t[torch.from_numpy(
                general).cuda()]).cpu().numpy()
            got = out[general]
            self.general_mismatch += int((got[:, 2] != ref[:, 2]).sum())
            self.general_err = max(self.general_err, float(
                np.abs(got[:, :2] - ref[:, :2]).max()))
        return out


class TickWatch:
    """While active, each ``OnlinePipeline.window_tick`` records K1's
    launches by variant during the tick, its ``summarize_s`` and
    ``localize_s``, and what ``observer`` (an ``ObservedK1``) saw in it:
    rows by path and K1's device time."""

    def __init__(self, K, observer=None):
        self.K, self.observer = K, observer
        self.ticks: list = []

    def __enter__(self):
        from repro_torch.online.pipeline import OnlinePipeline
        self._cls, self._orig = OnlinePipeline, OnlinePipeline.window_tick
        watch = self

        def tick(pipe, *args, **kwargs):
            return watch._tick(pipe, args, kwargs)
        OnlinePipeline.window_tick = tick
        return self

    def __exit__(self, *exc):
        self._cls.window_tick = self._orig

    def _tick(self, pipe, args, kwargs):
        ps, obs = self.K.pattern_summary, self.observer
        before = dict(ps.launches_by_variant)
        rows, ms = (dict(obs.rows), obs.k1_ms) if obs else (None, None)
        report = self._orig(pipe, *args, **kwargs)
        self.ticks.append(dict(
            launches={v: ps.launches_by_variant[v] - before[v]
                      for v in before},
            rows=(None if obs is None else
                  {k: obs.rows[k] - rows[k] for k in rows}),
            k1_ms=None if obs is None else obs.k1_ms - ms,
            summarize_s=report.summarize_s, localize_s=report.localize_s,
            states=[(i.id, i.state) for i in pipe.incidents.incidents]))
        return report

    def assert_warp_every_tick(self, what: str) -> None:
        for i, t in enumerate(self.ticks):
            if t["launches"]["warp"] < 1 or t["launches"]["block"]:
                raise AssertionError(f"{what} window {i}: K1 launches "
                                     f"{t['launches']}, expected warp only")


def online_trace(runner, res) -> dict:
    """What the online loop decided, window by window: diagnosed functions
    and workers, escalated sets, executed plans; every incident's life."""
    return {
        "windows": [([(d.abnormality.function,
                       d.abnormality.workers.tolist())
                      for d in r.diagnoses], list(r.escalated),
                     [str(m) for m in r.mitigations]) for r in res.reports],
        "incidents": [(i.id, i.function, i.channel, i.state, i.escalations,
                       list(i.workers), list(i.history),
                       [(t, p.action.value, list(p.workers))
                        for t, p in i.applied]) for i in res.incidents],
        "timeline": res.timeline(),
    }


def close_recovery(runner) -> None:
    """Remove the run's temporary checkpoint directory."""
    if runner.engine is not None and runner.engine.recovery is not None:
        runner.engine.recovery.close()


def online_catalog_phase(K, K2, K3) -> dict:
    """All 22 catalog scenarios through ``run_scenario(sc)`` on the card
    (counts reset before each), again with the backend observed (rows by
    K1 path, the general path's rows against the plain version), and on the
    host ``numpy`` backend: the same run window by window and the same
    ``evaluate`` rows, every row ``ok``."""
    from repro_torch.online.catalog import SCENARIOS, evaluate, run_scenario
    observer = ObservedK1(K)
    totals = dict.fromkeys(K.VARIANTS, 0)
    general_rows = 0
    for sc in SCENARIOS:
        reset_counts(K, K2, K3)
        with TickWatch(K) as watch:
            runner, res = run_scenario(sc)
        by_variant = dict(K.pattern_summary.launches_by_variant)
        if runner.pipeline.service.summarize_backend.name != "cuda":
            raise AssertionError("run_scenario's default backend is not cuda")
        watch.assert_warp_every_tick(sc.name)
        rows = evaluate(sc, runner, res)
        seen = dict(observer.rows)
        with TickWatch(K, observer) as owatch:
            orunner, ores = run_scenario(sc, summarize_backend=observer)
        host, host_res = run_scenario(sc, summarize_backend="numpy")
        trace = online_trace(runner, res)
        if trace != online_trace(host, host_res) \
                or trace != online_trace(orunner, ores) \
                or rows != evaluate(sc, host, host_res) \
                or not all(r["ok"] for r in rows):
            raise AssertionError(f"{sc.name}: the card's run differs from "
                                 f"the numpy run or misses its expectations "
                                 f"{rows}")
        for r in (runner, orunner, host):
            close_recovery(r)
        general = [t["rows"]["general"] for t in owatch.ticks]
        general_rows += sum(general)
        for v in totals:
            totals[v] += by_variant[v]
        first = ", ".join(f"{r['function']} -> {r['first_action']} "
                          f"(wtr {r['wtr']}, escalations "
                          f"{r['escalations']})" for r in rows)
        print(f"[online catalog] {sc.name} ({sc.fault_class}): {first}; "
              f"{sc.n_windows} windows, K1 launches {by_variant}; rows by "
              f"path {({k: observer.rows[k] - seen[k] for k in seen})}, "
              f"general rows by window {general}")
    if observer.general_mismatch or observer.general_err > ATOL:
        raise AssertionError(f"k1_warp_general disagrees with the plain "
                             f"version: {observer.general_mismatch} counts, "
                             f"err {observer.general_err}")
    print(f"[online catalog] 22 scenarios == numpy, every row ok; K1 "
          f"launches {totals}; rows that reached k1_warp_general "
          f"{general_rows}, against the plain version: "
          f"{observer.general_mismatch} count mismatches, max |mean/std "
          f"err| {observer.general_err:.3g}")
    return dict(launches=totals, general_rows=general_rows,
                general_err=observer.general_err)


def online_fleet_phase(K, K2, K3) -> dict:
    """One closed-loop scenario at the paper's window: W=256 + 16 standbys,
    20 s windows at 1 kHz base / 10 kHz escalated (at most 16 escalated),
    ``GpuThrottle`` on two workers from window 2, never removed.  Run on
    the card (counts reset before it), again observed and profiled per
    tick, and on the host ``numpy`` backend."""
    from repro_torch.core import faults as F
    from repro_torch.core.simulation import GEMM, SimConfig
    from repro_torch.online import (EscalationPolicy, ScenarioRunner,
                                    ScheduledFault)

    def runner(backend=None):
        return ScenarioRunner(
            SimConfig(n_workers=ONLINE_FLEET_W, window_s=20.0,
                      rate_hz=10000.0, seed=7,
                      n_standby=ONLINE_FLEET_STANDBY),
            [ScheduledFault(F.GpuThrottle(workers=ONLINE_FLEET_FAULTY), 2,
                            ONLINE_FLEET_WINDOWS)],
            n_windows=ONLINE_FLEET_WINDOWS,
            escalation=EscalationPolicy(
                n_workers=ONLINE_FLEET_W + ONLINE_FLEET_STANDBY,
                base_rate_hz=1000.0, full_rate_hz=10000.0, max_escalated=16),
            mitigation=True, summarize_backend=backend)

    reset_counts(K, K2, K3)
    main = runner()
    with TickWatch(K) as watch:
        res = main.run()
    by_variant = dict(K.pattern_summary.launches_by_variant)
    watch.assert_warp_every_tick("online fleet")
    observer = ObservedK1(K)
    observed = runner(observer)
    with TickWatch(K, observer) as owatch:
        ores = observed.run()
    host = runner("numpy")
    host_res = host.run()
    trace = online_trace(main, res)
    for i, (t, o) in enumerate(zip(watch.ticks, owatch.ticks)):
        print(f"[online fleet] window {i}: summarize_s "
              f"{t['summarize_s']:.4f} localize_s {t['localize_s']:.4f}; K1 "
              f"launches {t['launches']}; rows by path {o['rows']}; K1 "
              f"device {o['k1_ms']:.4f} ms (observed run); incidents "
              f"{t['states']}")
    gemm = [i for i in res.incidents if i.function == GEMM]
    mine = [m for m in main.engine.log if gemm and m.incident_id == gemm[0].id]
    if trace != online_trace(host, host_res) \
            or trace != online_trace(observed, ores) \
            or len(gemm) != 1 or gemm[0].state != "resolved" \
            or gemm[0].escalations or not mine \
            or mine[0].plan.action.value != "replace_hosts":
        raise AssertionError("the paper-window fleet did not resolve by "
                             "replace_hosts as its numpy run does")
    if observer.general_mismatch or observer.general_err > ATOL:
        raise AssertionError("k1_warp_general disagrees with the plain "
                             "version in the online fleet")
    for r in (main, observed, host):
        close_recovery(r)
    general = sum(o["rows"]["general"] for o in owatch.ticks)
    print(f"[online fleet] W={ONLINE_FLEET_W}+{ONLINE_FLEET_STANDBY}, 20 s "
          f"windows, 1/10 kHz: incident #{gemm[0].id} {GEMM} on "
          f"{list(gemm[0].workers_seen)} resolved by "
          f"{mine[0].plan.action.value} {mine[0].dropped} -> "
          f"{mine[0].replacements} in window {mine[0].window}, 0 "
          f"escalations; == numpy run; K1 launches {by_variant}; general "
          f"rows {general}")
    return dict(launches=by_variant, general_rows=general)


def host_tree(tree):
    """``tree`` with every tensor copied to the host."""
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_tree(v) for v in tree)
    return tree.detach().cpu().clone()


def online_rollback_phase(K, K2, K3, ARCHS) -> dict:
    """``ROLLBACK_WORKERS`` of the port's real trainers (``TrainerWorkload``)
    at gemma2-2b's full width cut to 2 layers on the card, under
    ``ParamCorruption(workers=(1,), nan=True)``, with the loop closed
    through ``RecoveryManager.for_workload`` (a save at window 0 only): the
    numerics incident must resolve by ``ROLLBACK_TO_CHECKPOINT`` with 0
    escalations, the verified rollback install what the checkpoint holds,
    the checkpoint hold the state taken at window 0 bit for bit (read back
    onto the host copy of that state), and K2 run in the training steps.
    The restore puts a second copy of the fleet's state on the card before
    it installs it, so the fleet's state must fit the card twice: 4 workers
    (10.4 GB each) do not.  Returns K1's launches by variant."""
    from repro_torch.ckpt.checkpoint import _flatten
    from repro_torch.ckpt.recovery import RecoveryManager
    from repro_torch.core.mitigation import Action
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.online import ScenarioRunner, ScheduledFault
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.loop import TrainConfig
    from repro_torch.train.workload import (ParamCorruption, TrainerWorkload,
                                            default_trainer_detector_cfg)

    cfg = ARCHS["gemma2-2b"].with_overrides(num_layers=2)
    setup = (cfg, DataConfig(batch=1, seq_len=TRAIN_SEQ), OptConfig(),
             TrainConfig(perftracker=False))
    wl = TrainerWorkload(n_workers=ROLLBACK_WORKERS, setup=setup,
                         device="cuda")
    wl._ensure_workers()
    state_bytes = torch.cuda.memory_allocated()
    # the state the window-0 save will take: nothing trains in between
    step0, tree0 = wl.snapshot_state()
    snapshot = host_tree(tree0)
    del tree0
    rec = RecoveryManager.for_workload(wl, save_every=ROLLBACK_WINDOWS)
    disk = shutil.disk_usage(rec.ckpt.dir)
    host_ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    r = ScenarioRunner(
        None, [ScheduledFault(ParamCorruption(workers=(1,), nan=True), 2,
                              ROLLBACK_WINDOWS,
                              cures=(Action.ROLLBACK_TO_CHECKPOINT,))],
        n_windows=ROLLBACK_WINDOWS, iters_per_window=FLEET_ITERS,
        detector_cfg=default_trainer_detector_cfg(FLEET_ITERS), workload=wl,
        mitigation=True, recovery=rec)
    reset_counts(K, K2, K3)
    t = time.perf_counter()
    with TickWatch(K) as watch:
        res = r.run()
    run_s = time.perf_counter() - t
    k2 = K2.flash_attention.launches
    k2_by_variant = dict(K2.flash_attention.launches_by_variant)
    k1 = dict(K.pattern_summary.launches_by_variant)
    watch.assert_warp_every_tick("online rollback")
    inc = next((i for i in res.incidents
                if i.channel == "numerics" and i.applied), None)
    m = next((m for m in r.engine.log
              if m.plan.action is Action.ROLLBACK_TO_CHECKPOINT), None)
    if inc is None or m is None or m.restored_step != step0:
        raise AssertionError(f"no rollback to step {step0} restored the "
                             f"corrupted trainers: {res.timeline()}")
    ck_bytes = sum(f.stat().st_size
                   for f in (rec.ckpt.dir / f"step_{step0}").iterdir())
    finite = all(torch.isfinite(t).all() for tw in wl.workers
                 for t in _flatten(tw.params).values())
    n_params = sum(t.numel() for t in _flatten(wl.workers[0].params).values())
    wl.close()
    # the checkpoint read back onto the host copy of the window-0 state
    on_disk = _flatten(rec.ckpt.restore(step0, snapshot)[0])
    flat = _flatten(snapshot)
    bitwise = list(on_disk) == list(flat) and all(
        a.dtype == on_disk[k].dtype and torch.equal(
            a.reshape(-1).view(torch.uint8),
            on_disk[k].reshape(-1).view(torch.uint8))
        for k, a in flat.items())
    del on_disk, flat, snapshot
    print(f"[online rollback] {ROLLBACK_WORKERS} workers x {cfg.name} at "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, {n_params} parameters a worker, batch 1 x "
          f"{TRAIN_SEQ}; state on the card {state_bytes} bytes; "
          f"checkpoint directory's disk {disk.free} of {disk.total} bytes "
          f"free, host memory {host_ram} bytes; {ROLLBACK_WINDOWS} windows "
          f"x {FLEET_ITERS} steps in {run_s:.2f} s: incident "
          f"{(inc.function, inc.state, inc.escalations)} by "
          f"{[p.action.value for _, p in inc.applied]}; checkpoint step "
          f"{step0}: {ck_bytes} bytes, save {rec.ckpt.last_save_s:.4f} s "
          f"(write thread), restore {m.restore_s:.4f} s, lost steps "
          f"{m.lost_steps}; rollback verified {m.rollback_verified}, "
          f"checkpoint == window-0 state bit for bit: {bitwise}; K2 launches "
          f"{k2} {k2_by_variant}; K1 launches {k1}")
    ok = (inc.state == "resolved" and not inc.escalations
          and inc.applied[0][1].action is Action.ROLLBACK_TO_CHECKPOINT
          and m.rollback_verified and not m.rollback_failed
          and m.lost_steps > 0 and bitwise and finite and k2 > 0
          and k2_by_variant["wgmma"] == k2)
    rec.close()
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("the corrupted trainers were not restored by a "
                             "verified rollback")
    return k1


# -- serving, the wire and worker processes ------------------------------------

SERVE_BATCH, SERVE_MAX_LEN = 4, 128
ENGINE_PROMPT, ENGINE_NEW = 16, 32     # [serve engine]: 47 decode steps
MOE_ARCH = "deepseek-v2-lite-16b"     # [moe serve] at full depth, and
MOE_TRAIN_LAYERS = 4                   # [moe trainer] cut to 1 dense + 3 MoE
PAIR_ARCH, PAIR_NEW = "llama4-maverick-400b-a17b", 8   # [moe pair]
FLEET_PROMPT, FLEET_NEW = 4, 8         # [serve fleet]: the reference's
SERVE_IPW, SERVE_WINDOWS = 8, 7        # requests a window; fault in [2, 7)
#: engine decode logits vs one teacher-forced forward of the same tokens,
#: max |difference|.  The control is the same forward with K2's plain
#: version in its place: it differs from the decode by the decode path's
#: own rounding (bf16 activations through 26 layers, other GEMM shapes, an
#: f32 softmax of the cache), and the forward through K2 may be at most
#: this factor of that control further from the decode
#: (H100 80GB HBM3, 700 W: 0.1752 through K2 in every run, control
#: 0.1588, the two forwards 0.1506 apart: a rounding-level change in 26
#: layers of random weights moves the logits this much, so this check
#: catches gross faults; K2 at this shape is held to its plain version in
#: ``k2_checks``)
LOGIT_CONTROL_FACTOR = 1.25
#: [hybrid serve]'s f32 run: at zamba2's 81 layers bf16 rounding alone
#: moves the logits by about their own size, so the control above cannot
#: fail there.  With f32 parameters and activations the decode and the
#: K2/K3 forward, and that forward and the plain-version control, must lie
#: within this share of the largest forward logit of each other (H100 80GB
#: HBM3, 700 W: 2.5e-4 and 1.4e-4; a decode one position off from step 20
#: moved them by 1.25, and two applications of the shared block swapping
#: K/V caches by 0.010: tools/hybrid_decode_mutants.py, PERF.md)
F32_LOGIT_RTOL = 2e-3
#: the serve fleet's depth: 4 workers at gemma2-2b's full width cut to one
#: local/global pair.  A full-depth decode step takes ~10x a 2-layer one on
#: the host ([serve engine] against [serve fleet]'s base TBT), so the three
#: scenarios would take ~10x too, past the script's time (PERF.md)
SERVE_FLEET_LAYERS = 2
PROFILED_DECODE_STEPS = 3
MP_W, MP_WINDOWS = 32, 9               # tests/test_wire.py's C1P1 cell
MP_CHECK_WINDOW = 3                    # GpuThrottle is live
MP_CHECK_WORKERS = (3, 27)             # throttled in child 0, healthy in 1
#: the slo incident each live fault must open on the card: (function,
#: workers, first action).  The decode and KV frames name no sampled
#: stream on the card (as in the reference off the CPU), so they keep
#: beta-only patterns: a stalled worker's decode.step fills about all of
#: each request as a healthy one's does, so no window of DecodeStall flags
#: decode.step and no incident is localized to it or confirmed with a plan
#: (None below), which is what the reference's machinery gives such windows
#: (tests/test_torch_serve.py's no-stream tests).  An slo incident is still
#: open while the fault is live, and the stalled worker's TBT shows the
#: pad (``stall_ran``).
SERVE_EXPECT = {
    "BurstArrivals": ("serve.queue:dequeue_wait", [0, 1, 2, 3], "shed_load"),
    "DecodeStall": None,
    "CacheThrash": ("kv_cache.read_block", [0, 1, 2, 3], "shed_load"),
}


def decode_profile(engine, prompts, tag: str) -> dict:
    """``PROFILED_DECODE_STEPS`` decode steps of the engine under
    ``torch.profiler``: device kernels a step, busy time against the
    steps' wall time (the card's idle share) and the gaps between
    consecutive kernels."""
    from torch.profiler import ProfilerActivity, profile
    B = prompts.shape[0]
    cache = engine.model.init_cache(B, SERVE_MAX_LEN, device=engine.device)
    tok = torch.from_numpy(prompts[:, :1].astype(np.int64)).to(engine.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for pos in range(PROFILED_DECODE_STEPS):
            engine._step(engine.params, cache, {"tokens": tok}, pos)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    ev = sorted(device_events(prof), key=lambda e: e.start_ns())
    busy = sum(e.duration_ns() for e in ev) / 1e6
    gaps = [(b.start_ns() - a.start_ns() - a.duration_ns()) / 1e3
            for a, b in zip(ev, ev[1:])]
    by_name = device_ms_by_name(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    n = PROFILED_DECODE_STEPS
    out = dict(wall_ms=wall_ms / n, busy_ms=busy / n, kernels=len(ev) / n,
               gap_us=float(np.median(gaps)) if gaps else None)
    if not ev:
        print(f"{tag} the profiler recorded no device time: not "
              "measured")
        return out
    print(f"{tag} {n} decode steps under torch.profiler: wall "
          f"{out['wall_ms']:.3f} ms a step, device busy {out['busy_ms']:.3f} "
          f"ms a step (idle share {1 - busy / wall_ms:.2%}), "
          f"{out['kernels']:.0f} device activities a step, median gap "
          f"between them {out['gap_us']:.1f} us (p90 "
          f"{float(np.percentile(gaps, 90)):.1f} us)")
    for name, ms in top:
        print(f"{tag}   {ms / n:8.4f} ms a step  {name[:100]}")
    return out


class _FillOnDevice:
    """``torch`` for ``models/attention.py`` with ``tensor([pos],
    device=d)`` (its one use there: the decode position each layer) filled
    on ``d`` instead of copied from the host."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def tensor(data, device=None):
        return torch.full((len(data),), int(data[0]), dtype=torch.int64,
                          device=device)


def position_copy_ab(engine, prompts) -> dict:
    """What the decode's per-layer position copy costs a step: one
    ``generate`` as the port runs it (``h2d``: each layer copies the
    position from the host, a pageable copy that waits for the stream)
    against the same with that call filled on the card (``device``),
    in the order h2d, device, device, h2d, each after an untimed 2-token
    generate; host wall time, and the tokens must not change."""
    from repro_torch.models import attention as A
    steps = ENGINE_PROMPT + ENGINE_NEW - 1
    ways = {"h2d": torch, "device": _FillOnDevice()}
    ms, tokens = {w: [] for w in ways}, {}
    try:
        for way in ("h2d", "device", "device", "h2d"):
            A.torch = ways[way]
            engine.generate(prompts, 2)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = engine.generate(prompts, ENGINE_NEW)
            ms[way].append((time.perf_counter() - t) * 1e3 / steps)
            tokens.setdefault(way, out)
    finally:
        A.torch = torch
    med = {w: float(np.median(v)) for w, v in ms.items()}
    print(f"[serve engine] position copies: ms a step h2d "
          f"{[round(x, 4) for x in ms['h2d']]}, filled on the card "
          f"{[round(x, 4) for x in ms['device']]}; the copies cost "
          f"{med['h2d'] - med['device']:.4f} ms a step (medians)")
    if not np.array_equal(tokens["h2d"], tokens["device"]):
        raise AssertionError("the position fill changed the decoded tokens")
    return dict(h2d_ms=ms["h2d"], device_ms=ms["device"])


class RouteLog:
    """Records, while it is entered, each MoE layer's tokens per expert and
    rows dropped by capacity, by wrapping ``models.moe.route`` (which the
    layer looks up at each call)."""

    def __init__(self):
        from repro_torch.models import moe as M
        self.M, self.layers, self.capacity = M, [], None

    def __enter__(self):
        self.orig = route = self.M.route

        def recording(p, x, cfg, capacity):
            out = route(p, x, cfg, capacity)
            self.layers.append((out[4], (~out[6]).sum()))
            self.capacity = capacity
            return out
        self.M.route = recording
        return self

    def __exit__(self, *exc):
        self.M.route = self.orig

    def summary(self) -> dict:
        counts = torch.stack([c for c, _ in self.layers]).cpu()
        dropped = int(sum(int(d) for _, d in self.layers))
        return dict(layers=len(self.layers), capacity=self.capacity,
                    min=int(counts.min()), max=int(counts.max()),
                    dropped=dropped, pairs=int(counts.sum()))


@contextmanager
def plain_kernels(K2, K3):
    """While entered, the model's attention and SSD scan run K2's and K3's
    plain versions (the control forwards)."""
    from repro_torch.models import attention_core as C
    from repro_torch.models import ssm as S

    def attention(q, k, v, return_lse=False, **kw):
        out, lse = K2.flash_attention_reference(q, k, v, **kw)
        return (out, lse) if return_lse else out

    def ssd(x, dt, A, Bm, Cm, chunk):
        return K3.ssd_scan_reference(x, dt, A, Bm, Cm, chunk)
    C.flash_attention, S.ssd_scan = attention, ssd
    try:
        yield
    finally:
        C.flash_attention, S.ssd_scan = K2.flash_attention, K3.ssd_scan


def forward_logits(model, params, tokens: torch.Tensor, V: int):
    """One teacher-forced ``model.forward`` over ``tokens``: f32 logits of
    every position, cut to the vocabulary."""
    with torch.no_grad():
        hidden, _, _ = model.forward(params, {"tokens": tokens})
        return model.logits(params, hidden)[..., :V].float()


def engine_vs_forward(tag, cfg, K, K2, K3, prompt_len: int,
                      n_new: int) -> dict:
    """``Engine.generate`` on ``cfg`` built on the card (``init`` with no
    device: the card) from seed 0: batch 4, max_len 128, ``prompt_len``
    tokens of prompt from seed 0, ``n_new`` new tokens, greedy.  One
    teacher-forced ``model.forward`` over the generated sequence (K2's
    wgmma variant, and K3 in a model with mamba2 layers) gives the logits of
    every position, and a control forward with their plain versions in
    their place.  The engine's decode logits must
    be no further from the K2 forward than ``LOGIT_CONTROL_FACTOR`` times
    their distance from the control, and each greedy token must be the K2
    forward's argmax wherever its top-2 margin exceeds that limit.  An MoE
    model's forward also reports its routing (``RouteLog``).  Two generates
    give the same tokens, an MoE model's included (its combine adds each
    token's rows in a fixed order, with no atomics).  Returns the engine,
    its prompts and the readings; the caller frees the engine."""
    from repro_torch.models.layers import param_bytes
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.engine import Engine, ServeConfig
    V = cfg.vocab_size
    model = Transformer(cfg)
    t = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    engine = Engine(cfg, params, ServeConfig(batch=SERVE_BATCH,
                                             max_len=SERVE_MAX_LEN))
    prompts = np.random.default_rng(0).integers(
        0, V, (SERVE_BATCH, prompt_len)).astype(np.int32)
    step, decoded = engine._step, []

    def recording_step(*args):
        logits, cache = step(*args)
        decoded.append(logits[:, 0, :V].float())
        return logits, cache
    n_attn = len(model.layer_specs())
    n_ssd = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    engine.generate(prompts, 2)                 # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(K, K2, K3)
    steps = prompt_len + n_new - 1
    t = time.perf_counter()
    toks = engine.generate(prompts, n_new)      # ends in a copy to host
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    k_decode = (K2.flash_attention.launches, K3.ssd_scan.launches,
                K.pattern_summary.launches)
    engine._step = recording_step
    again = engine.generate(prompts, n_new)
    engine._step = step
    runs_differ = int((toks != again).sum())
    tok_dev = torch.from_numpy(again.astype(np.int64)).cuda()
    reset_counts(K, K2, K3)
    with RouteLog() as routes:
        forward = forward_logits(model, params, tok_dev, V)
    k2 = dict(K2.flash_attention.launches_by_variant)
    k3 = dict(K3.ssd_scan.launches_by_variant)
    with plain_kernels(K2, K3):
        control = forward_logits(model, params, tok_dev, V)
    # logits of the positions that produced the generated tokens
    lo = prompt_len - 1
    dec = torch.stack(decoded, 1)[:, lo:]
    ref, ctl = forward[:, lo:steps], control[:, lo:steps]
    err = float((dec - ref).abs().max())
    ctrl = float((dec - ctl).abs().max())
    gap = float((ref - ctl).abs().max())
    scale = float(ref.abs().max())
    limit = LOGIT_CONTROL_FACTOR * ctrl
    top2 = torch.topk(ref, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    sure = margin > limit
    agree = tok_dev[:, prompt_len:] == ref.argmax(-1)
    nbytes = param_bytes(params)
    cache_bytes, bound = decode_bytes_bound(engine, nbytes)
    print(f"{tag} {cfg.name}, {cfg.num_layers} layers, bf16, {nbytes} bytes "
          f"of parameters (init on the card {init_s:.2f} s), batch "
          f"{SERVE_BATCH} x ({prompt_len} + {n_new}) tokens, greedy: "
          f"{wall * 1e3:.3f} ms for {steps} steps, {wall * 1e3 / steps:.4f} "
          f"ms a step (host clock, ends in the copy to host); peak "
          f"{peak} bytes; K2 / K3 / K1 launches while decoding "
          f"{k_decode}; "
          f"tokens that differ between two generates {runs_differ}")
    print(f"{tag} cache {cache_bytes} bytes; a decode step reads every "
          f"weight (the reference computes every expert) and the cache: "
          f"bound {bound:.4f} ms at 3.35 TB/s, the step "
          f"{wall * 1e3 / steps / bound:.1f}x it")
    print(f"{tag} teacher-forced forward over {toks.shape}: K2 "
          f"launches {k2}, K3 launches {k3}; max |forward logit| "
          f"{scale:.4f}; max |decode - forward| logit {err:.4f}, control "
          f"(the kernels' plain versions in the forward) {ctrl:.4f}, limit "
          f"{LOGIT_CONTROL_FACTOR} x control = {limit:.4f}; max |forward - "
          f"control| {gap:.4f}; greedy token == forward argmax at "
          f"{int(agree.sum())} of {agree.numel()} positions; "
          f"{int(sure.sum())} have a top-2 margin over the limit, where they "
          f"must agree, and {int((agree & sure).sum())} do; median margin "
          f"{float(margin.median()):.4f}")
    routing = routes.summary() if routes.layers else None
    if routing:
        print(f"{tag} routing of that forward: {routing['layers']} MoE "
              f"layers x {tok_dev.numel()} tokens x top-{cfg.top_k}: tokens "
              f"per (layer, expert) min {routing['min']} max "
              f"{routing['max']} (capacity {routing['capacity']}); rows "
              f"dropped by capacity {routing['dropped']} of "
              f"{routing['pairs']}")
    q3 = min(cfg.ssm_chunk, tok_dev.shape[1])
    k3_want = K3.variant_for(torch.bfloat16, cfg.ssm_head_dim,
                             cfg.ssm_state, q3) if n_ssd else "simt"
    if runs_differ or k_decode != (0, 0, 0) \
            or not np.isfinite(err) or not ctrl > 0 or err > limit \
            or not bool((agree | ~sure).all()) \
            or k2["wgmma"] != n_attn or k2["simt"] \
            or k3[k3_want] != n_ssd or sum(k3.values()) != n_ssd:
        raise AssertionError(f"{tag} the engine's decode disagrees with the "
                             "teacher-forced forward")
    del decoded, forward, control, dec, ref, ctl
    return dict(engine=engine, prompts=prompts, k2=k2, k3=k3,
                runs_differ=runs_differ,
                ms_per_step=wall * 1e3 / steps, err=err, ctrl=ctrl, gap=gap,
                peak=peak, param_bytes=nbytes, routing=routing,
                logit_scale=scale, cache_bytes=cache_bytes, bound_ms=bound)


def decode_bytes_bound(engine, nbytes: int) -> tuple:
    """(cache bytes, the least ms of one decode step at 3.35 TB/s): every
    parameter byte and the whole cache read once, except the embedding
    table, of which only the batch's rows are read unless it is also the LM
    head; a hybrid model's shared attention block is read once for each of
    its applications."""
    from repro_torch.models.layers import param_bytes
    cfg = engine.cfg
    cache = engine.model.init_cache(SERVE_BATCH, SERVE_MAX_LEN)  # the card
    cache_bytes = sum(t.numel() * t.element_size()
                      for c in cache for t in c.values())
    table = engine.params["embed"]["table"]
    read = nbytes + cache_bytes
    if "shared_attn" in engine.params:
        read += (len(engine.model.layer_specs()) - 1) \
            * param_bytes(engine.params["shared_attn"])
    if not cfg.tie_embeddings:
        read -= (table.shape[0] - SERVE_BATCH) * table[0].numel() \
            * table.element_size()
    return cache_bytes, read / 3.35e12 * 1e3


def f32_decode_vs_forward(tag, cfg, K, K2, K3, prompt_len: int,
                          n_new: int) -> dict:
    """``Engine.generate`` on ``cfg`` with f32 parameters and activations,
    built on the card from seed 0 (batch 4, max_len 128, ``prompt_len``
    tokens of prompt from seed 0, ``n_new`` greedy tokens), its decode
    logits recorded; one teacher-forced ``model.forward`` through K2 and K3
    (their SIMT kernels, which take f32), and a control forward with their
    plain versions.  Decode against the K2/K3 forward, and that forward
    against the control, must each be within ``F32_LOGIT_RTOL`` of the
    largest forward logit, and each greedy token the forward's argmax
    wherever its top-2 margin exceeds that limit."""
    from repro_torch.models.layers import param_bytes
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = cfg.with_overrides(dtype="float32", param_dtype="float32")
    V = cfg.vocab_size
    model = Transformer(cfg)
    params = model.init(0)
    engine = Engine(cfg, params, ServeConfig(batch=SERVE_BATCH,
                                             max_len=SERVE_MAX_LEN))
    prompts = np.random.default_rng(0).integers(
        0, V, (SERVE_BATCH, prompt_len)).astype(np.int32)
    step, decoded = engine._step, []

    def recording_step(*args):
        logits, cache = step(*args)
        decoded.append(logits[:, 0, :V].float())
        return logits, cache
    n_attn = len(model.layer_specs())
    n_ssd = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    reset_counts(K, K2, K3)
    engine._step = recording_step
    t = time.perf_counter()
    toks = engine.generate(prompts, n_new)
    wall = time.perf_counter() - t
    k_decode = (K2.flash_attention.launches, K3.ssd_scan.launches,
                K.pattern_summary.launches)
    tok_dev = torch.from_numpy(toks.astype(np.int64)).cuda()
    reset_counts(K, K2, K3)
    forward = forward_logits(model, params, tok_dev, V)
    k2 = dict(K2.flash_attention.launches_by_variant)
    k3 = dict(K3.ssd_scan.launches_by_variant)
    with plain_kernels(K2, K3):
        control = forward_logits(model, params, tok_dev, V)
    steps = prompt_len + n_new - 1
    lo = prompt_len - 1
    dec = torch.stack(decoded, 1)[:, lo:]
    ref, ctl = forward[:, lo:steps], control[:, lo:steps]
    err = float((dec - ref).abs().max())
    ctrl = float((dec - ctl).abs().max())
    gap = float((ref - ctl).abs().max())
    scale = float(ref.abs().max())
    limit = F32_LOGIT_RTOL * scale
    top2 = torch.topk(ref, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    sure = margin > limit
    agree = tok_dev[:, prompt_len:] == ref.argmax(-1)
    nbytes = param_bytes(params)
    print(f"{tag} f32: {cfg.name}, {cfg.num_layers} layers, {nbytes} bytes "
          f"of f32 parameters, batch {SERVE_BATCH} x ({prompt_len} + "
          f"{n_new}) tokens, greedy: {wall * 1e3 / steps:.4f} ms a step "
          f"(host clock); K2 / K3 / K1 launches while decoding {k_decode}; "
          f"teacher-forced forward K2 launches {k2}, K3 launches {k3}; max "
          f"|forward logit| {scale:.4f}, limit {F32_LOGIT_RTOL} x it = "
          f"{limit:.4f}; max |decode - forward| {err:.6f} "
          f"({err / scale:.3g} of it), |decode - control| {ctrl:.6f}, "
          f"|forward - control| {gap:.6f}; greedy token == forward argmax "
          f"at {int(agree.sum())} of {agree.numel()} positions; "
          f"{int(sure.sum())} have a top-2 margin over the limit, where they "
          f"must agree, and {int((agree & sure).sum())} do; median margin "
          f"{float(margin.median()):.4f}")
    if k_decode != (0, 0, 0) or not np.isfinite(err) or err > limit \
            or not np.isfinite(gap) or gap > limit \
            or not bool((agree | ~sure).all()) \
            or k2["simt"] != n_attn or k2["wgmma"] \
            or k3["simt"] != n_ssd or k3["wgmma"]:
        raise AssertionError(f"{tag} the f32 decode disagrees with the "
                             "teacher-forced forward")
    del engine, params, decoded, forward, control, dec, ref, ctl
    gc.collect()
    torch.cuda.empty_cache()
    return dict(err=err, ctrl=ctrl, gap=gap, logit_scale=scale, limit=limit,
                ms_per_step=wall * 1e3 / steps, sure=int(sure.sum()),
                agree=int(agree.sum()), positions=agree.numel(), k2=k2, k3=k3)


def free_engine(run: dict) -> None:
    """Drop an ``engine_vs_forward`` run's engine and parameters from the
    card."""
    run.pop("engine")
    gc.collect()
    torch.cuda.empty_cache()


def serve_engine_phase(K, K2, K3, ARCHS) -> dict:
    """``engine_vs_forward`` on gemma2-2b at its published widths (26
    layers), 16-token prompts and 32 new tokens, then a profile of its
    decode steps and the position-copy A/B.  Returns K2's launches by
    variant in the forward, the step time, the logit errors, peak bytes,
    the decode profile and the A/B."""
    run = engine_vs_forward("[serve engine]", ARCHS["gemma2-2b"], K, K2, K3,
                            ENGINE_PROMPT, ENGINE_NEW)
    run["profile"] = decode_profile(run["engine"], run["prompts"],
                                    "[serve engine]")
    run["position_ab"] = position_copy_ab(run["engine"], run["prompts"])
    free_engine(run)
    # the bf16 check passes under both decode faults of
    # tools/hybrid_decode_mutants.py (a fault moves the control as much as
    # the decode): the f32 rerun is the check that can fail
    run["f32"] = f32_decode_vs_forward("[serve engine]", ARCHS["gemma2-2b"],
                                       K, K2, K3, ENGINE_PROMPT, ENGINE_NEW)
    return run


def moe_serve_phase(K, K2, K3, ARCHS) -> dict:
    """``engine_vs_forward`` on deepseek-v2-lite-16b at its published
    widths and depth (27 layers: MLA with kv_lora 512, 64 routed experts
    top-6 plus 2 shared, layer 0 dense), 16-token prompts and 32 new
    tokens, with its decode profile; its cache holds only the latent and
    the roped key dims of each token (4 x 128 x (512 + 64) x 2 bytes a
    layer)."""
    cfg = ARCHS[MOE_ARCH]
    run = engine_vs_forward("[moe serve]", cfg, K, K2, K3, ENGINE_PROMPT,
                            ENGINE_NEW)
    want = SERVE_BATCH * SERVE_MAX_LEN * (cfg.kv_lora_rank
                                          + cfg.qk_rope_dim) * 2 \
        * cfg.num_layers
    if run["cache_bytes"] != want:
        raise AssertionError(f"latent cache {run['cache_bytes']} bytes, "
                             f"expected {want}")
    run["profile"] = decode_profile(run["engine"], run["prompts"],
                                    "[moe serve]")
    free_engine(run)
    return run


def moe_pair_phase(K, K2, K3, ARCHS) -> dict:
    """``engine_vs_forward`` on one (dense, MoE) pair of
    llama4-maverick-400b-a17b at its published widths (d_model 5120, GQA 40
    / 8 heads of 128, dense ff 16 384, 128 experts of ff 8192 top-1 plus a
    shared expert, vocab 202 048): 16-token prompts and ``PAIR_NEW`` new
    tokens."""
    cfg = ARCHS[PAIR_ARCH].with_overrides(num_layers=2)
    run = engine_vs_forward("[moe pair]", cfg, K, K2, K3, ENGINE_PROMPT,
                            PAIR_NEW)
    free_engine(run)
    return run


def hybrid_serve_phase(K, K2, K3, ARCHS) -> dict:
    """``engine_vs_forward`` on zamba2-7b at its published widths and depth
    (81 mamba2 layers, the shared attention block after every 6th: 13
    applications), 16-token prompts and 32 new tokens, with its decode
    profile.  Its cache is 81 SSM caches (conv windows in bf16, the f32
    state (4, 112, 64, 64)) and 13 K/V caches of 128 positions; the
    forward runs K3 at a chunk of 48 (the SIMT kernel) and K2 at head dim
    112.  bf16 rounding through 81 layers reaches the logits' own size, so
    the same decode then runs in f32 (``f32_decode_vs_forward``), where the
    check can fail."""
    cfg = ARCHS[ZAMBA]
    run = engine_vs_forward("[hybrid serve]", cfg, K, K2, K3, ENGINE_PROMPT,
                            ENGINE_NEW)
    B, W, G, N = SERVE_BATCH, cfg.conv_width, cfg.ssm_groups, cfg.ssm_state
    ssm = B * (W - 1) * (cfg.d_inner + 2 * G * N) * 2 \
        + B * cfg.ssm_heads * N * cfg.ssm_head_dim * 4
    kv = 2 * B * SERVE_MAX_LEN * cfg.num_kv_heads * cfg.head_dim * 2
    napp = len(run["engine"].model.layer_specs())
    want = cfg.num_layers * ssm + napp * kv
    print(f"[hybrid serve] cache: {cfg.num_layers} SSM caches of {ssm} bytes "
          f"and {napp} K/V caches of {kv} bytes = {want} bytes")
    if run["cache_bytes"] != want or napp != 13:
        raise AssertionError(f"hybrid cache {run['cache_bytes']} bytes, "
                             f"expected {want}")
    run["profile"] = decode_profile(run["engine"], run["prompts"],
                                    "[hybrid serve]")
    free_engine(run)
    run["f32"] = f32_decode_vs_forward("[hybrid serve]", cfg, K, K2, K3,
                                       ENGINE_PROMPT, ENGINE_NEW)
    return run


def hybrid_remat_phase(K, K2, K3, cfg, first, Trainer, TrainConfig,
                       DataConfig, OptConfig) -> dict:
    """``ZAMBA_REMAT_STEPS`` steps of the [hybrid trainer] with
    ``remat="full"``, from the same initial weights (seed 0) and batches:
    each loss and grad norm within ``REMAT_RTOL`` of the first run's, K2
    launched twice a group (the backward reruns each group's forward), peak
    memory beside the first run's."""
    tr = Trainer(cfg, DataConfig(batch=1, seq_len=TRAIN_SEQ), OptConfig(),
                 TrainConfig(perftracker=False, remat="full"), device="cuda")
    params, opt_state, _ = tr.init_state()
    tr.ensure_bundle(params, tr._batch(tr.source.batch_at(0)))  # the count
    torch.cuda.reset_peak_memory_stats()
    reset_counts(K, K2, K3)
    rows, k2_steps, times = [], [], []
    for _ in range(ZAMBA_REMAT_STEPS):
        before = K2.flash_attention.launches
        t = time.perf_counter()
        params, opt_state, m = tr.train_iteration(params, opt_state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        k2_steps.append(K2.flash_attention.launches - before)
        rows.append((float(m["loss"]), float(m["grad_norm"])))
    peak = torch.cuda.max_memory_allocated()
    k2 = dict(K2.flash_attention.launches_by_variant)
    k3 = dict(K3.ssd_scan.launches_by_variant)
    tr.loader.close()
    del tr, params, opt_state, m
    gc.collect()
    torch.cuda.empty_cache()
    want = [(st["loss"], st["grad_norm"]) for st in first["steps"]]
    worst = max(abs(a - b) / abs(b) for r, w in zip(rows, want)
                for a, b in zip(r, w))
    napp = cfg.num_layers // cfg.shared_attn_every
    print(f"[hybrid trainer] remat=\"full\": {ZAMBA_REMAT_STEPS} steps from "
          f"the same weights and batches: (loss, grad norm) {rows} against "
          f"{want[:ZAMBA_REMAT_STEPS]}, worst relative difference "
          f"{worst:.3g} (tolerance {REMAT_RTOL}); step s "
          f"{[round(x, 4) for x in times]}; K2 launches a step {k2_steps} "
          f"({k2}), K3 {k3}; peak {peak} bytes (without remat "
          f"{first['peak']})")
    if not worst <= REMAT_RTOL or k2_steps != [2 * napp] * ZAMBA_REMAT_STEPS \
            or k2["simt"] or k3["simt"] \
            or k3["wgmma"] != 2 * cfg.num_layers * ZAMBA_REMAT_STEPS:
        raise AssertionError("the remat run disagrees with the run without")
    return dict(rows=rows, worst=worst, peak=peak, k2_per_step=k2_steps,
                k2=k2, k3=k3, step_s=times)


def serve_fleet_phase(K, K2, K3, ARCHS, expect) -> dict:
    """``ServeWorkload``: 4 workers of gemma2-2b at its full width cut to
    ``SERVE_FLEET_LAYERS`` layers, sharing one parameter tree, 4-token
    prompts, 8 new tokens, batch
    4, max_len 128; 7 windows of 8 requests, the fault live in windows 2-6,
    under each of the three live SLO faults, each on a fresh workload (a
    request generator keeps its backlog across windows).  The service runs
    the ``cuda`` backend (K1 every window), observed untimed: rows by K1
    path and the general-path rows held against the plain version.  ``expect`` maps each fault to the
    slo-channel incident it must open: (function, workers, first action)."""
    from repro_torch.online import ScenarioRunner, ScheduledFault
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.workload import (DECODE_STEP, BurstArrivals,
                                            CacheThrash, DecodeStall,
                                            ServeWorkload)
    from repro_torch.train.workload import default_trainer_detector_cfg
    cfg = ARCHS["gemma2-2b"].with_overrides(num_layers=SERVE_FLEET_LAYERS)
    setup = (cfg, ServeConfig(batch=SERVE_BATCH, max_len=SERVE_MAX_LEN),
             FLEET_PROMPT, FLEET_NEW)
    out = {}
    rows = ObservedK1(K, timed=False)
    for fault in (BurstArrivals(workers=()), DecodeStall(workers=(2,)),
                  CacheThrash(workers=())):
        name = type(fault).__name__
        wl = ServeWorkload(n_workers=4, setup=setup)
        t = time.perf_counter()
        wl._ensure_workers()
        print(f"[serve fleet] {name}: 4 workers x gemma2-2b at "
              f"{cfg.num_layers} layers, d_model {cfg.d_model}, batch "
              f"{SERVE_BATCH}, {FLEET_PROMPT} + {FLEET_NEW} tokens: warm-up "
              f"{time.perf_counter() - t:.2f} s; base request "
              f"{[round(sw.base_request_s, 5) for sw in wl.workers]} s, base "
              f"TBT {[round(sw.base_tbt_s, 6) for sw in wl.workers]} s")
        seen = dict(rows.rows)
        tbts = record_tbts(wl)
        r = ScenarioRunner(
            None, [ScheduledFault(fault, 2, SERVE_WINDOWS)],
            n_windows=SERVE_WINDOWS, iters_per_window=SERVE_IPW,
            detector_cfg=default_trainer_detector_cfg(SERVE_IPW),
            workload=wl, summarize_backend=rows)
        reset_counts(K, K2, K3)
        t = time.perf_counter()
        with TickWatch(K) as watch:
            res = r.run()
        run_s = time.perf_counter() - t
        watch.assert_warp_every_tick(f"serve fleet {name}")
        by_variant = dict(K.pattern_summary.launches_by_variant)
        incs = [(i.function, i.channel, list(i.workers),
                 [p.action.value for p in i.plans]) for i in res.incidents]
        for i, rep in enumerate(res.reports):
            print(f"[serve fleet] {name} window {i}: summarize_s "
                  f"{rep.summarize_s:.4f}; flagged "
                  f"{[(d.abnormality.function, d.abnormality.workers.tolist(), d.abnormality.reason) for d in rep.diagnoses]}"
                  f"; (beta, mu, sigma) {serve_patterns(rep)}")
        by_path = {k: rows.rows[k] - seen[k] for k in seen}
        print(f"[serve fleet] {name}{fault.workers}: {run_s:.2f} s; "
              f"incidents {incs}; K1 launches {by_variant}; rows by path "
              f"{by_path}")
        out[name] = dict(incidents=incs, launches=by_variant, rows=by_path,
                         run_s=run_s, base_request_s=wl.base_request_s,
                         base_tbt_s=float(np.median(
                             [sw.base_tbt_s for sw in wl.workers])))
        slo = [i for i in res.incidents if i.channel == "slo"]
        live = any(open_while(res, i, 2, SERVE_WINDOWS) for i in slo)
        print(f"[serve fleet] {name}: slo incidents opened in windows "
              f"{[res.window_of(i.opened_at) for i in slo]}, one open while "
              f"the fault is live: {live}; median TBT a window per worker (s) "
              f"{[[round(float(np.median(w)), 6) for w in win] for win in tbts]}")
        if expect[name] is None:
            ok = not any(DECODE_STEP in rep.functions()
                         for rep in res.reports) \
                and not any(i[0] == DECODE_STEP or i[3] for i in incs) \
                and live and stall_ran(wl, tbts, fault)
        else:
            fn, workers, action = expect[name]
            ok = any(i[:3] == (fn, "slo", workers) and i[3]
                     and i[3][0] == action for i in incs)
        wl.close()
        if not ok or by_variant["warp"] == 0 or by_variant["block"]:
            raise AssertionError(f"{name}: the incidents {incs} are not "
                                 f"{expect[name]}")
    print(f"[serve fleet] rows that reached k1_warp_general "
          f"{rows.rows['general']}, against the plain version: "
          f"{rows.general_mismatch} count mismatches, max |mean/std err| "
          f"{rows.general_err:.3g}")
    if rows.general_mismatch or rows.general_err > ATOL:
        raise AssertionError("k1_warp_general disagrees with the plain "
                             "version in the serve fleet")
    out["general_err"] = rows.general_err
    gc.collect()
    torch.cuda.empty_cache()
    return out


def record_tbts(wl) -> list:
    """Per window, each worker's per-request TBTs: ``wl.run_window``
    wrapped to keep what each worker measured (the list fills as the
    scenario runs)."""
    out, run = [], wl.run_window

    def recording(*args, **kw):
        wd = run(*args, **kw)
        out.append([[tbt for _, tbt in sw.window_slo] for sw in wl.workers])
        return wd
    wl.run_window = recording
    return out


def open_while(res, inc, lo: int, hi: int) -> bool:
    """``inc`` was open at some time in windows ``lo`` to ``hi - 1``: the
    slo trigger may open an incident in a healthy window before the fault,
    and that one then holds the fault's windows."""
    t0, t1 = res.spans[lo][0], res.spans[hi - 1][1]
    ended = [t for t, state in inc.history
             if state in ("resolved", "escalated")]
    return inc.opened_at <= t1 and (not ended or ended[-1] > t0)


def stall_ran(wl, tbts, fault) -> bool:
    """The stall ran where it was put: over the fault's windows 2-6 each
    stalled worker's median TBT exceeds its base TBT by at least 0.8 of
    its pad, and every other worker's moved less than half the smallest
    pad from its own median in the healthy windows 0-1."""
    pads = {w: fault.pad_s or max(0.0, fault.factor - 1.0)
            * wl.workers[w].base_tbt_s for w in fault.workers}
    ok = True
    for sw in wl.workers:
        w = sw.worker
        live = float(np.median([t for win in tbts[2:] for t in win[w]]))
        if w in pads:
            moved = live - sw.base_tbt_s
            ok &= moved >= 0.8 * pads[w]
            print(f"[serve fleet] worker {w} (stalled): median TBT in "
                  f"windows 2-6 {live:.6f} s, base {sw.base_tbt_s:.6f} s, "
                  f"moved {moved:.6f} s against a pad of {pads[w]:.6f} s")
        else:
            calm = float(np.median([t for win in tbts[:2] for t in win[w]]))
            ok &= live - calm < 0.5 * min(pads.values())
    return bool(ok)


def serve_patterns(report) -> dict:
    """Per worker (beta, mu, sigma) of the three serving frames in a
    window's smoothed EMA, rounded (printing only)."""
    from repro_torch.serve.workload import DECODE_STEP, KV_READ, QUEUE_WAIT
    pats = {}
    for d in report.diagnoses:
        a = d.abnormality
        if a.function in (QUEUE_WAIT, DECODE_STEP, KV_READ):
            pats[a.function] = np.round(np.asarray(a.patterns), 3).tolist()
    return pats


def wire_phase(K, K2, K3, profiles, fleet_res) -> dict:
    """The W=256, 20 s x 10 kHz fleet through
    ``diagnose_profiles(mode="wire")`` on the card: 256 per-worker
    ``summarize_and_upload`` calls (K1 per worker and rate group) over
    ``LoopbackWire``.  The diagnosis must equal fleet mode's (functions,
    workers, patterns bit for bit) and the payload bytes fleet mode's
    ``pattern_bytes``; four workers' uploads are held against the plain
    version of K1 on the card."""
    from repro_torch.core.daemon import summarize_and_upload
    from repro_torch.core.service import PerfTrackerService
    svc = PerfTrackerService()
    reset_counts(K, K2, K3)
    t = time.perf_counter()
    res = svc.diagnose_profiles(profiles, mode="wire")
    wall = time.perf_counter() - t
    by_variant = dict(K.pattern_summary.launches_by_variant)
    tm = res.timing
    print(f"[wire] W={len(profiles)} 20s x 10kHz over LoopbackWire: "
          f"summarize_s {tm['summarize_s']:.4f} transport_s "
          f"{tm['transport_s']:.4f} localize_s {tm['localize_s']:.4f} wall "
          f"{wall:.4f} s; K1 launches {by_variant}; payload bytes "
          f"{res.pattern_bytes} (fleet mode {fleet_res.pattern_bytes}); "
          f"transport {res.transport}")
    if res.functions() != fleet_res.functions():
        raise AssertionError("wire diagnosis functions differ from fleet's")
    for a, b in zip(res.diagnoses, fleet_res.diagnoses):
        if not (np.array_equal(a.abnormality.workers, b.abnormality.workers)
                and np.array_equal(a.abnormality.patterns,
                                   b.abnormality.patterns)):
            raise AssertionError(f"wire diagnosis of "
                                 f"{a.abnormality.function} differs")
    if res.pattern_bytes != fleet_res.pattern_bytes \
            or res.transport["present"] != len(profiles) \
            or by_variant["warp"] == 0 or by_variant["block"]:
        raise AssertionError("wire mode lost uploads or bytes")
    plain = PerfTrackerService(summarize_backend="torch")
    gap = 0.0
    for w in (0, 1, len(profiles) // 2, len(profiles) - 1):
        got, _ = summarize_and_upload(profiles[w],
                                      backend=svc.summarize_backend).unpack()
        want, _ = summarize_and_upload(
            profiles[w], backend=plain.summarize_backend).unpack()
        if list(got) != list(want):
            raise AssertionError(f"worker {w}: functions differ")
        gap = max(gap, max(float(np.abs(got[n].astype(np.float64)
                                        - want[n]).max()) for n in got))
    print(f"[wire] == fleet mode (functions, workers, patterns bit for "
          f"bit, bytes); 4 workers' uploads vs the plain version of K1: max "
          f"|pattern err| {gap:.3g}")
    if gap > PATTERN_ATOL:
        raise AssertionError("K1's uploads disagree with the plain version")
    return dict(launches=by_variant, timing=tm, err=gap)


def culprits(res) -> dict:
    return {i.function: sorted(i.workers) for i in res.incidents
            if i.function}


def child_uploads_vs_plain(runner, res, kept) -> float:
    """The uploads the children sent in window ``MP_CHECK_WINDOW`` for
    ``MP_CHECK_WORKERS``, against the same workers' profiles rebuilt in
    this process (the simulator is seeded by window and worker, as each
    child seeds it) and summarized by K1's plain version on the card:
    the same functions and kinds, and max |pattern err| within ``ATOL``."""
    from repro_torch.core.daemon import summarize_and_upload
    from repro_torch.core.simulation import FleetSimulator
    from repro_torch.online.scenario import _WINDOW_SEED_STRIDE
    from repro_torch.summarize.base import get_backend
    i, cfg = MP_CHECK_WINDOW, runner.sim_cfg
    sim = FleetSimulator(cfg, [])
    sim.faults = [sf.fault for sf in runner.schedule if sf.active(i)]
    slices = np.array_split(np.arange(cfg.n_workers), 2)
    plain = get_backend("torch", "cuda")
    worst = 0.0
    for w in MP_CHECK_WORKERS:
        mine = next(sl for sl in slices if w in sl).tolist()
        profiles = sim.profile_window_slice(
            mine, rates=res.reports[i].rates,
            seed=cfg.seed + _WINDOW_SEED_STRIDE * (i + 1))
        want_p, want_k = summarize_and_upload(profiles[mine.index(w)],
                                              backend=plain).unpack()
        got_p, got_k = kept[w].unpack()
        if got_k != want_k:
            raise AssertionError(f"worker {w}'s upload names other "
                                 f"functions or kinds than the plain version")
        worst = max([worst] + [float(np.abs(got_p[f] - want_p[f]).max())
                               for f in want_p])
    print(f"[multiprocess] window {i} uploads of workers "
          f"{list(MP_CHECK_WORKERS)} from the children vs the profiles "
          f"rebuilt here through K1's plain version: max |pattern err| "
          f"{worst:.3g} (tolerance {ATOL})")
    if worst > ATOL:
        raise AssertionError("a child's K1 upload disagrees with the plain "
                             "version")
    return worst


def multiprocess_phase(K, K2, K3, ARCHS) -> dict:
    """``run_multiprocess(n_procs=2)`` with the ``cuda`` backend in the
    children (each its own CUDA context; K1 built in the parent), on
    tests/test_wire.py's C1P1 cell (W=32, 1 s windows, 250/2000 Hz, 9
    windows, ``GpuThrottle(3, 11)`` in [2, 6)), flat and with 2 collector
    shards, each against the in-process run, the flat run's uploads of two
    workers against K1's plain version; then 4 trainers of the ``[trainer
    fleet]`` model (gemma2-2b at full width cut to 2 layers, K2's wgmma
    variant) in 2 processes on the card under ``DataloaderBurn(1)``."""
    from repro_torch.core import faults as F
    from repro_torch.core.mitigation import Action
    from repro_torch.core.simulation import SimConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.online import (EscalationPolicy, ScenarioRunner,
                                    ScheduledFault)
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.loop import TrainConfig
    from repro_torch.train.workload import (DataloaderBurn, TrainerWorkload,
                                            default_trainer_detector_cfg)

    def runner():
        return ScenarioRunner(
            SimConfig(n_workers=MP_W, window_s=1.0, rate_hz=2000.0, seed=5),
            [ScheduledFault(F.GpuThrottle(workers=(3, 11)), 2, 6)],
            n_windows=MP_WINDOWS,
            escalation=EscalationPolicy(n_workers=MP_W, base_rate_hz=250.0,
                                        full_rate_hz=2000.0))
    inproc = runner().run()
    want = culprits(inproc)
    out = {}
    for label, kw in (("flat", {}), ("tree", {"n_shards": 2})):
        r, kept = runner(), {}
        if label == "flat":
            tick = r.pipeline.window_tick_batch

            def keeping(batch, t=None, rates=None):
                if batch.window == MP_CHECK_WINDOW:
                    kept.update({w: batch.uploads[w]
                                 for w in MP_CHECK_WORKERS})
                return tick(batch, t=t, rates=rates)
            r.pipeline.window_tick_batch = keeping
        reset_counts(K, K2, K3)
        t = time.perf_counter()
        res = r.run_multiprocess(n_procs=2, window_timeout=120.0, **kw)
        run_s = time.perf_counter() - t
        ws = res.wire_summary()
        k1 = res.worker_launches.get("pattern_summary", {})
        print(f"[multiprocess] C1P1 {label}: {run_s:.2f} s, 2 processes; "
              f"culprits {culprits(res)} (in-process {want}); wire "
              f"{ws}; K1 launches in the children {k1}, in the parent "
              f"{dict(K.pattern_summary.launches_by_variant)}")
        if culprits(res) != want or ws["delivered"] != ws["expected"] \
                or not k1.get("warp") or k1.get("block"):
            raise AssertionError(f"multiprocess {label} differs from the "
                                 f"in-process run")
        out[label] = dict(launches=res.worker_launches, run_s=run_s)
        if kept:
            out[label]["err"] = child_uploads_vs_plain(r, res, kept)
    cfg = ARCHS["gemma2-2b"].with_overrides(num_layers=2)
    setup = (cfg, DataConfig(batch=1, seq_len=TRAIN_SEQ), OptConfig(),
             TrainConfig(perftracker=False))
    wl = TrainerWorkload(n_workers=4, setup=setup, device="cuda")
    r = ScenarioRunner(
        None, [ScheduledFault(DataloaderBurn(workers=(1,)), 2, 7)],
        n_windows=7, iters_per_window=FLEET_ITERS,
        detector_cfg=default_trainer_detector_cfg(FLEET_ITERS), workload=wl)
    reset_counts(K, K2, K3)
    t = time.perf_counter()
    res = r.run_multiprocess(n_procs=2, window_timeout=240.0)
    run_s = time.perf_counter() - t
    ws = res.wire_summary()
    incs = [(i.function, i.channel, list(i.workers),
             [p.action.value for p in i.plans]) for i in res.incidents]
    print(f"[multiprocess] trainers, DataloaderBurn(1), 4 x gemma2-2b at "
          f"{cfg.num_layers} layers in 2 processes: {run_s:.2f} s; wire "
          f"{ws}; incidents {incs}; launches in the children "
          f"{res.worker_launches}")
    hit = [i for i in res.incidents if i.function == "dataloader.next"
           and 1 in i.workers
           and Action.MIGRATE_DATALOADER in [p.action for p in i.plans]]
    k1 = res.worker_launches.get("pattern_summary", {})
    k2 = res.worker_launches.get("flash_attention", {})
    if not hit or ws["delivered"] != ws["expected"] or not k1.get("warp") \
            or not k2.get("wgmma") or k2.get("simt"):
        raise AssertionError("the trainer processes' DataloaderBurn was not "
                             "localized to dataloader.next on worker 1 "
                             "through K2's wgmma variant")
    out["trainer"] = dict(launches=res.worker_launches, run_s=run_s)
    return out


DIST_LAYERS = 4      # [dist one-rank]: gemma2-2b and deepseek at full width
#: the reference's tests/test_dist.py bounds: sharded vs single-device loss
#: and parameters after one step
DIST_LOSS_TOL = 1e-3
DIST_PARAM_TOL = 5e-3
#: deepseek's expert-parallel branch vs the local one, max |grad diff| over
#: the largest |grad| of the leaf (bf16: both run the same kernels on one
#: rank, so this is the room for a different summation order only)
DIST_MOE_GRAD_RTOL = 1e-2
CLI_STEPS = 3


def step_cost_phase(ARCHS) -> dict:
    """``[step cost]``: the count of one reduced gemma2 step (f32, 2 x 128
    tokens) on the card equals the count on the CPU: K2 counts by its FLOP
    formula whichever path its forward takes, K4 and K6 by their bytes (the
    CPU count routes the norms and the loss to K4's and K6's plain
    versions, as the card routes them to the kernels), and the rest is the
    same dispatched ops."""
    from repro_torch.kernels import cross_entropy as K6
    from repro_torch.kernels import rms_norm as K4
    from repro_torch.configs.registry import reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.step_cost import count_step
    from repro_torch.models.transformer import Transformer, map_params
    from repro_torch.optim.adamw import AdamW, OptConfig
    from repro_torch.train.step import make_split_train_step
    cfg = reduced(ARCHS["gemma2-2b"])
    model = Transformer(cfg)
    params = model.init(0, device="cpu")
    grad_fn, _ = make_split_train_step(model, AdamW(OptConfig()))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        cfg, DataConfig(batch=2, seq_len=128)).batch_at(0).items()}
    kernels = (K4, K6)
    takes = [k.takes for k in kernels]
    for k in kernels:
        k.takes = lambda t: type(t).__name__ != "DTensor"
    try:
        cpu = count_step(grad_fn, params, batch)
    finally:
        for k, t in zip(kernels, takes):
            k.takes = t
    card = count_step(grad_fn, map_params(lambda t: t.cuda(), params),
                      {k: v.cuda() for k, v in batch.items()})
    for op, name in (("rms_norm_bwd", "K4"), ("cross_entropy_bwd", "K6")):
        if not card.detail_bytes.get(op):
            raise AssertionError(f"[step cost] the card's step did not count "
                                 f"{name}")
    print(f"[step cost] reduced gemma2 (2 layers, d_model 64, f32, 2 x 128 "
          f"tokens): card {card.flops:.6g} FLOPs {card.bytes:.6g} bytes, "
          f"CPU {cpu.flops:.6g} FLOPs {cpu.bytes:.6g} bytes")
    if (card.flops, card.bytes, card.detail_flops) != \
            (cpu.flops, cpu.bytes, cpu.detail_flops):
        raise AssertionError("the step's count on the card differs from the "
                             "CPU's")
    return dict(flops=card.flops, bytes=card.bytes)


def _leaf_rel_diff(a_tree, b_tree) -> float:
    """max over leaves of max |a - b| / max |a| (b's leaves may be
    DTensors)."""
    from repro_torch.models.transformer import param_leaves
    worst = 0.0
    for (_, a), (_, b) in zip(param_leaves(a_tree), param_leaves(b_tree)):
        b = b.full_tensor() if hasattr(b, "full_tensor") else b
        d = float((a.float() - b.float()).abs().max())
        worst = max(worst, d / max(float(a.float().abs().max()), 1e-30))
    return worst


def _max_abs_diff(a_tree, b_tree) -> float:
    from repro_torch.models.transformer import param_leaves
    return max(float((a.float() - (b.full_tensor() if hasattr(
        b, "full_tensor") else b).float()).abs().max())
        for (_, a), (_, b) in zip(param_leaves(a_tree), param_leaves(b_tree)))


def dist_one_rank_phase(K, K2, K3, ARCHS) -> dict:
    """``[dist one-rank]``: a one-rank NCCL process group and a (1, 1)
    ``("data", "model")`` mesh.  gemma2-2b at full width cut to
    ``DIST_LAYERS`` layers: one AdamW step with ``dist`` against one
    without, from the same weights and batch (loss within 1e-3, parameters
    within 5e-3: the reference's test_dist bounds), K2 launched as wgmma
    inside the attention core's region; deepseek-v2-lite-16b cut to
    ``DIST_LAYERS`` layers through the expert-parallel branch against the
    local one run with the composed norms, as the mesh runs them (loss and
    every gradient); ``psum_compressed`` in its three
    methods over the group; the ``launch.train`` CLI for ``CLI_STEPS``
    steps of the gemma2 cut, with its PerfTracker report."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist.sharding import DistCtx
    from repro_torch.kernels import rms_norm as K4
    from repro_torch.launch import train as cli
    from repro_torch.models import moe as M
    from repro_torch.models.io import synth_batch
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim.adamw import AdamW, OptConfig
    from repro_torch.optim.compress import (dequantize_int8, psum_compressed,
                                            quantize_int8)
    from repro_torch.train.step import make_split_train_step, make_train_step
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    out = {}
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        d = DistCtx.from_mesh(mesh)
        # gemma2-2b: one step with and without dist
        cfg = ARCHS["gemma2-2b"].with_overrides(num_layers=DIST_LAYERS)
        batch = synth_batch(cfg, "train", 1, TRAIN_SEQ, seed=0)
        opt = AdamW(OptConfig())
        m1 = Transformer(cfg)
        p1 = m1.init(0)
        s1 = opt.init(p1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        p1, s1, met1 = make_train_step(m1, opt)(p1, s1, batch)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
        loss1 = float(met1["loss"])
        del s1
        torch.cuda.empty_cache()
        m2 = Transformer(cfg, dist=d)
        p2 = m2.init(0)
        p2 = d.place(p2, d.params_shardings(p2))
        s2 = opt.init(p2)
        b2 = d.place(batch, d.batch_shardings(batch))
        torch.cuda.synchronize()
        reset_counts(K, K2, K3)
        t = time.perf_counter()
        p2, s2, met2 = make_train_step(m2, opt)(p2, s2, b2)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t
        k2 = dict(K2.flash_attention.launches_by_variant)
        loss2 = float(met2["loss"].full_tensor())
        pdiff = _max_abs_diff(p1, p2)
        print(f"[dist one-rank] gemma2-2b at full width, {DIST_LAYERS} "
              f"layers, 1 x {TRAIN_SEQ} tokens: loss without dist {loss1:.6f}"
              f", with {loss2:.6f}; max |parameter diff| after the step "
              f"{pdiff:.3g} (bounds {DIST_LOSS_TOL}, {DIST_PARAM_TOL}); the "
              f"step {plain_s:.3f} s plain, {step_s:.3f} s sharded (host "
              f"clock, each one call); K2 launches {k2}")
        if not (abs(loss1 - loss2) < DIST_LOSS_TOL and pdiff < DIST_PARAM_TOL
                and k2 == {"wgmma": DIST_LAYERS, "simt": 0}):
            raise AssertionError("the one-rank sharded gemma2 step disagrees "
                                 "with the plain one, or K2 did not run as "
                                 "wgmma in its region")
        out.update(loss=(loss1, loss2), param_diff=pdiff, k2=k2,
                   step_s=step_s, plain_s=plain_s)
        del p1, p2, s2, met1, met2, m1, m2
        gc.collect()
        torch.cuda.empty_cache()

        # deepseek: the expert-parallel branch against the local one
        mcfg = ARCHS[MOE_ARCH].with_overrides(num_layers=DIST_LAYERS)
        mbatch = synth_batch(mcfg, "train", 1, TRAIN_SEQ, seed=1)
        mm1 = Transformer(mcfg)
        mp = mm1.init(0)
        # the local branch with the composed norms, as the mesh's DTensors
        # run them: K4's output may sit one bf16 step from theirs, which
        # can move a token's top-k experts; this check is about the
        # expert-parallel branch, not the norm
        takes, K4.takes = K4.takes, lambda t: False
        try:
            g1, mt1 = make_split_train_step(mm1, opt)[0](mp, mbatch)
        finally:
            K4.takes = takes
        mm2 = Transformer(mcfg, dist=d)
        ep_calls = []
        real_ep = M._moe_expert_parallel

        def counted_ep(*args):
            ep_calls.append(1)
            return real_ep(*args)
        M._moe_expert_parallel = counted_ep
        try:
            reset_counts(K, K2, K3)
            g2, mt2 = make_split_train_step(mm2, opt)[0](
                d.place(mp, d.params_shardings(mp)),
                d.place(mbatch, d.batch_shardings(mbatch)))
            torch.cuda.synchronize()
        finally:
            M._moe_expert_parallel = real_ep
        mk2 = dict(K2.flash_attention.launches_by_variant)
        ml1, ml2 = float(mt1["loss"]), float(mt2["loss"].full_tensor())
        grel = _leaf_rel_diff(g1, g2)
        n_moe = sum(1 for bp in mp["blocks"] if "moe" in bp)
        print(f"[dist one-rank] {MOE_ARCH} at full width, {DIST_LAYERS} "
              f"layers ({n_moe} MoE, {mcfg.num_experts} experts top-"
              f"{mcfg.top_k}): expert-parallel branch taken {len(ep_calls)} "
              f"times; loss local {ml1:.6f}, expert-parallel {ml2:.6f}; "
              f"max over leaves of max |grad diff| / max |grad| {grel:.3g} "
              f"(tolerance {DIST_MOE_GRAD_RTOL}); K2 launches {mk2}")
        if not (len(ep_calls) == n_moe and abs(ml1 - ml2) < DIST_LOSS_TOL
                and grel < DIST_MOE_GRAD_RTOL
                and mk2 == {"wgmma": DIST_LAYERS, "simt": 0}):
            raise AssertionError("deepseek's expert-parallel branch disagrees "
                                 "with the local one")
        out.update(moe_loss=(ml1, ml2), moe_grad_rel=grel, moe_k2=mk2)
        del mp, g1, g2, mt1, mt2, mm1, mm2
        gc.collect()
        torch.cuda.empty_cache()

        # compressed all-reduce over the one-rank group
        g = torch.from_numpy(np.random.default_rng(0).normal(
            0, 1, (4096,)).astype(np.float32)).cuda()
        errs = {}
        for method in ("none", "bf16", "int8"):
            got, _ = psum_compressed({"g": g}, dist.group.WORLD, method)
            want = {"none": g, "bf16": g.bfloat16().float(),
                    "int8": dequantize_int8(*quantize_int8(g))}[method]
            errs[method] = float((got["g"] - want).abs().max())
        print(f"[dist one-rank] psum_compressed over the one-rank NCCL "
              f"group, max |err| against the local round trip: {errs}")
        if any(errs.values()):
            raise AssertionError(f"psum_compressed on one rank {errs}")
        out["psum_errs"] = errs

        # the training CLI
        reset_counts(K, K2, K3)
        t = time.perf_counter()
        trainer, res = cli.main(["--arch", "gemma2-2b", "--layers",
                                 str(DIST_LAYERS), "--steps", str(CLI_STEPS),
                                 "--batch", "1", "--seq", str(TRAIN_SEQ)])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t
        ck2 = dict(K2.flash_attention.launches_by_variant)
        hist = trainer.history
        print(f"[dist one-rank] launch.train CLI: gemma2-2b --layers "
              f"{DIST_LAYERS} --steps {CLI_STEPS} --batch 1 --seq "
              f"{TRAIN_SEQ} in {cli_s:.2f} s; logged {hist}; K2 launches "
              f"{ck2}; PerfTracker report: "
              + (res.report() if res is not None else
                 "none (no diagnosis window opened: the detector learns the "
                 f"iteration over more than {CLI_STEPS} steps)"))
        if ck2 != {"wgmma": DIST_LAYERS * CLI_STEPS, "simt": 0} \
                or not hist or not all(math.isfinite(h["loss"])
                                       for h in hist):
            raise AssertionError("the training CLI did not run its steps "
                                 "through K2's wgmma variant")
        out.update(cli_k2=ck2, cli_s=cli_s, cli_history=hist)
        del trainer
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def start_script(args: list, log: Path):
    """A Python subprocess of this checkout (``PYTHONPATH=src``), its
    output to ``log``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env,
                            stdout=log.open("w"), stderr=subprocess.STDOUT)


def finish_scripts(runs: dict, timeout: float) -> dict:
    """Waits for each ``(Popen, log, started)`` of ``runs``; returns each
    one's (exit code, output, wall seconds).  A run still going at
    ``timeout`` is killed and fails."""
    out, end = {}, time.perf_counter() + timeout
    for name, (p, log, t0) in runs.items():
        try:
            rc = p.wait(timeout=max(1.0, end - time.perf_counter()))
        except subprocess.TimeoutExpired:
            p.kill()
            rc = p.wait()
        out[name] = (rc, log.read_text(), time.perf_counter() - t0)
    return out


def dryrun_phase(ARCHS, tr) -> dict:
    """``[dryrun]`` (``launch.dryrun``): the step ``[trainer]`` ran,
    traced on fake tensors through K2's fake implementation on the card's
    route, counted equal to that step's real count on the card, exactly
    (FLOPs, bytes, and both by op); the dry peak of live bytes of the
    whole step (parameters, gradients, AdamW state, activations) against
    ``max_memory_allocated`` over the trainer's steps, within
    ``DRYRUN_MEM_TOL``, and the same check failing on an estimate that
    leaves out the optimizer state; then ``DRYRUN_CELLS`` through
    ``python -m repro_torch.launch.dryrun``, each in a process of its own
    (a fake process group of 256 or 512 ranks), each printing its
    ``[ok]`` line."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.step_cost import count_step
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim.adamw import AdamW, OptConfig
    from repro_torch.train.step import make_split_train_step
    logs = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    runs = {}
    for arch, shape, mesh in DRYRUN_CELLS:
        name = f"{mesh} {arch} {shape}"
        log = logs / f"{mesh}__{arch}__{shape}.log"
        runs[name] = (start_script(
            ["-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
             shape, "--mesh", mesh, "--out", str(logs), "--force"], log),
            log, time.perf_counter())

    cfg = ARCHS["gemma2-2b"]
    real = tr["step_cost"]
    grad_fn, _ = make_split_train_step(Transformer(cfg), AdamW(OptConfig()))
    host = SyntheticLM(cfg, DataConfig(batch=1, seq_len=TRAIN_SEQ)
                       ).batch_at(0)
    t = time.perf_counter()
    with FakeTensorMode():
        params = Transformer(cfg).init(0, device="cuda")
        batch = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                                device="cuda") for k, v in host.items()}
        dry = count_step(grad_fn, params, batch)
    count_s = time.perf_counter() - t
    diff = {k: (getattr(real, k), getattr(dry, k))
            for k in ("flops", "bytes", "detail_flops", "detail_bytes",
                      "coll_counts") if getattr(real, k) != getattr(dry, k)}
    print(f"[dryrun] {cfg.name} trainer step (1 x {TRAIN_SEQ}): dry count "
          f"{dry.flops:.6g} FLOPs, {dry.bytes:.6g} bytes (flash_attention "
          f"{dry.detail_flops.get('flash_attention', 0):.6g} FLOPs by its "
          f"fake implementation), traced in {count_s:.2f} s; real count on "
          f"the card {real.flops:.6g} FLOPs, {real.bytes:.6g} bytes; equal "
          f"by op: {not diff}")
    if diff or not dry.detail_flops.get("flash_attention"):
        raise AssertionError(f"[dryrun] dry count != real count: {diff}")

    shape = ShapeConfig("trainer", TRAIN_SEQ, 1, "train")
    t = time.perf_counter()
    low, _ = D.lower_cell(cfg.name, shape.name, False, cfg=cfg, shape=shape,
                          mesh_shape=(), device="cuda")
    _, arg_bytes, peak, _ = D.trace(low)
    trace_s = time.perf_counter() - t
    opt_bytes = D.local_bytes(low.args[1])
    ratio = peak / tr["peak"]
    ratio_no_opt = (peak - opt_bytes) / tr["peak"]
    ok = abs(ratio - 1.0) <= DRYRUN_MEM_TOL
    ok_no_opt = abs(ratio_no_opt - 1.0) <= DRYRUN_MEM_TOL
    print(f"[dryrun] memory: dry peak {peak} bytes (arguments {arg_bytes}, "
          f"of which AdamW state {opt_bytes}; traced in {trace_s:.2f} s) vs "
          f"max_memory_allocated {tr['peak']} bytes over [trainer]'s steps: "
          f"ratio {ratio:.4f} (tolerance {DRYRUN_MEM_TOL}: "
          f"{'pass' if ok else 'FAIL'}); without the optimizer state "
          f"{ratio_no_opt:.4f} ({'pass' if ok_no_opt else 'fails'}, as it "
          f"must)")
    if not ok or ok_no_opt:
        raise AssertionError("[dryrun] memory estimate vs the card")

    cells = {}
    for name, (rc, text, wall) in finish_scripts(runs, DRYRUN_TIMEOUT
                                                 ).items():
        line = next((ln for ln in text.splitlines()
                     if ln.startswith(("[ok]", "[FAIL]"))), "no report")
        print(f"[dryrun] {name}: {line} ({wall:.1f} s, exit {rc})")
        if rc != 0 or not line.startswith("[ok]"):
            raise AssertionError(f"[dryrun] {name} failed:\n{text[-3000:]}")
        cells[name] = wall
    shutil.rmtree(logs, ignore_errors=True)
    return dict(count_s=count_s, flops=dry.flops,
                k2_flops=dry.detail_flops["flash_attention"], ratio=ratio,
                ratio_no_opt=ratio_no_opt, peak=peak, real_peak=tr["peak"],
                cells=cells)


def examples_phase() -> dict:
    """``[examples]`` (``examples_torch/``, on the card): the ring fault
    (worker 9 on ``AllGather_RING``, ``replace_hosts [9]``), a short
    ``train_lm`` (loss lower, checkpoints written) and ``serve_lm``
    (tokens generated), each a process of its own, run together."""
    logs = Path(tempfile.mkdtemp(prefix="chip_smoke_examples_"))
    runs = {}
    for name, args in EXAMPLE_RUNS.items():
        args = [str(ROOT / "examples_torch" / args[0]), *args[1:]]
        if name == "train_lm":
            args += ["--ckpt-dir", str(logs / "train_lm_ckpt")]
        log = logs / f"{name}.log"
        runs[name] = (start_script(args, log), log, time.perf_counter())
    out = {}
    for name, (rc, text, wall) in finish_scripts(runs, EXAMPLE_TIMEOUT
                                                 ).items():
        missing = [w for w in EXAMPLE_EXPECT[name] if w not in text]
        print(f"[examples] {name}: exit {rc}, {wall:.1f} s; expected lines "
              f"{'all present' if not missing else f'MISSING {missing}'}")
        for ln in text.splitlines():
            if any(w in ln for w in EXAMPLE_EXPECT[name]):
                print(f"[examples]   {ln.strip()}")
        if rc != 0 or missing:
            raise AssertionError(f"[examples] {name}:\n{text[-3000:]}")
        out[name] = wall
    shutil.rmtree(logs, ignore_errors=True)
    return out


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
        from repro_torch.kernels import _build
        from repro_torch.kernels import causal_conv as K5
        from repro_torch.kernels import cross_entropy as K6
        from repro_torch.kernels import flash_attention as K2
        from repro_torch.kernels import pattern_summary as K
        from repro_torch.kernels import rms_norm as K4
        from repro_torch.kernels import ssd_scan as K3
        from repro_torch.summarize.engine import summarize_profile
        from repro_torch.summarize.fleet import pack_fleet
        from repro_torch.configs.registry import ARCHS
        from repro_torch.data.pipeline import DataConfig
        from repro_torch.instrument.tracer import Tracer
        from repro_torch.models import attention_core as C
        from repro_torch.models import layers as L
        from repro_torch.models.transformer import Transformer
        from repro_torch.optim.adamw import OptConfig
        from repro_torch.train.loop import Trainer, TrainConfig
        from repro_torch.train.workload import (DataloaderBurn, StepThrottle,
                                                TrainerWorkload)
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    clock = PhaseClock()
    card = gpu_line()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | {card}")

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("fp32 matmuls must not run in TF32")

    # -- 1. build the six kernels at once --------------------------------------
    t = time.perf_counter()
    libs = _build.build_all([(K.SOURCE, "k1_pattern_summary"),
                             (K2.SOURCE, "k2_flash_attention"),
                             (K3.SOURCE, "k3_ssd_scan"),
                             (K4.SOURCE, "k4_rms_norm"),
                             (K5.SOURCE, "k5_causal_conv"),
                             (K6.SOURCE, "k6_cross_entropy")])
    print(f"[build] {[lib.name for lib in libs]} in "
          f"{time.perf_counter() - t:.2f}s (parallel nvcc)")
    for lib in libs:
        print(lib.with_suffix(".log").read_text().strip())
    k1_ptxas = ptxas_summary(libs[0].with_suffix(".log").read_text())
    print("[build] K1 registers / spill-store bytes: " + ", ".join(
        f"{name} {v['registers']}/{v['spill_bytes']}"
        for name, v in sorted(k1_ptxas.items())))
    K.pattern_summary.library()
    K2.flash_attention.library()
    K3.ssd_scan.library()
    K4.rms_norm.library()
    K5.causal_conv_silu.library()
    K6.cross_entropy.library()
    for dt in (torch.bfloat16, torch.float32):
        print(f"[build] K2 {dt}: " + ", ".join(
            f"D={d} {K2.variant_for(dt, d)} "
            f"{K2.flash_attention.smem_bytes(dt, d)} bytes of shared memory"
            for d in K2.HEAD_DIMS))
    print(f"[build] K2 bf16 (D, Dv)={K2.MLA_HEAD_DIMS}: "
          f"{K2.variant_for(torch.bfloat16, *K2.MLA_HEAD_DIMS)} "
          f"{K2.flash_attention.smem_bytes(torch.bfloat16, *K2.MLA_HEAD_DIMS)}"
          f" bytes of shared memory")
    sass, sass3 = sass_counts(libs[1]), sass_counts(libs[2])
    for name, counts in (("K2", sass), ("K3", sass3)):
        if counts is None:
            print(f"[build] {name} SASS: cuobjdump not found, not counted")
            continue
        print(f"[build] {name} SASS: {counts['HGMMA']} HGMMA (wgmma) and "
              f"{counts['UTMALDG']} UTMALDG (TMA load) instructions")
        if not (counts["HGMMA"] and counts["UTMALDG"]):
            raise AssertionError(f"{name}'s library holds no wgmma or no "
                                 f"TMA load")
    print(f"[build] K3 dynamic shared memory per block at mamba2-2.7b's "
          f"layer (N 128, Q 256): wgmma state / cb / scan passes "
          f"{K3.ssd_scan.wgmma_smem_bytes(128, 256)} bytes; SIMT (f32, P "
          f"slice {K3.p_split_for(64)}) {K3.ssd_scan.smem_bytes(128, 256, 64)}"
          f" bytes")

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

    clock.lap("build and fleet simulation")

    # -- 2. kernel vs plain version on the card -------------------------------
    rng = np.random.default_rng(0)
    inputs = {f"fleet_group({g.u.shape[0]},{g.u.shape[1]})": g.u
              for g in groups}
    inputs.update(adversarial_matrices(rng))
    mismatch_rows, max_err = 0, 0.0
    for name, u in inputs.items():
        for variant in K.VARIANTS:
            if variant == "warp" and u.shape[1] > K.WARP_MAX_N:
                continue
            m, e = compare(K, u, variant)
            mismatch_rows += m
            max_err = max(max_err, e)
            print(f"[check] {name} variant={variant}: count mismatches {m}, "
                  f"max |mean/std err| {e:.3g}")
    if mismatch_rows or max_err > ATOL:
        raise AssertionError(f"K1 disagrees with its plain version: "
                             f"{mismatch_rows} rows, err {max_err}")
    for g in groups:
        print(f"[check] fleet_group{g.u.shape} rows by path: "
              f"{row_paths(g.u)}; live samples {int(g.lengths.sum())} of "
              f"{g.u.size} ({g.lengths.sum() / g.u.size:.1%})")
    live = sum(int(g.lengths.sum()) for g in groups)
    print(f"[check] fleet: live samples {live} of "
          f"{sum(g.u.size for g in groups)} "
          f"({live / sum(g.u.size for g in groups):.1%}); the rest is "
          f"padding that K1 reads and its bytes bound counts")

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    k1_sums = dict.fromkeys(("device", "ms", "block_ms", "plain", "h2d",
                             "h2d_pinned", "bound"), 0.0)
    for g in groups:
        E, n = g.u.shape
        u = torch.from_numpy(g.u).cuda()
        dev, by_kernel = k1_device_ms(K, u, flush)
        t = dict(
            device=dev,
            ms=timed_ms(lambda: K.pattern_summary(u), TIMED_LAUNCHES, flush),
            block_ms=timed_ms(lambda: K.pattern_summary(u, variant="block"),
                              TIMED_LAUNCHES, flush),
            plain=timed_ms(lambda: K.pattern_summary_reference(u), 2, flush),
            bound=K.bound_ms(E, n))
        t["h2d"], t["h2d_pinned"] = h2d_ms(g.u)
        for key in k1_sums:
            k1_sums[key] += t[key]
        print(f"[time] K1 ({E}, {n}) variant={K.variant_for(n)} "
              f"lane_samples={K.lane_samples_for(n)}: device "
              f"{t['device']:.4f} ms ({share(t['bound'], t['device'])} of "
              f"bound), timed {t['ms']:.4f} ms ({share(t['bound'], t['ms'])}), "
              f"bound {t['bound']:.4f} ms, block variant timed "
              f"{t['block_ms']:.4f} ms, plain {t['plain']:.3f} ms, h2d "
              f"pageable {t['h2d']:.3f} ms, pinned {t['h2d_pinned']:.3f} ms")
        for name, ms in by_kernel.items():
            print(f"[time]   {ms:.4f} ms  {name[:100]}")
        del u
    del flush
    print(f"[time] K1 per diagnosis (all groups): device "
          f"{k1_sums['device']:.4f} ms, timed {k1_sums['ms']:.4f} ms, bound "
          f"{k1_sums['bound']:.4f} ms ({share(k1_sums['bound'], k1_sums['device'])}"
          f" of bound by device time), block variant timed "
          f"{k1_sums['block_ms']:.4f} ms, plain {k1_sums['plain']:.3f} ms, "
          f"h2d pageable {k1_sums['h2d']:.3f} ms, pinned "
          f"{k1_sums['h2d_pinned']:.3f} ms")

    clock.lap("K1 check and time")

    # -- 3. ring fault (examples/diagnose_ring_fault.py) ----------------------
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
    reset_counts(K, K2, K3)
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
    reset_counts(K, K2, K3)
    t = time.perf_counter()
    res = svc.diagnose_profiles(profiles)
    wall = time.perf_counter() - t
    launches = K.pattern_summary.launches
    k1_by_variant = dict(K.pattern_summary.launches_by_variant)
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
          f"K1 launches {launches} {k1_by_variant} for {len(groups)} groups")
    print(f"[fleet] flagged {flagged}; plans {plans}")
    if launches != len(groups) or launches == 0 \
            or k1_by_variant["warp"] != launches:
        raise AssertionError("the main path did not launch K1's warp variant "
                             "once per group")
    want = [0, 1, 2, 3]
    if flagged.get(GEMM) != want or flagged.get(ALLGATHER) != want \
            or plans[0] != ("replace_hosts", want):
        raise AssertionError("fleet not diagnosed as the reference does")
    host = PerfTrackerService(summarize_backend="numpy")
    same_diagnosis(res, host.diagnose_profiles(profiles), 256)
    print("[fleet] cuda diagnosis == host numpy diagnosis")
    clock.lap("ring fault and fleet diagnosis")

    # -- 4b. the same fleet over the socket transport (mode="wire") ---------
    wire = wire_phase(K, K2, K3, profiles, res)
    del profiles, groups, res, host
    clock.lap("wire")

    # -- 5. K2 against its plain version, and its times -----------------------
    k2_err = k2_checks(K2)
    clock.lap("K2 check")
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    k2_times = k2_timing(K2, flush)
    k2_mla = k2_sdpa_timing(K2, flush, "deepseek-v2 MLA", 16, 192, 128,
                            MLA_SCALE)
    k2_zamba = k2_sdpa_timing(K2, flush, "zamba2-7b shared attention", 32,
                              112, 112, 112 ** -0.5, ZAMBA_WINDOW, seed=5)
    k2_instruct = k2_sdpa_timing(
        K2, flush, "zamba2-7b-instruct shared attention", INSTRUCT_HEADS,
        INSTRUCT_D, INSTRUCT_D, INSTRUCT_SCALE, seed=6, seq=INSTRUCT_SEQ)
    bwd = attention_backward_ms(C, K2, flush)
    head = logits_ce_ms(L, K6, flush)
    del flush
    n_pairs = ARCHS["gemma2-2b"].num_layers // 2
    fwd_step = n_pairs * (k2_times[(TRAIN_SEQ, "local")]["ms"]
                          + k2_times[(TRAIN_SEQ, "global")]["ms"])
    bwd_step = n_pairs * (bwd["local"] + bwd["global"])
    print(f"[breakdown] per full-depth step at {TRAIN_SEQ} tokens: K2 "
          f"forward {fwd_step:.3f} ms (26 launches), plain attention backward "
          f"{bwd_step:.3f} ms (26 layers; one layer local {bwd['local']:.3f} "
          f"/ global {bwd['global']:.3f} ms), LM head + softcap + CE "
          f"forward+backward {head['k6']:.3f} ms by K6 (the composed ops "
          f"{head['composed']:.3f} ms)")
    torch.cuda.empty_cache()
    clock.lap("K2 time and breakdown")

    # -- 6. the step's cost on the card and on the CPU, then the full
    # gemma2-2b trainer (the main path of K2, counted by [step cost]) -------
    cost_check = step_cost_phase(ARCHS)
    tr = trainer_phase("[trainer]", ARCHS["gemma2-2b"], TRAIN_SEQ,
                       (K, K2, K3), "K2", K2.flash_attention, "flash_fwd",
                       Trainer, TrainConfig, DataConfig, OptConfig, Tracer)
    print(f"[trainer] K2 launches by variant in the {TRAIN_STEPS} counted "
          f"steps: {tr['by_variant']}")
    if tr["by_variant"] != {"wgmma": tr["launches"], "simt": 0}:
        raise AssertionError("the gemma2 trainer's K2 launches were not all "
                             "wgmma")
    k6_check_steps("[trainer]", tr)
    clock.lap("gemma2 trainer")

    # -- 7. the trainer fleet, diagnosed on the card --------------------------
    trainer_fleet_phase(K, K2, K3, ARCHS, TrainerWorkload, DataloaderBurn,
                        StepThrottle, TrainConfig, DataConfig, OptConfig,
                        PerfTrackerService, plan_mitigations,
                        summarize_profile)
    clock.lap("trainer fleet")

    # -- 7b. distribution on a one-rank mesh, and the training CLI ----------
    dist_run = dist_one_rank_phase(K, K2, K3, ARCHS)
    clock.lap("dist one-rank")

    # -- 8. K3 against its plain version, and its times -----------------------
    k3_err = k3_checks(K3)
    clock.lap("K3 check")
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    k3_time = k3_timing(K3, flush)
    del flush
    torch.cuda.empty_cache()
    clock.lap("K3 time")

    # -- 8b. K4 against its plain versions, and its times ---------------------
    k4_err = k4_checks(K4)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    k4_time = k4_timing(K4, flush)
    clock.lap("K4 check and time")

    # -- 8c. K5 against the composed ops, and its times -----------------------
    k5_err = k5_checks(K5)
    k5_time = k5_timing(K5, flush)
    clock.lap("K5 check and time")

    # -- 8d. K6 against the composed ops, and its times -----------------------
    k6_err = k6_checks(K6)
    k6_time = k6_timing(K6, flush)
    del flush
    torch.cuda.empty_cache()
    clock.lap("K6 check and time")

    # -- 9. the full mamba2-2.7b trainer: the main path of K3 -----------------
    mcfg = ARCHS[MAMBA]
    mtr = trainer_phase("[mamba2 trainer]", mcfg, MAMBA_SEQ, (K, K2, K3),
                        "K3", K3.ssd_scan, "ssd_fwd", Trainer, TrainConfig,
                        DataConfig, OptConfig, Tracer)
    print(f"[mamba2 trainer] per step at {MAMBA_SEQ} tokens: K3 forward "
          f"{mcfg.num_layers * k3_time['ms']:.3f} ms ({mcfg.num_layers} "
          f"launches), plain SSD backward "
          f"{mcfg.num_layers * k3_time['backward_ms']:.3f} ms "
          f"({mcfg.num_layers} layers, timed alone); K3 launches in the "
          f"{TRAIN_STEPS} counted steps {mtr['launches']} "
          f"{mtr['by_variant']}; peak {mtr['peak']} bytes, state "
          f"{mtr['state_bytes']} bytes")
    if mtr["by_variant"] != {"wgmma": mtr["launches"], "simt": 0}:
        raise AssertionError("the mamba2 trainer's K3 launches were not all "
                             "wgmma")
    norms = 2 * mcfg.num_layers + 1
    print(f"[mamba2 trainer] K4 launches a step {mtr['k4_per_step'][0]} "
          f"(the pre-norm and the gated norm of each layer, and the final "
          f"norm: {norms} each way), by variant over the {TRAIN_STEPS} "
          f"counted steps {mtr['k4_by_variant']}")
    if mtr["k4_per_step"] != [{"forward": norms, "backward": norms}] \
            * TRAIN_STEPS or mtr["k4_by_variant"] != {
                "plain": 2 * (mcfg.num_layers + 1) * TRAIN_STEPS,
                "gated": 2 * mcfg.num_layers * TRAIN_STEPS}:
        raise AssertionError("the mamba2 trainer's K4 launches were not one "
                             "a norm each way")
    k5_check_steps("[mamba2 trainer]", mtr, mcfg.num_layers)
    k6_check_steps("[mamba2 trainer]", mtr)
    clock.lap("mamba2 trainer")

    # -- 10. the online loop: catalog, paper-window fleet, real rollback ------
    online_cat = online_catalog_phase(K, K2, K3)
    clock.lap("online catalog")
    online_fleet = online_fleet_phase(K, K2, K3)
    clock.lap("online fleet")
    rollback = online_rollback_phase(K, K2, K3, ARCHS)   # K1 by variant
    clock.lap("online rollback")

    # -- 11. serving: the engine at full width, then the serve fleet ---------
    engine = serve_engine_phase(K, K2, K3, ARCHS)
    clock.lap("serve engine")

    # -- 11b. the moe family: deepseek-v2-lite-16b served at full depth, one
    # llama4-maverick (dense, MoE) pair, deepseek trained with depth cut -----
    moe_serve = moe_serve_phase(K, K2, K3, ARCHS)
    clock.lap("moe serve")
    moe_pair = moe_pair_phase(K, K2, K3, ARCHS)
    clock.lap("moe pair")
    mtcfg = ARCHS[MOE_ARCH].with_overrides(num_layers=MOE_TRAIN_LAYERS)
    moe_tr = trainer_phase("[moe trainer]", mtcfg, TRAIN_SEQ, (K, K2, K3),
                           "K2", K2.flash_attention, "flash_fwd", Trainer,
                           TrainConfig, DataConfig, OptConfig, Tracer)
    print(f"[moe trainer] K2 launches by variant in the {TRAIN_STEPS} "
          f"counted steps: {moe_tr['by_variant']}; aux losses "
          f"{moe_tr['aux']}; peak {moe_tr['peak']} bytes, state "
          f"{moe_tr['state_bytes']} bytes")
    if moe_tr["by_variant"] != {"wgmma": moe_tr["launches"], "simt": 0}:
        raise AssertionError("the moe trainer's K2 launches were not all "
                             "wgmma")
    k6_check_steps("[moe trainer]", moe_tr)
    clock.lap("moe trainer")

    # -- 11c. the hybrid family: zamba2-7b served at full depth, trained with
    # depth cut, then with remat="full" --------------------------------------
    hyb_serve = hybrid_serve_phase(K, K2, K3, ARCHS)
    clock.lap("hybrid serve")
    zcfg = ARCHS[ZAMBA].with_overrides(num_layers=ZAMBA_TRAIN_LAYERS)
    hyb_tr = trainer_phase("[hybrid trainer]", zcfg, TRAIN_SEQ, (K, K2, K3),
                           "K3", K3.ssd_scan, "ssd_fwd", Trainer, TrainConfig,
                           DataConfig, OptConfig, Tracer)
    napp = len(Transformer(zcfg).layer_specs())
    print(f"[hybrid trainer] {ZAMBA_TRAIN_LAYERS} layers ({napp} groups of "
          f"{zcfg.shared_attn_every} + a tail of "
          f"{ZAMBA_TRAIN_LAYERS % zcfg.shared_attn_every}): launches in the "
          f"{TRAIN_STEPS} counted steps K2 {hyb_tr['k2_by_variant']}, K3 "
          f"{hyb_tr['k3_by_variant']}; peak {hyb_tr['peak']} bytes, state "
          f"{hyb_tr['state_bytes']} bytes")
    if hyb_tr["k2_by_variant"] != {"wgmma": napp * TRAIN_STEPS, "simt": 0} \
            or hyb_tr["k3_by_variant"] != {
                "wgmma": ZAMBA_TRAIN_LAYERS * TRAIN_STEPS, "simt": 0}:
        raise AssertionError("the hybrid trainer's K2 and K3 launches were "
                             "not all wgmma, or not one an application")
    k5_check_steps("[hybrid trainer]", hyb_tr, ZAMBA_TRAIN_LAYERS)
    k6_check_steps("[hybrid trainer]", hyb_tr)
    hyb_remat = hybrid_remat_phase(K, K2, K3, zcfg, hyb_tr, Trainer,
                                   TrainConfig, DataConfig, OptConfig)
    clock.lap("hybrid trainer")
    serve = serve_fleet_phase(K, K2, K3, ARCHS, SERVE_EXPECT)
    clock.lap("serve fleet")

    # -- 12. worker processes over the socket transport ----------------------
    mp_runs = multiprocess_phase(K, K2, K3, ARCHS)
    clock.lap("multiprocess")

    # -- the dry run ([trainer]'s step traced without data, three
    # production cells in their own processes) and the examples, last:
    # run before [k3 time], phases made its profiler trace lose passes --
    dry = dryrun_phase(ARCHS, tr)
    clock.lap("dryrun")
    examples = examples_phase()
    clock.lap("examples")

    # -- 13. kernels line, card, contract line --------------------------------
    k2_main = k2_times[(TRAIN_SEQ, "global")]
    print(json.dumps({"kernels": [{
        "name": "pattern_summary",
        "route": "cuda",
        "source": "src/repro_torch/csrc/pattern_summary.cu",
        "replaces": "src/repro/kernels/pattern_summary.py:73",
        "variant": "warp",
        "launches": launches,
        "launches_by_variant": k1_by_variant,
        "ptxas": k1_ptxas,
        "count_mismatch_rows": mismatch_rows,
        "max_abs_err": max_err,
        "ms": k1_sums["ms"],
        "device_ms": k1_sums["device"],
        "block_variant_ms": k1_sums["block_ms"],
        "plain_ms": k1_sums["plain"],
        "h2d_ms": k1_sums["h2d"],
        "h2d_pinned_ms": k1_sums["h2d_pinned"],
        "bound_ms": k1_sums["bound"],
        "bound_by": "bytes",
        "library_ms": None,
        "dry_run": "not reached: the dry run traces model steps",
        "online_launches_by_variant": {
            "catalog": online_cat["launches"],
            "fleet": online_fleet["launches"],
            "rollback": rollback},
        "online_general_rows": {"catalog": online_cat["general_rows"],
                                "fleet": online_fleet["general_rows"]},
        "online_general_max_abs_err": online_cat["general_err"],
        "serve_fleet_launches_by_variant": {
            name: serve[name]["launches"] for name in SERVE_EXPECT},
        "serve_fleet_rows_by_path": {
            name: serve[name]["rows"] for name in SERVE_EXPECT},
        "serve_fleet_general_max_abs_err": serve["general_err"],
        "wire_launches_by_variant": wire["launches"],
        "wire_max_abs_err": wire["err"],
        "multiprocess_child_launches_by_variant": {
            label: run["launches"].get("pattern_summary")
            for label, run in mp_runs.items()},
        "multiprocess_upload_max_abs_err": mp_runs["flat"]["err"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:25",
        "variant": "wgmma",
        "launches": tr["launches"],
        "launches_by_variant": tr["by_variant"],
        "sass": sass,
        "shape": f"bf16 q (1, {TRAIN_SEQ}, 8, 256) k/v (1, {TRAIN_SEQ}, 4, "
                 f"256), causal, softcap 50, global layer",
        "max_abs_err": k2_err["bf16"],
        "max_abs_err_f32": k2_err["f32"],
        "max_abs_err_lse": k2_err["lse"],
        "ms": k2_main["ms"],
        "plain_ms": k2_main["plain_ms"],
        "bound_ms": k2_main["bound_ms"],
        "bound_by": k2_main["bound_by"],
        "library_ms": k2_main["library_ms"],
        "library_call": "torch.compile(flex_attention), tanh score_mod, "
                        "causal block mask, enable_gqa",
        "dry_run": "traced through repro_torch::flash_attention_fwd's fake "
                   f"implementation ([dryrun]: {dry['k2_flops']:.6g} FLOPs "
                   "by formula in the gemma2-2b step)",
        "library_max_abs_err": k2_main["library_err"],
        "softcap0_ms": k2_main["ms_softcap0"],
        "softcap0_sdpa_ms": k2_main["sdpa_ms"],
        "serve_engine_forward_launches_by_variant": engine["k2"],
        "serve_engine_f32_forward_launches_by_variant": engine["f32"]["k2"],
        "serve_engine_max_logit_err": {
            "decode_vs_forward": engine["err"],
            "decode_vs_plain_forward": engine["ctrl"],
            "forward_vs_plain_forward": engine["gap"]},
        "multiprocess_trainer_child_launches_by_variant":
            mp_runs["trainer"]["launches"].get("flash_attention"),
        "dist_one_rank_launches_by_variant": dist_run["k2"],
        "dist_moe_launches_by_variant": dist_run["moe_k2"],
        "train_cli_launches_by_variant": dist_run["cli_k2"],
        "step_cost_flops": tr["cost"]["detail_flops"].get(
            "flash_attention"),
        "mla_shape": {
            "shape": f"bf16 q/k (1, {TRAIN_SEQ}, 16, 192) v (1, {TRAIN_SEQ}, "
                     f"16, 128), causal: one deepseek-v2-lite-16b layer",
            "launches": moe_tr["launches"],
            "launches_by_variant": moe_tr["by_variant"],
            "serve_forward_launches_by_variant": moe_serve["k2"],
            "pair_forward_launches_by_variant": moe_pair["k2"],
            "max_abs_err": k2_err["mla"],
            "ms": k2_mla["ms"],
            "device_ms": k2_mla["device_ms"],
            "plain_ms": k2_mla["plain_ms"],
            "bound_ms": k2_mla["bound_ms"],
            "bound_by": k2_mla["bound_by"],
            "library_ms": k2_mla["library_ms"],
            "library_call": "scaled_dot_product_attention(is_causal=True, "
                            f"scale=192^-0.5), backend "
                            f"{k2_mla['library_backend']}",
            "library_max_abs_err": k2_mla["library_err"]},
        "zamba2_shape": {
            "shape": f"bf16 q/k/v (1, {TRAIN_SEQ}, 32, 112), causal, window "
                     f"{ZAMBA_WINDOW}: zamba2-7b's shared attention block "
                     f"(tiles of 128, columns 112-127 zero)",
            "launches": sum(hyb_tr["k2_by_variant"].values()),
            "launches_by_variant": hyb_tr["k2_by_variant"],
            "remat_launches_per_step": hyb_remat["k2_per_step"],
            "serve_forward_launches_by_variant": hyb_serve["k2"],
            "serve_f32_forward_launches_by_variant": hyb_serve["f32"]["k2"],
            "max_abs_err": k2_err["zamba"]["out"],
            "max_abs_err_lse": k2_err["zamba"]["lse"],
            "ms": k2_zamba["ms"],
            "device_ms": k2_zamba["device_ms"],
            "plain_ms": k2_zamba["plain_ms"],
            "bound_ms": k2_zamba["bound_ms"],
            "bound_by": k2_zamba["bound_by"],
            "library_ms": k2_zamba["library_ms"],
            "library_call": "scaled_dot_product_attention(is_causal=True, "
                            f"scale=112^-0.5), backend "
                            f"{k2_zamba['library_backend']}",
            "library_max_abs_err": k2_zamba["library_err"]},
        "zamba2_instruct_shape": {
            "shape": f"bf16 q/k/v (1, {INSTRUCT_SEQ}, {INSTRUCT_HEADS}, "
                     f"{INSTRUCT_D}), causal, scale 112^-0.5: "
                     f"zamba2-7b-instruct's shared attention (tiles of 256, "
                     f"columns 224-255 zero)",
            "max_abs_err": k2_err["instruct"]["out"],
            "max_abs_err_lse": k2_err["instruct"]["lse"],
            "ms": k2_instruct["ms"],
            "device_ms": k2_instruct["device_ms"],
            "plain_ms": k2_instruct["plain_ms"],
            "bound_ms": k2_instruct["bound_ms"],
            "bound_by": k2_instruct["bound_by"],
            "library_ms": k2_instruct["library_ms"],
            "library_call": "scaled_dot_product_attention(is_causal=True, "
                            f"scale=112^-0.5), backend "
                            f"{k2_instruct['library_backend']}",
            "library_max_abs_err": k2_instruct["library_err"]},
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:25",
        "variant": "wgmma",
        "launches": mtr["launches"],
        "launches_by_variant": mtr["by_variant"],
        "sass": sass3,
        "shape": "bf16 x (1, 2048, 80, 64), B/C (1, 2048, 1, 128), dt f32, "
                 "chunk 256: one mamba2-2.7b layer",
        "max_abs_err": k3_err["bf16"],
        "max_rel_err_f32": k3_err["f32"],
        "ms": k3_time["ms"],
        "plain_ms": k3_time["plain_ms"],
        "bound_ms": k3_time["bound_ms"],
        "bound_by": k3_time["bound_by"],
        "library_ms": None,
        "library_call": "none: no PyTorch call computes the SSD scan",
        "dry_run": "traced through repro_torch::ssd_scan_fwd's fake "
                   "implementation (the mamba2-2.7b and zamba2-7b cells)",
        "plain_backward_ms": k3_time["backward_ms"],
        "step_cost_flops": mtr["cost"]["detail_flops"].get("ssd_scan"),
        "passes_ms": k3_time["passes_ms"],
        "zamba2": {
            "trainer_launches_by_variant": hyb_tr["k3_by_variant"],
            "remat_launches_by_variant": hyb_remat["k3"],
            "serve_forward_launches_by_variant": hyb_serve["k3"],
            "serve_f32_forward_launches_by_variant":
                hyb_serve["f32"]["k3"]},
    }, {
        "name": "rms_norm",
        "route": "cuda",
        "source": "src/repro_torch/csrc/rms_norm.cu",
        "replaces": None,
        "why": "keeps the norms' f32 copies out of device memory (the "
               "composed ops save them for autograd)",
        "variant": "plain, gated",
        "launches_per_mamba2_step": mtr["k4_per_step"][0],
        "launches_by_variant": mtr["k4_by_variant"],
        "gemma2_launches_per_step": tr["k4_per_step"][0],
        "shape": "bf16 (1, 2048, 2560) plain, (1, 2048, 80, 64) gated: one "
                 "mamba2-2.7b layer's two norms",
        "max_abs_err": k4_err["out"],
        "max_rel_err_rstd": k4_err["rstd"],
        "max_rel_err_grad": k4_err["grad"],
        "ms": k4_time["plain"]["ms"],
        "backward_ms": k4_time["plain"]["backward_ms"],
        "bound_ms": k4_time["plain"]["bound_ms"],
        "bound_by": "bytes",
        "plain_ms": k4_time["plain"]["plain_ms"],
        "gated": k4_time["gated"],
        "grouped_gated": dict(
            k4_time["gated_g2"],
            shape="bf16 (1, 4096, 112, 64), 2 groups of 3584: one "
                  "zamba2-7b-instruct layer's gated norm"),
        "library_ms": k4_time["plain"]["library_ms"],
        "library_call": "torch.nn.functional.rms_norm (the plain variant; "
                        "no PyTorch call computes the gated one)",
        "library_fwd_bwd_ms": k4_time["plain"]["library_fwd_bwd_ms"],
        "dry_run": "traced through repro_torch::rms_norm_fwd / _bwd's fake "
                   "implementations",
    }, {
        "name": "causal_conv_silu",
        "route": "cuda",
        "source": "src/repro_torch/csrc/causal_conv.cu",
        "replaces": None,
        "why": "keeps the conv's padded f32 copy of its input out of device "
               "memory (the composed ops save it for autograd)",
        "launches_per_mamba2_step": mtr["k5_per_step"][0],
        "launches_per_zamba2_step": hyb_tr["k5_per_step"][0],
        "shape": "bf16 (1, 2048, 5120) and (1, 2048, 128): one mamba2-2.7b "
                 "layer's xs and B / C convs; (1, 4096, 7168): one "
                 "zamba2-7b-instruct layer's xs conv",
        "forward_elements_differing": k5_err["forward_differ"],
        "forward_max_bf16_steps": k5_err["forward_steps"],
        "max_rel_err_grad": k5_err["grad"],
        "device_ms": k5_time["mamba2_xs"]["device_ms"],
        "backward_device_ms": k5_time["mamba2_xs"]["backward_device_ms"],
        "bound_ms": k5_time["mamba2_xs"]["bound_ms"],
        "backward_bound_ms": k5_time["mamba2_xs"]["backward_bound_ms"],
        "bound_by": "bytes",
        "plain_ms": k5_time["mamba2_xs"]["plain_ms"],
        "library_ms": k5_time["mamba2_xs"]["library_ms"],
        "library_call": "torch.nn.functional.conv1d(groups=C) + silu",
        "timings": k5_time,
        "dry_run": "traced through repro_torch::causal_conv_silu_fwd / "
                   "_bwd's fake implementations",
    }, {
        "name": "cross_entropy",
        "route": "cuda",
        "source": "src/repro_torch/csrc/cross_entropy.cu",
        "replaces": None,
        "why": "keeps the training loss's f32 (tokens x vocab) logits and "
               "their gradients out of device memory (the composed ops "
               "save one for autograd and their backward makes four)",
        "launches_per_mamba2_step": mtr["k6_per_step"][0],
        "launches_per_zamba2_step": hyb_tr["k6_per_step"][0],
        "shape": "bf16 (2048, 50432), 50277 kept: mamba2-2.7b's head as "
                 "the port pads it; (4096, 32000): zamba2-7b-instruct's",
        "max_rel_err_nll": k6_err["nll"],
        "dh_max_bf16_steps": k6_err["dh_steps"],
        "dh_elements_differing": k6_err["dh_differ"],
        "device_ms": k6_time["mamba2"]["device_ms"],
        "backward_device_ms": k6_time["mamba2"]["backward_device_ms"],
        "bound_ms": k6_time["mamba2"]["bound_ms"],
        "backward_bound_ms": k6_time["mamba2"]["backward_bound_ms"],
        "bound_by": "bytes",
        "plain_ms": k6_time["mamba2"]["plain_ms"],
        "library_ms": k6_time["mamba2"]["library_ms"],
        "library_call": "torch.nn.functional.cross_entropy on the f32 logits",
        "timings": k6_time,
        "dry_run": "traced through repro_torch::cross_entropy_fwd / _bwd's "
                   "fake implementations",
    }]}))
    print(f"[step cost] summary: " + json.dumps({
        "card_vs_cpu_reduced_gemma2": cost_check,
        **{name: {k: run["cost"][k] for k in ("flops", "bytes", "gemm_frac",
                                              "count_s", "ratio")}
           for name, run in (("gemma2-2b", tr), ("mamba2-2.7b", mtr),
                             ("deepseek-v2-lite-16b x4", moe_tr),
                             ("zamba2-7b x15", hyb_tr))}}))
    print("[dryrun] summary: " + json.dumps(
        {**{k: v for k, v in dry.items() if k != "cells"},
         "cell_seconds": dry["cells"], "example_seconds": examples}))
    print(f"[done] {time.perf_counter() - t_start:.1f}s; by phase "
          f"{clock.times}")
    print(card)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
