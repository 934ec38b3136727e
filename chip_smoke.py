#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds kernels K1 (``src/repro_torch/csrc/pattern_summary.cu``), K2
(``src/repro_torch/csrc/flash_attention.cu``) and K3
(``src/repro_torch/csrc/ssd_scan.cu``) with nvcc for sm_90a, all at once,
and then runs these phases, each checked:

1. K1 against its plain torch version on the card, timed;
2. the port's fleet-mode diagnosis path through ``PerfTrackerService`` on the
   ring fault of ``examples/diagnose_ring_fault.py`` and on a 256-worker
   fleet at the paper's profiling window (20 s at 10 kHz);
3. K2 against its plain torch version at gemma2-2b's attention shapes
   (bf16, local and global layers, at the trainer's 2048 tokens and at 8192)
   and at the f32 shapes of the reference's kernel tests; K2 timed beside
   its bound, its plain version, the library call that computes the same
   function (``flex_attention`` under ``torch.compile``, with a tanh
   ``score_mod`` and the causal/window block mask) and, for softcap 0,
   ``scaled_dot_product_attention``;
4. the full gemma2-2b trainer (26 layers, full width, bf16 with fp32 AdamW
   state) for 5 steps of batch 1 x 2048 tokens through
   ``Trainer.train_iteration``: 26 K2 launches a step, finite losses;
5. a 4-worker ``TrainerWorkload`` at gemma2-2b's full width cut to 2 layers,
   one window under ``DataloaderBurn`` and one under ``StepThrottle``, each
   diagnosed on the card;
6. K3 against its plain torch version (f32 on the shapes of the reference's
   kernel tests, bf16 at mamba2-2.7b's layer shape, and a chunk whose
   upper-triangle decay overflows float32), timed beside its bound and its
   plain version, with the plain SSD backward of one layer;
7. the full mamba2-2.7b trainer (64 layers, full width, bf16 with f32
   ``A_log``/``D``/``dt_bias`` and fp32 AdamW state) for 5 steps of batch
   1 x 2048 tokens: 64 K3 launches a step, finite losses and grad norms.

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
import subprocess
import sys
import time
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
GEMMA_ATTN = dict(softcap=50.0, scale=256 ** -0.5)   # gemma2-2b's layers
GEMMA_WINDOW = 4096
TRAIN_SEQ = 2048     # the trainer's tokens per step (batch 1)
TRAIN_STEPS = 5
FLEET_ITERS = 8      # iterations per profiling window (the reference's IPW)
#: the phases of the fenced step a StepThrottle incident may localize to
#: (the reference's tests/test_train_workload.py STEP_FUNCTIONS, less the
#: xla.* sub-events this port does not record; ROADMAP Queue 3 keeps the
#: attribution to optimizer.step as an open fault of the diagnosis).
#: train.step alone cannot be flagged in one window on the card: it fills
#: most of a healthy
#: iteration (about 72% on an H100 80GB HBM3 at 700 W, this script's
#: [trainer fleet] lines), so however slow the step gets, its
#: max-normalized beta moves by less than 1 - 0.72 < 0.4, the localizer's
#: differential threshold; and it has no sampled stream to show a mu.
STEP_PHASES = ("train.step", "optimizer.step")

MAMBA = "mamba2-2.7b"
MAMBA_SEQ = 2048     # the mamba2 trainer's tokens per step (batch 1)
#: K3's inputs at mamba2-2.7b's layer: (B, S, H, P, G, N, chunk)
MAMBA_LAYER = (1, MAMBA_SEQ, 80, 64, 1, 128, 256)
#: the reference's SSD kernel-test shapes (tests/test_kernels.py:48-51)
K3_TEST_SHAPES = [(1, 64, 2, 16, 1, 8, 16), (2, 128, 4, 32, 2, 16, 32),
                  (1, 128, 4, 64, 4, 32, 64), (1, 32, 2, 16, 2, 16, 32)]
K3_F32_TOL = 2e-5    # max |err| / max |ref|, the reference's own limit


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


def reset_counts(K, K2, K3) -> None:
    """Set every kernel's launch count to 0, just before a path runs."""
    K.pattern_summary.launches = 0
    K2.flash_attention.launches = 0
    K3.ssd_scan.launches = 0


def _rand(g, shape, dtype):
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def k2_checks(K2) -> dict:
    """K2 against its plain version: gemma2-2b's shapes in bf16 (local and
    global, at the trainer's length and at 8192), the reference's
    kernel-test shapes and variants in f32."""
    g = torch.Generator(device="cuda").manual_seed(0)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    bf16_ratio = 0.0      # worst |err| / (ATOL + RTOL * |ref|) in bf16
    cases = [(torch.bfloat16, (1, S, 8, 4, 256),
              dict(GEMMA_ATTN, window=w), name)
             for S in (TRAIN_SEQ, 8192)
             for w, name in ((GEMMA_WINDOW, "gemma2 local"),
                             (0, "gemma2 global"))]
    cases += [(torch.float32, shape, {}, "kernel test")
              for shape in ((1, 128, 4, 4, 64), (2, 256, 6, 2, 64),
                            (1, 256, 8, 1, 128), (2, 128, 2, 2, 32))]
    cases += [(torch.float32, (2, 256, 4, 2, 32), kw, "kernel test variant")
              for kw in (dict(window=100), dict(softcap=20.0),
                         dict(causal=False), dict(window=64, softcap=10.0))]
    cases += [(torch.float32, (1, 2048, 8, 4, 256), dict(GEMMA_ATTN, window=w),
               "gemma2 f32") for w in (GEMMA_WINDOW, 0)]
    for dtype, (B, S, H, KV, D), kw, name in cases:
        q = _rand(g, (B, S, H, D), dtype)
        k, v = _rand(g, (B, S, KV, D), dtype), _rand(g, (B, S, KV, D), dtype)
        out, lse = K2.flash_attention(q, k, v, return_lse=True, **kw)
        ref, ref_lse = K2.flash_attention_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        if not (torch.isfinite(out).all() and out.shape == ref.shape
                and out.dtype == dtype):
            raise AssertionError(f"K2 output not finite or misshapen ({name})")
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        lse_err = float((lse - ref_lse).abs().max())
        worst[dtype] = max(worst[dtype], err)
        extra = ""
        if dtype == torch.bfloat16:
            ratio = float((diff / (BF16_ATOL + BF16_RTOL
                                   * ref.float().abs())).max())
            bf16_ratio = max(bf16_ratio, ratio)
            extra = (f", max |ref| {float(ref.float().abs().max()):.3g}, "
                     f"worst err / limit {ratio:.3g}")
        print(f"[k2 check] {name} {dtype} B={B} S={S} H={H} KV={KV} D={D} "
              f"{kw}: max |out err| {err:.3g}, max |lse err| "
              f"{lse_err:.3g}{extra}")
        del q, k, v, out, lse, ref, ref_lse, diff
    print(f"[k2 check] worst bf16 {worst[torch.bfloat16]:.4g} at "
          f"{bf16_ratio:.3g} of its limit ({BF16_ATOL} + {BF16_RTOL} "
          f"* |ref|), worst f32 {worst[torch.float32]:.3g} (tolerance "
          f"{K2_F32_TOL})")
    if bf16_ratio > 1.0 or worst[torch.float32] > K2_F32_TOL:
        raise AssertionError("K2 disagrees with its plain version")
    return {"bf16": worst[torch.bfloat16], "f32": worst[torch.float32]}


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


def logits_ce_ms(L, flush) -> float:
    """gemma2-2b's tied LM head, logit softcap and cross-entropy, forward
    and backward, at the trainer's shape."""
    g = torch.Generator(device="cuda").manual_seed(3)
    h = _rand(g, (1, TRAIN_SEQ, 2304), torch.bfloat16).requires_grad_(True)
    table = (_rand(g, (256000, 2304), torch.bfloat16) * 0.02
             ).requires_grad_(True)
    labels = torch.randint(0, 256000, (1, TRAIN_SEQ), generator=g,
                           device="cuda")

    def run():
        loss, _ = L.cross_entropy(L.lm_logits(table, h, 30.0), labels, 256000)
        torch.autograd.grad(loss, (h, table))
    return timed_ms(run, 3, flush)


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
    shapes (max |err| / max |ref| < 2e-5); bf16
    at mamba2-2.7b's layer shape from its init ranges and at the overflow
    end of them (elementwise within one bf16 step), the overflow case
    finite."""
    worst_f32, worst_bf16, ratio_bf16 = 0.0, 0.0, 0.0
    for i, shape in enumerate(K3_TEST_SHAPES):
        ins = k3_inputs(shape, i, torch.float32, "test")
        ref = K3.ssd_scan_reference(*ins, shape[-1])
        out = K3.ssd_scan.run(*ins, shape[-1])
        torch.cuda.synchronize()
        if not (torch.isfinite(out).all() and out.shape == ref.shape):
            raise AssertionError(f"K3 output not finite or misshapen {shape}")
        rel = float((out - ref).abs().max() / ref.abs().max())
        worst_f32 = max(worst_f32, rel)
        print(f"[k3 check] kernel test f32 (B,S,H,P,G,N,Q)={shape} P slice "
              f"{K3.p_split_for(shape[3])}: max |err| / max |ref| {rel:.3g}")
    for ranges in ("model", "overflow"):
        ins = k3_inputs(MAMBA_LAYER, 7, torch.bfloat16, ranges)
        ref = K3.ssd_scan_reference(*ins, MAMBA_LAYER[-1]).float()
        out = K3.ssd_scan.run(*ins, MAMBA_LAYER[-1])
        torch.cuda.synchronize()
        if not (torch.isfinite(out).all() and out.dtype == torch.bfloat16
                and out.shape == ref.shape):
            raise AssertionError(f"K3 output not finite or misshapen "
                                 f"({ranges})")
        diff = (out.float() - ref).abs()
        ratio = float((diff / (BF16_ATOL + BF16_RTOL
                               * ref.abs())).max())
        worst_bf16 = max(worst_bf16, float(diff.max()))
        ratio_bf16 = max(ratio_bf16, ratio)
        print(f"[k3 check] mamba2-2.7b layer bf16 (B,S,H,P,G,N,Q)="
              f"{MAMBA_LAYER}, {ranges} dt/A: finite, max |err| "
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
    CUDA events beside its bound and its plain version, and the plain SSD
    backward the trainer runs for one layer."""
    ins = k3_inputs(MAMBA_LAYER, 11, torch.bfloat16, "model")
    Q = MAMBA_LAYER[-1]
    kms = timed_ms(lambda: K3.ssd_scan.run(*ins, Q), TIMED_LAUNCHES, flush)
    pms = timed_ms(lambda: K3.ssd_scan_reference(*ins, Q), 3, flush)
    bms, by = K3.bound_ms(ins[0], ins[1], ins[3], ins[4], Q)
    split = K3.p_split_for(MAMBA_LAYER[3])
    grad_ins = [t.detach().requires_grad_(True) for t in ins]
    dy = torch.randn_like(ins[0])

    def backward():
        with torch.enable_grad():
            y = K3.ssd_scan_reference(*grad_ins, Q)
            torch.autograd.grad(y, grad_ins, dy)
    bwd = timed_ms(backward, 3, flush)
    print(f"[k3 time] mamba2-2.7b layer bf16 (B,S,H,P,G,N,Q)={MAMBA_LAYER}: "
          f"kernel {kms:.4f} ms (P slice {split}), bound {bms:.4f} ms by {by} "
          f"({bms / kms:.2%} of bound), plain {pms:.3f} ms; plain "
          f"SSD backward (recompute under autograd) {bwd:.3f} ms a layer; "
          f"library: none (no PyTorch call computes the SSD scan)")
    del ins, grad_ins, dy
    return dict(ms=kms, plain_ms=pms, bound_ms=bms, bound_by=by,
                backward_ms=bwd)


def trainer_phase(tag, cfg, seq, kernels, label, counter, fragment, Trainer,
                  TrainConfig, DataConfig, OptConfig, Tracer) -> dict:
    """The full trainer of ``cfg``: 5 instrumented steps of batch 1 x
    ``seq`` tokens on the card.  ``counter`` is the wrapper of the kernel
    the path runs once a layer (``label`` names it, ``fragment`` is a piece
    of its device-side name for the profiler)."""
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
    tracer = Tracer(worker=0)
    tracer.start_window()
    reset_counts(*kernels)
    per_step, rows = [], []
    for i in range(TRAIN_STEPS):
        before = counter.launches
        params, opt_state, m = tr.train_iteration(params, opt_state,
                                                  tracer=tracer)
        per_step.append(counter.launches - before)
        rows.append((float(m["loss"]), float(m["grad_norm"])))
    launches = counter.launches
    prof = tracer.stop_window()
    peak = torch.cuda.max_memory_allocated()
    top = sorted((e for e in prof.events if e.depth == 1),
                 key=lambda e: e.start)
    names = [e.name for e in top]
    if names != ["dataloader.next", "train.step",
                 "optimizer.step"] * TRAIN_STEPS:
        raise AssertionError(f"trainer phases {names}")
    steps = []
    for i, (loss, gnorm) in enumerate(rows):
        d, s, o = (top[3 * i + j].duration for j in range(3))
        steps.append(dict(dataloader_next_s=d, train_step_s=s,
                          optimizer_step_s=o, loss=loss, grad_norm=gnorm))
        print(f"{tag} step {i + 1}: dataloader.next {d:.4f} s, "
              f"train.step {s:.4f} s, optimizer.step {o:.4f} s; loss "
              f"{loss:.4f} grad norm {gnorm:.4f}; {label} launches "
              f"{per_step[i]}; max memory allocated {peak} bytes")
    if not all(math.isfinite(x) for r in rows for x in r):
        raise AssertionError("trainer loss or grad norm not finite")
    if per_step != [cfg.num_layers] * TRAIN_STEPS:
        raise AssertionError(f"{label} launches per step {per_step}, "
                             f"expected {cfg.num_layers}")
    profile = step_profile(tr, params, opt_state, tag, label, fragment)
    tr.loader.close()
    del tr, params, opt_state, m
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, steps=steps, peak=peak,
                state_bytes=state_bytes, profile=profile)


#: kernel-name fragments of the matrix products (cuBLAS / CUTLASS kernels)
GEMM_NAMES = ("gemm", "Gemm", "GEMM", "cutlass", "xmma", "cublas")


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
    # the raw device activities (kernels, copies, fills), read without
    # building the op tree that key_averages() builds: at mamba2-2.7b's
    # 64 layers that took 29 s on the host
    t = time.perf_counter()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA \
                and not e.is_user_annotation():
            by_name[e.name()] = by_name.get(e.name(), 0.0) \
                + e.duration_ns() / 1e6
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
        print(f"{ptag} one full-depth step under torch.profiler: wall "
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
        samples = [len(p.streams["cpu"].values) for p in wd.profiles]
        for fname in ("dataloader.next", "train.step", "optimizer.step"):
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
        print(f"[trainer fleet] {name}{fault.workers}: K2 launches {k2}; cpu "
              f"samples per worker {samples}; backend "
              f"{svc.summarize_backend.name}, K1 launches {k1}; flagged "
              f"{flagged} by rule {rules}; plans {plans}")
        if k2 != cfg.num_layers * 4 * FLEET_ITERS:
            raise AssertionError(f"K2 launches in the window {k2}")
        hit = [f for f in fns if flagged.get(f) == workers]
        planned = any(a == action and w in ([], workers) for a, w in plans)
        if not hit or not planned or k1 == 0:
            raise AssertionError(f"{name} not localized to {fns} on "
                                 f"{workers} with {action}")
        out[name] = dict(flagged=flagged, plans=plans, samples=samples)
    wl.close()
    gc.collect()
    torch.cuda.empty_cache()
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
        from repro_torch.kernels import flash_attention as K2
        from repro_torch.kernels import pattern_summary as K
        from repro_torch.kernels import ssd_scan as K3
        from repro_torch.summarize.engine import summarize_profile
        from repro_torch.summarize.fleet import pack_fleet
        from repro_torch.configs.registry import ARCHS
        from repro_torch.data.pipeline import DataConfig
        from repro_torch.instrument.tracer import Tracer
        from repro_torch.models import attention_core as C
        from repro_torch.models import layers as L
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

    # -- 1. build the three kernels at once ------------------------------------
    t = time.perf_counter()
    libs = _build.build_all([(K.SOURCE, "k1_pattern_summary"),
                             (K2.SOURCE, "k2_flash_attention"),
                             (K3.SOURCE, "k3_ssd_scan")])
    print(f"[build] {[lib.name for lib in libs]} in "
          f"{time.perf_counter() - t:.2f}s (parallel nvcc)")
    for lib in libs:
        print(lib.with_suffix(".log").read_text().strip())
    K.pattern_summary.library()
    K2.flash_attention.library()
    K3.ssd_scan.library()
    smem = {dt: [K2.flash_attention.smem_bytes(dt, d) for d in K2.HEAD_DIMS]
            for dt in (torch.bfloat16, torch.float32)}
    print(f"[build] K2 dynamic shared memory per block, bytes: bf16 "
          f"{smem[torch.bfloat16]}, f32 {smem[torch.float32]} for D in "
          f"{K2.HEAD_DIMS}")
    print(f"[build] K3 dynamic shared memory per block at mamba2-2.7b's "
          f"layer (N 128, Q 256, P slice {K3.p_split_for(64)}): "
          f"{K3.ssd_scan.smem_bytes(128, 256, 64)} bytes")

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

    del profiles, groups, res, host
    clock.lap("ring fault and fleet diagnosis")

    # -- 5. K2 against its plain version, and its times -----------------------
    k2_err = k2_checks(K2)
    clock.lap("K2 check")
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    k2_times = k2_timing(K2, flush)
    bwd = attention_backward_ms(C, K2, flush)
    head = logits_ce_ms(L, flush)
    del flush
    n_pairs = ARCHS["gemma2-2b"].num_layers // 2
    fwd_step = n_pairs * (k2_times[(TRAIN_SEQ, "local")]["ms"]
                          + k2_times[(TRAIN_SEQ, "global")]["ms"])
    bwd_step = n_pairs * (bwd["local"] + bwd["global"])
    print(f"[breakdown] per full-depth step at {TRAIN_SEQ} tokens: K2 "
          f"forward {fwd_step:.3f} ms (26 launches), plain attention backward "
          f"{bwd_step:.3f} ms (26 layers; one layer local {bwd['local']:.3f} "
          f"/ global {bwd['global']:.3f} ms), LM head + softcap + CE "
          f"forward+backward {head:.3f} ms")
    torch.cuda.empty_cache()
    clock.lap("K2 time and breakdown")

    # -- 6. the full gemma2-2b trainer: the main path of K2 -------------------
    tr = trainer_phase("[trainer]", ARCHS["gemma2-2b"], TRAIN_SEQ,
                       (K, K2, K3), "K2", K2.flash_attention, "flash_fwd",
                       Trainer, TrainConfig, DataConfig, OptConfig, Tracer)
    clock.lap("gemma2 trainer")

    # -- 7. the trainer fleet, diagnosed on the card --------------------------
    trainer_fleet_phase(K, K2, K3, ARCHS, TrainerWorkload, DataloaderBurn,
                        StepThrottle, TrainConfig, DataConfig, OptConfig,
                        PerfTrackerService, plan_mitigations,
                        summarize_profile)
    clock.lap("trainer fleet")

    # -- 8. K3 against its plain version, and its times -----------------------
    k3_err = k3_checks(K3)
    clock.lap("K3 check")
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    k3_time = k3_timing(K3, flush)
    del flush
    torch.cuda.empty_cache()
    clock.lap("K3 time")

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
          f"{TRAIN_STEPS} counted steps {mtr['launches']}; peak "
          f"{mtr['peak']} bytes, state {mtr['state_bytes']} bytes")
    clock.lap("mamba2 trainer")

    # -- 10. kernels line, card, contract line --------------------------------
    k2_main = k2_times[(TRAIN_SEQ, "global")]
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
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:25",
        "launches": tr["launches"],
        "shape": f"bf16 q (1, {TRAIN_SEQ}, 8, 256) k/v (1, {TRAIN_SEQ}, 4, "
                 f"256), causal, softcap 50, global layer",
        "max_abs_err": k2_err["bf16"],
        "max_abs_err_f32": k2_err["f32"],
        "ms": k2_main["ms"],
        "plain_ms": k2_main["plain_ms"],
        "bound_ms": k2_main["bound_ms"],
        "bound_by": k2_main["bound_by"],
        "library_ms": k2_main["library_ms"],
        "library_call": "torch.compile(flex_attention), tanh score_mod, "
                        "causal block mask, enable_gqa",
        "library_max_abs_err": k2_main["library_err"],
        "softcap0_ms": k2_main["ms_softcap0"],
        "softcap0_sdpa_ms": k2_main["sdpa_ms"],
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:25",
        "launches": mtr["launches"],
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
        "plain_backward_ms": k3_time["backward_ms"],
    }]}))
    print(f"[done] {time.perf_counter() - t_start:.1f}s; by phase "
          f"{clock.times}")
    print(card)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
