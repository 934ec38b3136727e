#!/usr/bin/env python3
"""A/B of K3's wgmma variant against the same design with ``ssd_fwd_cb``
folded into ``ssd_fwd_scan`` (each scan block computes C_t B_s^T for its own
head with wgmma from B tiles it loads by TMA, instead of reading the
per-group C B^T tiles pass 3 wrote).

Run from the repository root on a machine with one CUDA card:

    python3 tools/k3_fused_cb_ab.py

It writes the fused source beside the build (``src/repro_torch/_build/``) by
applying the edits in ``FUSED_EDITS`` to ``csrc/ssd_scan.cu`` (each must
match exactly once, else it stops), builds both, holds both against the
plain version at mamba2-2.7b's and zamba2-7b's SSM layers (elementwise
within 1e-3 + 2^-7 |ref|), and times them in turns (four-pass, fused, fused,
four-pass, four-pass, fused) with ``chip_smoke.timed_ms``, with each pass's
device time from ``torch.profiler``.  It prints the card's name and power
limit first.  The fused source needs every B tile of the chunk in shared
memory, so it takes only the layers whose blocks still fit (not N 256 at
chunk 256).
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ssd_scan as K3  # noqa: E402

#: (old, new) edits that turn csrc/ssd_scan.cu into the fused variant
FUSED_EDITS = [
    ("""  return tpb * kW * N * 2 + Q * kRowBytes + 2 * N * kRowBytes + 8 * Q
         + 8 * (tpb + Q / kW);""",
     """  return tpb * kW * N * 2 + Q * kRowBytes + 2 * N * kRowBytes + 8 * Q
         + 8 * (tpb + Q / kW) + Q * N * 2;"""),
    ("""  unsigned char* sHi = sX + Q * kRowBytes;       // prev, N rows x 64 cols""",
     """  unsigned char* sBt = sX + Q * kRowBytes;
  unsigned char* sHi = sBt + Q * N * 2;"""),
    ("""      mbar_expect_tx(xbar + j, kTileBytes);
      tma_load(sX + j * kTileBytes, &tm_x, xbar + j, ps * kW, h, c0 + j * kW,
               b);""",
     """      mbar_expect_tx(xbar + j, kTileBytes + N * kRowBytes);
      tma_load(sX + j * kTileBytes, &tm_x, xbar + j, ps * kW, h, c0 + j * kW,
               b);
      for (int a = 0; a < NA; ++a)
        tma_load(sBt + (j * NA + a) * kTileBytes, &tm_b, xbar + j, a * kW, g,
                 c0 + j * kW, b);"""),
    ("""ssd_fwd_scan(const __grid_constant__ CUtensorMap tm_c,
             const __grid_constant__ CUtensorMap tm_x, const WParams p) {""",
     """ssd_fwd_scan(const __grid_constant__ CUtensorMap tm_c,
             const __grid_constant__ CUtensorMap tm_x,
             const __grid_constant__ CUtensorMap tm_b, const WParams p) {"""),
    ("""  load_frag(cbp, sc);            // s tile 0, in flight during C prev
""", ""),
    ("""  for (int si = 0; si <= ti; ++si) {
    const bool diag = si == ti;""",
     """  for (int si = 0; si <= ti; ++si) {
    const bool diag = si == ti;
    mbar_wait(xbar + si, 0);
    {
      const uint32_t aBs = smem_u32(sBt + si * NA * kTileBytes);
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wgmma_fence();
      for (int kk = 0; kk < N / 16; ++kk) {
        const uint32_t col = (kk / 4) * kTileBytes + (kk % 4) * 32;
        wgmma_ss<0, 0>(sc, make_desc(aC + col, 16, 1024),
                       make_desc(aBs + col, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(sc);
    }"""),
    ("""    if (!diag) load_frag(cbp + (si + 1) * (kFrag / 4), sc);
""", ""),
    ("""  ssd_fwd_cb<<<dim3(tile_pairs(nt), nc, p.B * p.G), 128, s3, st>>>(tc, tb,
                                                                    p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_fwd_scan<<<dim3(grid.x, grid.y, nt / tpb), 128 * tpb, s4, st>>>(
      tc, tx, p);""",
     """  ssd_fwd_scan<<<dim3(grid.x, grid.y, nt / tpb), 128 * tpb, s4, st>>>(
      tc, tx, tb, p);"""),
]
LAYERS = (("mamba2-2.7b", cs.MAMBA_LAYER), ("zamba2-7b", cs.ZAMBA_LAYER))
ORDER = ("four-pass", "fused", "fused", "four-pass", "four-pass", "fused")


def fused_source() -> Path:
    src = K3.SOURCE.read_text()
    for old, new in FUSED_EDITS:
        if src.count(old) != 1:
            raise SystemExit(f"edit does not apply once: {old[:60]!r}")
        src = src.replace(old, new)
    # the copy includes sm90.cuh from the build directory
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    (_build.BUILD_DIR / "sm90.cuh").write_text(
        (_build.CSRC / "sm90.cuh").read_text())
    out = _build.BUILD_DIR / "ssd_scan_fused_cb.cu"
    out.write_text(src)
    return out


def wrapper(source: Path) -> K3.SSDScan:
    """An ``SSDScan`` whose library is built from ``source``."""
    w = K3.SSDScan()
    w.SOURCE = source
    w.library()
    return w


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_fused_cb_ab: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    print(cs.gpu_line())
    kinds = {"four-pass": K3.SOURCE, "fused": fused_source()}
    _build.build_all([(src, f"k3_{src.stem}") for src in kinds.values()])
    runs = {k: wrapper(src) for k, src in kinds.items()}
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    for name, shape in LAYERS:
        Q = shape[-1]
        ins = cs.k3_inputs(shape, 11, torch.bfloat16, "model")
        ref = K3.ssd_scan_reference(*ins, Q).float()
        for kind, w in runs.items():
            out = w.run(*ins, Q).float()
            ratio = float(((out - ref).abs()
                           / (cs.BF16_ATOL + cs.BF16_RTOL * ref.abs())).max())
            if not (ratio <= 1.0 and torch.isfinite(out).all()):
                raise AssertionError(f"{kind} disagrees at {name}: {ratio}")
        times = {k: [] for k in runs}
        for kind in ORDER:
            times[kind].append(cs.timed_ms(lambda: runs[kind].run(*ins, Q),
                                           cs.TIMED_LAUNCHES, flush))
        for kind, w in runs.items():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(cs.K3_PROFILED_CALLS):
                    flush.zero_()
                    w.run(*ins, Q)
                torch.cuda.synchronize()
            seen = {p: [] for p in cs.K3_PASSES}
            for e in cs.device_events(prof):
                for p in cs.K3_PASSES:
                    if p in e.name():
                        seen[p].append(e.duration_ns() / 1e6)
            passes = {p: sum(v) / len(v) for p, v in seen.items() if v}
            print(f"[k3 ab] {name} {shape} {kind}: timed_ms "
                  f"{[round(t, 4) for t in times[kind]]}; device ms by pass "
                  f"{ {p: round(v, 4) for p, v in passes.items()} }, sum "
                  f"{sum(passes.values()):.4f}")
        del ins, ref
    return 0


if __name__ == "__main__":
    sys.exit(main())
