"""K1: Algorithm-1 behavior-pattern summary (paper §4.2) on the card.

``pattern_summary(u)`` takes a zero-padded ``(E, n)`` float32 utilization
matrix and returns ``(E, 3)`` float64 ``[mean, std, count]`` over each row's
critical execution duration (``repro_torch.summarize.base`` states the
contract).  On a CUDA tensor it launches the hand-written kernel in
``csrc/pattern_summary.cu`` or raises; on a CPU tensor it runs
``pattern_summary_reference``, the plain torch version of the same function.

The kernel replaces the JAX reference's Pallas TPU kernel
``repro/kernels/pattern_summary.py::_kernel``.  Its bound on an H100 is
bytes: ``E*n*4`` read once and ``E*3*8`` written, at 3.35 TB/s
(``bound_ms``).  No single PyTorch call computes Algorithm 1, so there is no
library yardstick.

The CUDA source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use, under ``_build/`` beside this
package (keyed by a hash of the source and flags), and loaded with
``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.core.patterns import MASS_FRACTION

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "pattern_summary.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: samples each thread handles per tile, and the block size cap
#: (kItems and kMaxThreads in the CUDA source)
ITEMS = 4
MAX_THREADS = 256

#: H100 SXM device-memory rate (NVIDIA data sheet), for ``bound_ms``
HBM_BYTES_PER_S = 3.35e12


def bound_ms(E: int, n: int) -> float:
    """Least time an H100 could take: each input byte read once and each
    output byte written once, at the device-memory rate."""
    return (E * n * 4 + E * 3 * 8) / HBM_BYTES_PER_S * 1e3


def threads_for(n: int) -> int:
    """Block size for rows of ``n`` samples: enough warps for one tile to
    cover the row, at most ``MAX_THREADS``."""
    warps = -(-n // (32 * ITEMS))
    return max(32, min(MAX_THREADS, 32 * warps))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> Path:
    """Compile the CUDA source into ``BUILD_DIR`` unless a library built from
    the same source and flags is there already; returns its path.  The
    compiler's ``-Xptxas -v`` report is kept beside it as ``.log``."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libk1_pattern_summary_{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


class PatternSummary:
    """The K1 wrapper.  ``launches`` counts kernel launches (plain integer,
    never incremented on the CPU path)."""

    def __init__(self):
        self.launches = 0
        self._lib: Optional[ctypes.CDLL] = None
        self._stage_limit: Dict[int, int] = {}

    def library(self) -> ctypes.CDLL:
        """Build (at first use) and load the kernel's shared library."""
        if self._lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.k1_pattern_summary.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            lib.k1_pattern_summary.restype = ctypes.c_int
            lib.k1_stage_limit.argtypes = [ctypes.POINTER(ctypes.c_int)]
            lib.k1_stage_limit.restype = ctypes.c_int
            lib.k1_error_string.argtypes = [ctypes.c_int]
            lib.k1_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def _check(self, code: int, what: str) -> None:
        if code != 0:
            msg = self.library().k1_error_string(code).decode()
            raise RuntimeError(f"K1 {what} failed: CUDA error {code} ({msg})")

    def stage_limit(self, device: torch.device) -> int:
        """Longest row, in samples, the kernel stages in shared memory."""
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        if idx not in self._stage_limit:
            out = ctypes.c_int(0)
            with torch.cuda.device(idx):
                self._check(self.library().k1_stage_limit(ctypes.byref(out)),
                            "stage-limit query")
            self._stage_limit[idx] = out.value
        return self._stage_limit[idx]

    def __call__(self, u: torch.Tensor,
                 stage: Optional[bool] = None) -> torch.Tensor:
        """``stage`` forces (True) or forbids (False) staging rows in shared
        memory; None stages every row that fits."""
        if u.dim() != 2:
            raise ValueError(f"u must be (E, n), got shape {tuple(u.shape)}")
        if u.device.type == "cpu":
            return pattern_summary_reference(u)
        if u.device.type != "cuda":
            raise ValueError(f"K1 runs on a CUDA device, not {u.device}")
        if u.dtype != torch.float32:
            raise TypeError(f"K1 takes float32, got {u.dtype}")
        if not u.is_contiguous():
            raise ValueError("K1 takes a contiguous (row-major) matrix")
        E, n = u.shape
        out = torch.zeros((E, 3), dtype=torch.float64, device=u.device)
        if E == 0 or n == 0:
            return out
        fits = n <= self.stage_limit(u.device)
        if stage and not fits:
            raise ValueError(f"rows of {n} samples do not fit in shared "
                             "memory")
        with torch.cuda.device(u.device):
            code = self.library().k1_pattern_summary(
                u.data_ptr(), out.data_ptr(), E, n, MASS_FRACTION,
                threads_for(n), int(fits if stage is None else stage),
                torch.cuda.current_stream(u.device).cuda_stream)
        self._check(code, f"launch on ({E}, {n})")
        self.launches += 1
        return out


pattern_summary = PatternSummary()


def pattern_summary_reference(u: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K1, in sample space (the formulation of the
    reference's ``_region_stats``/``_trim``), on ``u``'s device.

    For a gap bound g, a nonzero sample starts a region when the zero-run
    before it is longer than g (or it is the row's first nonzero), and ends
    one when the zero-run after it is longer than g (or it is the row's last
    nonzero).  A region's mass is the float64 prefix-sum difference over
    ``[start, end]``; a row is feasible at g when some region holds at least
    ``MASS_FRACTION * total - 1e-9``.  Every row bisects to its smallest
    feasible g (at most its largest inner zero-run), then takes the max-mass
    region there, leftmost on ties."""
    E, n = u.shape
    dev = u.device
    out = torch.zeros((E, 3), dtype=torch.float64, device=dev)
    if E == 0 or n == 0:
        return out
    x = u.to(torch.float64)
    idx = torch.arange(n, device=dev).expand(E, n)
    nz = u > 0
    P = torch.cumsum(x, dim=1)                       # inclusive prefix sums
    P0 = torch.cat([torch.zeros_like(P[:, :1]), P[:, :-1]], dim=1)
    last = torch.cummax(torch.where(nz, idx, -1), dim=1).values
    prev = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], dim=1)
    big = n + 1
    # zero-run before each nonzero sample (big before the first one)
    gap = torch.where(nz & (prev >= 0), idx - prev - 1, big)
    # next nonzero strictly after each sample (n if none) and its gap
    nxt = torch.flip(torch.cummin(torch.flip(torch.where(nz, idx, n), [1]),
                                  dim=1).values, [1])
    nxt = torch.cat([nxt[:, 1:], torch.full_like(nxt[:, :1], n)], dim=1)
    gap_next = torch.where(nxt < n,
                           torch.gather(gap, 1, nxt.clamp(max=n - 1)), big)

    total = P[:, -1]
    target = MASS_FRACTION * total - 1e-9
    empty = ~(total > 0)
    max_gap = torch.where(gap == big, 0, gap).max(dim=1).values

    def best_region(g: torch.Tensor):
        g = g[:, None]
        start = nz & (gap > g)
        st = torch.cummax(torch.where(start, idx, 0), dim=1).values
        mass = torch.where(nz & (gap_next > g),
                           P - torch.gather(P0, 1, st), -torch.inf)
        end = mass.argmax(dim=1, keepdim=True)       # first max: leftmost
        return (mass.gather(1, end)[:, 0], st.gather(1, end)[:, 0],
                end[:, 0] + 1)

    best_g = max_gap.clone()
    lo_g = torch.zeros_like(max_gap)
    hi_g = torch.where(empty, -1, max_gap - 1)
    while bool((lo_g <= hi_g).any()):
        act = lo_g <= hi_g
        g = (lo_g + hi_g) // 2
        feas = act & (best_region(g)[0] >= target)
        best_g = torch.where(feas, g, best_g)
        hi_g = torch.where(feas, g - 1, hi_g)
        lo_g = torch.where(act & ~feas, g + 1, lo_g)

    mass, lo, hi = best_region(best_g)
    cnt = (hi - lo).to(torch.float64)
    safe = cnt.clamp(min=1.0)
    mean = mass / safe
    inside = (idx >= lo[:, None]) & (idx < hi[:, None])
    var = torch.where(inside, (x - mean[:, None]) ** 2, 0.0).sum(dim=1) / safe
    out[:, 0] = torch.where(empty, 0.0, mean)
    out[:, 1] = torch.where(empty, 0.0, var.sqrt())
    out[:, 2] = torch.where(empty, float(n), cnt)
    return out
