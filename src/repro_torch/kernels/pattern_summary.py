"""K1: Algorithm-1 behavior-pattern summary (paper §4.2) on the card.

``pattern_summary(u)`` takes a zero-padded ``(E, n)`` float32 utilization
matrix and returns ``(E, 3)`` float64 ``[mean, std, count]`` over each row's
critical execution duration (``repro_torch.summarize.base`` states the
contract).  On a CUDA tensor it launches the hand-written kernels in
``csrc/pattern_summary.cu`` or raises; on a CPU tensor it runs
``pattern_summary_reference``, the plain torch version of the same function.

Which kernel runs is one fixed rule, ``variant_for(n)``, decided before any
launch (the source's header note gives the design):

* ``"warp"`` for rows of at most ``WARP_MAX_N`` (2048) samples: one warp per
  row, 8 rows a block, the row in registers
  (``lane_samples_for(n)`` samples a lane).  Pass 0 is reductions only and
  finishes every all-zero or one-run row; a second kernel runs the rows
  with several runs through the general path.
* ``"block"`` for longer rows: one block of 512 threads per
  row on a persistent grid of ``block_grid(E)`` blocks, the row staged in
  shared memory when it fits (``stage_limit``).  It takes any n.

``pattern_summary(u, variant=...)`` forces one; forcing ``"warp"`` on rows
longer than ``WARP_MAX_N`` or an unknown name raises ``ValueError``.  A
failed build or launch raises; nothing retries on the other variant or on
the plain version.  ``launches`` counts calls that launched K1 (one per
call, however many device kernels it ran) and ``launches_by_variant`` each
variant's.

The kernels replace the JAX reference's Pallas TPU kernel
``repro/kernels/pattern_summary.py::_kernel``.  Their bound on an H100 is
bytes: ``E*n*4`` read once and ``E*3*8`` written, at 3.35 TB/s
(``bound_ms``).  No single PyTorch call computes Algorithm 1, so there is no
library yardstick.

The CUDA source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use and loaded with ``ctypes``
(``kernels.common.Kernel``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.core.patterns import MASS_FRACTION
from repro_torch.kernels import _build
from repro_torch.kernels.common import F64, HBM_BYTES_PER_S, I, LL, P, Kernel

SOURCE = _build.CSRC / "pattern_summary.cu"

VARIANTS = ("warp", "block")
#: samples a lane of the warp variant holds: the counts the source
#: instantiates (``K1_CASE`` in ``k1_warp``); the last sets the cap
LANE_SAMPLES = (1, 2, 4, 8, 16, 24, 32, 40, 48, 56, 64)
WARP_MAX_N = 32 * LANE_SAMPLES[-1]
#: bytes of the block variant's scratch per sample of a block's row: f64
#: inclusive and exclusive prefix sums and an int position (kEntryBytes)
ENTRY_BYTES = 20


def bound_ms(E: int, n: int) -> float:
    """Least time an H100 could take: each input byte read once and each
    output byte written once, at the device-memory rate."""
    return (E * n * 4 + E * 3 * 8) / HBM_BYTES_PER_S * 1e3


def variant_for(n: int) -> str:
    """The kernel that runs rows of ``n`` samples: ``"warp"`` up to
    ``WARP_MAX_N``, else ``"block"``."""
    return "warp" if n <= WARP_MAX_N else "block"


def lane_samples_for(n: int) -> int:
    """Samples each lane of the warp variant holds for rows of ``n``: the
    smallest instantiated count that covers ``ceil(n / 32)``."""
    need = -(-n // 32)
    for k in LANE_SAMPLES:
        if k >= need:
            return k
    raise ValueError(f"the warp variant takes rows of at most {WARP_MAX_N} "
                     f"samples, not {n}")


def block_grid(E: int, sms: int) -> int:
    """Blocks of the block variant's persistent grid on a card of ``sms``
    SMs: two an SM, at most one a row."""
    return min(E, 2 * sms)


class PatternSummary(Kernel):
    """The K1 wrapper.  ``launches`` counts calls that launched K1 and
    ``launches_by_variant`` those of each variant (plain integers, never
    incremented on the CPU path)."""

    NAME, SOURCE = "K1", SOURCE
    SIGNATURES = {"k1_warp": ([P, P, LL, I, F64, I, P, P], I),
                  "k1_block": ([P, P, LL, I, F64, I, I, P, P], I),
                  "k1_stage_limit": ([ctypes.POINTER(I)], I)}
    COUNTS = {"variant": VARIANTS}

    def __init__(self):
        super().__init__()
        self._stage_limit: Dict[int, int] = {}

    def stage_limit(self, device: torch.device) -> int:
        """Longest row, in samples, the block variant stages in shared
        memory."""
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        if idx not in self._stage_limit:
            out = ctypes.c_int(0)
            with torch.cuda.device(idx):
                self.check(self.library().k1_stage_limit(ctypes.byref(out)),
                           lambda: "stage-limit query")
            self._stage_limit[idx] = out.value
        return self._stage_limit[idx]

    def __call__(self, u: torch.Tensor,
                 variant: Optional[str] = None) -> torch.Tensor:
        """``variant`` forces ``"warp"`` or ``"block"``; None takes
        ``variant_for(n)``."""
        if u.dim() != 2:
            raise ValueError(f"u must be (E, n), got shape {tuple(u.shape)}")
        E, n = u.shape
        chosen = variant_for(n) if variant is None else variant
        if chosen not in VARIANTS:
            raise ValueError(f"K1 variants are {VARIANTS}, not {variant!r}")
        if chosen == "warp" and n > WARP_MAX_N:
            raise ValueError(f"the warp variant takes rows of at most "
                             f"{WARP_MAX_N} samples, not {n}")
        if u.device.type == "cpu":
            return pattern_summary_reference(u)
        if u.device.type != "cuda":
            raise ValueError(f"K1 runs on a CUDA device, not {u.device}")
        if u.dtype != torch.float32:
            raise TypeError(f"K1 takes float32, got {u.dtype}")
        if not u.is_contiguous():
            raise ValueError("K1 takes a contiguous (row-major) matrix")
        if E == 0 or n == 0:
            return torch.zeros((E, 3), dtype=torch.float64, device=u.device)
        # every row is written by one of the kernels
        out = torch.empty((E, 3), dtype=torch.float64, device=u.device)
        lib = self.library()
        with torch.cuda.device(u.device):
            stream = torch.cuda.current_stream(u.device).cuda_stream
            if chosen == "warp":
                work = torch.empty(E + 1, dtype=torch.int32, device=u.device)
                code = lib.k1_warp(u.data_ptr(), out.data_ptr(), E, n,
                                   MASS_FRACTION, lane_samples_for(n),
                                   work.data_ptr(), stream)
            else:
                sms = torch.cuda.get_device_properties(
                    u.device).multi_processor_count
                grid = block_grid(E, sms)
                scratch = torch.empty(grid * n * ENTRY_BYTES,
                                      dtype=torch.uint8, device=u.device)
                code = lib.k1_block(u.data_ptr(), out.data_ptr(), E, n,
                                    MASS_FRACTION,
                                    int(n <= self.stage_limit(u.device)),
                                    grid, scratch.data_ptr(), stream)
        self.launched(code, lambda: f"{chosen} launch on ({E}, {n})", chosen)
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
