"""Expected ranges R_f (paper §4.3, Eq. 6) assigned by function class.

Paper values: Python functions R = [0, 0.01] x [0,1] x [0,1] (an LMT should
not be bottlenecked >1% by any Python function); collective communication
R = [0, 0.3] x [0,1] x [0,1]; GPU compute kernels are never 'unexpected'
(R = full box). Per-family adjustments (DESIGN.md §6): MoE archs allow a
wider collective box for all_to_all/dispatch phases.

The ``host`` family (DESIGN.md §11) calibrates the Python box for ALL-HOST
workloads — real trainers jit'd to CPU, where data loading and bookkeeping
legitimately hold ~10% of busy samples because there is no accelerator for
the step to hide behind.  The paper's 1% bound encodes "Python work should
vanish next to GPU kernels"; on a host-only fleet the equivalent healthy
ceiling is ~20%, and faults (dataloader burns, GC pauses) blow far past it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.events import Kind

Box = Tuple[Tuple[float, float], Tuple[float, float], Tuple[float, float]]

FULL: Box = ((0.0, 1.0), (0.0, 1.0), (0.0, 1.0))
PYTHON_BOX: Box = ((0.0, 0.01), (0.0, 1.0), (0.0, 1.0))
COMM_BOX: Box = ((0.0, 0.3), (0.0, 1.0), (0.0, 1.0))
MEM_BOX: Box = ((0.0, 0.4), (0.0, 1.0), (0.0, 1.0))
MOE_COMM_BOX: Box = ((0.0, 0.45), (0.0, 1.0), (0.0, 1.0))
HOST_PYTHON_BOX: Box = ((0.0, 0.2), (0.0, 1.0), (0.0, 1.0))


def expected_box(kind: Kind, name: str = "", family: str = "dense") -> Box:
    if kind in (Kind.GPU, Kind.NUMERICS):
        # GPU kernels are never 'unexpected'; NUMERICS abnormalities are
        # synthetic (no busy-fraction semantics), the trigger itself is the
        # evidence
        return FULL
    if kind == Kind.COMM:
        if family == "moe" and ("all_to_all" in name or "dispatch" in name
                                or "combine" in name):
            return MOE_COMM_BOX
        return COMM_BOX
    if kind == Kind.MEM:
        return MEM_BOX
    if family == "host":
        return HOST_PYTHON_BOX
    return PYTHON_BOX


def distance_from_expectation(p: np.ndarray, box: Box) -> float:
    """Minimal Manhattan distance from pattern p=(beta,mu,sigma) to the box
    (Eq. 7)."""
    d = 0.0
    for x, (lo, hi) in zip(p, box):
        if x < lo:
            d += lo - x
        elif x > hi:
            d += x - hi
    return float(d)
