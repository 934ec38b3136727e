"""Roofline terms of a step (port of the reference's
``repro/launch/analysis.py``: ``model_flops``, ``roofline`` and
``CollectiveStats``).

compute term    = FLOPs / peak FLOP/s
memory term     = bytes / HBM bandwidth
collective term = collective bytes / link bandwidth

The reference reads FLOPs, bytes and collectives from XLA's compiled HLO;
here ``launch.step_cost.count_step`` counts them while the step runs and
``CollectiveStats`` is filled from its ``Cost``.  The reference's HLO reader
``parse_collectives`` has no counterpart.

Hardware constants: the NVIDIA H100 SXM5 80GB data sheet (the card
``nvidia-smi`` names "NVIDIA H100 80GB HBM3", at its 700 W power limit):
989 TFLOP/s dense bf16 tensor-core math, 3.35 TB/s HBM3, and 450 GB/s
NVLink per direction.  They are data-sheet figures, not measurements.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

PEAK_FLOPS = 989e12        # bf16 dense, per card
HBM_BW = 3.35e12           # bytes/s per card
ICI_BW = 450e9             # bytes/s NVLink, per direction


def ring_traffic(op: str, size: float, n: int) -> float:
    """Per-device ring-model traffic of one collective of ``size`` result
    bytes over ``n`` ranks (the reference's formulas):

    all-reduce:   2 * size * (n-1)/n
    all-gather:   size * (n-1)/n
    reduce-scatter: size_result * (n-1)   (operand = result * n)
    all-to-all:   size * (n-1)/n
    anything else (collective-permute, broadcast): size
    """
    if op == "all-reduce":
        return 2.0 * size * (n - 1) / n
    if op == "all-gather":
        return size * (n - 1) / n
    if op == "reduce-scatter":
        return size * (n - 1)
    if op == "all-to-all":
        return size * (n - 1) / n
    return float(size)


@dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, float] = field(default_factory=dict)
    count_by_op: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_op.values())

    @classmethod
    def from_cost(cls, cost) -> "CollectiveStats":
        """The collectives a ``launch.step_cost.Cost`` counted."""
        return cls(dict(cost.coll_bytes),
                   {k: int(v) for k, v in cost.coll_counts.items()})


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (train, N=active params) / 2*N*D (prefill) /
    2*N*B (decode, one token per sequence)."""
    counts = cfg.param_counts()
    n_active = counts["active"]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token / seq


def roofline(cost: Dict[str, float], coll: CollectiveStats,
             num_devices: int, model_fl: float) -> Dict[str, float]:
    """The reference's roofline dict for per-device ``cost`` (``"flops"``,
    ``"bytes accessed"``) and collectives, on this module's constants."""
    dev_flops = float(cost.get("flops", 0.0))
    dev_bytes = float(cost.get("bytes accessed", 0.0))
    t_compute = dev_flops / PEAK_FLOPS
    t_memory = dev_bytes / HBM_BW
    t_coll = coll.total_bytes / ICI_BW
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    hlo_global = dev_flops * num_devices
    bound = max(t_compute, t_memory, t_coll)
    ideal = model_fl / (num_devices * PEAK_FLOPS)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "hlo_flops_per_dev": dev_flops,
        "hlo_bytes_per_dev": dev_bytes,
        "collective_bytes_per_dev": coll.total_bytes,
        "collective_breakdown": dict(coll.bytes_by_op),
        "collective_counts": dict(coll.count_by_op),
        "model_flops": model_fl,
        "useful_flops_ratio": (model_fl / hlo_global) if hlo_global else 0.0,
        "roofline_fraction": (ideal / bound) if bound else 0.0,
        "step_time_bound_s": bound,
    }
