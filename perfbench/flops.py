"""The yardstick's arithmetic: peaks of the chip and the least work each
measured kernel or step needs, from shapes and the inputs' own sizes alone,
so that any implementation of the same work reads the same bound.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit (dense
rates): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 outside
them, 3.35 TB/s of HBM.
"""
from __future__ import annotations

H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
H100_HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": H100_BF16_FLOPS, "float32": H100_F32_FLOPS}
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def ssd_flops(B: int, S: int, H: int, P: int, G: int, N: int,
              chunk: int) -> float:
    """The SSD scan's operations (a copy of the port's
    ``kernels/ssd_scan.py::ssd_flops``): C B^T once per (batch, group,
    chunk) and its product with x per (batch, head, chunk), each over the
    ``Q(Q+1)/2`` pairs the causal mask keeps, and ``4QNP`` per (batch,
    head, chunk) for C times the state and the state update."""
    Q = min(chunk, S)
    pairs = Q * (Q + 1) // 2
    nc = S // Q
    return float(B * G * nc * 2 * pairs * N
                 + B * H * nc * (2 * pairs * P + 4 * Q * N * P))


def ssd_bytes(B: int, S: int, H: int, P: int, G: int, N: int,
              dtype: str) -> float:
    """x, dt (float32), B and C read once and y written once (a copy of
    the port's ``kernels/ssd_scan.py::bound_ms``)."""
    e = ITEMSIZE[dtype]
    x = B * S * H * P * e
    return float(2 * x + B * S * H * 4 + 2 * B * S * G * N * e)


def k3_bound_s(B: int, S: int, H: int, P: int, G: int, N: int, chunk: int,
               dtype: str) -> float:
    """The larger of the operations at the dtype's peak and the bytes at
    the HBM rate."""
    return max(ssd_flops(B, S, H, P, G, N, chunk) / PEAK_FLOPS[dtype],
               ssd_bytes(B, S, H, P, G, N, dtype) / H100_HBM_BYTES_S)


def train_flops(n_params: int, tokens: int) -> float:
    """6 N D: a training step's forward and backward over ``tokens`` tokens
    of a model of ``n_params`` parameters (a copy of the port's
    ``launch/analysis.py::model_flops``), with no recompute counted."""
    return 6.0 * n_params * tokens
