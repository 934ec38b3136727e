"""A mamba2 model's parameters and its token batches, made from a seed.

The layout is the configuration's (``layout``): per layer an RMS norm and
a Mamba2 block (``w_z``/``w_x``/``w_B``/``w_C``/``w_dt`` in-projections,
depthwise causal convolutions of x, B and C with biases, ``A_log``, ``D``,
``dt_bias``, the gated norm's scale and the out-projection), the token
table (tied to the output head) and the final norm, under the paths the
program's parameter tree uses.  It imports nothing of the program.

Weights are drawn on the device by one ``torch.Generator`` in a few large
calls: every matrix from one stream of standard normals (``CHUNK`` values a
call, in layout order), scaled by ``1/sqrt(fan in)`` (the conv kernels by
``1/sqrt(width)``); ``A_log`` and ``dt_bias`` from one uniform draw, as the
published init ranges them (A in [1, 16], dt log-uniform in [1e-3, 1e-1]).
Norm scales and ``D`` are ones, conv biases zeros.  The same seed gives the
same weights in any process.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

#: standard normals drawn per generator call
CHUNK = 1 << 27
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

Leaf = Tuple[str, Tuple[int, ...], str, str]   # path, shape, dtype, init


def padded_vocab(cfg: Dict) -> int:
    m = int(cfg["pad_vocab_size_multiple"])
    return (int(cfg["vocab_size"]) + m - 1) // m * m


def layout(cfg: Dict) -> List[Leaf]:
    """Every parameter as ``(path, shape, dtype, init)``, sorted by path
    segment as the program flattens its tree (dict keys sorted, layers in
    order)."""
    d, L = int(cfg["d_model"]), int(cfg["num_layers"])
    di = int(cfg["expand"]) * d
    P, N, G = int(cfg["head_dim"]), int(cfg["d_state"]), int(cfg["n_groups"])
    H, W = di // P, int(cfg["d_conv"])
    dt = cfg["param_dtype"]
    block = sorted([
        ("A_log", (H,), "float32", "A_log"),
        ("D", (H,), "float32", "ones"),
        ("conv_B_b", (G * N,), dt, "zeros"),
        ("conv_B_w", (G * N, W), dt, "conv"),
        ("conv_C_b", (G * N,), dt, "zeros"),
        ("conv_C_w", (G * N, W), dt, "conv"),
        ("conv_x_b", (di,), dt, "zeros"),
        ("conv_x_w", (di, W), dt, "conv"),
        ("dt_bias", (H,), "float32", "dt_bias"),
        ("gate_norm", (di,), dt, "ones"),
        ("out_proj", (di, d), dt, "dense"),
        ("w_B", (d, G * N), dt, "dense"),
        ("w_C", (d, G * N), dt, "dense"),
        ("w_dt", (d, H), dt, "dense"),
        ("w_x", (d, di), dt, "dense"),
        ("w_z", (d, di), dt, "dense"),
    ])
    out: List[Leaf] = []
    for i in range(L):
        out.append((f"blocks/{i}/ln/scale", (d,), dt, "ones"))
        out += [(f"blocks/{i}/mamba/{k}", s, t, init)
                for k, s, t, init in block]
    out.append(("embed/table", (padded_vocab(cfg), d), dt, "dense"))
    out.append(("final_norm/scale", (d,), dt, "ones"))
    # the program sorts "blocks/<i>" by the list index, not as text
    return out


def n_params(cfg: Dict) -> int:
    return sum(math.prod(s) for _, s, _, _ in layout(cfg))


class _Normals:
    """A stream of standard normals drawn ``CHUNK`` at a time."""

    def __init__(self, gen: torch.Generator, device):
        self.gen, self.device = gen, device
        self.buf = torch.empty(0, device=device)
        self.pos = 0

    def take(self, n: int) -> torch.Tensor:
        parts = []
        while n:
            if self.pos == self.buf.numel():
                self.buf = torch.randn(CHUNK, generator=self.gen,
                                       device=self.device)
                self.pos = 0
            k = min(n, self.buf.numel() - self.pos)
            parts.append(self.buf[self.pos:self.pos + k])
            self.pos += k
            n -= k
        return parts[0] if len(parts) == 1 else torch.cat(parts)


def make_weights(cfg: Dict, seed: int, device, dtype: str | None = None
                 ) -> Dict[str, torch.Tensor]:
    """``{path: tensor}`` of every parameter (module docstring), each in
    its layout dtype, or all in ``dtype`` (the values rounded to the layout
    dtype first)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    leaves = layout(cfg)
    out: Dict[str, torch.Tensor] = {}
    small = [lf for lf in leaves if lf[3] in ("A_log", "dt_bias")]
    u = torch.rand(sum(math.prod(s) for _, s, _, _ in small), generator=gen,
                   device=device)
    pos = 0
    normals = _Normals(gen, device)
    for path, shape, dt, init in leaves:
        n = math.prod(shape)
        if init in ("A_log", "dt_bias"):
            v = u[pos:pos + n]
            pos += n
            if init == "A_log":
                t = torch.log(1.0 + 15.0 * v)
            else:
                lo, hi = math.log(1e-3), math.log(1e-1)
                step = torch.exp(v * (hi - lo) + lo)
                t = step + torch.log(-torch.expm1(-step))
        elif init == "ones":
            t = torch.ones(n, device=device)
        elif init == "zeros":
            t = torch.zeros(n, device=device)
        else:
            fan = shape[-1] if init == "conv" else shape[-2]
            t = normals.take(n) / math.sqrt(fan)
        t = t.reshape(shape).to(DTYPES[dt])
        out[path] = t if dtype is None else t.to(DTYPES[dtype])
    return out


def batch(cfg: Dict, traffic: Dict, seed: int, step: int
          ) -> Dict[str, np.ndarray]:
    """Step ``step``'s tokens and next-token labels, uniform over the
    vocabulary, from the seed: ``{"tokens", "labels"}`` int32
    ``(batch, seq_len)``.  Every step's rows differ."""
    B, S = int(traffic["batch"]), int(traffic["seq_len"])
    rng = np.random.default_rng((seed, 7, step))
    x = rng.integers(0, int(cfg["vocab_size"]), size=(B, S + 1))
    return {"tokens": x[:, :-1].astype(np.int32),
            "labels": x[:, 1:].astype(np.int32)}
