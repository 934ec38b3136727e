"""Gradient compression for data-parallel all-reduces (port of the
reference's ``repro/optim/compress.py``).

Two compressors:

  * ``bf16``  — cast grads to bf16 for the reduction (2x traffic cut);
  * ``int8``  — per-tensor symmetric int8 quantization with ERROR FEEDBACK
    (the residual carried between steps): 4x traffic cut, unbiased in the
    long run.

``psum_compressed`` is an all-reduce over a ``torch.distributed`` process
group (the reference's runs inside ``shard_map`` over a mesh axis).  For
``int8`` every rank quantizes against one shared scale (a ``MAX``
all-reduce of the local scales), the int8 payload is summed as int32, and
the sum is divided by the group size.  ``torch.round`` and ``jnp.round``
both round half to even, so ``quantize_int8`` is the reference's bit for
bit.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.models.transformer import map_params, param_leaves

Tensor = torch.Tensor


def quantize_int8(x: Tensor) -> Tuple[Tensor, Tensor]:
    scale = x.abs().max() / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: Tensor, scale: Tensor) -> Tensor:
    return q.to(torch.float32) * scale


def _zeros_like_f32(grads):
    return map_params(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                            device=g.device), grads)


def compress_tree_int8(grads, residual):
    """Error feedback: g' = g + residual; transmit Q(g'); residual = g'-Q.
    Returns (the tree of ``(q, scale)`` pairs, the new residual tree)."""
    if residual is None:
        residual = _zeros_like_f32(grads)
    quant, res = [], []
    for (_, g), (_, r) in zip(param_leaves(grads), param_leaves(residual)):
        gf = g.to(torch.float32) + r
        q, s = quantize_int8(gf)
        quant.append((q, s))
        res.append(gf - dequantize_int8(q, s))
    it_q, it_r = iter(quant), iter(res)
    return (map_params(lambda _: next(it_q), grads),
            map_params(lambda _: next(it_r), grads))


def _all_reduce(t: Tensor, group, op=dist.ReduceOp.SUM) -> Tensor:
    dist.all_reduce(t, op=op, group=group)
    return t


def psum_compressed(grads, group=None, method: str = "bf16", residual=None):
    """All-reduce ``grads`` (a nested dict/list of tensors) over the process
    ``group`` (None: the default group) with compression.  Returns
    (mean_grads_f32, new_residual); ``residual`` is used and returned only
    by ``int8``."""
    n = dist.get_world_size(group)
    if method == "none":
        return map_params(lambda g: _all_reduce(g.to(torch.float32).clone(),
                                                group) / n, grads), residual
    if method == "bf16":
        return map_params(
            lambda g: (_all_reduce(g.to(torch.bfloat16).clone(), group)
                       / n).to(torch.float32), grads), residual
    if method == "int8":
        if residual is None:
            residual = _zeros_like_f32(grads)
        outs, ress = [], []
        for (_, g), (_, r) in zip(param_leaves(grads),
                                  param_leaves(residual)):
            gf = g.to(torch.float32) + r
            # one scale shared across the group (a MAX of a scalar), so the
            # int32-summed payload dequantizes exactly
            s = _all_reduce(gf.abs().max() / 127.0 + 1e-30, group,
                            dist.ReduceOp.MAX)
            q = torch.clamp(torch.round(gf / s), -127, 127).to(torch.int8)
            ress.append(gf - q.to(torch.float32) * s)
            tot = _all_reduce(q.to(torch.int32), group)
            outs.append(tot.to(torch.float32) * s / n)
        it_o, it_r = iter(outs), iter(ress)
        return (map_params(lambda _: next(it_o), grads),
                map_params(lambda _: next(it_r), grads))
    raise ValueError(method)


def compression_ratio(method: str) -> float:
    return {"none": 1.0, "bf16": 2.0, "int8": 4.0}[method]
