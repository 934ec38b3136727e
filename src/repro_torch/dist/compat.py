"""Regions that run on local shards (the port's ``shard_map``, after the
reference's ``repro/dist/compat.py``).

``shard_map(f, mesh=, in_specs=, out_specs=)`` returns a function that
takes DTensors, redistributes each to its ``in_specs`` entry, calls ``f``
on the local shards (``to_local``), and wraps ``f``'s outputs as DTensors
with the ``out_specs`` placements (``from_local``): what
``torch.distributed.tensor.experimental.local_map`` does, with the
reference's argument names.  A spec is a ``sharding.P`` (one entry per
tensor dim), a tuple of placements (one per mesh dim), a dict of specs for
a dict argument, or None for an argument that is no tensor; a plain tensor
is passed as it is, as this rank's shard.  ``out_specs`` is one spec or a
tuple of them.

Autograd passes through both ends.  The gradient of an input comes back
with its ``in_grad_specs`` entry (default: its ``in_specs`` entry); a
replicated input whose shards each give only part of its gradient, as the
MoE router's under expert parallelism, names ``Partial`` there, and DTensor
sums the parts where the gradient meets its parameter's placements.

The region is where DTensor cannot dispatch: the hand kernels K2 and K3
have no sharding rule (a compiled library call), so the attention core and
the SSD scan run in one, and so does the MoE layer's expert-parallel body,
whose collectives are explicit (``all_reduce_fwd``, ``all_gather_fwd``).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch.distributed._functional_collectives import AsyncCollectiveTensor
from torch.distributed.tensor import DTensor, Placement

from repro_torch.dist.sharding import P, redistribute, spec_placements


def _is_placements(spec) -> bool:
    return isinstance(spec, tuple) and not isinstance(spec, P) \
        and bool(spec) and all(isinstance(p, Placement) for p in spec)


def _placements(mesh, spec):
    return tuple(spec) if _is_placements(spec) \
        else spec_placements(mesh, spec)


def _to_local(mesh, arg, spec, grad_spec):
    if spec is None:
        return arg
    if isinstance(spec, dict):
        return {k: _to_local(mesh, arg[k], spec[k], grad_spec[k])
                for k in spec}
    if not isinstance(arg, DTensor):
        return arg
    want = _placements(mesh, spec)
    if tuple(arg.placements) != want:
        arg = redistribute(arg, mesh, want)
    local = arg.to_local(grad_placements=_placements(mesh, grad_spec))
    return local.wait() if isinstance(local, AsyncCollectiveTensor) \
        else local


def _from_local(mesh, out, spec):
    if isinstance(spec, tuple) and not isinstance(spec, P) \
            and not _is_placements(spec):
        return tuple(_from_local(mesh, o, s) for o, s in zip(out, spec))
    if spec is None or not isinstance(out, torch.Tensor):
        return out
    return DTensor.from_local(out, mesh, _placements(mesh, spec),
                              run_check=False)


def shard_map(f: Callable, *, mesh, in_specs: Sequence, out_specs,
              in_grad_specs: Sequence = None) -> Callable:
    """``f`` run on local shards (module docstring).  The reference's
    ``check_vma`` has no counterpart: nothing checks replication here."""
    grads = in_specs if in_grad_specs is None else in_grad_specs

    def wrapped(*args):
        local = [_to_local(mesh, a, s, g)
                 for a, s, g in zip(args, in_specs, grads)]
        return _from_local(mesh, f(*local), out_specs)
    return wrapped


# -- collectives with the gradients a region needs ----------------------------

class _AllReduceFwd(torch.autograd.Function):
    """SUM over ``group`` forward; the identity backward (the output is
    replicated over the group, so each rank's gradient is already the
    whole one)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _AllGatherFwd(torch.autograd.Function):
    """The shards of ``group`` concatenated along ``dim`` forward; the
    backward sums the gradient over the group and keeps this rank's slice
    (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, dy):
        g = dy.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        rank = dist.get_rank(ctx.group)
        n = dist.get_world_size(ctx.group)
        return g.chunk(n, dim=ctx.dim)[rank].contiguous(), None, None


def all_reduce_fwd(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the process ``group`` (``_AllReduceFwd``)."""
    return _AllReduceFwd.apply(x, group)


def all_gather_fwd(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's shards of ``x`` concatenated along ``dim``
    (``_AllGatherFwd``)."""
    return _AllGatherFwd.apply(x, group, dim)
