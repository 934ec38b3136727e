"""Sharding context for meshes (port of the reference's
``repro/dist/sharding.py``; DESIGN.md §4).

``DistCtx`` is the one object the model, optimizer and serving layers
consult for placement decisions.  It holds a
``torch.distributed.device_mesh.DeviceMesh`` with named dims:

  - ``model`` (a.k.a. tensor-parallel) dim: expert/TP sharding;
  - every other dim ("pod", "data", ...): data-parallel, and — with
    ``fsdp`` on (the default) — parameter sharding a la ZeRO-3: each leaf is
    sharded over the DP dims along its largest divisible dimension and
    gathered on use by DTensor's sharding propagation.

Each rule returns DTensor placements, one ``Placement`` per mesh dim; a
tensor dim sharded over several DP dims (``pod`` and ``data``) is
``Shard(d)`` on each of them, pod-major, the layout of the reference's
tuple spec.  Numerics never depend on these choices; they only set where
bytes live, so the rules stay simple and total: anything indivisible is
replicated rather than rejected.  The port's parameters are one dict per
layer, not the reference's stacked ``(L, ...)`` leaves, so for the same
model it picks other dims; for the same shape it picks the same one.

Activation constraints (``constrain_act``, ``constrain_logits``,
``constrain_heads``) redistribute a DTensor to the placements the
reference's ``with_sharding_constraint`` names; a plain tensor passes
through.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.models.transformer import map_params

#: dim names treated as the tensor/model-parallel dim
MODEL_AXIS_NAMES = ("model", "tp")

Placements = Tuple[Placement, ...]


@dataclass(frozen=True)
class NamedSharding:
    """Placements on a mesh: what a leaf of ``Checkpointer.restore``'s
    ``shardings`` names (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: DeviceMesh
    placements: Placements


class P(tuple):
    """A reference-style partition spec, one entry per tensor dim: None, a
    mesh dim name, or a tuple of names (``jax.sharding.PartitionSpec``'s
    form)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)


def spec_placements(mesh: DeviceMesh, spec: Sequence) -> Placements:
    """DTensor placements of a reference-style spec: one entry per tensor
    dim, each None, a mesh dim name, or a tuple of names."""
    out = [Replicate()] * mesh.ndim
    names = mesh.mesh_dim_names
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(a)] = Shard(d)
    return tuple(out)


@dataclass
class DistCtx:
    mesh: Optional[DeviceMesh] = None
    fsdp: bool = True             # ZeRO-3 params over the DP dims
    zero1_moe: bool = False       # experts resident (no per-layer gathers)

    @classmethod
    def from_mesh(cls, mesh: DeviceMesh) -> "DistCtx":
        return cls(mesh=mesh)

    # -- axis bookkeeping --------------------------------------------------
    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names) if self.mesh is not None \
            else ()

    @property
    def tp_axis(self) -> Optional[str]:
        for a in self.axis_names:
            if a in MODEL_AXIS_NAMES:
                return a
        return None

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axis_names
                     if a not in MODEL_AXIS_NAMES)

    def _size(self, axes) -> int:
        if self.mesh is None:
            return 1
        s = 1
        for a in axes:
            s *= self.mesh.size(self.axis_names.index(a))
        return s

    @property
    def dp_size(self) -> int:
        return self._size(self.dp_axes)

    @property
    def tp_size(self) -> int:
        return self._size((self.tp_axis,)) if self.tp_axis else 1

    def _dp_entry(self):
        dp = self.dp_axes
        return dp if len(dp) > 1 else dp[0]

    def placements(self, spec: Sequence) -> Placements:
        """The placements of a reference-style spec on this mesh."""
        return spec_placements(self.mesh, spec)

    def named(self, shardings):
        """A tree of placements as ``NamedSharding`` on this mesh."""
        if isinstance(shardings, tuple) and all(
                isinstance(p, Placement) for p in shardings):
            return NamedSharding(self.mesh, shardings)
        if isinstance(shardings, dict):
            return {k: self.named(v) for k, v in shardings.items()}
        return [self.named(v) for v in shardings]

    # -- sharding rules ----------------------------------------------------
    def replicated(self) -> Optional[Placements]:
        """Fully-replicated placements on this mesh (None when unmeshed)."""
        if self.mesh is None:
            return None
        return (Replicate(),) * self.mesh.ndim

    def _shard_leaf_fsdp(self, leaf) -> Placements:
        """ZeRO-3: the leaf's largest dim divisible by ``dp_size`` (the
        first of equals) over every DP dim; replicated when fsdp is off,
        nothing is data-parallel or nothing divides."""
        shape = tuple(leaf.shape)
        dpn = self.dp_size
        spec = [None] * len(shape)
        divisible = [i for i, s in enumerate(shape) if s and s % dpn == 0]
        if self.fsdp and dpn > 1 and divisible:
            spec[max(divisible, key=lambda i: shape[i])] = self._dp_entry()
        return self.placements(spec)

    def params_shardings(self, params):
        """ZeRO-3 layout: every leaf sharded over DP along its largest
        divisible dim (replicated when fsdp is off or nothing divides)."""
        return map_params(self._shard_leaf_fsdp, params)

    def _shard_batch_leaf(self, leaf) -> Placements:
        shape = tuple(leaf.shape)
        dpn = self.dp_size
        spec = [None] * len(shape)
        if dpn > 1 and shape and shape[0] % dpn == 0:
            spec[0] = self._dp_entry()
        return self.placements(spec)

    def batch_shardings(self, batch):
        """Inputs: leading (global-batch) dim over the DP dims."""
        return {k: self._shard_batch_leaf(v) for k, v in batch.items()}

    def cache_shardings(self, cache, batch_size: int):
        """KV caches: the batch dim (whichever dim equals ``batch_size``)
        over DP; everything else replicated."""
        dpn = self.dp_size

        def shard(leaf):
            spec = [None] * leaf.dim()
            if dpn > 1:
                for i, s in enumerate(leaf.shape):
                    if s == batch_size and s % dpn == 0:
                        spec[i] = self._dp_entry()
                        break
            return self.placements(spec)
        return map_params(shard, cache)

    # -- placing tensors ---------------------------------------------------
    def distribute(self, t: torch.Tensor, placements: Placements) -> DTensor:
        """``t``, the same full tensor on every rank, as a DTensor on this
        mesh: each rank keeps its own shard and nothing is sent."""
        return distribute_tensor(t, self.mesh, placements, src_data_rank=None)

    def place(self, tree, shardings):
        """Every tensor of ``tree`` (the same on every rank) distributed by
        the placements of the same path in ``shardings``."""
        flat = iter(_leaves(shardings))
        return map_params(lambda t: self.distribute(t, next(flat)), tree)

    # -- activation constraints -------------------------------------------
    def _constrain(self, x, spec):
        if not isinstance(x, DTensor):
            return x
        want = self.placements(spec)
        if tuple(x.placements) == want:
            return x
        return redistribute(x, self.mesh, want)

    def _act_spec(self, x, last_axis_tp: bool):
        spec = [None] * x.ndim
        if self.dp_size > 1 and x.shape[0] % self.dp_size == 0:
            spec[0] = self._dp_entry()
        tp = self.tp_axis
        if (last_axis_tp and tp and self.tp_size > 1
                and x.shape[-1] % self.tp_size == 0):
            spec[-1] = tp
        return spec

    def constrain_act(self, x):
        """Activations: batch over DP, feature dim replicated."""
        if self.mesh is None or not getattr(x, "ndim", 0):
            return x
        return self._constrain(x, self._act_spec(x, False))

    def constrain_logits(self, x):
        """Logits: batch over DP, vocab over the model dim."""
        if self.mesh is None or not getattr(x, "ndim", 0):
            return x
        return self._constrain(x, self._act_spec(x, True))

    def heads_spec(self, x) -> list:
        """The spec of an attention tensor ``(B, S, H, D)``: batch over DP,
        heads over the model dim where they divide."""
        spec = [None] * x.ndim
        if self.dp_size > 1 and x.shape[0] % self.dp_size == 0:
            spec[0] = self._dp_entry()
        tp = self.tp_axis
        if tp and self.tp_size > 1 and x.shape[2] % self.tp_size == 0:
            spec[2] = tp
        return spec

    def gather(self, x):
        """``x`` replicated on every mesh dim: a parameter gathered before
        ops that DTensor cannot run on its shards, as FSDP gathers on
        use."""
        if self.mesh is None or not isinstance(x, DTensor):
            return x
        return self._constrain(x, [None] * x.ndim)

    def batch_entry(self, x):
        """The spec entry of ``x``'s batch dim in a local-shard region: the
        data-parallel dims where they divide it, else None (replicated).  A
        plain tensor is None: it counts as replicated (``replicating``),
        and a region takes it whole on every rank."""
        if isinstance(x, DTensor) and self.dp_size > 1 \
                and x.shape[0] % self.dp_size == 0:
            return self._dp_entry()
        return None

    def dp_partial(self, sharded: bool) -> Placements:
        """Placements of a value each data-parallel shard holds part of
        (a sum over its tokens, the gradient of a replicated weight) and
        each model shard holds whole: ``Partial`` on the data-parallel dims
        when the batch is ``sharded`` over them, else replicated."""
        from torch.distributed.tensor import Partial
        return tuple(Partial() if sharded and a in self.dp_axes
                     else Replicate() for a in self.axis_names)

    def shard_vocab(self, w):
        """An LM head or embedding table ``(V, d)`` with the vocab over the
        model dim where it divides and replicated over the data dims (the
        Megatron vocab-parallel head)."""
        if self.mesh is None or not isinstance(w, DTensor):
            return w
        tp = self.tp_axis
        spec = [None] * w.ndim
        if tp and self.tp_size > 1 and w.shape[0] % self.tp_size == 0:
            spec[0] = tp
        return self._constrain(w, spec)

    def constrain_heads(self, x):
        """Attention tensors (B, S, H, D): batch over DP, heads over the
        model dim (the head counts are padded upstream to divide tp)."""
        if self.mesh is None or getattr(x, "ndim", 0) < 4:
            return x
        return self._constrain(x, self.heads_spec(x))


def _contiguous_grad(g):
    """A DTensor gradient whose local shard is contiguous."""
    local = g.to_local()
    if local.is_contiguous():
        return g
    return DTensor.from_local(local.contiguous(), g.device_mesh,
                              g.placements, shape=g.shape, stride=g.stride())


def redistribute(x: DTensor, mesh: DeviceMesh, placements) -> DTensor:
    """``x.redistribute(mesh, placements)`` whose backward hands on a
    gradient with contiguous local shards: redistributing Replicate to
    Shard in the backward slices the local tensor, and DTensor's ``view``
    (a matrix product's backward folds its batch dims with one) cannot
    take a non-contiguous shard."""
    if x.requires_grad:
        x.register_hook(_contiguous_grad)
    return x.redistribute(mesh, tuple(placements))


def _keeps(src, dst, d: int, n: int) -> bool:
    """Whether a reshape of ``src`` to ``dst`` keeps a shard of ``src``'s
    dim ``d`` over ``n`` ranks even: the dim stays in place (the dims
    before it equal), or at the same distance from the end, with a leading
    size that ``n`` divides."""
    src, dst = tuple(src), tuple(dst)
    if d < len(dst) and src[:d] == dst[:d] and dst[d] % n == 0:
        return True
    back = len(src) - d
    return back <= len(dst) and src[d:] == dst[len(dst) - back:]


def uneven_mesh_dims(src, placements, mesh_sizes, dst) -> list:
    """The mesh dims whose shards a reshape of ``src`` to ``dst`` would
    split unevenly or move.  A tensor dim sharded over several mesh dims
    (``(pod, data)``) is split ``prod`` of their sizes ways, so it keeps its
    shards only if that product divides it: each mesh dim alone may
    divide where their product does not (zamba2's 112 SSM heads over
    2 x 16 ranks)."""
    ndim = len(src)
    over = {}
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            over.setdefault(p.dim % ndim, []).append(i)
    bad = []
    for d, dims in over.items():
        n = math.prod(mesh_sizes[i] for i in dims)
        if not _keeps(src, dst, d, n):
            bad.extend(dims)
    return sorted(bad)


def even_for_reshape(x, shape):
    """``x`` replicated on every mesh dim whose shard a reshape to
    ``shape`` would split unevenly or move (``uneven_mesh_dims``):
    DTensor's own choice of placements for a matrix product (or its
    gradient) may shard a dim over the model dim, and DTensor refuses such
    a reshape."""
    if not isinstance(x, DTensor):
        return x
    pl = list(x.placements)
    mesh = x.device_mesh
    bad = uneven_mesh_dims(tuple(x.shape), pl,
                           [mesh.size(i) for i in range(mesh.ndim)], shape)
    if not bad:
        return x
    for i in bad:
        pl[i] = Replicate()
    return redistribute(x, mesh, pl)


_nesting = threading.local()


@contextmanager
def replicating():
    """Plain tensors meet DTensors as replicated ones (DTensor's
    ``implicit_replication``), re-entrantly: DTensor's own context turns
    the switch off when any nested use of it ends."""
    from torch.distributed.tensor.experimental import implicit_replication
    depth = getattr(_nesting, "depth", 0)
    _nesting.depth = depth + 1
    try:
        if depth:
            yield
        else:
            with implicit_replication():
                yield
    finally:
        _nesting.depth = depth


def _leaves(tree):
    """The placements tuples of a shardings tree, in ``param_leaves``
    order (a placements tuple is a leaf, not a list)."""
    if isinstance(tree, tuple) and all(isinstance(p, Placement)
                                       for p in tree):
        return [tree]
    items = [v for _, v in sorted(tree.items())] \
        if isinstance(tree, dict) else tree
    return [leaf for sub in items for leaf in _leaves(sub)]
