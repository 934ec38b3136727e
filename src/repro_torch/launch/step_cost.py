"""The cost of one training step, counted while it runs: the counterpart
of the reference's ``repro/launch/hlo_cost.py::expanded_cost`` for a torch
step (the role, not the HLO parser: PyTorch runs eagerly, so there is no
compiled module to read).

``count_step(grad_step, params, batch)`` runs one call under a
``TorchDispatchMode`` and returns a ``Cost`` with the reference's fields:

* FLOPs of ``mm``, ``bmm``, ``addmm``, ``baddbmm`` (``2 * numel(result) *
  K``; the held-expert MoE layer's grouped products are one ``mm`` a held
  expert over its slice, ``models/moe.py``) and ``convolution`` (``2 * numel(result) * kernel_spatial * Cin /
  groups``), the reference's formulas, and of the hand kernels' custom
  ops by the formula each kernel module gives (``kernels.common.OP_FLOPS``);
  elementwise ops count none;
* bytes: every op's tensor operands plus its results.  Views and
  allocations count nothing, as the reference skips ``parameter``,
  ``constant``, ``bitcast`` and the rest;
* collectives: the c10d ops (functional, as DTensor issues them, and the
  process-group ones) by type, with the reference's ring formulas
  (``launch.analysis.ring_traffic``) over the op's process group.

Under a mesh the count is per device, as the reference's SPMD module is:
an op on DTensors is counted by the ops it runs on the local shards and
the collectives it issues.

Every hand kernel runs behind custom ops (``repro_torch::*``), and this
mode counts each call as the one op it is: the FLOPs its kernel module
gives the op (K2's forward ``kernels.flash_attention.fwd_flops``, 2 (D +
Dv) per unmasked pair and head; K3's ``kernels.ssd_scan.ssd_flops``; none
for K4's, K5's and K6's, which compute no products) and the bytes of its tensor
arguments and results, filed under the kernel's name (``flash_attention``,
``ssd_scan``, ``rms_norm_fwd``, ...).  A mode does not see the ops inside
a custom op's body, so the compiled library on the card and the plain
version on the CPU count alike, on whichever thread autograd runs the op.
K2's and K3's backwards run as plain torch on both devices and are counted
as dispatched.  The CPU counts K4, K5 and K6 only where it takes them too
(the models route CPU tensors to the composed norms, convs and loss,
``K4.takes``, ``K5.takes``, ``K6.takes``).

On real tensors a count runs the step: one extra forward and backward.
Under a ``FakeTensorMode`` (``launch.dryrun``) nothing runs: the ops whose
fake tensors belong to that mode count as a real step's would, the
kernels' custom ops reach their fake implementations and count alike,
and DTensor's bookkeeping (``marking_propagation``) counts nothing.  On
one device the two counts are equal.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch._guards import active_fake_mode
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels.common import OP_FLOPS
from repro_torch.launch.analysis import ring_traffic

aten = torch.ops.aten


@dataclass
class Cost:
    """What one step costs a device (the reference's ``Cost``;
    ``unknown_trip_loops`` is always 0: nothing here is a loop of unknown
    trip count)."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: Dict[str, float] = field(default_factory=dict)
    coll_counts: Dict[str, float] = field(default_factory=dict)
    unknown_trip_loops: int = 0
    detail_bytes: Dict[str, float] = field(default_factory=dict)
    detail_flops: Dict[str, float] = field(default_factory=dict)

    def _dadd(self, d: Dict[str, float], key: str, v: float):
        d[key] = d.get(key, 0.0) + v

    @property
    def collective_total(self) -> float:
        return sum(self.coll_bytes.values())


#: collective op names (``_c10d_functional`` and ``c10d``) -> the
#: reference's op types
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_NAMESPACES = ("_c10d_functional", "c10d")
#: ops that move no data: allocations, ``_unsafe_view`` (a view the
#: dispatcher does not mark as one), the waits of async collectives and
#: ``prim.device`` (a fake tensor's ``.device`` dispatches it)
_FREE = {aten.empty, aten.empty_strided, aten.empty_like, aten.lift_fresh,
         aten.new_empty, aten.new_empty_strided, aten._unsafe_view,
         torch.ops.prim.device}
_FREE_NAMES = {"wait_tensor", "barrier", "monitored_barrier_"}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _is_dtensor(t) -> bool:
    return type(t).__name__ == "DTensor"


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _group_size(args, kwargs) -> int:
    """Ranks of the collective's process group: the functional ops name
    it, the process-group ops pass it."""
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (KeyError, RuntimeError, ValueError):
                continue
        if isinstance(a, dist.ProcessGroup):
            return a.size()
    return dist.get_world_size() if dist.is_initialized() else 1


def _dot_flops(func, args, out) -> float:
    pkt = func.overloadpacket
    if pkt in (aten.mm, aten.bmm):
        return 2.0 * out.numel() * args[0].shape[-1]
    if pkt in (aten.addmm, aten.baddbmm):
        return 2.0 * out.numel() * args[1].shape[-1]
    if pkt is aten.convolution:
        w = args[1]
        # weight (Cout, Cin / groups, *kernel): spatial x Cin per group
        transposed = bool(args[6])
        per_out = w[0].numel() if not transposed else \
            w.shape[0] // int(args[8]) * w[0, 0].numel()
        return 2.0 * out.numel() * per_out
    return 0.0


_FLOP_OPS = (aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten.convolution)


class _Counter(TorchDispatchMode):
    """The dispatch mode of ``count_step``."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.cost = Cost()
        #: the fake mode the step runs under (a dry run's), whose tensors
        #: count as a real step's do; None for a step on real tensors
        self.fake_mode = fake_mode

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        seen = _tensors((args, kwargs))
        if any(_is_dtensor(t) for t in seen):
            # a DTensor op: DTensor runs it, and this mode, still active,
            # counts the ops on the local shards and the collectives it
            # issues, i.e. what this device does
            return NotImplemented
        out = func(*args, **kwargs)
        if propagating() or any(
                isinstance(t, FakeTensor) and t.fake_mode is not self.fake_mode
                for t in seen + _tensors(out)):
            # DTensor's sharding propagation runs ops on fake tensors: of
            # its own mode, or of the step's under a fake mode
            return out
        name = func.overloadpacket.__name__
        ns = func.namespace
        if ns in _NAMESPACES:
            op = _COLLECTIVES.get(name)
            if op is not None:
                n = max(2, _group_size(args, kwargs))
                size = float(_nbytes(out if ns == "_c10d_functional"
                                     else args[0]))
                c = self.cost
                c._dadd(c.coll_bytes, op, ring_traffic(op, size, n))
                c._dadd(c.coll_counts, op, 1.0)
                b = _nbytes(args) + _nbytes(out)
                c.bytes += b
                c._dadd(c.detail_bytes, f"{op}", b)
            return out
        if name in _FREE_NAMES or func.is_view \
                or func.overloadpacket in _FREE:
            return out
        c = self.cost
        fl = None
        if func.overloadpacket in _FLOP_OPS:
            fl = _dot_flops(func, args, out)
        elif ns == "repro_torch" and name in OP_FLOPS:
            name, formula = OP_FLOPS[name]
            fl = float(formula(*args, **kwargs))
        if fl is not None:
            c.flops += fl
            c._dadd(c.detail_flops, name, fl)
        b = _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        c.bytes += b
        c._dadd(c.detail_bytes, name, b)
        return out


_state = threading.local()


def _active() -> Optional[_Counter]:
    return getattr(_state, "counter", None)


def propagating() -> bool:
    """Whether DTensor's own bookkeeping runs on this thread (inside
    ``marking_propagation``): ops that compute shapes and shard offsets,
    which no device runs."""
    return getattr(_state, "propagating", 0) > 0


@contextmanager
def marking_propagation():
    """Marks DTensor's bookkeeping for ``propagating`` while the block
    runs: its sharding propagation, which computes global shapes on fake
    tensors of the active fake mode (under a dry run's mode only this mark
    tells its ops from the step's), and a strided shard's offsets, which
    it reads back as Python ints (``tolist``) and so computes on real
    index tensors, outside the fake mode, as in a step on real tensors."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard

    def marked(orig, outside_fake):
        def run(*args, **kwargs):
            _state.propagating = getattr(_state, "propagating", 0) + 1
            try:
                with unset_fake_temporarily() if outside_fake \
                        else nullcontext():
                    return orig(*args, **kwargs)
            finally:
                _state.propagating -= 1
        return run
    patched = [(ShardingPropagator, "_propagate_tensor_meta_non_cached",
                False),
               (_StridedShard, "local_shard_size_and_offset", True)]
    origs = [cls.__dict__[name] for cls, name, _ in patched]
    for (cls, name, outside_fake), orig in zip(patched, origs):
        setattr(cls, name, marked(orig, outside_fake))
    try:
        yield
    finally:
        for (cls, name, _), orig in zip(patched, origs):
            setattr(cls, name, orig)


def count_step(grad_step: Callable, params, batch) -> Cost:
    """The ``Cost`` of one ``grad_step(params, batch)`` call (module
    docstring).  Runs the call; its result is dropped."""
    if _active() is not None:
        raise RuntimeError("a step count is already running on this thread")
    fake_mode = active_fake_mode()
    counter = _Counter(fake_mode)
    _state.counter = counter
    try:
        # on real tensors DTensor's propagation runs under a fake mode of
        # its own, which the counter tells apart without the mark
        with marking_propagation() if fake_mode else nullcontext(), counter:
            grad_step(params, batch)
    finally:
        _state.counter = None
    return counter.cost
