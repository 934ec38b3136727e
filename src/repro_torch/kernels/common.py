"""What the port's six hand kernels share.  Each wrapper (K1
``pattern_summary``, K2 ``flash_attention``, K3 ``ssd_scan``, K4
``rms_norm``, K5 ``causal_conv``, K6 ``cross_entropy``) imports this module
and ``_build`` and
no other wrapper; it keeps only what is its own: its argument checks,
its variant rule, its scratch sizes, its plain version, its custom ops
with their fakes, and its launch calls.

* The H100 SXM's data-sheet rates (NVIDIA, 700 W): the kernels' bounds
  and ``launch.analysis``'s roofline read them.
* ``Kernel``, the base of a wrapper: the kernel's library, compiled from
  its CUDA source by ``_build`` and loaded with ``ctypes`` at first use,
  its C signatures given as data; its launch counters; and the check of a
  launch's return code, which raises or counts.  Both sit on the host path
  of every launch, so neither formats a message unless a launch failed.
* ``OP_FLOPS``: the FLOP formula of a kernel's custom op, which
  ``launch.step_cost`` counts the op by.  Every hand kernel runs behind
  custom ops, so a step count sees each call as the one op it is, on the
  CPU (the plain version inside it unseen) and on the card alike.
* The rules of a call: when it may skip the dispatcher (``unwatched``),
  its device context (``on``), its checks made once a layout
  (``Layouts``), K4's, K5's and K6's routing (``takes``) and bytes bound
  (``bound_ms``), and the sm_90 TMA rules of K2's and K3's wgmma variants
  (``tma_strides``; ``csrc/sm90.cuh`` is their C++ side).
"""
from __future__ import annotations

import contextlib
import ctypes
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.kernels import _build

Tensor = torch.Tensor

#: H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor cores, fp32 on
#: the CUDA cores
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: device memory
HBM_BYTES_PER_S = 3.35e12
#: NVLink, per direction
NVLINK_BYTES_PER_S = 450e9

#: the type codes every kernel's C interface takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: layouts whose checks a wrapper keeps (``Layouts``)
MAX_LAYOUTS = 256

#: the C types the wrappers' signatures are written in
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
F32, F64 = ctypes.c_float, ctypes.c_double

#: the FLOPs of a hand kernel's custom op, by the op's name in the
#: ``repro_torch`` namespace: (the name ``launch.step_cost`` files the op
#: under, its FLOPs from the op's arguments).  An op not named here counts
#: no FLOPs, under its own name (K4's, K5's and K6's compute no products).
OP_FLOPS: Dict[str, Tuple[str, Callable[..., float]]] = {}


class Kernel:
    """The base of a kernel's wrapper.  A subclass names the kernel
    (``NAME``, "K1" to "K6"; its C functions and its library's file start
    with ``NAME.lower()``), its CUDA source (``SOURCE``, under ``csrc/``),
    its C functions' signatures (``SIGNATURES``: name -> (argument types,
    result type); the error-string function is added) and its launch
    counters (``COUNTS``: for each ``launches_by_<name>``, its keys).
    ``launches`` counts every launch; the CPU path counts none."""

    NAME: str
    SOURCE: Path
    SIGNATURES: Dict[str, Tuple[list, object]]
    COUNTS: Dict[str, Sequence] = {}

    def __init__(self):
        self._lib: Optional[ctypes.CDLL] = None
        self.reset_counts()

    def reset_counts(self) -> None:
        self.launches = 0
        self._by = [dict.fromkeys(keys, 0) for keys in self.COUNTS.values()]
        for name, counts in zip(self.COUNTS, self._by):
            setattr(self, f"launches_by_{name}", counts)

    def library(self) -> ctypes.CDLL:
        """Build (at first use) and load the kernel's shared library."""
        if self._lib is None:
            prefix = self.NAME.lower()
            lib = ctypes.CDLL(str(_build.build(
                self.SOURCE, f"{prefix}_{self.SOURCE.stem}")))
            errors = f"{prefix}_error_string"
            for name, (args, res) in {**self.SIGNATURES,
                                      errors: ([I], ctypes.c_char_p)}.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, res
            self._lib = lib
        return self._lib

    def check(self, code: int, what: Callable[[], str]) -> None:
        """Raise ``RuntimeError`` naming the kernel, ``what()`` (what was
        launched: its variant or direction and operands) and the library's
        message for a nonzero ``code``."""
        if code != 0:
            msg = getattr(self.library(), f"{self.NAME.lower()}_error_string")
            raise RuntimeError(f"{self.NAME} {what()} failed: error {code} "
                               f"({msg(code).decode()})")

    def launched(self, code: int, what: Callable[[], str], *keys) -> None:
        """``check`` a launch's ``code``; only if it succeeded, count the
        launch, and one under each of ``keys`` (one a counter, in the
        order of ``COUNTS``)."""
        if code != 0:
            self.check(code, what)
        self.launches += 1
        for counts, key in zip(self._by, keys):
            counts[key] += 1


def takes(x: Tensor) -> bool:
    """Whether the models route ``x`` to K4, K5 or K6: a tensor on a CUDA
    device (a dry run's fake ones included) that is not a DTensor."""
    return x.device.type == "cuda" and type(x).__name__ != "DTensor"


def bound_ms(tensors: Sequence[Tensor]) -> float:
    """Least time an H100 could take for a call that reads or writes
    ``tensors`` once each (its inputs and outputs), in ms."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return nbytes / HBM_BYTES_PER_S * 1e3


def unwatched(tensors: Sequence[Optional[Tensor]]) -> bool:
    """Whether a call may skip the dispatcher: no dispatch mode is active
    (a step count's, a fake mode's) and no operand is a tensor subclass
    with a dispatch of its own.  Such a call runs the op's body directly,
    which spares the custom op's host time (on an H100 host a norm's
    forward and backward fell from ~980 to ~750 us with the checks made
    once a layout); every other call goes through the op, whose fake
    implementation and count those readers need.  K4 and K5 take it; K2,
    K3 and K6 always enter through their ops, whose events the benchmark
    reads in the device trace (K6 runs twice a step, too few calls for the
    op's host time to matter)."""
    return _get_current_dispatch_mode() is None and all(
        type(t) in _PLAIN for t in tensors if t is not None)


_PLAIN = (torch.Tensor, torch.nn.Parameter)
_NO_CONTEXT = contextlib.nullcontext()


def on(device: torch.device):
    """A launch's device context: none when ``device`` is current."""
    if device.index == torch.cuda.current_device():
        return _NO_CONTEXT
    return torch.cuda.device(device)


def ptr(t: Optional[Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


class Layouts:
    """A wrapper's card checks made once a layout: ``layouts(check,
    tensors, *rest)`` is ``check(*tensors, *rest)``, kept by the tensors'
    layouts (shapes, strides, types and devices; None for an absent one)
    and ``rest``, at most ``MAX_LAYOUTS`` of them."""

    def __init__(self):
        self._hits: dict = {}

    def __call__(self, check: Callable, tensors: Sequence[Optional[Tensor]],
                 *rest):
        key = rest + tuple(None if t is None else (
            t.shape, t.stride(), t.dtype, t.device) for t in tensors)
        hit = self._hits.get(key)
        if hit is None:
            hit = check(*tensors, *rest)
            if len(self._hits) >= MAX_LAYOUTS:
                self._hits.clear()
            self._hits[key] = hit
        return hit


def tma_strides(t: Tensor) -> Tuple[int, int, int]:
    """The (batch, seq, head) strides, in elements, by which a wgmma
    variant's TMA descriptors read a ``(B, S, heads, D)`` operand: its own,
    except that a dimension of size 1 gets the stride of a dense layout
    (its stride is never used, and TMA takes none that is not a multiple of
    16 bytes).  Raises ``ValueError`` unless the head dim is contiguous,
    the base is 16-byte aligned and every other stride is a positive
    multiple of 16 bytes below 2^40."""
    if t.dim() == 4 and t.stride(3) == 1 and t.data_ptr() % 16:
        raise ValueError(f"TMA needs a 16-byte-aligned base, got address "
                         f"{t.data_ptr():#x}")
    return tma_layout(t)


def tma_layout(t: Tensor) -> Tuple[int, int, int]:
    """``tma_strides`` without the base address: what a tensor with no
    storage (a dry run's) can be checked for."""
    if t.dim() != 4 or t.stride(3) != 1:
        raise ValueError("TMA reads (B, S, heads, D) with D contiguous")
    size = t.element_size()
    strides = [0, 0, 0]
    inner, extent = 1, t.shape[3]
    for dim in (2, 1, 0):
        st = t.stride(dim) if t.shape[dim] > 1 else inner * extent
        if st <= 0 or (st * size) % 16 or st * size >= 1 << 40:
            raise ValueError(f"TMA needs strides that are positive "
                             f"multiples of 16 bytes, got stride {st} "
                             f"elements of {size} bytes in dim {dim}")
        strides[dim] = st
        inner, extent = st, t.shape[dim]
    return strides[0], strides[1], strides[2]
