"""Backend protocol for batched behavior-pattern summarization (DESIGN.md §3).

A *summarize backend* consumes one zero-padded ``(E, n)`` utilization matrix
(one row per function execution, see ``repro_torch.summarize.packing``) and
returns an ``(E, 3)`` float array of per-row critical-duration statistics::

    out[e] = (mean, std, count)

where ``[lo, hi)`` is the Algorithm-1 critical execution duration of row
``e``, ``mean``/``std`` are the population statistics of ``u[e, lo:hi]`` and
``count = hi - lo`` (samples, including interior zeros kept by the gap
bound).  All-zero rows may return any ``count``; the engine overrides them
with the row's true (unpadded) length, so backends need not know padding.

Backends are registered by name: ``python`` and ``numpy`` run on the host,
``torch`` runs the plain torch version of kernel K1 on a CPU or CUDA device,
``cuda`` runs K1 itself on the card.  A call names one explicitly, or the
``REPRO_TORCH_SUMMARIZE_BACKEND`` environment variable does, or the device
decides: ``cuda`` on a CUDA device, ``torch`` on the CPU.  There is no
fallback: an unknown name raises ``KeyError``, and a backend that cannot run
raises when it is asked to.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Protocol, runtime_checkable

import numpy as np
import torch

ENV_BACKEND = "REPRO_TORCH_SUMMARIZE_BACKEND"


@runtime_checkable
class SummarizeBackend(Protocol):
    """Batched Algorithm-1 executor."""

    name: str

    def batch_stats(self, u: np.ndarray) -> np.ndarray:
        """u: (E, n) utilization in [0, 1]. Returns (E, 3) [mean, std, count]."""
        ...


#: name -> factory taking the torch device the backend runs on
_REGISTRY: Dict[str, Callable[[torch.device], SummarizeBackend]] = {}
_INSTANCES: Dict[tuple, SummarizeBackend] = {}


def register_backend(name: str,
                     factory: Callable[[torch.device], SummarizeBackend]
                     ) -> None:
    _REGISTRY[name] = factory


def default_backend(device) -> str:
    """The backend a device runs when nothing names one."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def get_backend(name: Optional[str] = None,
                device="cuda") -> SummarizeBackend:
    """Resolve a backend by explicit name, else the environment variable,
    else the device's default (``default_backend``).  Unknown names raise
    ``KeyError`` listing the registered ones."""
    choice = name or os.environ.get(ENV_BACKEND) or default_backend(device)
    if choice not in _REGISTRY:
        raise KeyError(f"unknown summarize backend {choice!r}; "
                       f"registered: {sorted(_REGISTRY)}")
    dev = torch.device(device)
    key = (choice, str(dev))
    if key not in _INSTANCES:
        _INSTANCES[key] = _REGISTRY[choice](dev)
    return _INSTANCES[key]
