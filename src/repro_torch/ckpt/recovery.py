"""Checkpoint-aware recovery: the bridge between mitigation plans and
REAL on-disk training state (DESIGN.md §14).

``CHECKPOINT_NOW`` and ``ROLLBACK_TO_CHECKPOINT`` were plan labels until
this module: a ``RecoveryManager`` owns a ``Checkpointer`` plus two hooks
into the live workload —

  * ``snapshot()  -> (step, tree)``   — gather the current training state;
  * ``install(step, tree)``           — push a restored state back in;

so the ``MitigationEngine`` can drive an actual async save for
``CHECKPOINT_NOW`` and, for ``ROLLBACK_TO_CHECKPOINT``, restore the
latest VALID on-disk step into the running workload.  Every rollback is
verified by parameter equality against the saved arrays and reported as a
``RestoreOutcome``; when no usable checkpoint exists the outcome is an
honest failure (``ok=False``) — the engine then cures nothing, the
signature survives verification, and the incident escalates instead of
faking a cure.

Two workload bindings:

  * ``RecoveryManager.for_workload`` — a real workload exposing
    ``snapshot_state``/``install_state`` (``TrainerWorkload``: the live
    params/opt_state of every ``Trainer``);
  * ``RecoveryManager.for_sim`` — simulator scenarios carry a
    ``SimTrainState`` side-car: a small REAL tree of torch tensors advanced
    one optimizer step per profiling window, so catalog rollbacks exercise
    genuine save/restore/verify against disk rather than a label.

Both write to a temporary directory unless given one; ``close`` waits for
the last save and removes it.
"""
from __future__ import annotations

import tempfile
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import Checkpointer, CheckpointError, _flatten
from repro_torch.core.service import resolve_device


@dataclass
class RestoreOutcome:
    """What one rollback actually did (the goodput accounting unit)."""
    ok: bool
    step: Optional[int] = None
    #: wall-clock restore cost (read + install + verify), seconds
    restore_s: float = 0.0
    #: training steps discarded by rolling back (current - restored)
    lost_steps: int = 0
    #: installed state compared equal, leaf by leaf, to the on-disk arrays
    verified: bool = False
    error: str = ""


def _bits(x) -> torch.Tensor:
    """A leaf's bytes on the host, for bit-for-bit comparison."""
    t = x.detach() if isinstance(x, torch.Tensor) \
        else torch.from_numpy(np.array(x))
    return t.to("cpu").contiguous().reshape(-1).view(torch.uint8)


def _trees_equal(a, b) -> bool:
    """Same keys, and every leaf the same dtype, shape and bits."""
    flat_a, flat_b = _flatten(a), _flatten(b)
    if list(flat_a) != list(flat_b):
        return False
    for k, x in flat_a.items():
        y = flat_b[k]
        if getattr(x, "dtype", None) != getattr(y, "dtype", None) \
                or tuple(np.shape(x)) != tuple(np.shape(y)) \
                or not torch.equal(_bits(x), _bits(y)):
            return False
    return True


class SimTrainState:
    """Minimal REAL training state for simulator scenarios: a dict of two
    f32 tensors on ``device`` (params + first-moment accumulator) advanced
    one deterministic pseudo-SGD step per profiling window, drawn from the
    reference's numpy seed.  It is what simulator-backed rollbacks save,
    restore, and verify against disk — the fault world stays simulated,
    the checkpoint path does not.  ``device=None`` means the card (and
    raises without one); pass ``device="cpu"`` for the host."""

    def __init__(self, seed: int = 0, n: int = 64, device=None):
        device = resolve_device(device)
        self.step = 0
        rng = np.random.default_rng((int(seed), 0x51))
        w = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        self.params = {"w": w.to(device),
                       "mu": torch.zeros(n, dtype=torch.float32,
                                         device=device)}

    def advance(self) -> None:
        self.step += 1
        g = torch.sin(self.params["w"] * float(self.step))
        mu = 0.9 * self.params["mu"] + 0.1 * g
        self.params = {"w": self.params["w"] - 0.01 * mu, "mu": mu}

    def snapshot(self) -> Tuple[int, dict]:
        return self.step, dict(self.params)

    def install(self, step: int, tree: dict) -> None:
        self.step = int(step)
        self.params = {"w": tree["w"], "mu": tree["mu"]}


class RecoveryManager:
    """Owns the checkpoint directory and the live-state hooks for one run.

    ``on_window`` is the cadence hook (periodic saves every ``save_every``
    windows, plus the side-car's step for sim runs); ``checkpoint`` and
    ``rollback`` are the two verbs the ``MitigationEngine`` executes.
    ``save_every=0`` disables periodic saves entirely — the honest-failure
    path: a rollback before any explicit save finds an empty directory.
    """

    def __init__(self, checkpointer: Checkpointer,
                 snapshot: Callable[[], Tuple[int, object]],
                 install: Callable[[int, object], None],
                 advance: Optional[Callable[[], None]] = None,
                 save_every: int = 3):
        self.ckpt = checkpointer
        self._snapshot = snapshot
        self._install = install
        self._advance = advance
        self.save_every = int(save_every)
        self.saved_steps: List[int] = []
        self.outcomes: List[RestoreOutcome] = []
        self._tmp: Optional[tempfile.TemporaryDirectory] = None

    # -- constructors --------------------------------------------------------
    @classmethod
    def for_sim(cls, seed: int = 0, directory: Optional[str] = None,
                save_every: int = 3, device=None) -> "RecoveryManager":
        """Bind to a ``SimTrainState`` on ``device`` (``None``: the card)."""
        st = SimTrainState(seed, device=device)
        tmp = None
        if directory is None:
            tmp = tempfile.TemporaryDirectory(prefix="repro-ckpt-")
            directory = tmp.name
        mgr = cls(Checkpointer(directory), st.snapshot, st.install,
                  advance=st.advance, save_every=save_every)
        mgr.state = st
        mgr._tmp = tmp            # keeps the temp dir alive for the run
        return mgr

    @classmethod
    def for_workload(cls, workload, directory: Optional[str] = None,
                     save_every: int = 3) -> "RecoveryManager":
        """Bind to a live workload exposing ``snapshot_state`` /
        ``install_state`` (e.g. ``TrainerWorkload``)."""
        tmp = None
        if directory is None:
            tmp = tempfile.TemporaryDirectory(prefix="repro-ckpt-")
            directory = tmp.name
        mgr = cls(Checkpointer(directory), workload.snapshot_state,
                  workload.install_state, advance=None,
                  save_every=save_every)
        mgr._tmp = tmp
        return mgr

    # -- cadence -------------------------------------------------------------
    def on_window(self, window: int) -> None:
        """Called once at the top of every profiling window: periodic
        baseline saves, then (for sim runs) one training step."""
        if self.save_every > 0 and window % self.save_every == 0:
            self.checkpoint()
        if self._advance is not None:
            self._advance()

    # -- verbs ---------------------------------------------------------------
    def checkpoint(self, async_: bool = True) -> int:
        """CHECKPOINT_NOW: snapshot the live state and save it (async:
        file IO off-thread, the workload is never blocked)."""
        step, tree = self._snapshot()
        self.ckpt.save(int(step), tree, async_=async_)
        self.saved_steps.append(int(step))
        return int(step)

    def rollback(self) -> RestoreOutcome:
        """ROLLBACK_TO_CHECKPOINT: restore the latest VALID on-disk step
        into the live workload and verify parameter equality against the
        saved arrays.  Never raises — a missing/corrupt checkpoint is an
        honest ``ok=False`` outcome for the engine to act on."""
        t0 = time.perf_counter()
        self.ckpt.wait()
        cur_step, template = self._snapshot()
        step = self.ckpt.latest_step()
        if step is None:
            out = RestoreOutcome(ok=False,
                                 error="no valid checkpoint on disk")
        else:
            try:
                tree, meta = self.ckpt.restore(step, template)
            except CheckpointError as e:
                out = RestoreOutcome(ok=False, step=step, error=str(e))
            else:
                restored_step = int(meta["step"])
                self._install(restored_step, tree)
                _, now = self._snapshot()
                out = RestoreOutcome(
                    ok=True, step=restored_step,
                    restore_s=time.perf_counter() - t0,
                    lost_steps=max(0, int(cur_step) - restored_step),
                    verified=_trees_equal(now, tree))
        self.outcomes.append(out)
        return out

    def close(self) -> None:
        """Wait for the last save; remove the directory if this manager
        made it."""
        self.ckpt.wait()
        if self._tmp is not None:
            self._tmp.cleanup()
            self._tmp = None

    # -- accounting ----------------------------------------------------------
    @property
    def total_restore_s(self) -> float:
        return sum(o.restore_s for o in self.outcomes)

    @property
    def total_lost_steps(self) -> int:
        return sum(o.lost_steps for o in self.outcomes if o.ok)
