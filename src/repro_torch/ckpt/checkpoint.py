"""Checkpointing with async save and restore onto the current device (port
of the reference's ``repro/ckpt/checkpoint.py``).

Layout:  <dir>/step_<n>/
           meta.json          — leaf shapes and dtypes, step, extra
           <flat_key>.npy     — one array per leaf

The on-disk format is the reference's, byte for byte, for the same tree:

* a leaf's key joins its dict keys and list/tuple indices with ``/`` (and
  ``__`` in its file name); dicts flatten in sorted key order, as JAX
  flattens a pytree, so ``meta.json`` lists the leaves in the same order;
* bf16 and float8 leaves are written as ``uint16``/``uint8`` views, and
  ``meta.json`` names their dtype (``bfloat16``, ``float8_e4m3fn``,
  ``float8_e5m2``), so either package reads the other's checkpoints.

* ``save`` copies each leaf to the host inline (a copy, never a view of a
  tensor the optimizer updates in place) and writes the files on a thread,
  so the training loop is not blocked;
* ``restore`` reads the arrays and puts each leaf on the device and dtype
  of the template's leaf;
* the step directory is written as ``.tmp_step_<n>`` and renamed when it is
  complete, and a step directory whose ``meta.json`` or a leaf is missing or
  unreadable is never counted as a checkpoint.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

#: torch dtypes numpy has no type for, by the names the reference's
#: ``ml_dtypes`` gives them; saved as views of the unsigned integer of the
#: same width
_EXT_DTYPES = {torch.bfloat16: "bfloat16",
               torch.float8_e4m3fn: "float8_e4m3fn",
               torch.float8_e5m2: "float8_e5m2"}
_EXT_BY_NAME = {name: dt for dt, name in _EXT_DTYPES.items()}
_SIGNED = {1: torch.int8, 2: torch.int16}
_UNSIGNED = {1: np.uint8, 2: np.uint16}


class CheckpointError(RuntimeError):
    """A checkpoint step directory is unusable: missing ``meta.json``,
    unreadable metadata, or a leaf absent (partial write)."""


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """``(savable array, dtype name)`` of one leaf, copied off the device."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        name = _EXT_DTYPES.get(t.dtype)
        if name is not None:
            size = t.element_size()
            return (t.view(_SIGNED[size]).numpy().view(_UNSIGNED[size]),
                    name)
        a = t.numpy()
    else:
        a = np.array(leaf)
    return a, str(a.dtype)


def _from_savable(v: np.ndarray, dtype_name: str):
    """A read leaf as a torch tensor (ext dtypes viewed back)."""
    v = np.require(v, requirements="C")      # keeps 0-d leaves 0-d
    ext = _EXT_BY_NAME.get(dtype_name)
    if ext is not None:
        signed = np.dtype(f"i{v.dtype.itemsize}")
        return torch.from_numpy(v.view(signed)).view(ext)
    return torch.from_numpy(v)


def _children(tree):
    """A container's ``(key, child)`` pairs in JAX's flatten order, or None
    for a leaf."""
    if isinstance(tree, dict):
        return sorted(tree.items())
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``{key: leaf}`` in flatten order; ``None`` is an empty subtree."""
    flat: Dict[str, Any] = {}
    if tree is None:
        return flat
    kids = _children(tree)
    if kids is None:
        flat[prefix] = tree
        return flat
    for k, sub in kids:
        flat.update(_flatten(sub, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _unflatten_into(template, flat: Dict[str, torch.Tensor], prefix: str = ""):
    """``template``'s structure with each leaf replaced by its restored
    tensor, on the template leaf's device and dtype."""
    if template is None:
        return None
    kids = _children(template)
    if kids is None:
        if prefix not in flat:
            raise CheckpointError(f"checkpoint has no leaf {prefix!r}")
        arr = flat[prefix]
        if tuple(arr.shape) != tuple(np.shape(template)):
            raise CheckpointError(f"leaf {prefix!r} has shape "
                                  f"{tuple(arr.shape)}, the template "
                                  f"{tuple(np.shape(template))}")
        if isinstance(template, torch.Tensor):
            return arr.to(device=template.device, dtype=template.dtype)
        return arr
    out = [(k, _unflatten_into(sub, flat, f"{prefix}/{k}" if prefix
                               else str(k))) for k, sub in kids]
    if isinstance(template, dict):
        return dict(out)
    return type(template)(v for _, v in out)


def _leaf_file(d: Path, key: str) -> Path:
    return d / (key.replace("/", "__") + ".npy")


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.keep = keep
        self.dir.mkdir(parents=True, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self.last_save_s = 0.0
        # a crashed process may leave .tmp_step_* behind; they were never
        # renamed so they are not checkpoints — reclaim the disk
        for p in self.dir.glob(".tmp_step_*"):
            shutil.rmtree(p, ignore_errors=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[dict] = None,
             async_: bool = True):
        """Copy to the host + write. With async_, the device->host copy
        happens inline and file IO goes to a background thread."""
        self.wait()
        flat = {k: _to_host(v) for k, v in _flatten(tree).items()}
        meta = {"step": step,
                "extra": extra or {},
                "leaves": {k: {"shape": list(a.shape), "dtype": name}
                           for k, (a, name) in flat.items()}}

        def write():
            t0 = time.perf_counter()
            tmp = self.dir / f".tmp_step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            for k, (a, _) in flat.items():
                np.save(_leaf_file(tmp, k), a)
            (tmp / "meta.json").write_text(json.dumps(meta))
            final = self.dir / f"step_{step}"
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()
            self.last_save_s = time.perf_counter() - t0

        if async_:
            self._pending = threading.Thread(target=write, daemon=True)
            self._pending.start()
        else:
            write()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def _read_meta(self, d: Path) -> dict:
        """Read and validate one step dir's metadata; raises
        ``CheckpointError`` on a torn or corrupt directory."""
        meta_path = d / "meta.json"
        try:
            meta = json.loads(meta_path.read_text())
        except OSError as e:
            raise CheckpointError(f"{d.name}: missing meta.json ({e})")
        except ValueError as e:
            raise CheckpointError(f"{d.name}: corrupt meta.json ({e})")
        for k in meta.get("leaves", {}):
            if not _leaf_file(d, k).exists():
                raise CheckpointError(
                    f"{d.name}: partial write, leaf {k!r} missing")
        return meta

    def _is_valid(self, d: Path) -> bool:
        try:
            self._read_meta(d)
        except CheckpointError:
            return False
        return True

    def steps(self):
        """Step numbers of the VALID on-disk checkpoints, ascending.  A
        torn ``step_<n>/`` (missing/corrupt meta.json or a leaf .npy gone)
        is never counted, so it can never be selected as "latest"."""
        out = []
        for p in self.dir.glob("step_*"):
            try:
                s = int(p.name.split("_")[1])
            except ValueError:
                continue
            if self._is_valid(p):
                out.append(s)
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, template) -> Tuple[Any, dict]:
        """Restore ``step`` into ``template``'s structure, each leaf on the
        device and dtype of the template's leaf (the current devices, not
        those at save time).  Raises ``CheckpointError`` when the step dir
        is torn or corrupt, or does not fit the template."""
        self.wait()
        d = self.dir / f"step_{step}"
        meta = self._read_meta(d)
        flat = {}
        for k, info in meta["leaves"].items():
            try:
                arr = np.load(_leaf_file(d, k))
            except (OSError, ValueError) as e:
                raise CheckpointError(f"{d.name}: unreadable leaf "
                                      f"{k!r} ({e})")
            flat[k] = _from_savable(arr, info["dtype"])
        return _unflatten_into(template, flat), meta
