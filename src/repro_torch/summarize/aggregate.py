"""Incremental columnar pattern aggregation (DESIGN.md §4).

The old ``PerfTrackerService.aggregate`` unpacked *every* worker's msgpack
payload into a Python dict, held all W dicts alive at once, then scattered
them into per-function ``(W, 3)`` arrays allocated per name.  At the paper's
fleet scale (~100k workers x hundreds of functions) that is W transient
dicts plus F separate arrays touched W times each.

``PatternAggregator`` streams instead: each upload is unpacked, scattered
into one growing ``(W_cap, F_cap, 3)`` buffer, and dropped before the next
one is touched.  Function identities are interned once into a column index;
both axes grow geometrically so adding a worker or discovering a new
function is amortized O(1).  ``finalize`` hands the localizer zero-copy
per-function views into the same buffer.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.events import Kind


class PatternAggregator:
    """Streaming {function -> (W, 3)} builder over per-worker uploads."""

    def __init__(self, expected_workers: int = 16, expected_functions: int = 32):
        self._names: List[str] = []
        self._col: Dict[str, int] = {}          # function name -> column
        self._kinds: Dict[str, Kind] = {}
        self._buf = np.zeros((max(1, expected_workers),
                              max(1, expected_functions), 3), np.float32)
        self._n_workers = 0

    # -- growth ------------------------------------------------------------
    def _ensure(self, rows: int, cols: int) -> None:
        W_cap, F_cap, _ = self._buf.shape
        if rows <= W_cap and cols <= F_cap:
            return
        new = np.zeros((max(rows, 2 * W_cap) if rows > W_cap else W_cap,
                        max(cols, 2 * F_cap) if cols > F_cap else F_cap, 3),
                       np.float32)
        new[:self._n_workers, :len(self._names)] = \
            self._buf[:self._n_workers, :len(self._names)]
        self._buf = new

    def _intern(self, name: str, kind: Optional[Kind]) -> int:
        j = self._col.get(name)
        if j is None:
            j = len(self._names)
            self._ensure(self._n_workers, j + 1)
            self._col[name] = j
            self._names.append(name)
        if kind is not None and name not in self._kinds:
            self._kinds[name] = kind
        return j

    # -- columnar fast path (fleet-batched summarization) -------------------
    def reserve_workers(self, count: int) -> int:
        """Pre-assign ``count`` worker rows for a block scatter; returns the
        first row id.  Used by the fleet-batched path, which fills whole
        (W, F, 3) blocks at once instead of streaming per-worker dicts."""
        base = self._n_workers
        self._ensure(base + count, len(self._names))
        self._n_workers = base + count
        return base

    def intern(self, name: str, kind: Optional[Kind] = None) -> int:
        """Public column interning: same first-seen-kind semantics the
        streaming path applies upload by upload."""
        return self._intern(name, kind)

    def scatter_block(self, row0: int, block: np.ndarray) -> None:
        """Write a dense (Wb, Fb, 3) pattern block at rows ``row0..`` into
        the first ``Fb`` columns — the direct scatter-reduce target of the
        fleet-batched path (no per-worker dicts, no msgpack)."""
        Wb, Fb = block.shape[0], block.shape[1]
        if row0 + Wb > self._buf.shape[0] or Fb > self._buf.shape[1]:
            raise ValueError("scatter_block outside reserved buffer: call "
                             "reserve_workers/intern first")
        self._buf[row0:row0 + Wb, :Fb] = block

    def scatter_rows(self, rows: np.ndarray, block: np.ndarray) -> None:
        """Write a dense (Wb, Fb, 3) block at explicit (non-contiguous)
        reserved rows — the partial-fleet scatter target: a wire window
        missing workers lands its present rows without renumbering them."""
        rows = np.asarray(rows, np.int64)
        Wb, Fb = block.shape[0], block.shape[1]
        if rows.shape != (Wb,):
            raise ValueError(f"rows {rows.shape} must match block rows {Wb}")
        if (rows.size and (int(rows.min()) < 0
                           or int(rows.max()) >= self._n_workers)) \
                or Fb > self._buf.shape[1]:
            raise ValueError("scatter_rows outside reserved buffer (rows "
                             "must be non-negative — negative indices would "
                             "wrap): call reserve_workers/intern first")
        self._buf[rows, :Fb] = block

    def scatter_cols(self, rows: np.ndarray, cols: np.ndarray,
                     block: np.ndarray) -> None:
        """Write a dense (Wb, Fb, 3) block at explicit reserved rows AND
        explicit interned columns — the collector-tree root's scatter
        target (DESIGN.md §10): each shard frame carries its rack's rows
        over its own function subset, so neither axis is a prefix of the
        root buffer."""
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        Wb, Fb = block.shape[0], block.shape[1]
        if rows.shape != (Wb,) or cols.shape != (Fb,):
            raise ValueError(f"rows {rows.shape}/cols {cols.shape} must "
                             f"match block ({Wb}, {Fb}, 3)")
        if rows.size and (int(rows.min()) < 0
                          or int(rows.max()) >= self._n_workers):
            raise ValueError("scatter_cols rows outside reserved "
                             f"[0, {self._n_workers})")
        if cols.size and (int(cols.min()) < 0
                          or int(cols.max()) >= len(self._names)):
            raise ValueError("scatter_cols cols outside interned "
                             f"[0, {len(self._names)})")
        self._buf[np.ix_(rows, cols)] = block

    def set_row(self, row: int, pats: Dict[str, np.ndarray],
                kinds: Optional[Dict[str, Kind]] = None) -> int:
        """Scatter one worker's patterns at an explicit reserved row (the
        wire collector's entry: uploads address rows by worker id, and a
        partial window simply leaves absent rows at zero)."""
        if not 0 <= row < self._n_workers:
            raise ValueError(f"row {row} outside reserved "
                             f"[0, {self._n_workers})")
        kinds = kinds or {}
        for name, p in pats.items():
            j = self._intern(name, kinds.get(name))
            self._buf[row, j] = p
        return row

    def add_upload_at(self, upload, row: int) -> int:
        """Unpack one ``PatternUpload`` into an explicit reserved row."""
        pats, kinds = upload.unpack()
        return self.set_row(row, pats, kinds)

    # -- streaming ---------------------------------------------------------
    def add_patterns(self, pats: Dict[str, np.ndarray],
                     kinds: Optional[Dict[str, Kind]] = None) -> int:
        """Scatter one worker's patterns; returns its row id. Functions this
        worker never reported keep the zero pattern (never on its critical
        path) — exactly the old stacking semantics."""
        w = self._n_workers
        self._ensure(w + 1, len(self._names))
        self._n_workers = w + 1
        kinds = kinds or {}
        for name, p in pats.items():
            j = self._intern(name, kinds.get(name))
            self._buf[w, j] = p
        return w

    def add_upload(self, upload) -> int:
        """Unpack one ``PatternUpload`` and fold it in; the transient dict
        dies here — W uploads never coexist as Python objects."""
        pats, kinds = upload.unpack()
        return self.add_patterns(pats, kinds)

    def extend(self, uploads: Iterable) -> "PatternAggregator":
        for u in uploads:
            self.add_upload(u)
        return self

    # -- results -----------------------------------------------------------
    @property
    def n_workers(self) -> int:
        return self._n_workers

    @property
    def n_functions(self) -> int:
        return len(self._names)

    def matrix(self) -> Tuple[np.ndarray, List[str]]:
        """The raw columnar view: ((W, F, 3) float32, column names)."""
        return (self._buf[:self._n_workers, :len(self._names)],
                list(self._names))

    def kinds(self) -> Dict[str, Kind]:
        """First-seen kind per interned function (copy)."""
        return dict(self._kinds)

    def finalize(self, sort_names: bool = True
                 ) -> Tuple[Dict[str, np.ndarray], Dict[str, Kind]]:
        """Localizer-shaped result: {name: (W, 3) zero-copy view}, kinds.

        The views alias the internal buffer: they are valid until the next
        ``add_*`` call (growth may reallocate, freezing old views at stale
        data).  Treat finalize as terminal, or re-call it after adding."""
        mat, names = self.matrix()
        order = sorted(names) if sort_names else names
        return ({n: mat[:, self._col[n], :] for n in order},
                dict(self._kinds))
