"""Deterministic synthetic token pipeline with a prefetching loader (a copy
of the reference's ``repro/data/pipeline.py``: the same numpy RNG, so the
same seed gives byte-identical batches).

The loader exposes ``next()`` — one of PerfTracker's two anchors. A
``delay_s`` knob injects storage slowness (used by examples/tests to
reproduce paper case C2P1 online).

Data is generated from a counting PRNG keyed by (seed, step, shard), so any
(worker, step) pair is reproducible regardless of fleet size — elastic
restarts resume mid-epoch deterministically.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass
class DataConfig:
    batch: int = 8
    seq_len: int = 128
    seed: int = 1234
    shard: int = 0              # this host's DP shard index
    num_shards: int = 1
    prefetch: int = 2
    delay_s: float = 0.0        # injected storage latency (C2P1 repro)


class SyntheticLM:
    """Markov-ish synthetic token stream: next-token structure so a real
    model can overfit it (loss decreases — used in examples/train_lm.py)."""

    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        d = self.data
        rng = np.random.default_rng(
            (d.seed, step, d.shard))
        B, S, V = d.batch, d.seq_len, self.cfg.vocab_size
        # structured stream: tok[t+1] = (a*tok[t] + b) % V with noise
        a = 31, 17
        x = np.zeros((B, S + 1), np.int64)
        x[:, 0] = rng.integers(0, V, B)
        mult = rng.integers(1, 8, B)[:, None]
        for t in range(S):
            nxt = (x[:, t] * 31 + 17 * mult[:, 0]) % V
            noise = rng.random(B) < 0.05
            x[:, t + 1] = np.where(noise, rng.integers(0, V, B), nxt)
        out = {"tokens": x[:, :-1].astype(np.int32),
               "labels": x[:, 1:].astype(np.int32)}
        if self.cfg.frontend == "audio":
            rngf = np.random.default_rng((d.seed, step, d.shard, 7))
            out = {"embeds": rngf.normal(
                size=(B, S, self.cfg.d_model)).astype(np.float32),
                "labels": out["labels"]}
        elif self.cfg.frontend == "vision":
            F = min(self.cfg.frontend_tokens, S - 1)
            rngf = np.random.default_rng((d.seed, step, d.shard, 7))
            out = {"embeds": rngf.normal(
                size=(B, F, self.cfg.d_model)).astype(np.float32),
                "tokens": out["tokens"][:, :S - F],
                "labels": out["labels"]}
        return out


class DataLoader:
    """Prefetching loader; ``next()`` is the PerfTracker anchor."""

    def __init__(self, source: SyntheticLM, start_step: int = 0):
        self.source = source
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(
            maxsize=max(1, source.data.prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._produce_step = start_step
        self._thread.start()

    def _producer(self):
        while not self._stop.is_set():
            b = self.source.batch_at(self._produce_step)
            self._produce_step += 1
            while not self._stop.is_set():
                try:
                    self._q.put(b, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def next(self) -> Dict[str, np.ndarray]:
        if self.source.data.delay_s:
            time.sleep(self.source.data.delay_s)   # injected storage fault
        b = self._q.get()
        self.step += 1
        return b

    def close(self):
        self._stop.set()
