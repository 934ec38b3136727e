"""Batched serving engine (port of the reference's
``repro/serve/engine.py``): continuous batched decode with prefill, KV/SSM
caches, temperature sampling, and PerfTracker serve-mode anchors
(request.dequeue / decode.step play the roles of the two anchors).

PyTorch runs eagerly: the step is ``make_serve_step``'s plain function, the
cache is updated in place, and the next token stays on the device as the
next step's input.  Greedy decoding takes the ``argmax`` (the first index on
ties, as the reference's).  ``temperature > 0`` samples from a
``torch.Generator`` seeded with ``ServeConfig.seed``: the JAX PRNG stream
cannot be matched, so sampling is deterministic per seed but not the
reference's.

Device policy: the engine runs on ``device`` (``None`` means ``"cuda"``) and
raises without a CUDA device unless the caller passes ``"cpu"``.  The
parameters are the caller's, on that device.  With ``dist`` (a
``dist.sharding.DistCtx`` with a mesh) the model runs under it and each
cache is placed by ``cache_shardings`` (batch over the data-parallel dims);
the parameters are then the caller's DTensors or plain tensors, and the
tokens come back whole on every rank.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.events import Kind
from repro_torch.core.service import resolve_device
from repro_torch.instrument.hooks import PerfTracker, PerfTrackerConfig
from repro_torch.models.transformer import Transformer
from repro_torch.train.step import make_serve_step


@dataclass
class ServeConfig:
    batch: int = 4
    max_len: int = 128
    temperature: float = 0.0        # 0 = greedy
    seed: int = 0
    perftracker: bool = False


class Engine:
    def __init__(self, cfg: ModelConfig, params, sc: ServeConfig,
                 dist=None, device=None):
        self.cfg, self.sc = cfg, sc
        self.device = resolve_device(device)
        self.dist = dist if dist is not None and dist.mesh is not None \
            else None
        self.model = Transformer(cfg, dist=self.dist)
        self.params = params
        self._step = make_serve_step(self.model)
        self.pt: Optional[PerfTracker] = None
        if sc.perftracker:
            self.pt = PerfTracker(PerfTrackerConfig(window_s=0.5),
                                  device=self.device)

    def generate(self, prompts: np.ndarray, n_new: int) -> np.ndarray:
        """prompts: (B, P) int32. Returns (B, P+n_new) int32."""
        sc = self.sc
        B, P = prompts.shape
        cache = self.model.init_cache(B, sc.max_len, device=self.device)
        if self.dist is not None:
            cache = self.dist.place(cache,
                                    self.dist.cache_shardings(cache, B))
        gen = None
        if sc.temperature > 0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(sc.seed))
        prompt = torch.from_numpy(np.asarray(prompts, np.int64)).to(
            self.device)
        tracer = self.pt.tracer if self.pt else None
        new = []
        nxt = None
        # prefill token-by-token (tiny configs; production path would use
        # the chunked prefill_step)
        for t in range(P + n_new - 1):
            cur = prompt[:, t:t + 1] if t < P else nxt[:, None]
            batch = {"tokens": cur}
            if tracer:
                # the fence waits for the card at the span's end (the
                # cache's device; nothing to wait for on the CPU)
                with tracer.phase("decode.step", Kind.GPU, depth=1,
                                  fence=cache):
                    logits, cache = self._step(self.params, cache, batch, t)
            else:
                logits, cache = self._step(self.params, cache, batch, t)
            lg = logits[:, 0, :self.cfg.vocab_size]
            if sc.temperature > 0:
                probs = torch.softmax(lg.float() / sc.temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                nxt = torch.argmax(lg, dim=-1)
            if self.dist is not None and hasattr(nxt, "full_tensor"):
                nxt = nxt.full_tensor()     # every rank holds the tokens
            if t >= P - 1:
                new.append(nxt)
        out = np.asarray(prompts, np.int32)
        if new:
            out = np.concatenate(
                [out, torch.stack(new, 1).cpu().numpy().astype(np.int32)],
                axis=1)
        return out
