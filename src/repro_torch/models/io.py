"""Model input construction (port of the reference's
``repro/models/io.py``): logical input shapes of a cell, meta-device
stand-ins for every input (no allocation), and synthetic concrete batches
for tests and examples.

Modality frontends (vlm/audio) are stubs, as in the reference: the inputs
carry precomputed patch/frame embeddings.  Tokens and labels are int32, as
the reference's; embeddings take the config's activation dtype.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.service import resolve_device
from repro_torch.models.layers import dtype_of


def batch_shapes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, tuple]:
    """Logical (global) input shapes for a cell."""
    B, S = shape.global_batch, shape.seq_len
    out: Dict[str, tuple] = {}
    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "audio":
            out["embeds"] = (B, S, cfg.d_model)
        elif cfg.frontend == "vision":
            F = cfg.frontend_tokens
            out["embeds"] = (B, F, cfg.d_model)
            out["tokens"] = (B, S - F)
        else:
            out["tokens"] = (B, S)
        if shape.kind == "train":
            out["labels"] = (B, S)
    else:  # decode: one new token against a cache of size S
        if cfg.frontend == "audio":
            out["embeds"] = (B, 1, cfg.d_model)
        else:
            out["tokens"] = (B, 1)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """Meta-device tensors standing in for every model input: the shapes
    and dtypes of ``batch_shapes``, with no storage."""
    dt = dtype_of(cfg.dtype)
    return {name: torch.empty(shp, device="meta",
                              dtype=torch.int32 if name in ("tokens",
                                                            "labels")
                              else dt)
            for name, shp in batch_shapes(cfg, shape).items()}


def synth_batch(cfg: ModelConfig, kind: str, batch: int, seq: int,
                seed: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """Concrete synthetic batch for smoke tests and examples, drawn from
    ``np.random.default_rng(seed)`` in the reference's order, so the arrays
    are the reference's; on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    dt = dtype_of(cfg.dtype)

    def emb(shape):
        return torch.from_numpy(rng.normal(size=shape)).to(device, dt)

    def ids(shape):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)
                                .astype(np.int32)).to(device)

    out: Dict[str, torch.Tensor] = {}
    if kind in ("train", "prefill"):
        if cfg.frontend == "audio":
            out["embeds"] = emb((batch, seq, cfg.d_model))
        elif cfg.frontend == "vision":
            F = min(cfg.frontend_tokens, seq - 1)
            out["embeds"] = emb((batch, F, cfg.d_model))
            out["tokens"] = ids((batch, seq - F))
        else:
            out["tokens"] = ids((batch, seq))
        if kind == "train":
            out["labels"] = ids((batch, seq))
    else:
        if cfg.frontend == "audio":
            out["embeds"] = emb((batch, 1, cfg.d_model))
        else:
            out["tokens"] = ids((batch, 1))
    return out
