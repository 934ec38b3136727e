"""AdamW (port of the reference's ``repro/optim/adamw.py``): fp32 master
weights and moments, global-norm clipping, name-based weight-decay masking,
warmup + cosine schedule.

State mirrors the parameter tree (``m``, ``v``, ``master`` as nested
dicts/lists of fp32 tensors, plus ``step``).  Unlike the reference, whose
arrays are immutable, ``update`` works IN PLACE: it overwrites ``m``, ``v``
and ``master`` and copies the new master weights into the parameter tensors
it was given, and returns those same objects.  On the full-size model this
saves a second copy of 16 bytes of state per parameter.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.transformer import map_params, param_leaves

NO_DECAY_TOKENS = ("norm", "scale", "bias", "ln", "A_log", "dt_bias",
                   "/D", "bi", "bo", "bq", "bk", "bv")


@dataclass(frozen=True)
class OptConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_schedule(c: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """fp32 learning rate at ``step`` (a tensor), as the reference computes
    it."""
    step = step.float()
    warm = step / max(1.0, c.warmup_steps)
    prog = (step - c.warmup_steps) / max(1.0, c.total_steps - c.warmup_steps)
    prog = prog.clamp(0.0, 1.0)
    cos = c.min_lr_ratio + (1 - c.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return c.lr_peak * torch.where(step < c.warmup_steps, warm, cos)


def decays(path: str) -> bool:
    """Whether the leaf at ``path`` (keys joined by ``/``) takes weight
    decay.  Layer indices in the path (this port's per-layer lists) are
    digits and match no token, so the mask equals the reference's."""
    return not any(t in path for t in NO_DECAY_TOKENS)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(t.float().square().sum()
                          for _, t in param_leaves(tree)))


class AdamW:
    def __init__(self, cfg: OptConfig):
        self.cfg = cfg

    def init(self, params) -> Dict[str, Any]:
        """Zero moments and fp32 master weights shaped, and placed, like
        ``params`` (a DTensor leaf gives DTensor state on its placements:
        ZeRO-sharded with the parameters)."""
        f32 = lambda t: torch.zeros_like(t, dtype=torch.float32)  # noqa: E731
        first = next(param_leaves(params))[1]
        return {"m": map_params(f32, params), "v": map_params(f32, params),
                "master": map_params(lambda t: t.detach().float().clone(),
                                     params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=first.device)}

    def state_shardings(self, param_shardings, replicated):
        """Placements of the optimizer state given the parameters':
        ``replicated`` for the step counter."""
        return {"m": param_shardings, "v": param_shardings,
                "master": param_shardings, "step": replicated}

    @torch.no_grad()
    def update(self, grads, state, params) -> Tuple[Any, Dict[str, Any],
                                                    Dict[str, torch.Tensor]]:
        """One step, in place (module docstring).  Returns
        ``(params, state, {"lr", "grad_norm"})``."""
        c = self.cfg
        step = state["step"] + 1
        lr = lr_schedule(c, step)
        gnorm = global_norm(grads)
        if c.clip_norm:
            scale = torch.clamp(c.clip_norm / gnorm.clamp(min=1e-12), max=1.0)
        else:
            scale = torch.ones((), device=gnorm.device)
        b1c = 1 - c.b1 ** step.float()
        b2c = 1 - c.b2 ** step.float()
        for (path, g), (_, m), (_, v), (_, w), (_, p) in zip(
                param_leaves(grads), param_leaves(state["m"]),
                param_leaves(state["v"]), param_leaves(state["master"]),
                param_leaves(params)):
            g = g.float() * scale
            m.mul_(c.b1).add_((1 - c.b1) * g)
            v.mul_(c.b2).add_((1 - c.b2) * g.square())
            delta = (m / b1c) / (torch.sqrt(v / b2c) + c.eps)
            if decays(path):
                delta += c.weight_decay * w
            w.sub_(lr * delta)
            p.copy_(w)
        state["step"] = step
        return params, state, {"lr": lr, "grad_norm": gnorm}
