"""Train / prefill / serve step builders (port of the reference's
``repro/train/step.py``).  PyTorch runs eagerly, so a step is a plain
function: nothing is traced or compiled.

Parameters are leaf tensors; ``grad_step`` differentiates the loss with
``torch.autograd.grad`` and returns the gradients as a tree shaped like the
parameters.  The optimizer updates in place (``optim/adamw.py``).
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import (Transformer, map_params,
                                            param_leaves, unflatten_like)
from repro_torch.optim.adamw import AdamW


def _grad_fn(model: Transformer):
    def grad_step(params, batch):
        leaves = [t for _, t in param_leaves(params)]
        for t in leaves:
            t.requires_grad_(True)
        try:
            with model.replicating():       # the backward meets them too
                loss, metrics = model.loss(params, batch)
                grads = torch.autograd.grad(loss, leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return unflatten_like(params, list(grads)), metrics
    return grad_step


def make_split_train_step(model: Transformer, opt: AdamW):
    """The step in two halves, ``grad_step(params, batch) -> (grads,
    metrics)`` and ``opt_step(grads, opt_state, params) -> (params,
    opt_state, opt_metrics)``, so an instrumented loop can fence between
    the forward+backward and the optimizer update (``train.step`` vs
    ``optimizer.step`` phases)."""
    def opt_step(grads, opt_state, params):
        return opt.update(grads, opt_state, params)
    return _grad_fn(model), opt_step


def _accumulate(grad_step, params, batch, accum_steps: int):
    """Gradient accumulation, as the reference's scan over micro-batches:
    the batch is split on its leading axis into ``accum_steps`` equal
    micro-batches, their gradients summed in fp32 and divided by
    ``accum_steps``, and each metric (``loss`` included) averaged."""
    n = next(iter(batch.values())).shape[0]
    if n % accum_steps:
        raise ValueError(f"batch {n} does not split into {accum_steps} "
                         f"micro-batches")
    gsum, ms = None, []
    for part in zip(*(v.chunk(accum_steps, dim=0) for v in batch.values())):
        grads, m = grad_step(params, dict(zip(batch, part)))
        if gsum is None:
            gsum = map_params(lambda g: g.float(), grads)
        else:
            for (_, acc), (_, g) in zip(param_leaves(gsum),
                                        param_leaves(grads)):
                acc.add_(g.float())
        ms.append(m)
    grads = map_params(lambda g: g / accum_steps, gsum)
    metrics = {k: torch.stack([m[k].float() for m in ms]).mean()
               for k in ms[0]}
    return grads, metrics


def make_train_step(model: Transformer, opt: AdamW, accum_steps: int = 1):
    """The fused step ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``.  ``accum_steps > 1`` accumulates the gradients
    of that many micro-batches (``_accumulate``): activation memory
    follows the micro-batch."""
    grad_step = _grad_fn(model)

    def train_step(params, opt_state, batch):
        if accum_steps == 1:
            grads, metrics = grad_step(params, batch)
        else:
            grads, metrics = _accumulate(grad_step, params, batch,
                                         accum_steps)
        params, opt_state, opt_metrics = opt.update(grads, opt_state, params)
        metrics.update(opt_metrics)
        return params, opt_state, metrics
    return train_step


def make_prefill_step(model: Transformer):
    @torch.no_grad()
    def prefill_step(params, batch):
        hidden, _, cache = model.forward(params, batch, collect_cache=True)
        return model.logits(params, hidden[:, -1:, :]), cache
    return prefill_step


def make_serve_step(model: Transformer):
    @torch.no_grad()
    def serve_step(params, cache, batch, pos):
        return model.decode_step(params, cache, batch, pos)
    return serve_step
