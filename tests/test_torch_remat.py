"""Remat, gradient accumulation, balanced causal folding and the tracer's
profiles, each against the JAX reference on the CPU.

* ``Transformer(remat="full"|"dots")`` on reduced gemma2-2b (local/global
  pairs) and zamba2-7b (groups of mamba2 layers and the shared attention
  block): loss within 1e-5 relative and every gradient within 1e-4 of its
  largest entry, against the port's ``remat="none"`` and against the
  reference with the same setting; the backward reruns the attention and
  SSD forwards of every recomputed body (without remat it reruns none),
  and its matrix products (``aten.mm``) under ``"full"`` but not under
  ``"dots"``, which saves them.
* ``make_train_step(accum_steps=2)``: metrics within 1e-5 relative, the
  first moments (the clipped, accumulated gradients) within 1e-4, and the
  parameters after the step within 1e-5 of the reference's.
* ``blocked_attention`` with ``AttnSpec(folded=True)``, which the port runs
  unfolded: where the reference folds (causal, no window, an even number of
  q blocks) the output and lse within 2e-5 and the gradients within 1e-4 of
  the reference's folded call, and the same outside its fold conditions.
* A ``WorkerProfile`` recorded by the port's ``Tracer`` over real trainer
  iterations gives the same patterns through the reference's
  ``summarize_profile`` as through the port's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.registry import ARCHS as R_ARCHS
from repro.configs.registry import reduced as r_reduced
from repro.core import events as RE
from repro.models import attention_core as RC
from repro.models.transformer import Transformer as RTransformer
from repro.optim.adamw import AdamW as RAdamW
from repro.optim.adamw import OptConfig as ROptConfig
from repro.summarize.engine import summarize_profile as r_summarize_profile
from repro.train.step import make_train_step as r_make_train_step

from repro_torch.configs.registry import ARCHS, reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.instrument.tracer import Tracer
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import attention_core as C
from repro_torch.models.convert import params_from_reference, params_to_numpy
from repro_torch.models.transformer import (Transformer, param_leaves,
                                            unflatten_like)
from repro_torch.optim.adamw import AdamW, OptConfig
from repro_torch.summarize.engine import summarize_profile
from repro_torch.train.loop import Trainer
from repro_torch.train.step import make_train_step
from repro_torch.train.workload import tiny_train_setup

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401

SEQ = 96


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _pair(arch, remat="none", seed=0):
    rcfg, cfg = r_reduced(R_ARCHS[arch]), reduced(ARCHS[arch])
    rmodel = RTransformer(rcfg, remat=remat)
    rparams = rmodel.init(jax.random.PRNGKey(seed))
    params = params_from_reference(_np_tree(rparams), cfg, device="cpu")
    return cfg, rmodel, rparams, params


def _batch(cfg, batch=2, seq=SEQ, seed=3):
    return SyntheticLM(cfg, DataConfig(batch=batch, seq_len=seq,
                                       seed=seed)).batch_at(0)


class _Count:
    """Counts the calls of a callable it stands in for."""

    def __init__(self, fn):
        self.fn, self.n = fn, 0

    def __call__(self, *args, **kwargs):
        self.n += 1
        return self.fn(*args, **kwargs)


class _CountMM(TorchDispatchMode):
    """Counts the ``aten.mm`` calls dispatched while it is entered."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def _port_loss_and_grads(model, params, b, monkeypatch):
    """Loss, gradients, the attention / SSD forward calls made by the
    forward and by the backward, and the backward's ``aten.mm`` calls."""
    attn = _Count(C.flash_attention)
    ssd = _Count(ssd_scan.run)
    monkeypatch.setattr(C, "flash_attention", attn)
    monkeypatch.setattr(ssd_scan, "run", ssd)
    leaves = [t for _, t in param_leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, _ = model.loss(params, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        fwd = (attn.n, ssd.n)
        with _CountMM() as mm:
            grads = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    bwd = (attn.n - fwd[0], ssd.n - fwd[1])
    return loss.item(), unflatten_like(params, list(grads)), fwd, bwd, mm.n


def _assert_grads_close(cfg, grads, rgrads):
    flat_p = jax.tree_util.tree_leaves_with_path(params_to_numpy(grads, cfg))
    flat_r = jax.tree_util.tree_leaves(_np_tree(rgrads))
    assert len(flat_p) == len(flat_r)
    for (path, g), r in zip(flat_p, flat_r):
        assert _rel(g, r) < 1e-4, (jax.tree_util.keystr(path), _rel(g, r))


# -- remat ------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma2-2b", "zamba2-7b"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_matches_none_and_the_reference(arch, remat, monkeypatch):
    cfg, rmodel, rparams, params = _pair(arch, remat)
    b = _batch(cfg)
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(
        rmodel.loss, has_aux=True))(rparams, {k: jnp.asarray(v)
                                              for k, v in b.items()})
    loss0, grads0, fwd0, bwd0, mm0 = _port_loss_and_grads(
        Transformer(cfg), params, b, monkeypatch)
    loss, grads, fwd, bwd, mm = _port_loss_and_grads(
        Transformer(cfg, remat=remat), params, b, monkeypatch)
    assert abs(loss - float(rloss)) <= 1e-5 * abs(float(rloss))
    assert abs(loss - loss0) <= 1e-5 * abs(loss0)
    _assert_grads_close(cfg, grads, rgrads)
    for (_, g), (_, g0) in zip(param_leaves(grads), param_leaves(grads0)):
        assert _rel(g.numpy(), g0.numpy()) < 1e-4
    # every attention / SSD forward runs again in the backward under remat
    n_attn = len(Transformer(cfg).layer_specs())
    n_ssd = cfg.num_layers if cfg.family == "hybrid" else 0
    assert fwd0 == fwd == (n_attn, n_ssd)
    assert bwd0 == (0, 0)
    assert bwd == (n_attn, n_ssd)
    # "full" recomputes the bodies' matrix products, "dots" keeps them
    assert mm == mm0 if remat == "dots" else mm > mm0


def test_remat_rejects_unknown_policies():
    with pytest.raises(ValueError, match="remat"):
        Transformer(reduced(ARCHS["gemma2-2b"]), remat="offload")


# -- gradient accumulation --------------------------------------------------------

def test_accumulated_step_matches_the_reference():
    """One fused step over a batch of 4 in 2 micro-batches of 2."""
    arch = "gemma2-2b"
    cfg, rmodel, rparams, params = _pair(arch, seed=2)
    b = _batch(cfg, batch=4, seed=5)
    ropt = RAdamW(ROptConfig())
    rstep = jax.jit(r_make_train_step(rmodel, ropt, accum_steps=2))
    rnew, rstate, rm = rstep(rparams, ropt.init(rparams),
                             {k: jnp.asarray(v) for k, v in b.items()})
    opt = AdamW(OptConfig())
    step = make_train_step(Transformer(cfg), opt, accum_steps=2)
    new, state, m = step(params, opt.init(params),
                         {k: torch.from_numpy(v) for k, v in b.items()})
    for key in ("loss", "nll", "grad_norm"):
        assert abs(float(m[key]) - float(rm[key])) \
            <= 1e-5 * abs(float(rm[key])), key
    assert float(m["ntok"]) == float(rm["ntok"]) == b["labels"].size / 2
    _assert_grads_close(cfg, state["m"], rstate["m"])
    port = jax.tree_util.tree_leaves(params_to_numpy(new, cfg))
    ref = jax.tree_util.tree_leaves(_np_tree(rnew))
    scale = max(float(np.abs(r).max()) for r in ref)
    assert max(float(np.abs(p - r).max()) for p, r in zip(port, ref)) \
        <= 1e-5 * scale
    # the two micro-batches' mean is not the first micro-batch's alone
    one = make_train_step(Transformer(cfg), opt, accum_steps=1)
    first = {k: torch.from_numpy(v[:2]) for k, v in b.items()}
    _, _, m1 = one(params_from_reference(_np_tree(rparams), cfg,
                                         device="cpu"),
                   opt.init(params), first)
    assert abs(float(m1["loss"]) - float(m["loss"])) > 1e-4


def test_accumulation_needs_a_batch_that_splits():
    cfg, _, _, params = _pair("gemma2-2b")
    opt = AdamW(OptConfig())
    step = make_train_step(Transformer(cfg), opt, accum_steps=2)
    b = _batch(cfg, batch=3)
    with pytest.raises(ValueError, match="micro-batches"):
        step(params, opt.init(params), {k: torch.from_numpy(v)
                                        for k, v in b.items()})


# -- balanced causal folding ------------------------------------------------------

def _qkv(seed, B, S, H, KV, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D), np.float32),
            rng.standard_normal((B, S, KV, D), np.float32),
            rng.standard_normal((B, S, KV, D), np.float32))


FOLDED = [pytest.param(dict(), id="causal"),
          pytest.param(dict(softcap=20.0), id="softcap")]


def _folded_vs_reference(q, k, v, kw, block, kv_len=None):
    """The port's ``blocked_attention`` under ``folded=True`` against the
    reference's folded call: max |out difference| and the gradients'
    relative differences."""
    dout = np.random.default_rng(9).standard_normal(q.shape, np.float32)
    rspec = RC.AttnSpec(folded=True, **block, **kw)
    spec = C.AttnSpec(folded=True, **block, **kw)

    def rloss(a, b, c):
        return jnp.sum(RC.blocked_attention(a, b, c, rspec, kv_len=kv_len)
                       * jnp.asarray(dout))
    r_out = RC.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), rspec, kv_len=kv_len)
    rg = jax.grad(rloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = C.blocked_attention(*ts, spec, kv_len=kv_len)
    grads = torch.autograd.grad((out * torch.from_numpy(dout)).sum(), ts)
    err = float(np.abs(out.detach().numpy() - np.asarray(r_out)).max())
    return err, [_rel(g.numpy(), np.asarray(r)) for g, r in zip(grads, rg)]


FOLDED = [pytest.param(dict(), id="causal"),
          pytest.param(dict(softcap=20.0), id="softcap")]


@pytest.mark.parametrize("kw", FOLDED)
def test_folded_forward_lse_and_gradients_match_reference(kw):
    """Where the reference folds (causal, no window, NQ = 4 even)."""
    q, k, v = _qkv(8, 2, 128, 4, 2, 32)
    rspec = RC.AttnSpec(q_block=32, kv_block=32, folded=True, **kw)
    r_out, r_lse = RC._forward(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), rspec, 0, None)
    out, lse = C.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal=True, return_lse=True, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(r_lse).reshape(2, 128, 4), rtol=0,
                               atol=2e-5)
    err, rels = _folded_vs_reference(q, k, v, kw,
                                     dict(q_block=32, kv_block=32))
    assert err <= 2e-5
    for name, rel in zip("qkv", rels):
        assert rel < 1e-4, name


UNFOLDED = [
    pytest.param(dict(window=40), 128, dict(q_block=32, kv_block=32), None,
                 id="window"),
    pytest.param(dict(causal=False), 128, dict(q_block=32, kv_block=32),
                 None, id="not-causal"),
    pytest.param(dict(), 128, dict(q_block=32, kv_block=32), 100,
                 id="kv_len"),
    pytest.param(dict(), 96, dict(q_block=32, kv_block=32), None,
                 id="odd-NQ"),
    pytest.param(dict(), 128, dict(q_block=32, kv_block=64), None,
                 id="unequal-blocks"),
]


@pytest.mark.parametrize("kw,S,block,kv_len", UNFOLDED)
def test_folded_spec_outside_the_fold_matches_reference(kw, S, block,
                                                        kv_len):
    """``folded=True`` where the reference's conditions do not hold (it
    runs unfolded too): out within 2e-5, gradients within 1e-4."""
    q, k, v = _qkv(10, 2, S, 4, 2, 32)
    err, rels = _folded_vs_reference(q, k, v, kw, block, kv_len)
    assert err <= 2e-5
    for name, rel in zip("qkv", rels):
        assert rel < 1e-4, name


def test_folded_model_loss_matches_reference():
    """The forward's attention specs carry ``folded`` (decode's do not);
    on gemma2's global layers with 32-token blocks the fold engages."""
    arch = "gemma2-2b"
    rcfg, cfg = r_reduced(R_ARCHS[arch]), reduced(ARCHS[arch])
    rmodel = RTransformer(rcfg, folded=True)
    rparams = rmodel.init(jax.random.PRNGKey(1))
    params = params_from_reference(_np_tree(rparams), cfg, device="cpu")
    model = Transformer(cfg, folded=True)
    assert [s.folded for s in model.layer_specs(model.folded)] == \
        [True] * cfg.num_layers
    assert not any(s.folded for s in model.layer_specs())
    b = _batch(cfg, seq=128)
    rloss, _ = rmodel.loss(rparams, {k: jnp.asarray(v) for k, v in b.items()})
    with torch.no_grad():
        loss, _ = model.loss(params, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
    assert abs(loss.item() - float(rloss)) <= 1e-5 * abs(float(rloss))


# -- the tracer's profiles through both packages' summarize ----------------------

def _to_reference(profile):
    return RE.WorkerProfile(
        worker=profile.worker, window=tuple(profile.window),
        events=[RE.FunctionEvent(e.name, RE.Kind(int(e.kind)), e.start, e.end,
                                 e.worker, e.thread, e.depth, e.resource)
                for e in profile.events],
        streams={r: RE.SampleStream(s.rate_hz, s.t0, np.asarray(s.values))
                 for r, s in profile.streams.items()})


def test_tracer_profile_summarizes_alike_in_both_packages():
    """Six real CPU trainer iterations recorded by the port's ``Tracer``
    (its ``cpu`` sampler at 1 kHz, the step phases on the cpu stream):
    every function's (beta, mu, sigma) and kind through the reference's
    ``summarize_profile`` equal the port's within 1e-6."""
    mc, dc, oc, tc = tiny_train_setup()
    tr = Trainer(mc, dc, oc, tc, device="cpu")
    params, opt_state, _ = tr.init_state()
    tracer = Tracer(worker=3, rate_hz=1000.0)
    tracer.start_window()
    for _ in range(6):
        params, opt_state, _ = tr.train_iteration(params, opt_state,
                                                  tracer=tracer)
    profile = tracer.stop_window()
    tr.loader.close()
    names = {e.name for e in profile.events}
    assert {"dataloader.next", "train.step", "optimizer.step"} <= names
    assert profile.streams["cpu"].values.size > 0
    pats, kinds = summarize_profile(profile, backend="numpy")
    rpats, rkinds = r_summarize_profile(_to_reference(profile),
                                        backend="numpy")
    assert set(pats) == set(rpats) == names
    assert {n: int(k) for n, k in kinds.items()} == \
        {n: int(k) for n, k in rkinds.items()}
    for name in names:
        got = np.array([pats[name].beta, pats[name].mu, pats[name].sigma])
        want = np.array([rpats[name].beta, rpats[name].mu,
                         rpats[name].sigma])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=name)
    assert any(pats[n].mu > 0 for n in names)
