"""The port's ``hybrid`` family (zamba2) against the JAX reference, on the
CPU.

Reduced zamba2-7b (``reduced``: 4 mamba2 layers in 2 groups of
``shared_attn_every`` 2, d_model 64, f32, window 64) and a 5-layer variant
whose last layer is a tail that the shared attention block does not follow.
The reference's own ``init`` makes the parameters (``groups (ngroups, k,
...)``, ``tail``, one ``shared_attn`` block) and ``params_from_reference``
carries them across into the port's layout (``blocks``: every mamba layer
in order; ``shared_attn``); tokens come from a numpy seed.

Tolerances: the final hidden state within 2e-5 of its largest entry and
no further from a float64 forward than the reference's, the loss within
1e-5 relative, every gradient leaf (``shared_attn``'s, summed
over its applications, among them) within 1e-4 of its largest entry,
decode logits within 1e-5 of max(1, the largest logit) (also past a window
of 8, where the attention caches are rings), three ``train_iteration``
losses and grad norms within 1e-5 relative, greedy tokens equal.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import Checkpointer as RCheckpointer
from repro.configs.registry import ARCHS as R_ARCHS
from repro.configs.registry import reduced as r_reduced
from repro.models.transformer import Transformer as RTransformer
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.train.loop import Trainer as RTrainer
from repro.train.workload import tiny_train_setup as r_tiny_train_setup

from repro_torch.ckpt import Checkpointer
from repro_torch.configs.registry import ARCHS, reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_reference, params_to_numpy
from repro_torch.models.transformer import (Transformer, hybrid_layout,
                                            map_params, param_leaves,
                                            unflatten_like)
from repro_torch.optim.adamw import decays
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train.loop import Trainer
from repro_torch.train.workload import tiny_train_setup

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401

ARCH = "zamba2-7b"
SEQ = 96           # > the reduced window of 64, so the window masks
#: the reduced config (2 groups of 2) and one with a tail of 1 layer
LAYERS = [4, 5]
#: the leaves ``param_counts`` leaves out: norm scales, biases, dt_bias
UNCOUNTED = ("scale", "gate_norm", "dt_bias", "_b")


def _cfgs(layers=4, **kw):
    rcfg = r_reduced(R_ARCHS[ARCH]).with_overrides(num_layers=layers, **kw)
    cfg = reduced(ARCHS[ARCH]).with_overrides(num_layers=layers, **kw)
    return rcfg, cfg


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(layers=4, seed=0, **kw):
    rcfg, cfg = _cfgs(layers, **kw)
    rmodel = RTransformer(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(seed))
    params = params_from_reference(_np_tree(rparams), cfg, device="cpu")
    return rcfg, cfg, rmodel, rparams, Transformer(cfg), params


def _batch(cfg, batch=2, seq=SEQ, seed=3):
    return SyntheticLM(cfg, DataConfig(batch=batch, seq_len=seq,
                                       seed=seed)).batch_at(0)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# -- layout, counts, converter ---------------------------------------------------

@pytest.mark.parametrize("layers", LAYERS)
def test_hybrid_builds_in_the_reference_layout(layers):
    """The port's own init has the converted reference's names, shapes and
    dtypes, one mamba layer a block and one shared block; the leaves that
    ``param_counts`` counts number its total, and all of them the
    reference's."""
    rcfg, cfg, _, rparams, model, params = _pair(layers)
    own = model.init(seed=1, device="cpu")
    assert [(p, tuple(t.shape), t.dtype) for p, t in param_leaves(own)] == \
        [(p, tuple(t.shape), t.dtype) for p, t in param_leaves(params)]
    assert len(own["blocks"]) == layers
    assert all(set(b) == {"ln", "mamba"} for b in own["blocks"])
    assert set(own["shared_attn"]) == {"ln1", "ln2", "attn", "mlp"}
    assert hybrid_layout(cfg) == divmod(layers, 2)
    leaves = list(param_leaves(own))
    counted = sum(t.numel() for path, t in leaves
                  if not path.endswith(UNCOUNTED))
    assert counted == cfg.param_counts()["total"]
    assert sum(t.numel() for _, t in leaves) == sum(
        a.size for a in jax.tree_util.tree_leaves(_np_tree(rparams)))
    assert [s.window for s in model.layer_specs()] == \
        [cfg.sliding_window] * (layers // 2)


def test_published_zamba2_counts():
    """zamba2-7b at its published widths: 6 672 161 504 parameters by
    ``param_counts`` (81 mamba2 layers, one shared block applied 13
    times); the 15-layer cut that the card trains, 1 496 496 416 (2 groups
    of 6 and a tail of 3)."""
    cfg = ARCHS[ARCH]
    assert hybrid_layout(cfg) == (13, 3)
    assert cfg.param_counts()["total"] == 6_672_161_504
    cut = cfg.with_overrides(num_layers=15)
    assert hybrid_layout(cut) == (2, 3)
    assert cut.param_counts()["total"] == 1_496_496_416
    assert Transformer(cfg).layer_specs()[0].window == 4096
    assert len(Transformer(cfg).layer_specs()) == 13


@pytest.mark.parametrize("layers", LAYERS)
def test_converter_round_trip_and_layout(layers):
    _, cfg, _, rparams, _, params = _pair(layers)
    tree = _np_tree(rparams)
    back = params_to_numpy(params, cfg)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
    # group g, layer j is block 2g + j; the tail follows
    np.testing.assert_array_equal(params["blocks"][3]["mamba"]["w_x"].numpy(),
                                  tree["groups"]["mamba"]["w_x"][1, 1])
    if layers == 5:
        np.testing.assert_array_equal(
            params["blocks"][4]["mamba"]["A_log"].numpy(),
            tree["tail"]["mamba"]["A_log"][0])
    np.testing.assert_array_equal(params["shared_attn"]["attn"]["wq"].numpy(),
                                  tree["shared_attn"]["attn"]["wq"])


def test_bf16_leaves_carry_bit_for_bit_and_mamba_scalars_stay_f32():
    kw = dict(param_dtype="bfloat16", dtype="bfloat16")
    rcfg, cfg = _cfgs(5, **kw)
    tree = _np_tree(RTransformer(rcfg).init(jax.random.PRNGKey(2)))
    params = params_from_reference(tree, cfg, device="cpu")
    for path, t in param_leaves(params):
        name = path.split("/")[-1]
        want = torch.float32 if name in ("A_log", "D", "dt_bias") \
            else torch.bfloat16
        assert t.dtype == want, path
    np.testing.assert_array_equal(
        params["shared_attn"]["mlp"]["wi"].float().numpy(),
        tree["shared_attn"]["mlp"]["wi"].astype(np.float32))
    back = params_to_numpy(params, cfg)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(a, b.astype(np.float32)),
        back, tree)


def test_decay_mask_matches_reference_paths():
    """AdamW's decay mask on the port's paths (``blocks/i/...``,
    ``shared_attn/...``) equals the reference's on its own (``groups``,
    ``tail``, ``shared_attn``) leaf for leaf."""
    from repro.optim.adamw import _decay_mask
    _, cfg, _, rparams, _, params = _pair(5)
    want = _decay_mask(rparams)
    port = params_to_numpy(unflatten_like(
        params, [torch.tensor(decays(p)) for p, _ in param_leaves(params)]),
        cfg)
    flat_p = jax.tree_util.tree_leaves(port)
    flat_r = jax.tree_util.tree_leaves(want)
    assert len(flat_p) == len(flat_r)
    for a, b in zip(flat_p, flat_r):
        assert bool(np.all(a)) == bool(b) and bool(np.any(a)) == bool(b)


# -- forward, loss, gradients -----------------------------------------------------

def test_forward_hidden_state_matches_reference(monkeypatch):
    """The final hidden state, and each application's K/V.  At these widths
    the shared block's SwiGLU output is ~70 against a residual of ~5, so
    f32 rounding alone puts each package 1.3e-5 to 1.4e-5 (of the largest
    entry) from the same forward in float64: the port is held within 2e-5
    of the reference and no further from the float64 forward than the
    reference is (x 1.25)."""
    _, cfg, rmodel, rparams, model, params = _pair(5, seed=4)
    b = _batch(cfg)
    rh, _, rcache = rmodel.forward(rparams, {"tokens": jnp.asarray(
        b["tokens"])}, collect_cache=True)
    tokens = {"tokens": torch.from_numpy(b["tokens"])}
    with torch.no_grad():
        h, stats, kvs = model.forward(params, tokens, collect_cache=True)
        monkeypatch.setitem(L.DTYPES, "float64", torch.float64)
        c64 = cfg.with_overrides(dtype="float64", param_dtype="float64")
        h64 = Transformer(c64).forward(
            map_params(lambda t: t.double(), params), tokens)[0].numpy()
    assert stats is None
    rh = np.asarray(rh)
    assert _rel(h.numpy(), rh) < 2e-5
    assert _rel(h.numpy(), h64) <= 1.25 * _rel(rh, h64)
    assert len(kvs) == 2                        # one per application
    rk = np.asarray(rcache["kv"][0])            # (ngroups, B, S, KV, D)
    np.testing.assert_allclose(kvs[1][0].numpy(), rk[1], rtol=0,
                               atol=1e-5 * np.abs(rk).max())


@pytest.mark.parametrize("layers", LAYERS)
def test_loss_and_every_gradient_match_reference(layers):
    _, cfg, rmodel, rparams, model, params = _pair(layers)
    b = _batch(cfg)
    (rloss, _), rgrads = jax.value_and_grad(rmodel.loss, has_aux=True)(
        rparams, {k: jnp.asarray(v) for k, v in b.items()})
    leaves = [t for _, t in param_leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = model.loss(params, {k: torch.from_numpy(v)
                                  for k, v in b.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(rloss)) <= 1e-5 * abs(float(rloss))
    port = params_to_numpy(unflatten_like(params, list(grads)), cfg)
    flat_p = jax.tree_util.tree_leaves_with_path(port)
    flat_r = jax.tree_util.tree_leaves(_np_tree(rgrads))
    assert len(flat_p) == len(flat_r)
    for (path, g), r in zip(flat_p, flat_r):
        assert _rel(g, r) < 1e-4, (jax.tree_util.keystr(path), _rel(g, r))
    assert np.abs(port["shared_attn"]["attn"]["wq"]).max() > 0


# -- decode -----------------------------------------------------------------------

def _decode_both(rmodel, rparams, model, params, cfg, steps, max_len):
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, steps)).astype(np.int32)
    rcache = rmodel.init_cache(2, max_len)
    cache = model.init_cache(2, max_len, device="cpu")
    step = jax.jit(rmodel.decode_step)
    for pos in range(steps):
        rlog, rcache = step(rparams, rcache,
                            {"tokens": jnp.asarray(toks[:, pos:pos + 1])},
                            jnp.int32(pos))
        with torch.no_grad():
            log, cache = model.decode_step(
                params, cache, {"tokens": torch.from_numpy(
                    toks[:, pos:pos + 1])}, pos)
        rlog = np.asarray(rlog)
        err = np.abs(log.numpy() - rlog).max()
        assert err <= 1e-5 * max(1.0, np.abs(rlog).max()), (pos, err)
    return cache, rcache


def test_decode_logits_match_reference():
    """16 tokens one at a time through the 5-layer model: the per-layer SSM
    caches and the per-application K/V caches carry as the reference's
    stacked ones do."""
    _, cfg, rmodel, rparams, model, params = _pair(5, seed=1)
    cache, rcache = _decode_both(rmodel, rparams, model, params, cfg, 16, 24)
    nl = cfg.num_layers
    assert len(cache) == nl + 2
    assert set(cache[0]) == {"conv_x", "conv_B", "conv_C", "state"}
    assert cache[nl]["k"].shape == (2, 24, cfg.num_kv_heads, cfg.head_dim)
    np.testing.assert_allclose(
        cache[nl + 1]["v"].numpy(), np.asarray(rcache["attn"]["v"][1]),
        rtol=0, atol=1e-5 * np.abs(np.asarray(rcache["attn"]["v"])).max())
    np.testing.assert_allclose(
        cache[4]["state"].numpy(), np.asarray(rcache["ssm_tail"]["state"][0]),
        rtol=0, atol=1e-5 * np.abs(np.asarray(rcache["ssm_tail"]
                                              ["state"])).max())


def test_ring_decode_past_the_window_matches_reference():
    """A window of 8 and 24 tokens: both packages allocate window-sized
    attention caches and write them as rings."""
    _, cfg, rmodel, rparams, model, params = _pair(4, seed=5,
                                                   sliding_window=8)
    assert model.kv_len(24) == rmodel.kv_len(24) == 8
    cache, _ = _decode_both(rmodel, rparams, model, params, cfg, 24, 24)
    assert model._ring_for(cache)
    assert cache[cfg.num_layers]["k"].shape[1] == 8


# -- trainer, engine, checkpoint --------------------------------------------------

def test_train_iterations_match_reference_losses():
    """Three ``train_iteration`` steps of each package on the same batches;
    before each of the port's steps its parameters are set to the
    reference's, so every loss and grad norm is compared on the same
    weights (as tests/test_torch_moe.py does: run free, AdamW's sign-like
    first update parts the trajectories on rounding-noise gradients)."""
    rcfg, cfg = _cfgs()
    _, rdc, roc, rtc = r_tiny_train_setup()
    rtr = RTrainer(rcfg, rdc, roc, rtc)
    rparams, ropt, _ = rtr.init_state()
    _, dc, oc, tc = tiny_train_setup()
    tr = Trainer(cfg, dc, oc, replace(tc, perftracker=False), device="cpu")
    opt_state = None
    for _ in range(3):
        params = params_from_reference(_np_tree(rparams), cfg, device="cpu")
        opt_state = opt_state or tr.opt.init(params)
        rparams, ropt, rm = rtr.train_iteration(rparams, ropt)
        _, opt_state, m = tr.train_iteration(params, opt_state)
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - float(rm[key])) \
                <= 1e-5 * abs(float(rm[key])), key
    rtr.loader.close()
    tr.loader.close()


def test_greedy_generate_matches_the_reference():
    rcfg, cfg, _, rparams, _, params = _pair(5, seed=2)
    ref = RefEngine(rcfg, rparams, RefServeConfig(batch=2, max_len=24))
    port = Engine(cfg, params, ServeConfig(batch=2, max_len=24),
                  device="cpu")
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    np.testing.assert_array_equal(port.generate(prompts, 12),
                                  ref.generate(prompts, 12))


def test_hybrid_checkpoint_crosses_packages(tmp_path):
    """The port saves its parameters in the reference's layout
    (``params_to_numpy``: groups, tail, shared_attn) and the reference
    restores them bit for bit; the reference's checkpoint restores in the
    port and converts back to the port's parameters."""
    _, cfg, _, rparams, _, params = _pair(5, seed=6)
    tree = _np_tree(rparams)
    Checkpointer(str(tmp_path / "port")).save(
        3, params_to_numpy(params, cfg), async_=False)
    got, meta = RCheckpointer(str(tmp_path / "port")).restore(3, rparams)
    assert meta["step"] == 3
    jax.tree_util.tree_map(np.testing.assert_array_equal, _np_tree(got),
                           tree)
    RCheckpointer(str(tmp_path / "ref")).save(3, rparams, async_=False)
    template = params_to_numpy(Transformer(cfg).init(seed=2, device="cpu"),
                               cfg)
    got, _ = Checkpointer(str(tmp_path / "ref")).restore(3, template)
    back = params_from_reference(got, cfg, device="cpu")
    for (path, a), (_, b) in zip(param_leaves(back), param_leaves(params)):
        assert torch.equal(a, b), path
