"""The port's ``moe`` family against the JAX reference, on the CPU.

Reduced configs (``reduced``: d_model 64, f32, 8 experts) of
deepseek-v2-lite-16b (MLA, 2 experts chosen of 8 plus a shared expert,
layer 0 dense) and llama4-maverick-400b-a17b ((dense, MoE) pairs, top-1 plus
a shared expert, GQA).  The reference's own ``init`` makes the parameters
and ``params_from_reference`` carries them across; tokens and activations
come from a numpy seed.

* ``_moe_local`` / ``apply_moe``: outputs within 1e-5 of the largest; the
  chosen experts, the ``keep`` mask and the per-expert counts exactly the
  reference's, at the default capacity factor and at one so small that
  rows are dropped.  Ties between router probabilities, where
  ``jax.lax.top_k`` and ``torch.topk`` could order experts differently, do
  not occur on these random inputs.  The aux loss within 1e-6.
* Each model: loss within 1e-5 relative, every gradient within 1e-4 of its
  largest entry, decode logits within 1e-5 of max(1, the largest logit),
  three ``train_iteration`` losses and grad norms within 1e-5 relative,
  greedy ``Engine.generate`` tokens equal.
* The converter's round trip for both layouts, and a deepseek checkpoint
  written by either package restored by the other.
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
from repro.models import moe as RM
from repro.models.transformer import Transformer as RTransformer
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.train.loop import Trainer as RTrainer
from repro.train.workload import tiny_train_setup as r_tiny_train_setup

from repro_torch.ckpt import Checkpointer
from repro_torch.configs.registry import ARCHS, reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import moe as M
from repro_torch.models.convert import params_from_reference, params_to_numpy
from repro_torch.models.transformer import (Transformer, param_leaves,
                                            unflatten_like)
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train.loop import Trainer
from repro_torch.train.workload import tiny_train_setup

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401

MOE_ARCHS = ["deepseek-v2-lite-16b", "llama4-maverick-400b-a17b"]
SEQ = 32


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  _np_tree(tree))


def _pair(arch, seed=0):
    rcfg, cfg = r_reduced(R_ARCHS[arch]), reduced(ARCHS[arch])
    rmodel = RTransformer(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(seed))
    params = params_from_reference(_np_tree(rparams), cfg, device="cpu")
    return rcfg, cfg, rmodel, rparams, Transformer(cfg), params


def _batch(cfg, batch=2, seq=SEQ, seed=3):
    return SyntheticLM(cfg, DataConfig(batch=batch, seq_len=seq,
                                       seed=seed)).batch_at(0)


# -- the MoE layer ------------------------------------------------------------

def _reference_routing(rp, x, rcfg, capacity):
    """The reference's expert choice (its router, softmax and top_k), and
    the ``keep`` mask of its sort-based dispatch, recomputed in numpy from
    that choice."""
    logits = jnp.einsum("td,de->te", jnp.asarray(x), rp["router"])
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), rcfg.top_k)
    eid = np.asarray(idx).reshape(-1)
    eid_s = eid[np.argsort(eid, kind="stable")]
    counts = np.bincount(eid_s, minlength=rcfg.num_experts)
    pos = np.arange(eid.size) - (np.cumsum(counts) - counts)[eid_s]
    return np.asarray(idx), pos < capacity


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_moe_layer_routes_and_computes_as_the_reference(arch,
                                                        capacity_factor):
    rcfg = r_reduced(R_ARCHS[arch]).with_overrides(
        capacity_factor=capacity_factor)
    cfg = reduced(ARCHS[arch]).with_overrides(capacity_factor=capacity_factor)
    rp = RM.init_moe(jax.random.PRNGKey(1), rcfg)
    p = _torch_tree(rp)
    B, S = 2, 64
    x = np.random.default_rng(2).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    cap = M._capacity(B * S, cfg)
    assert cap == RM._capacity(B * S, rcfg)

    want_idx, want_keep = _reference_routing(rp, x.reshape(B * S, -1), rcfg,
                                             cap)
    probs, eid_s, tid_s, _, counts, pos, keep = M.route(
        p, torch.from_numpy(x.reshape(B * S, -1)), cfg, cap)
    idx = torch.topk(probs, cfg.top_k, dim=-1).indices.numpy()
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if capacity_factor < 1:
        assert not want_keep.all()            # rows are dropped

    ry, rstats = RM.apply_moe(rp, jnp.asarray(x), rcfg)
    y, stats = M.apply_moe(p, torch.from_numpy(x), cfg)
    ry, rstats = np.asarray(ry), np.asarray(rstats)
    E = cfg.num_experts
    np.testing.assert_array_equal(counts.numpy(), rstats[:E])
    np.testing.assert_array_equal(stats[:E].numpy(), rstats[:E])
    assert np.abs(stats[E:].numpy() - rstats[E:]).max() < 1e-5
    assert _rel(y.numpy(), ry) < 1e-5
    tokens = float(B * S)
    raux = float(RM.aux_loss_from_stats(jnp.asarray(rstats), rcfg, tokens))
    aux = float(M.aux_loss_from_stats(stats, cfg, tokens))
    assert abs(aux - raux) < 1e-6


def test_moe_router_is_float32_under_bf16_parameters():
    cfg = reduced(ARCHS["deepseek-v2-lite-16b"]).with_overrides(
        param_dtype="bfloat16", dtype="bfloat16")
    g = torch.Generator().manual_seed(0)
    p = M.init_moe(g, cfg, torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert p["wi"].dtype == p["wo"].dtype == torch.bfloat16
    assert p["wi"].shape == (cfg.num_experts, cfg.d_model, 2, cfg.d_ff)
    assert p["shared"]["wi"].shape[-1] == cfg.d_ff * cfg.num_shared_experts
    x = torch.randn((2, 8, cfg.d_model), generator=g).bfloat16()
    y, stats = M.apply_moe(p, x, cfg)
    assert y.dtype == torch.bfloat16 and stats.dtype == torch.float32
    assert float(stats[:cfg.num_experts].sum()) == 2 * 8 * cfg.top_k


# -- whole models -------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    rcfg, cfg, rmodel, rparams, model, params = _pair(arch)
    b = _batch(cfg)
    (rloss, rm), rgrads = jax.value_and_grad(rmodel.loss, has_aux=True)(
        rparams, {k: jnp.asarray(v) for k, v in b.items()})
    leaves = [t for _, t in param_leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = model.loss(params, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(rloss)) <= 1e-5 * abs(float(rloss))
    aux = float(metrics["aux"].detach())
    assert aux > 0 and abs(aux - float(rm["aux"])) < 1e-6
    port = params_to_numpy(unflatten_like(params, list(grads)), cfg)
    flat_p = jax.tree_util.tree_leaves_with_path(port)
    flat_r = jax.tree_util.tree_leaves(_np_tree(rgrads))
    assert len(flat_p) == len(flat_r)
    for (path, g), r in zip(flat_p, flat_r):
        assert _rel(g, r) < 1e-4, (jax.tree_util.keystr(path), _rel(g, r))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_logits_match_reference(arch):
    rcfg, cfg, rmodel, rparams, model, params = _pair(arch)
    steps, max_len = 20, 24
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, steps)).astype(np.int32)
    rcache = rmodel.init_cache(2, max_len)
    cache = model.init_cache(2, max_len, device="cpu")
    if cfg.attention == "mla":
        assert set(cache[0]) == {"latent", "krope"}
        assert cache[0]["latent"].shape == (2, max_len, cfg.kv_lora_rank)
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_iterations_match_reference_losses(arch):
    """Three ``train_iteration`` steps of each package on the same batches;
    before each of the port's steps its parameters are set to the
    reference's, so every loss and grad norm is compared on the same
    weights.  Run free, the trajectories part after two steps: AdamW's
    first update moves every entry by about ``lr * sign(g)``, so the few
    entries whose gradient is rounding noise (1 to 21 of each leaf's
    thousands, llama4) move by +-lr in one package and -+lr in the other,
    and llama4's top-1 router then sends a token elsewhere on step 3."""
    rcfg = r_reduced(R_ARCHS[arch])
    _, rdc, roc, rtc = r_tiny_train_setup()
    rtr = RTrainer(rcfg, rdc, roc, rtc)
    rparams, ropt, _ = rtr.init_state()

    _, dc, oc, tc = tiny_train_setup()
    cfg = reduced(ARCHS[arch])
    tagged = Trainer(cfg, dc, oc, replace(tc, perftracker=True),
                     device="cpu")
    assert tagged.pt.cfg.family == "moe"        # as the reference tags it
    tagged.loader.close()
    tr = Trainer(cfg, dc, oc, tc, device="cpu")
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_greedy_generate_matches_the_reference(arch):
    rcfg, cfg, _, rparams, _, params = _pair(arch)
    ref = RefEngine(rcfg, rparams, RefServeConfig(batch=2, max_len=24))
    port = Engine(cfg, params, ServeConfig(batch=2, max_len=24),
                  device="cpu")
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    np.testing.assert_array_equal(port.generate(prompts, 12),
                                  ref.generate(prompts, 12))


# -- the converter and checkpoints --------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_round_trip_and_layout(arch):
    rcfg, cfg, _, rparams, model, params = _pair(arch)
    tree = _np_tree(rparams)
    back = params_to_numpy(params, cfg)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
    assert len(params["blocks"]) == cfg.num_layers
    if cfg.moe_every == 2:      # llama4: pair i is layers 2i and 2i + 1
        np.testing.assert_array_equal(
            params["blocks"][3]["moe"]["wi"].numpy(),
            tree["pair_moe"]["moe"]["wi"][1])
        np.testing.assert_array_equal(
            params["blocks"][2]["mlp"]["wo"].numpy(),
            tree["pair_dense"]["mlp"]["wo"][1])
    else:                       # deepseek: dense0, then blocks
        np.testing.assert_array_equal(
            params["blocks"][0]["mlp"]["wi"].numpy(),
            tree["dense0"]["mlp"]["wi"][0])
        np.testing.assert_array_equal(
            params["blocks"][1]["attn"]["wk_up"].numpy(),
            tree["blocks"]["attn"]["wk_up"][0])
    own = model.init(seed=1, device="cpu")
    assert [(p, tuple(t.shape), t.dtype) for p, t in param_leaves(own)] == \
        [(p, tuple(t.shape), t.dtype) for p, t in param_leaves(params)]


def test_bf16_leaves_carry_bit_for_bit_and_router_stays_f32():
    arch = "deepseek-v2-lite-16b"
    kw = dict(param_dtype="bfloat16", dtype="bfloat16")
    rcfg = r_reduced(R_ARCHS[arch]).with_overrides(**kw)
    cfg = reduced(ARCHS[arch]).with_overrides(**kw)
    tree = _np_tree(RTransformer(rcfg).init(jax.random.PRNGKey(2)))
    params = params_from_reference(tree, cfg, device="cpu")
    moe = params["blocks"][1]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["wi"].dtype == torch.bfloat16
    np.testing.assert_array_equal(moe["wi"].float().numpy(),
                                  tree["blocks"]["moe"]["wi"][0]
                                  .astype(np.float32))


def test_deepseek_checkpoint_crosses_packages(tmp_path):
    """The port saves its parameters in the reference's layout
    (``params_to_numpy``) and the reference restores them bit for bit; the
    reference's checkpoint restores in the port, into the same layout, and
    converts back to the port's parameters."""
    rcfg, cfg, _, rparams, _, params = _pair("deepseek-v2-lite-16b", seed=6)
    tree = _np_tree(rparams)
    Checkpointer(str(tmp_path / "port")).save(
        4, params_to_numpy(params, cfg), async_=False)
    got, meta = RCheckpointer(str(tmp_path / "port")).restore(4, rparams)
    assert meta["step"] == 4
    jax.tree_util.tree_map(np.testing.assert_array_equal, _np_tree(got),
                           tree)
    RCheckpointer(str(tmp_path / "ref")).save(4, rparams, async_=False)
    template = params_to_numpy(Transformer(cfg).init(seed=2, device="cpu"),
                               cfg)
    got, meta = Checkpointer(str(tmp_path / "ref")).restore(4, template)
    back = params_from_reference(got, cfg, device="cpu")
    for (path, a), (_, b) in zip(param_leaves(back), param_leaves(params)):
        assert torch.equal(a, b), path
