"""The port's model substrate against the JAX reference, on the CPU.

Reduced configs (``reduced``: 2 layers, d_model 64, f32) of gemma2-2b
(local/global pairs, softcaps, window 64), starcoder2-3b (LayerNorm, GELU,
biases, a sliding window on every layer), and for the loss alone
internvl2-1b (vision frontend, qkv biases) and musicgen-medium (audio
frontend).  The reference's own ``Transformer.init`` makes the parameters
and ``params_from_reference`` carries them across; batches come from a numpy
seed.  Tolerances: loss within 1e-5 relative, every gradient leaf within
1e-4 of its largest entry, one AdamW step within 1e-6, gemma2's decode
logits within 1e-5 of max(1, the largest logit).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as R_ARCHS
from repro.configs.registry import reduced as r_reduced
from repro.models.transformer import Transformer as RTransformer
from repro.optim.adamw import AdamW as RAdamW
from repro.optim.adamw import OptConfig as ROptConfig

from repro_torch.configs.registry import ARCHS, reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.convert import params_from_reference, params_to_numpy
from repro_torch.models.transformer import (Transformer, param_leaves,
                                            unflatten_like)
from repro_torch.optim.adamw import AdamW, OptConfig, decays

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401

SEQ = 128          # > the reduced window of 64, so the window masks


def _pair(arch, seed=0):
    rcfg, cfg = r_reduced(R_ARCHS[arch]), reduced(ARCHS[arch])
    rmodel = RTransformer(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    return rcfg, cfg, rmodel, rparams, Transformer(cfg), \
        params_from_reference(tree, cfg)


def _batch(cfg, batch=2, seq=SEQ, seed=3):
    return SyntheticLM(cfg, DataConfig(batch=batch, seq_len=seq,
                                       seed=seed)).batch_at(0)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_params_round_trip_and_layout():
    rcfg, cfg, _, rparams, model, params = _pair("gemma2-2b")
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    back = params_to_numpy(params, cfg)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
    # stacked (L/2, 2, ...) pairs become one dict per layer, in order
    assert len(params["blocks"]) == cfg.num_layers
    np.testing.assert_array_equal(
        params["blocks"][1]["attn"]["wq"].numpy(),
        tree["blocks"]["attn"]["wq"][0, 1])
    assert params["embed"]["table"].shape == (cfg.padded_vocab, cfg.d_model)
    # the port's own init makes the same names and shapes
    own = model.init(seed=1)
    assert [(p, tuple(t.shape)) for p, t in param_leaves(own)] == \
        [(p, tuple(t.shape)) for p, t in param_leaves(params)]


def test_bf16_leaves_carry_bit_for_bit():
    rcfg = R_ARCHS["gemma2-2b"].with_overrides(
        num_layers=2, d_model=64, vocab_size=256, d_ff=128, head_dim=16)
    cfg = ARCHS["gemma2-2b"].with_overrides(
        num_layers=2, d_model=64, vocab_size=256, d_ff=128, head_dim=16)
    rparams = RTransformer(rcfg).init(jax.random.PRNGKey(2))
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    params = params_from_reference(tree, cfg)
    assert params["embed"]["table"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params["blocks"][1]["mlp"]["wi"].float().numpy(),
        tree["blocks"]["mlp"]["wi"][0, 1].astype(np.float32))


@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-medium"])
def test_frontend_loss_matches_reference(arch):
    """The vision and audio frontends: precomputed embeddings through the
    frontend projection (beside or instead of token embeddings)."""
    rcfg, cfg, rmodel, rparams, model, params = _pair(arch)
    b = _batch(cfg)
    assert "embeds" in b
    rloss, _ = rmodel.loss(rparams, {k: jnp.asarray(v) for k, v in b.items()})
    with torch.no_grad():
        loss, _ = model.loss(params, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
    assert abs(float(loss) - float(rloss)) <= 1e-5 * abs(float(rloss))


@pytest.mark.parametrize("arch", ["gemma2-2b", "starcoder2-3b"])
def test_loss_and_every_gradient_match_reference(arch):
    rcfg, cfg, rmodel, rparams, model, params = _pair(arch)
    b = _batch(cfg)
    (rloss, _), rgrads = jax.value_and_grad(rmodel.loss, has_aux=True)(
        rparams, {k: jnp.asarray(v) for k, v in b.items()})
    leaves = [t for _, t in param_leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = model.loss(params, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(rloss)) <= 1e-5 * abs(float(rloss))
    assert float(metrics["ntok"]) == b["labels"].size
    port = params_to_numpy(unflatten_like(params, list(grads)), cfg)
    ref = jax.tree_util.tree_map(np.asarray, rgrads)
    flat_p = jax.tree_util.tree_leaves_with_path(port)
    flat_r = jax.tree_util.tree_leaves(ref)
    assert len(flat_p) == len(flat_r)
    for (path, g), r in zip(flat_p, flat_r):
        assert _rel(g, r) < 1e-4, (jax.tree_util.keystr(path), _rel(g, r))


def test_adamw_update_matches_reference():
    rcfg, cfg, _, rparams, _, params = _pair("gemma2-2b")
    oc = dict(lr_peak=1e-2, warmup_steps=1, total_steps=10)
    ropt, opt = RAdamW(ROptConfig(**oc)), AdamW(OptConfig(**oc))
    rstate, state = ropt.init(rparams), opt.init(params)
    rng = np.random.default_rng(9)
    for _ in range(2):           # warmup step, then the cosine branch
        gtree = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            jax.tree_util.tree_map(np.asarray, rparams))
        rparams, rstate, rm = ropt.update(
            jax.tree_util.tree_map(jnp.asarray, gtree), rstate, rparams)
        grads = params_from_reference(gtree, cfg)
        params, state, m = opt.update(grads, state, params)
        assert abs(float(m["lr"]) - float(rm["lr"])) < 1e-9
        assert abs(float(m["grad_norm"]) - float(rm["grad_norm"])) \
            < 1e-6 * float(rm["grad_norm"])
    for got, want in ((params, rparams), (state["m"], rstate["m"]),
                      (state["v"], rstate["v"]),
                      (state["master"], rstate["master"])):
        got = params_to_numpy(got, cfg)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, np.asarray(b),
                                                    rtol=0, atol=1e-6),
            got, jax.tree_util.tree_map(np.asarray, want))
    assert int(state["step"]) == int(rstate["step"]) == 2


def test_decay_mask_matches_reference_paths():
    assert not decays("final_norm/scale")
    assert not decays("blocks/3/ln1p/scale")
    assert not decays("blocks/0/attn/bq")
    assert decays("blocks/0/attn/wq") and decays("embed/table")
    assert decays("blocks/1/mlp/wi")


@pytest.mark.parametrize("arch,steps,tol", [("gemma2-2b", 72, 1e-5),
                                            ("starcoder2-3b", 72, 5e-5)])
def test_decode_logits_match_reference(arch, steps, tol):
    """Token-by-token decode past the window of 64: gemma2's local layers
    mask by position, starcoder2's window-sized cache wraps as a ring.
    starcoder2's unsoftcapped logits go through LayerNorm and GELU, whose
    f32 rounding differs between the frameworks (worst seen 1.4e-5 at
    position 47, before the ring wraps), hence its wider tolerance."""
    rcfg, cfg, rmodel, rparams, model, params = _pair(arch)
    max_len = 80
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, steps)).astype(np.int32)
    rcache = rmodel.init_cache(2, max_len)
    cache = model.init_cache(2, max_len)
    assert cache[0]["k"].shape[1] == rmodel.kv_len(max_len)
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
        assert err <= tol * max(1.0, np.abs(rlog).max()), (pos, err)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "zamba2-7b",
                                  "llama4-maverick-400b-a17b"])
def test_families_not_ported_raise(arch):
    with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
        Transformer(reduced(ARCHS[arch])).init()


def test_remat_is_not_ported():
    with pytest.raises(NotImplementedError, match="remat"):
        Transformer(reduced(ARCHS["gemma2-2b"]), remat="full")
