"""The port's mamba2 (``ssm`` family) path against the JAX reference, on the
CPU.

K3's plain version ``ssd_scan_reference`` against the reference's Pallas
kernel (interpret mode) and its float64 oracle on the four shapes of
tests/test_kernels.py (2e-5 of the largest output); the port's
``ssd_chunked`` against the reference's (1e-5 of the largest output, f32);
``apply_mamba2`` with either impl; the reduced mamba2-2.7b (``reduced``: 2
layers, d_model 64, state 16, head dim 16, chunk 32, f32) for its loss
(1e-5 relative), every gradient leaf (1e-4 of its largest entry), decode
logits stepped token by token, and 3 ``train_iteration`` losses (1e-4); the
converter; and the overflow the reference's gradients hit at mamba2's
published chunk.  Inputs come from numpy seeds; the reference's own
``init`` makes the parameters and ``params_from_reference`` carries them
across.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as R_ARCHS
from repro.configs.registry import reduced as r_reduced
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.models import ssm as r_ssm
from repro.models.transformer import Transformer as RTransformer
from repro.optim.adamw import AdamW as RAdamW
from repro.optim.adamw import OptConfig as ROptConfig
from repro.train.loop import Trainer as RTrainer
from repro.train.workload import tiny_train_setup as r_tiny_train_setup

from repro_torch.configs.registry import ARCHS, reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels.ssd_scan import (bound_ms, p_split_for, ssd_flops,
                                          ssd_oracle, ssd_scan,
                                          ssd_scan_reference)
from repro_torch.models import ssm
from repro_torch.models.convert import params_from_reference, params_to_numpy
from repro_torch.models.transformer import (Transformer, param_leaves,
                                            unflatten_like)
from repro_torch.optim.adamw import AdamW, OptConfig, decays
from repro_torch.train.loop import Trainer
from repro_torch.train.workload import tiny_train_setup

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401

ARCH = "mamba2-2.7b"
#: (B, S, H, P, G, N, chunk): the SSD shapes of tests/test_kernels.py
KERNEL_SHAPES = [(1, 64, 2, 16, 1, 8, 16), (2, 128, 4, 32, 2, 16, 32),
                 (1, 128, 4, 64, 4, 32, 64), (1, 32, 2, 16, 2, 16, 32)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _ssd_inputs(B, S, H, P, G, N, seed=2, dt=None, A=None):
    """x, B, C standard normal; dt = softplus(normal) and A = -exp(U[0,1])
    as in tests/test_kernels.py, or the constants given."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    raw = rng.standard_normal((B, S, H)).astype(np.float32)
    dtv = np.logaddexp(raw, 0).astype(np.float32) if dt is None \
        else np.full((B, S, H), dt, np.float32)
    Av = -np.exp(rng.random(H)).astype(np.float32) if A is None \
        else np.full(H, A, np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    return x, dtv, Av, Bm, Cm


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


# -- K3's plain version ---------------------------------------------------------

@pytest.mark.parametrize("B,S,H,P,G,N,chunk", KERNEL_SHAPES)
def test_plain_version_matches_pallas_kernel_and_oracle(B, S, H, P, G, N,
                                                        chunk):
    arrays = _ssd_inputs(B, S, H, P, G, N)
    y = ssd_scan_reference(*_t(arrays), chunk).numpy()
    pallas = np.asarray(r_ops.ssd_scan(*_j(arrays), chunk=chunk))
    oracle = np.asarray(r_ref.ssd_oracle(*_j(arrays)))
    assert _rel(y, pallas) < 2e-5 and _rel(y, oracle) < 2e-5
    # the port's float64 oracle is the reference's
    np.testing.assert_allclose(ssd_oracle(*_t(arrays)).numpy(), oracle,
                               rtol=0, atol=1e-6 * np.abs(oracle).max())


def test_wrapper_on_cpu_runs_plain_version_without_launch():
    arrays = _t(_ssd_inputs(2, 128, 4, 32, 2, 16))
    before = ssd_scan.launches
    y = ssd_scan(*arrays, 32)
    assert ssd_scan.launches == before
    assert torch.equal(y, ssd_scan_reference(*arrays, 32))
    assert torch.equal(ssd_scan.run(*arrays, 32), y)
    x, dt, A, Bm, Cm = arrays
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A, Bm, Cm, 48)             # 128 % 48
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A[:3], Bm, Cm, 32)
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A, Bm[:, :, :1].expand(2, 128, 3, 16),
                 Cm[:, :, :1].expand(2, 128, 3, 16), 32)   # 4 heads, 3 groups


def test_p_split_and_bound():
    assert p_split_for(64) == 64 and p_split_for(32) == 32
    assert p_split_for(48) == 16 and p_split_for(128) == 64
    with pytest.raises(ValueError):
        p_split_for(24)
    x = torch.empty((1, 2048, 80, 64), dtype=torch.bfloat16)
    bc = torch.empty((1, 2048, 1, 128), dtype=torch.bfloat16)
    dt = torch.empty((1, 2048, 80))
    # C B^T once per group and chunk (G = 1), its product with x per head,
    # both over the 256 * 257 / 2 pairs t >= s; the state's 4QNP per head
    pairs = 256 * 257 // 2
    flops = ssd_flops(x, bc, 256)
    assert flops == 8 * 2 * pairs * 128 + 80 * 8 * (2 * pairs * 64
                                                    + 4 * 256 * 128 * 64)
    assert flops == pytest.approx(8.13e9, rel=1e-3)
    ms, by = bound_ms(x, dt, bc, bc, 256)
    nbytes = 2 * x.numel() * 2 + dt.numel() * 4 + 2 * bc.numel() * 2
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert flops / 989e12 * 1e3 < ms
    # f32 at the same shape is bound by the CUDA cores' 67 TFLOP/s
    x32, bc32 = x.float(), bc.float()
    ms32, by32 = bound_ms(x32, dt, bc32, bc32, 256)
    assert by32 == "operations"
    assert ms32 == pytest.approx(flops / 67e12 * 1e3)


# -- the model's chunked path and the block ------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_reference(dtype):
    arrays = list(_ssd_inputs(2, 128, 4, 32, 2, 16, seed=3))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    ry, rstate = r_ssm.ssd_chunked(
        *[jnp.asarray(a).astype(jdt) if i in (0, 3, 4) else jnp.asarray(a)
          for i, a in enumerate(arrays)], 32)
    t = _t(arrays)
    y, state = ssm.ssd_chunked(t[0].to(tdt), t[1], t[2], t[3].to(tdt),
                               t[4].to(tdt), 32)
    assert y.dtype == tdt and state.dtype == torch.float32
    ry = np.asarray(ry.astype(jnp.float32))
    if dtype == "float32":
        assert _rel(y.numpy(), ry) < 1e-5
    else:
        # one bf16 step of the value: both round an f32 sum to bf16
        err = np.abs(y.float().numpy() - ry)
        assert (err <= 1e-3 + 2.0 ** -7 * np.abs(ry)).all()
    assert _rel(state.numpy(), np.asarray(rstate)) < 1e-5


def _block(seed=0, dtype=jnp.float32):
    rcfg = r_reduced(R_ARCHS[ARCH])
    p = r_ssm.init_mamba2(jax.random.PRNGKey(seed), rcfg, dtype=dtype)
    return rcfg, reduced(ARCHS[ARCH]), p, {
        k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("impl", ["ssd_k3", "ssd_chunked"])
def test_apply_mamba2_matches_reference(impl):
    rcfg, cfg, rp, p = _block()
    x = np.random.default_rng(5).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    want = np.asarray(r_ssm.apply_mamba2(rp, jnp.asarray(x), rcfg))
    got = ssm.apply_mamba2(p, torch.from_numpy(x), cfg,
                           impl=getattr(ssm, impl)).numpy()
    assert _rel(got, want) < 1e-5


def test_port_init_matches_reference_names_shapes_and_dtypes():
    cfg = ARCHS[ARCH].with_overrides(num_layers=2, d_model=64,
                                     vocab_size=256)
    rcfg = R_ARCHS[ARCH].with_overrides(num_layers=2, d_model=64,
                                        vocab_size=256)
    rparams = RTransformer(rcfg).init(jax.random.PRNGKey(0))
    ref = params_from_reference(jax.tree_util.tree_map(np.asarray, rparams),
                                cfg)
    own = Transformer(cfg).init(seed=1)
    assert [(p, tuple(t.shape), t.dtype) for p, t in param_leaves(own)] == \
        [(p, tuple(t.shape), t.dtype) for p, t in param_leaves(ref)]
    m = own["blocks"][1]["mamba"]
    assert m["A_log"].dtype == m["D"].dtype == m["dt_bias"].dtype \
        == torch.float32 and m["w_x"].dtype == torch.bfloat16
    a = torch.exp(m["A_log"])
    assert ((a >= 1) & (a <= 16)).all()
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert ((dt > 0.99e-3) & (dt < 0.101)).all()


# -- the converter ----------------------------------------------------------------

def test_converter_round_trip_keeps_every_dtype():
    """bf16 parameters (mamba2's own dtype): f32 leaves stay f32, bf16
    leaves are carried bit for bit, and the round trip gives the tree."""
    cfg = ARCHS[ARCH].with_overrides(num_layers=3, d_model=64,
                                     vocab_size=256)
    rcfg = R_ARCHS[ARCH].with_overrides(num_layers=3, d_model=64,
                                        vocab_size=256)
    tree = jax.tree_util.tree_map(
        np.asarray, RTransformer(rcfg).init(jax.random.PRNGKey(2)))
    params = params_from_reference(tree, cfg)
    assert len(params["blocks"]) == 3
    assert set(params["blocks"][0]) == {"ln", "mamba"}
    for path, t in param_leaves(params):
        name = path.split("/")[-1]
        want = torch.float32 if name in ("A_log", "D", "dt_bias") \
            else torch.bfloat16
        assert t.dtype == want, path
    back = params_to_numpy(params, cfg)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(a, b.astype(np.float32)),
        back, tree)
    np.testing.assert_array_equal(
        params["blocks"][2]["mamba"]["w_z"].float().numpy(),
        tree["blocks"]["mamba"]["w_z"][2].astype(np.float32))


# -- the reduced model --------------------------------------------------------------

def _pair(seed=0):
    rcfg, cfg = r_reduced(R_ARCHS[ARCH]), reduced(ARCHS[ARCH])
    rmodel = RTransformer(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    return rcfg, cfg, rmodel, rparams, Transformer(cfg), \
        params_from_reference(tree, cfg)


def test_loss_and_every_gradient_match_reference():
    rcfg, cfg, rmodel, rparams, model, params = _pair()
    b = SyntheticLM(cfg, DataConfig(batch=2, seq_len=128, seed=3)).batch_at(0)
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
    flat_p = jax.tree_util.tree_leaves_with_path(port)
    flat_r = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, rgrads))
    assert len(flat_p) == len(flat_r)
    for (path, g), r in zip(flat_p, flat_r):
        assert _rel(g, r) < 1e-4, (jax.tree_util.keystr(path), _rel(g, r))


def test_decode_logits_match_reference():
    """Token by token over 40 positions (past the chunk of 32): the conv
    windows and the f32 state carry through the port's per-layer cache."""
    rcfg, cfg, rmodel, rparams, model, params = _pair(seed=1)
    steps = 40
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, steps)).astype(np.int32)
    rcache = rmodel.init_cache(2, steps)
    cache = model.init_cache(2, steps)
    assert cache[0]["state"].dtype == torch.float32
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
    np.testing.assert_allclose(
        cache[1]["state"].numpy(), np.asarray(rcache["ssm"]["state"][1]),
        rtol=0, atol=1e-5 * np.abs(np.asarray(rcache["ssm"]["state"])).max())


def test_prefill_forward_matches_decode():
    """The chunked forward (K3's plain version) and the recurrent decode give
    the same last-position logits."""
    _, cfg, _, _, model, params = _pair(seed=2)
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (1, 64)).astype(np.int32)
    with torch.no_grad():
        hidden, _, cache = model.forward(
            params, {"tokens": torch.from_numpy(toks)}, collect_cache=True)
        full = model.logits(params, hidden)[:, -1]
        dec = model.init_cache(1, 64)
        for pos in range(64):
            log, dec = model.decode_step(
                params, dec, {"tokens": torch.from_numpy(
                    toks[:, pos:pos + 1])}, pos)
    assert cache == []
    assert _rel(log[:, 0].numpy(), full.numpy()) < 1e-5


def test_adamw_takes_mixed_leaves_and_matches_reference():
    """bf16 parameters with f32 ``A_log``/``D``/``dt_bias``: one step of
    each optimizer from the same gradients.  The f32 state agrees within
    1e-6; the new bf16 parameters are the same rounding of the master
    weights, so they agree to one bf16 step."""
    cfg = ARCHS[ARCH].with_overrides(num_layers=2, d_model=64,
                                     vocab_size=256)
    rcfg = R_ARCHS[ARCH].with_overrides(num_layers=2, d_model=64,
                                        vocab_size=256)
    rparams = RTransformer(rcfg).init(jax.random.PRNGKey(3))
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    params = params_from_reference(tree, cfg)
    oc = dict(lr_peak=1e-2, warmup_steps=1, total_steps=10)
    ropt, opt = RAdamW(ROptConfig(**oc)), AdamW(OptConfig(**oc))
    rstate, state = ropt.init(rparams), opt.init(params)
    rng = np.random.default_rng(9)
    gtree = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
    rparams, rstate, rm = ropt.update(
        jax.tree_util.tree_map(jnp.asarray, gtree), rstate, rparams)
    params, state, m = opt.update(params_from_reference(gtree, cfg), state,
                                  params)
    assert abs(float(m["grad_norm"]) - float(rm["grad_norm"])) \
        < 1e-6 * float(rm["grad_norm"])
    for got, want in ((state["m"], rstate["m"]), (state["v"], rstate["v"]),
                      (state["master"], rstate["master"])):
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, np.asarray(b),
                                                    rtol=0, atol=1e-6),
            params_to_numpy(got, cfg),
            jax.tree_util.tree_map(np.asarray, want))
    assert params["blocks"][0]["mamba"]["A_log"].dtype == torch.float32
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(
            a, np.asarray(b, np.float32), rtol=2.0 ** -7, atol=1e-6),
        params_to_numpy(params, cfg), jax.tree_util.tree_map(np.asarray,
                                                             rparams))


def test_decay_mask_matches_reference_for_mamba_leaves():
    for leaf in ("A_log", "dt_bias", "D", "gate_norm"):
        assert not decays(f"blocks/7/mamba/{leaf}"), leaf
    assert not decays("blocks/7/ln/scale")
    for leaf in ("w_z", "w_x", "w_B", "w_C", "w_dt", "conv_x_w", "out_proj"):
        assert decays(f"blocks/7/mamba/{leaf}"), leaf


def test_train_iterations_match_reference_losses():
    rcfg = r_reduced(R_ARCHS[ARCH])
    _, rdc, roc, rtc = r_tiny_train_setup()
    rtr = RTrainer(rcfg, rdc, roc, rtc)
    rparams, ropt, _ = rtr.init_state()
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    rlosses = []
    for _ in range(3):
        rparams, ropt, m = rtr.train_iteration(rparams, ropt)
        rlosses.append(float(m["loss"]))
    rtr.loader.close()

    _, dc, oc, tc = tiny_train_setup()
    cfg = reduced(ARCHS[ARCH])
    tr = Trainer(cfg, dc, oc, tc, device="cpu")
    params = params_from_reference(tree, cfg)
    opt_state = tr.opt.init(params)
    losses = []
    for _ in range(3):
        params, opt_state, m = tr.train_iteration(params, opt_state)
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
    tr.loader.close()
    np.testing.assert_allclose(losses, rlosses, rtol=0, atol=1e-4)


# -- mamba2's published chunk: the reference's gradients overflow ------------------

def test_gradients_at_published_chunk_are_finite_and_exact():
    """Chunk 256 with dt 0.1 and A -16 (the ends of mamba2's init ranges):
    the upper triangle's ``cum_t - cum_s`` reaches 409, past float32's exp
    range.  The reference exponentiates before masking (``ssm.py:107-108``)
    and its gradients of dt and A are NaN (recorded here); the port masks
    first.  In float64, the gradients through K3's autograd function equal
    float64 autograd through the sequential oracle within 1e-6 of each
    gradient's largest entry.  In float32, those through K3's function and
    through ``ssd_chunked`` are finite and within 1e-4: ``cum`` itself is
    rounded to float32's step at 409 (3e-5), and A's gradient sums every
    position's share."""
    B, S, H, P, G, N, Q = 1, 512, 2, 16, 1, 16, 256
    arrays = _ssd_inputs(B, S, H, P, G, N, seed=7, dt=0.1, A=-16.0)
    w = np.random.default_rng(8).standard_normal((B, S, H, P))

    def rloss(*a):
        return jnp.sum(r_ssm.ssd_chunked(*a, Q)[0] * jnp.asarray(w))
    rgrads = jax.grad(rloss, argnums=(0, 1, 2, 3, 4))(*_j(arrays))
    finite = [bool(jnp.isfinite(g).all()) for g in rgrads]
    assert finite == [True, False, False, True, True]     # dt, A: NaN

    def grads(fn, dtype):
        ins = [t.to(dtype).requires_grad_(True) for t in _t(arrays)]
        y = fn(*ins)
        return torch.autograd.grad((y * torch.from_numpy(w).to(dtype)).sum(),
                                   ins)
    want = grads(ssd_oracle, torch.float64)
    cases = [("ssd_scan", lambda *a: ssd_scan(*a, Q), torch.float64, 1e-6),
             ("ssd_scan", lambda *a: ssd_scan(*a, Q), torch.float32, 1e-4),
             ("ssd_chunked", lambda *a: ssm.ssd_chunked(*a, Q)[0],
              torch.float32, 1e-4)]
    for name, fn, dtype, tol in cases:
        got = grads(fn, dtype)
        for arg, g, r in zip("x dt A B C".split(), got, want):
            assert g.dtype == dtype and torch.isfinite(g).all(), (name, arg)
            err = _rel(g.numpy(), r.numpy())
            assert err < tol, (name, dtype, arg, err)


def test_model_gradients_finite_at_published_widths_of_the_scan():
    """One mamba2 block at chunk 256 on the init's extreme dt/A: the loss's
    gradients are finite in every leaf (the reference's are NaN in
    ``A_log``, ``dt_bias`` and ``w_dt`` at mamba2-2.7b's widths)."""
    cfg = reduced(ARCHS[ARCH]).with_overrides(ssm_chunk=256)
    p = ssm.init_mamba2(torch.Generator().manual_seed(0), cfg)
    p["A_log"] = torch.full_like(p["A_log"], math.log(16.0))
    p["dt_bias"] = torch.full_like(p["dt_bias"], 0.1 + math.log(
        -math.expm1(-0.1)))
    for t in p.values():
        t.requires_grad_(True)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 512, cfg.d_model)).astype(np.float32))
    out = ssm.apply_mamba2(p, x, cfg)
    grads = torch.autograd.grad(out.square().sum(), list(p.values()))
    assert all(torch.isfinite(g).all() for g in grads)
