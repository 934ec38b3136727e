"""MLA attention (deepseek-v2) and K2 at q/k head dim != v head dim, the
port against the JAX reference on the CPU.

* K2's plain version at (D, Dv) = (24, 16) and (192, 128) against the
  reference's ``attention_ref`` and its XLA ``blocked_attention`` (the
  path the reference's ``apply_mla`` runs; its Pallas kernel takes one
  head dim), f32 within 2e-5; the port's ``blocked_attention`` gradients
  there against ``jax.grad`` of the reference's, within 1e-4 of the
  largest gradient.
* ``apply_mla`` (materialized) and ``mla_decode`` (absorbed, the latent
  cache written in place) against the reference's, reduced
  deepseek-v2-lite-16b widths in f32, within 1e-5 of the largest output.

Inputs and weights come from a numpy seed and the reference's own init.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as R_ARCHS
from repro.configs.registry import reduced as r_reduced
from repro.models import attention as RA
from repro.models import attention_core as RC

from repro_torch.configs.registry import ARCHS, reduced
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as A
from repro_torch.models import attention_core as C

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401

ARCH = "deepseek-v2-lite-16b"


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _qkv(seed, B, S, H, D, Dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D), np.float32),
            rng.standard_normal((B, S, H, D), np.float32),
            rng.standard_normal((B, S, H, Dv), np.float32))


@pytest.mark.parametrize("B,S,H,D,Dv", [(2, 64, 4, 24, 16),
                                        (1, 128, 2, 192, 128)])
def test_plain_k2_with_a_narrower_v_matches_reference(B, S, H, D, Dv):
    q, k, v = _qkv(0, B, S, H, D, Dv)
    scale = D ** -0.5
    spec = RC.AttnSpec(scale=scale, q_block=32, kv_block=32)
    ref = np.asarray(RA.attention_ref(*map(jnp.asarray, (q, k, v)), spec))
    xla = np.asarray(RC.blocked_attention(*map(jnp.asarray, (q, k, v)),
                                          spec))
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), scale=scale)
    assert out.shape == (B, S, H, Dv)
    assert np.abs(out.numpy() - ref).max() < 2e-5
    assert np.abs(out.numpy() - xla).max() < 2e-5


def test_blocked_gradients_with_a_narrower_v_match_reference():
    q, k, v = _qkv(1, 2, 64, 4, 24, 16)
    dout = np.random.default_rng(2).standard_normal(
        (2, 64, 4, 16)).astype(np.float32)
    rspec = RC.AttnSpec(scale=24 ** -0.5, q_block=32, kv_block=32)
    spec = C.AttnSpec(scale=24 ** -0.5, q_block=32, kv_block=32)
    rgrads = jax.grad(lambda a, b, c: jnp.sum(
        RC.blocked_attention(a, b, c, rspec) * dout), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = C.blocked_attention(*ts, spec)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(dout))
    for g, r in zip(grads, rgrads):
        assert g.shape == r.shape
        assert _rel(g.numpy(), np.asarray(r)) < 1e-4


def _mla_setup(seed=0):
    rcfg, cfg = r_reduced(R_ARCHS[ARCH]), reduced(ARCHS[ARCH])
    rp = RA.init_mla(jax.random.PRNGKey(seed), rcfg)
    p = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    return rcfg, cfg, rp, p


def test_apply_mla_matches_reference():
    rcfg, cfg, rp, p = _mla_setup()
    B, S = 2, 48
    x = np.random.default_rng(3).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S)[None, :]
    rspec = RC.AttnSpec(q_block=16, kv_block=16)
    ry, (rlat, rkr) = RA.apply_mla(rp, jnp.asarray(x), rcfg,
                                   jnp.asarray(pos), rspec)
    with torch.no_grad():
        y, (lat, kr) = A.apply_mla(p, torch.from_numpy(x), cfg,
                                   torch.from_numpy(pos),
                                   C.AttnSpec(q_block=16, kv_block=16))
    assert y.shape == (B, S, cfg.d_model)
    assert lat.shape == (B, S, cfg.kv_lora_rank)
    assert kr.shape == (B, S, cfg.qk_rope_dim)
    for got, want in ((y, ry), (lat, rlat), (kr, rkr)):
        assert _rel(got.numpy(), np.asarray(want)) < 1e-5


def test_mla_decode_matches_reference_and_writes_the_cache_in_place():
    rcfg, cfg, rp, p = _mla_setup(seed=1)
    B, S_max, steps = 2, 16, 12
    xs = np.random.default_rng(4).standard_normal(
        (steps, B, 1, cfg.d_model)).astype(np.float32)
    rlat = jnp.zeros((B, S_max, cfg.kv_lora_rank))
    rkr = jnp.zeros((B, S_max, cfg.qk_rope_dim))
    lat = torch.zeros((B, S_max, cfg.kv_lora_rank))
    kr = torch.zeros((B, S_max, cfg.qk_rope_dim))
    spec = C.AttnSpec()
    for pos in range(steps):
        ry, rlat, rkr = RA.mla_decode(rp, jnp.asarray(xs[pos]), rcfg,
                                      jnp.int32(pos), rlat, rkr,
                                      RC.AttnSpec())
        with torch.no_grad():
            y, lat2, kr2 = A.mla_decode(p, torch.from_numpy(xs[pos]), cfg,
                                        pos, lat, kr, spec)
        assert lat2 is lat and kr2 is kr
        assert y.shape == (B, 1, cfg.d_model)
        assert _rel(y.numpy(), np.asarray(ry)) < 1e-5, pos
    assert _rel(lat.numpy(), np.asarray(rlat)) < 1e-5
    assert _rel(kr.numpy(), np.asarray(rkr)) < 1e-5
    assert float(lat[:, steps:].abs().max()) == 0.0
