"""The MoE combine in a fixed order and the expert slice of
``models.moe._moe_local``, against the JAX reference on the CPU.

* ``combine``: each token's top-k rows, added one at a time in bf16 from
  zeros in the order of the reference's stable sort by expert, equals the
  reference's ``zeros.at[tid_s].add(...)`` bit for bit, at top_k 6 on
  values whose bf16 sum depends on the order (a reversed order, and an f32
  sum rounded once, both differ somewhere).
* ``_moe_local(p, x, cfg, e_start, e_count, capacity)`` on an expert slice
  gives the reference's partial output and stats; the slices' partial
  outputs add up to the whole layer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as R_ARCHS
from repro.configs.registry import reduced as r_reduced
from repro.models import moe as RM

from repro_torch.configs.registry import ARCHS, reduced
from repro_torch.models import moe as M

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401


def _bits(t):
    return t.view(torch.int16).numpy()


def _ref_combine(contrib_f32, tid_s, T):
    """The reference's combine line (``repro/models/moe.py:86``)."""
    c = jnp.asarray(contrib_f32, jnp.bfloat16)
    y = jnp.zeros((T, c.shape[1]), jnp.bfloat16).at[jnp.asarray(tid_s)] \
        .add(c)
    return torch.from_numpy(np.array(y.astype(jnp.float32))) \
        .to(torch.bfloat16)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_combine_is_the_reference_bit_for_bit_in_bf16(seed):
    rng = np.random.default_rng(seed)
    T, k, E, d = 96, 6, 16, 48
    # each token's k distinct experts, sorted stably by expert as route()
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    eid = idx.reshape(-1)
    tid = np.repeat(np.arange(T), k)
    order = np.argsort(eid, kind="stable")
    tid_s = tid[order]
    # magnitudes over 2^12: bf16 sums depend on the order
    contrib = (rng.standard_normal((T * k, d))
               * np.exp2(rng.integers(-6, 7, (T * k, 1)))).astype(np.float32)
    c = torch.from_numpy(contrib).to(torch.bfloat16)
    got = M.combine(c, torch.from_numpy(tid_s), T, k)
    want = _ref_combine(c.float().numpy(), tid_s, T)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the order matters on these values: reversed, or f32 rounded once
    rev = _ref_combine(c.float().numpy()[::-1], tid_s[::-1], T)
    once = torch.zeros((T, d)).index_add(0, torch.from_numpy(tid_s),
                                         c.float()).to(torch.bfloat16)
    assert (_bits(rev) != _bits(want)).any()
    assert (_bits(once) != _bits(want)).any()


def test_moe_layer_in_bf16_uses_the_fixed_order():
    """``apply_moe``'s combine is ``combine`` on the sort's rows (no
    atomics): the same call twice gives the same bits."""
    cfg = reduced(ARCHS["deepseek-v2-lite-16b"]).with_overrides(
        top_k=6, num_experts=16, dtype="bfloat16", param_dtype="bfloat16")
    p = M.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    y1, s1 = M.apply_moe(p, x, cfg)
    y2, s2 = M.apply_moe(p, x, cfg)
    np.testing.assert_array_equal(_bits(y1), _bits(y2))
    assert torch.equal(s1, s2)


@pytest.mark.parametrize("e_start,e_count", [(0, 8), (0, 2), (2, 2),
                                             (6, 2), (4, 4)])
def test_expert_slice_matches_reference(e_start, e_count):
    rcfg = r_reduced(R_ARCHS["deepseek-v2-lite-16b"])
    cfg = reduced(ARCHS["deepseek-v2-lite-16b"])
    rp = RM.init_moe(jax.random.PRNGKey(1), rcfg)
    sl = slice(e_start, e_start + e_count)
    rps = {"router": rp["router"], "wi": rp["wi"][sl], "wo": rp["wo"][sl]}
    p = {k: torch.from_numpy(np.array(v)) for k, v in rps.items()}
    x = np.random.default_rng(2).standard_normal(
        (128, cfg.d_model)).astype(np.float32)
    cap = M._capacity(128, cfg)
    ry, rstats = RM._moe_local(rps, jnp.asarray(x), rcfg, e_start, e_count,
                               cap)
    y, stats = M._moe_local(p, torch.from_numpy(x), cfg, e_start, e_count,
                            cap)
    ry = np.asarray(ry)
    assert np.abs(y.numpy() - ry).max() <= 1e-5 * max(np.abs(ry).max(), 1)
    np.testing.assert_array_equal(stats[:8].numpy(), np.asarray(rstats)[:8])
    assert np.abs(stats[8:].numpy() - np.asarray(rstats)[8:]).max() < 1e-5


def test_expert_slices_add_up_to_the_layer():
    cfg = reduced(ARCHS["deepseek-v2-lite-16b"])
    p = M.init_moe(torch.Generator().manual_seed(4), cfg)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (64, cfg.d_model)).astype(np.float32))
    cap = M._capacity(64, cfg)
    whole, _ = M._moe_local(p, x, cfg, 0, 8, cap)
    parts = sum(M._moe_local({"router": p["router"],
                              "wi": p["wi"][e:e + 2], "wo": p["wo"][e:e + 2]},
                             x, cfg, e, 2, cap)[0] for e in range(0, 8, 2))
    assert float((parts - whole).abs().max()) < 1e-5
