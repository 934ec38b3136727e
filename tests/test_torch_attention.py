"""Kernel K2's plain version and the port's blocked attention against the
JAX reference.

* K2's plain version (``repro_torch.kernels.flash_attention``) against the
  reference's Pallas kernel in interpret mode
  (``repro.kernels.ops.flash_attention``), on the shapes, dtypes and
  variants of tests/test_kernels.py: f32 within 2e-5, bf16 within 0.035.
* The port's ``blocked_attention`` forward, and the lse it saves for the
  backward, against the reference's blocked forward ``_forward``.
* The port's ``blocked_attention`` gradients against ``jax.grad`` of the
  reference's custom VJP, in f32, within 1e-4 of the largest gradient.

Inputs come from a numpy seed and go to both packages; the port runs on the
CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.models import attention_core as RC

from repro_torch.configs.registry import ARCHS
from repro_torch.kernels.flash_attention import (bound_ms, flash_attention,
                                                 flash_attention_reference,
                                                 tma_strides, unmasked_pairs,
                                                 variant_for)
from repro_torch.models import attention as A
from repro_torch.models import attention_core as C

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401


def _qkv(seed, B, S, H, KV, D, Skv=None):
    rng = np.random.default_rng(seed)
    Skv = S if Skv is None else Skv
    return (rng.standard_normal((B, S, H, D), np.float32),
            rng.standard_normal((B, Skv, KV, D), np.float32),
            rng.standard_normal((B, Skv, KV, D), np.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


# -- K2's plain version against the Pallas kernel (interpret mode) -----------

@pytest.mark.parametrize("B,S,H,KV,D", [
    (1, 128, 4, 4, 64), (2, 256, 6, 2, 64), (1, 256, 8, 1, 128),
    (2, 128, 2, 2, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_pallas_kernel(B, S, H, KV, D, dtype):
    q, k, v = _qkv(0, B, S, H, KV, D)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    exp = ops.flash_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                              jnp.asarray(v, jd), block_q=64, block_k=64)
    out = flash_attention(_t(q, td), _t(k, td), _t(v, td))
    tol = 0.035 if dtype == "bfloat16" else 2e-5
    assert out.dtype == td and tuple(out.shape) == exp.shape
    err = np.abs(out.float().numpy()
                 - np.asarray(exp.astype(jnp.float32))).max()
    assert err < tol


@pytest.mark.parametrize("kw", [dict(window=100), dict(softcap=20.0),
                                dict(causal=False),
                                dict(window=64, softcap=10.0)])
def test_plain_version_variants_match_pallas_kernel(kw):
    q, k, v = _qkv(1, 2, 256, 4, 2, 32)
    exp = ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              block_q=64, block_k=64, **kw)
    out = flash_attention(_t(q), _t(k), _t(v), **kw)
    assert np.abs(out.numpy() - np.asarray(exp)).max() < 2e-5


@pytest.mark.parametrize("Sq,Skv", [(128, 256), (256, 128), (128, 384)])
@pytest.mark.parametrize("kw", [dict(), dict(window=100), dict(causal=False),
                                dict(softcap=20.0)])
def test_plain_version_matches_pallas_kernel_at_unequal_lengths(Sq, Skv, kw):
    """q and k/v of different lengths, at G = 3 (6 q heads, 2 kv heads):
    positions count from 0 on both sides, as the Pallas kernel's do."""
    q, k, v = _qkv(2, 1, Sq, 6, 2, 32, Skv=Skv)
    exp = ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              block_q=64, block_k=64, **kw)
    out = flash_attention(_t(q), _t(k), _t(v), **kw)
    assert tuple(out.shape) == exp.shape == (1, Sq, 6, 32)
    assert np.abs(out.numpy() - np.asarray(exp)).max() < 2e-5


def test_wrapper_on_cpu_runs_plain_version_without_launch():
    q, k, v = (_t(a) for a in _qkv(2, 1, 64, 4, 2, 16))
    before = flash_attention.launches
    by_variant = dict(flash_attention.launches_by_variant)
    out, lse = flash_attention(q, k, v, window=8, softcap=5.0,
                               return_lse=True)
    assert flash_attention.launches == before
    assert flash_attention.launches_by_variant == by_variant
    ref_out, ref_lse = flash_attention_reference(q, k, v, window=8,
                                                 softcap=5.0)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert lse.shape == (1, 64, 4) and lse.dtype == torch.float32
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :1].expand(1, 64, 3, 16), v)
    with pytest.raises(ValueError):
        flash_attention(q[0], k, v)


#: the attention models of the repo, with their head dims 64, 128 and 256
ATTENTION_ARCHS = ["gemma2-2b", "granite-34b", "phi3-medium-14b",
                   "starcoder2-3b", "llama4-maverick-400b-a17b",
                   "internvl2-1b", "musicgen-medium"]


@pytest.mark.parametrize("arch", ATTENTION_ARCHS + ["deepseek-v2-lite-16b"])
def test_model_qkv_in_bf16_takes_the_wgmma_variant(arch):
    """The q/k/v that the port's attention block hands K2 (projections and
    RoPE at the model's heads and head dim, bf16; MLA's materialized q/k at
    192 and v at 128) go to the wgmma kernel, and their layouts pass its
    TMA check."""
    cfg = ARCHS[arch]
    if cfg.attention == "mla":
        seen = []

        def impl(q, k, v, spec):
            seen.append((q, k, v, spec))
            return torch.zeros(v.shape, dtype=v.dtype)
        g = torch.Generator().manual_seed(0)
        p = A.init_mla(g, cfg.with_overrides(d_model=32), torch.bfloat16)
        x = torch.randn((2, 8, 32), generator=g).bfloat16()
        A.apply_mla(p, x, cfg, torch.arange(8)[None], A.AttnSpec(), impl)
        (q, k, v, spec), = seen
        assert spec.scale == 192 ** -0.5
        assert (q.shape[-1], v.shape[-1]) == (192, 128)
        assert variant_for(q.dtype, 192, 128) == "wgmma"
        for t in (q, k, v):
            assert t.dtype == torch.bfloat16
            assert tma_strides(t)[1:] == (16 * t.shape[-1], t.shape[-1])
        return
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator().manual_seed(0)
    width = 32                     # the model's width does not enter
    p = {name: torch.randn((width, n, D), generator=g).bfloat16()
         for name, n in (("wq", H), ("wk", KV), ("wv", KV))}
    x = torch.randn((2, 8, width), generator=g).bfloat16()
    q, k, v = A._qkv(p, x, cfg, torch.arange(8))
    assert {t.dtype for t in (q, k, v)} == {torch.bfloat16}
    assert variant_for(q.dtype, D) == "wgmma"
    for t, heads in ((q, H), (k, KV), (v, KV)):
        assert tma_strides(t)[1:] == (heads * D, D)


def test_plain_version_lse_is_the_log_partition():
    q, k, v = (_t(a) for a in _qkv(3, 1, 32, 2, 1, 16))
    _, lse = flash_attention_reference(q, k, v, softcap=7.0)
    s = torch.einsum("bthd,bshd->bths", q, k.expand(1, 32, 2, 16)) / 4.0
    s = torch.tanh(s / 7.0) * 7.0
    causal = torch.ones(32, 32, dtype=torch.bool).tril()
    s = s.masked_fill(~causal[None, :, None, :], -1e30)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("causal,window,q_offset,kv_len", [
    (True, 0, 0, None), (True, 100, 0, None), (False, 0, 0, None),
    (False, 10, 0, None), (True, 7, 30, 50), (True, 4096, 0, None)])
def test_unmasked_pairs_counts_the_mask(causal, window, q_offset, kv_len):
    Sq, Skv = 48, 64
    qpos = q_offset + np.arange(Sq)[:, None]
    kpos = np.arange(Skv)[None, :]
    m = np.ones((Sq, Skv), bool)
    if causal:
        m &= qpos >= kpos
    if window:
        m &= qpos - kpos < window
    if kv_len is not None:
        m &= kpos < kv_len
    assert unmasked_pairs(Sq, Skv, causal, window, q_offset, kv_len) \
        == int(m.sum())


def test_bound_counts_causal_and_window_pairs():
    q = torch.empty((1, 8192, 8, 256), dtype=torch.bfloat16)
    k = torch.empty((1, 8192, 4, 256), dtype=torch.bfloat16)
    full, by = bound_ms(q, k, window=0)
    pairs = 8192 * 8193 // 2
    assert by == "operations"
    assert full == pytest.approx(4 * 256 * 8 * pairs / 989e12 * 1e3)
    local, _ = bound_ms(q, k, window=4096)
    assert local < full


# -- the port's blocked forward and backward ----------------------------------

SPECS = [
    pytest.param(dict(), id="causal"),
    pytest.param(dict(window=40), id="window"),
    pytest.param(dict(softcap=20.0), id="softcap"),
    pytest.param(dict(window=40, softcap=20.0), id="window+softcap"),
    pytest.param(dict(causal=False), id="noncausal"),
]


@pytest.mark.parametrize("kw", SPECS)
def test_blocked_forward_and_lse_match_reference(kw):
    q, k, v = _qkv(4, 2, 128, 4, 2, 32)
    rspec = RC.AttnSpec(q_block=32, kv_block=32, **kw)
    spec = C.AttnSpec(q_block=32, kv_block=32, **kw)
    r_out, r_lse = RC._forward(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), rspec, 0, None)
    out = C.blocked_attention(_t(q), _t(k), _t(v), spec)
    # the forward blocked_attention runs, with the lse it saves
    lse = flash_attention(_t(q), _t(k), _t(v), return_lse=True, **kw)[1]
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(r_lse).reshape(2, 128, 4), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("kw", SPECS)
def test_blocked_gradients_match_reference(kw):
    q, k, v = _qkv(5, 1, 128, 4, 2, 32)
    dout = np.random.default_rng(6).standard_normal(q.shape, np.float32)
    rspec = RC.AttnSpec(q_block=32, kv_block=32, **kw)
    spec = C.AttnSpec(q_block=32, kv_block=32, **kw)

    def rloss(a, b, c):
        return jnp.sum(RC.blocked_attention(a, b, c, rspec)
                       * jnp.asarray(dout))
    rg = jax.grad(rloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    ts = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out = C.blocked_attention(*ts, spec)
    grads = torch.autograd.grad((out * _t(dout)).sum(), ts)
    for name, g, r in zip("qkv", grads, rg):
        r = np.asarray(r)
        rel = np.abs(g.numpy() - r).max() / np.abs(r).max()
        assert rel < 1e-4, (name, rel)


def test_blocked_attention_on_cpu_equals_plain_k2():
    q, k, v = (_t(a) for a in _qkv(7, 1, 64, 4, 1, 16))
    spec = C.AttnSpec(window=20, softcap=30.0, q_block=16, kv_block=16)
    out = C.blocked_attention(q, k, v, spec)
    ref = flash_attention_reference(q, k, v, window=20, softcap=30.0)[0]
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-6)

