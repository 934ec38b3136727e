"""Kernels K1, K2 and K3: wrappers and plain versions, and (marked ``gpu``)
each kernel against its plain version on a CUDA device.

This file imports neither JAX nor the reference package, so it also runs on
the card's machine:  ``python -m pytest -q -m gpu tests/test_torch_kernels.py``.
Without a CUDA device the ``gpu`` tests skip.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_reference)
from repro_torch.kernels.pattern_summary import (bound_ms, pattern_summary,
                                                 pattern_summary_reference,
                                                 threads_for)
from repro_torch.kernels.ssd_scan import (ssd_oracle, ssd_scan,
                                          ssd_scan_reference)

from _torch_inputs import EDGE_EXPECTED, case, edge_rows, long_row, matrices
# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401

ATOL = 1e-5   # kernel vs plain version: float64 sums in another order


def test_plain_version_on_edge_rows():
    out = pattern_summary_reference(torch.from_numpy(edge_rows())).numpy()
    np.testing.assert_allclose(out, np.array(EDGE_EXPECTED), rtol=0,
                               atol=1e-7)


def test_plain_version_is_padding_inert():
    u = case(5, 24, 512)
    padded = np.concatenate([u, np.zeros((24, 300), np.float32)], axis=1)
    a = pattern_summary_reference(torch.from_numpy(u)).numpy()
    b = pattern_summary_reference(torch.from_numpy(padded)).numpy()
    nonzero = u.sum(axis=1) > 0          # all-zero rows report the width
    np.testing.assert_array_equal(a[nonzero], b[nonzero])


def test_wrapper_on_cpu_tensor_runs_plain_version_without_launch():
    u = torch.from_numpy(case(5, 24, 512))
    before = pattern_summary.launches
    out = pattern_summary(u)
    assert pattern_summary.launches == before
    assert out.dtype == torch.float64 and out.shape == (24, 3)
    np.testing.assert_array_equal(out.numpy(),
                                  pattern_summary_reference(u).numpy())
    assert pattern_summary(torch.zeros((0, 5))).shape == (0, 3)
    assert pattern_summary(torch.zeros((3, 0))).abs().sum() == 0
    with pytest.raises(ValueError):
        pattern_summary(torch.zeros(4))


def test_launch_geometry_and_bound():
    assert threads_for(1) == 32
    assert threads_for(121) == 32
    assert threads_for(211) == 64
    assert threads_for(1101) == 256 and threads_for(200000) == 256
    # bytes: E*n*4 read + E*3*8 written at 3.35 TB/s
    assert bound_ms(84384, 1101) == pytest.approx(
        (84384 * 1101 * 4 + 84384 * 24) / 3.35e12 * 1e3)


# -- on the card ----------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("stage", [None, False])
def test_k1_matches_plain_version_on_card(stage):
    _cuda()
    for u in matrices() + [long_row(200000, seed=5)]:
        t = torch.from_numpy(u).cuda()
        ref = pattern_summary_reference(t)
        before = pattern_summary.launches
        out = pattern_summary(t, stage=stage)
        torch.cuda.synchronize()
        assert pattern_summary.launches == before + 1
        assert torch.equal(out[:, 2], ref[:, 2])
        assert float((out[:, :2] - ref[:, :2]).abs().max()) <= ATOL


@pytest.mark.gpu
def test_k1_rejects_what_it_does_not_take():
    _cuda()
    u = torch.from_numpy(case(0, 16, 256)).cuda()
    with pytest.raises(TypeError):
        pattern_summary(u.double())
    with pytest.raises(ValueError):
        pattern_summary(u.t())
    with pytest.raises(ValueError):
        pattern_summary(torch.zeros((1, 300000), device="cuda"), stage=True)
    empty = pattern_summary(torch.zeros((0, 7), device="cuda"))
    assert empty.shape == (0, 3)


#: (B, Sq, Skv, H, KV, D, options): the shapes of tests/test_kernels.py, the
#: reduced and full gemma2-2b layers, ragged lengths, decode-style offsets
K2_CASES = [
    (1, 128, 128, 4, 4, 64, {}), (2, 256, 256, 6, 2, 64, {}),
    (1, 256, 256, 8, 1, 128, {}), (2, 128, 128, 2, 2, 32, {}),
    (2, 256, 256, 4, 2, 32, dict(window=100)),
    (2, 256, 256, 4, 2, 32, dict(softcap=20.0)),
    (2, 256, 256, 4, 2, 32, dict(causal=False)),
    (2, 256, 256, 4, 2, 32, dict(window=64, softcap=10.0)),
    (4, 32, 32, 4, 2, 16, dict(window=64, softcap=50.0, scale=0.0625)),
    (1, 1000, 1000, 8, 4, 256, dict(window=300, softcap=50.0,
                                    scale=0.0625)),
    (1, 16, 200, 4, 1, 64, dict(q_offset=150, kv_len=166)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 0.035)])
def test_k2_matches_plain_version_on_card(dtype, tol):
    _cuda()
    for i, (B, Sq, Skv, H, KV, D, kw) in enumerate(K2_CASES):
        g = torch.Generator(device="cuda").manual_seed(i)
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                   for shape in ((B, Sq, H, D), (B, Skv, KV, D),
                                 (B, Skv, KV, D)))
        ref, ref_lse = flash_attention_reference(q, k, v, **kw)
        before = flash_attention.launches
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        assert out.dtype == dtype and out.shape == ref.shape
        assert float((out.float() - ref.float()).abs().max()) < tol, i
        assert float((lse - ref_lse).abs().max()) < 1e-3, i


@pytest.mark.gpu
def test_k2_reads_strided_inputs_and_rejects_what_it_does_not_take():
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((2, 64, 4 + 2 + 2, 32), generator=g, device="cuda")
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    out = flash_attention(q, k, v, window=16)
    ref, _ = flash_attention_reference(q, k, v, window=16)
    assert float((out - ref).abs().max()) < 2e-5
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        flash_attention(q[..., :24], k[..., :24], v[..., :24])
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 3), k.transpose(1, 3),
                        v.transpose(1, 3))


#: (B, S, H, P, G, N, chunk): the SSD shapes of tests/test_kernels.py
K3_TEST_SHAPES = [(1, 64, 2, 16, 1, 8, 16), (2, 128, 4, 32, 2, 16, 32),
                  (1, 128, 4, 64, 4, 32, 64), (1, 32, 2, 16, 2, 16, 32)]
#: a ragged chunk (Q not a multiple of the kernel's 64-row tiles), the
#: longest chunk, and mamba2-2.7b's widths on fewer heads
K3_MODEL_SHAPES = [(2, 192, 3, 32, 3, 24, 96), (1, 1024, 1, 16, 1, 16, 1024),
                   (1, 512, 4, 64, 1, 128, 256)]


def _ssd(shape, seed, dtype, model_ranges=False):
    """x, B, C standard normal; dt and A as tests/test_kernels.py draws
    them, or from mamba2's init ranges (dt log-uniform in [1e-3, 0.1], A
    in [-16, -1])."""
    B, S, H, P, G, N, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=g, device="cuda")
    if model_ranges:
        u = torch.rand((B, S, H), generator=g, device="cuda")
        dt = torch.exp(u * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
        A = -(1.0 + 15.0 * torch.rand(H, generator=g, device="cuda"))
    else:
        dt = torch.nn.functional.softplus(randn(B, S, H))
        A = -torch.exp(torch.rand(H, generator=g, device="cuda"))
    return (randn(B, S, H, P).to(dtype), dt, A, randn(B, S, G, N).to(dtype),
            randn(B, S, G, N).to(dtype))


def _cum_step(dt, A, chunk: int) -> float:
    """float32's step at the largest ``|cumsum(dt * A)|`` within a chunk."""
    B, S, H = dt.shape
    Q = min(chunk, S)
    cum = (dt.double() * A.double()).reshape(B, S // Q, Q, H).cumsum(2)
    return float(np.spacing(np.float32(cum.abs().max().item())))


@pytest.mark.gpu
def test_k3_matches_plain_version_on_card():
    """f32, x, dt, A, B, C drawn as tests/test_kernels.py draws them: K3
    within 2e-5 of the largest output of its plain version on the
    reference's four shapes; K3 and its plain version each against the
    float64 oracle within the larger of 2e-5 and float32's step at the
    largest ``|cum|`` of the draw, relative to the largest output.  Both
    round ``cum = cumsum(dt * A)`` to that step, and an error of one step
    in ``cum`` moves ``exp(cum_t - cum_s)`` by that much relative:
    softplus(normal) dt over the 1024-row chunk reaches ``|cum|`` ~ 1200,
    a step of 1.2e-4.  bf16, dt and A from mamba2's init ranges:
    elementwise within one bf16 step of the plain version, 1e-3 + 2^-7
    |ref|, since both round an f32 sum to bf16."""
    _cuda()
    for i, shape in enumerate(K3_TEST_SHAPES + K3_MODEL_SHAPES):
        chunk = shape[-1]
        ins = _ssd(shape, i, torch.float32)
        ref = ssd_scan_reference(*ins, chunk)
        before = ssd_scan.launches
        out = ssd_scan.run(*ins, chunk)
        torch.cuda.synchronize()
        assert ssd_scan.launches == before + 1
        if shape in K3_TEST_SHAPES:
            err = float((out - ref).abs().max() / ref.abs().max())
            assert err < 2e-5, (shape, err)
        exact = ssd_oracle(*(t.double() for t in ins))
        limit = max(2e-5, _cum_step(ins[1], ins[2], chunk))
        for name, y in (("kernel", out), ("plain", ref)):
            err = float((y.double() - exact).abs().max() / exact.abs().max())
            assert err < limit, (shape, name, err, limit)
        ins = _ssd(shape, i, torch.bfloat16, model_ranges=True)
        ref = ssd_scan_reference(*ins, chunk).float()
        out = ssd_scan.run(*ins, chunk).float()
        assert bool(((out - ref).abs()
                     <= 1e-3 + 2.0 ** -7 * ref.abs()).all()), shape


@pytest.mark.gpu
def test_k3_overflow_case_is_finite_and_its_gradient_too():
    """dt 0.1 and A -16 over a chunk of 256: the upper triangle's decay
    difference overflows float32's exp; the kernel never takes it."""
    _cuda()
    x, _, _, Bm, Cm = _ssd((1, 512, 4, 64, 1, 128, 256), 0, torch.float32)
    dt = torch.full((1, 512, 4), 0.1, device="cuda")
    A = torch.full((4,), -16.0, device="cuda")
    ins = [t.requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    out = ssd_scan(*ins, 256)
    ref = ssd_scan_reference(*ins, 256).detach()
    assert torch.isfinite(out).all()
    assert float((out.detach() - ref).abs().max() / ref.abs().max()) < 2e-5
    grads = torch.autograd.grad(out.square().sum(), ins)
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.gpu
def test_k3_reads_strided_inputs_and_rejects_what_it_does_not_take():
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((2, 128, 4, 32), generator=g, device="cuda")
    bc = torch.randn((2, 128, 2, 2, 16), generator=g, device="cuda")
    Bm, Cm = bc[:, :, 0], bc[:, :, 1]            # strided views
    dt = torch.rand((2, 128, 4), generator=g, device="cuda")
    A = -torch.rand(4, generator=g, device="cuda") - 0.5
    out = ssd_scan.run(x, dt, A, Bm, Cm, 32)
    ref = ssd_scan_reference(x, dt, A, Bm, Cm, 32)
    assert float((out - ref).abs().max() / ref.abs().max()) < 2e-5
    with pytest.raises(TypeError):
        ssd_scan.run(x.half(), dt, A, Bm.half(), Cm.half(), 32)
    with pytest.raises(TypeError):
        ssd_scan.run(x, dt.double(), A, Bm, Cm, 32)
    with pytest.raises(ValueError):
        ssd_scan.run(x[..., :24], dt, A, Bm, Cm, 32)
    pairs = torch.randn((2, 128, 2, 16, 2), generator=g, device="cuda")
    with pytest.raises(ValueError):               # last dim not contiguous
        ssd_scan.run(x, dt, A, pairs[..., 0], pairs[..., 1], 32)
