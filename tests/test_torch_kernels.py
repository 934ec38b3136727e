"""Kernels K1 and K2: wrappers and plain versions, and (marked ``gpu``) each
kernel against its plain version on a CUDA device.

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
