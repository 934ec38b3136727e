"""Kernels K1, K2, K3 and K4: wrappers and plain versions, and (marked
``gpu``) each kernel against its plain version on a CUDA device.

This file imports neither JAX nor the reference package, so it also runs on
the card's machine:  ``python -m pytest -q -m gpu tests/test_torch_kernels.py``.
Without a CUDA device the ``gpu`` tests skip.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (HEAD_DIMS, MLA_HEAD_DIMS,
                                                 VARIANTS, flash_attention,
                                                 flash_attention_reference,
                                                 tma_strides, variant_for)
from repro_torch.kernels.flash_attention import bound_ms as k2_bound_ms
from repro_torch.kernels.pattern_summary import VARIANTS as K1_VARIANTS
from repro_torch.kernels.pattern_summary import (WARP_MAX_N, block_grid,
                                                 bound_ms, lane_samples_for,
                                                 pattern_summary,
                                                 pattern_summary_reference)
from repro_torch.kernels.pattern_summary import variant_for as k1_variant_for
from repro_torch.configs.registry import ARCHS, reduced
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import VARIANTS as K3_VARIANTS
from repro_torch.kernels.ssd_scan import (ssd_oracle, ssd_scan,
                                          ssd_scan_reference)
from repro_torch.kernels.ssd_scan import variant_for as k3_variant_for
from repro_torch.kernels import rms_norm as K4

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
    # warp variant: ceil(n / 32) samples a lane, rounded up to an
    # instantiated count; the fleet's groups at 121, 211 and 1101
    assert lane_samples_for(1) == 1 and lane_samples_for(32) == 1
    assert lane_samples_for(33) == 2
    assert lane_samples_for(121) == 4
    assert lane_samples_for(211) == 8
    assert lane_samples_for(1101) == 40
    assert lane_samples_for(2048) == 64 and WARP_MAX_N == 2048
    with pytest.raises(ValueError):
        lane_samples_for(2049)
    # block variant: a persistent grid of two blocks an SM, one a row at most
    assert block_grid(3, 132) == 3 and block_grid(84384, 132) == 264
    # bytes: E*n*4 read + E*3*8 written at 3.35 TB/s
    assert bound_ms(84384, 1101) == pytest.approx(
        (84384 * 1101 * 4 + 84384 * 24) / 3.35e12 * 1e3)


@pytest.mark.parametrize("n,want", [
    (1, "warp"), (121, "warp"), (211, "warp"), (1101, "warp"),
    (2048, "warp"), (2049, "block"), (40000, "block"), (200000, "block")])
def test_k1_variant_rule(n, want):
    """Rows up to 2048 samples (every fleet group) take the warp variant,
    longer rows the block variant."""
    assert k1_variant_for(n) == want and want in K1_VARIANTS


def test_k1_rejects_unknown_and_impossible_variants_without_launch():
    """On any device: an unknown name, and the warp variant forced on rows
    past its cap, raise before anything runs; the block variant takes any
    row (on the CPU, the plain version)."""
    before = (pattern_summary.launches,
              dict(pattern_summary.launches_by_variant))
    with pytest.raises(ValueError, match="variants"):
        pattern_summary(torch.zeros((2, 5)), variant="simt")
    with pytest.raises(ValueError, match="at most 2048"):
        pattern_summary(torch.zeros((2, WARP_MAX_N + 1)), variant="warp")
    u = torch.from_numpy(case(5, 24, 512))
    for variant in K1_VARIANTS:
        assert torch.equal(pattern_summary(u, variant=variant),
                           pattern_summary_reference(u))
    assert (pattern_summary.launches,
            pattern_summary.launches_by_variant) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_k2_variant_rule(dtype, D):
    """bf16 at D 64/112/128/256 runs the wgmma kernel; f32, and bf16 at
    D 16 and 32, the SIMT kernel."""
    want = "wgmma" if dtype == torch.bfloat16 and D >= 64 else "simt"
    assert variant_for(dtype, D) == want and want in VARIANTS


def test_k2_variant_rule_rejects_what_k2_does_not_take():
    for D in (0, 8, 48, 96, 120, 192, 512):
        with pytest.raises(ValueError):
            variant_for(torch.bfloat16, D)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            variant_for(dtype, 64)


def test_k2_variant_rule_at_mla_head_dims():
    """q/k at 192 with v at 128 (deepseek-v2's materialized MLA) runs the
    wgmma kernel in bf16; f32 there, and every other pair with D != Dv,
    raise ValueError naming the pair."""
    assert MLA_HEAD_DIMS == (192, 128)
    assert variant_for(torch.bfloat16, 192, 128) == "wgmma"
    assert variant_for(torch.bfloat16, 128, 128) == "wgmma"
    assert variant_for(torch.float32, 64, 64) == "simt"
    for dtype, D, Dv in ((torch.float32, 192, 128), (torch.bfloat16, 128, 64),
                         (torch.bfloat16, 192, 192), (torch.bfloat16, 24, 16),
                         (torch.bfloat16, 128, 192)):
        with pytest.raises(ValueError, match=f"\\({D}, {Dv}\\)"):
            variant_for(dtype, D, Dv)


def test_k2_at_zamba2_head_dim():
    """zamba2-7b's shared attention (32 heads of 112, 32 kv heads): bf16
    on the wgmma kernel, f32 on the SIMT kernel, and its layer's bound at
    2048 tokens, causal, window 4096 (wider than the sequence): 2 098 176
    unmasked pairs x 32 heads x 4 x 112 FLOPs = 30.08 GFLOP at 989
    TFLOP/s, against 59.0 MB at 3.35 TB/s.  The bound counts the real head
    dim, not the 128-wide tiles it runs on."""
    assert ARCHS["zamba2-7b"].head_dim == 112
    assert variant_for(torch.bfloat16, 112) == "wgmma"
    assert variant_for(torch.bfloat16, 112, 112) == "wgmma"
    assert variant_for(torch.float32, 112) == "simt"
    q = torch.empty((1, 2048, 32, 112), dtype=torch.bfloat16, device="meta")
    ms, by = k2_bound_ms(q, q, window=4096)
    flops = 2048 * 2049 // 2 * 32 * 4 * 112
    assert flops == 30_079_451_136
    assert by == "operations"
    assert ms == pytest.approx(flops / 989e12 * 1e3, rel=1e-12)
    assert ms == pytest.approx(0.0304, abs=5e-5)
    nbytes = 4 * 2048 * 32 * 112 * 2 + 2048 * 32 * 4
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(0.0176, abs=5e-5)


def test_tma_strides_of_dense_fused_and_degenerate_layouts():
    dense = torch.zeros((2, 64, 8, 64), dtype=torch.bfloat16)
    assert tma_strides(dense) == (64 * 8 * 64, 8 * 64, 64)
    fused = torch.zeros((2, 64, 4 + 2 + 2, 64), dtype=torch.bfloat16)
    assert tma_strides(fused[:, :, 4:6]) == (64 * 8 * 64, 8 * 64, 64)
    # size-1 dims take a dense stride, whatever torch reports for them
    one = torch.zeros((1, 10, 1, 128), dtype=torch.bfloat16)
    assert tma_strides(one.as_strided(one.shape, (3, 128, 5, 1))) == \
        (10 * 128, 128, 128)
    # MLA's concatenated q/k (384-byte rows) and its v (256-byte rows)
    qk = torch.zeros((4, 48, 16, 192), dtype=torch.bfloat16)
    assert tma_strides(qk) == (48 * 16 * 192, 16 * 192, 192)
    v = torch.zeros((4, 48, 16, 128), dtype=torch.bfloat16)
    assert tma_strides(v) == (48 * 16 * 128, 16 * 128, 128)


@pytest.mark.parametrize("offset,strides", [
    (1, (64 * 8 * 64, 8 * 64, 64, 1)),        # base 2 bytes off 16
    (4, (64 * 8 * 64, 8 * 64, 64, 1)),        # base 8 bytes off 16
    (0, (64 * 8 * 64, 8 * 64 + 1, 64, 1)),    # seq stride 1026 bytes
    (0, (64 * 8 * 64, 8 * 64, 60, 1)),        # head stride 120 bytes
    (0, (64 * 8 * 64 + 4, 8 * 64, 64, 1)),    # batch stride off 16
    (0, (64 * 8 * 64, 0, 64, 1)),             # broadcast seq: stride 0
    (0, (64 * 8 * 64, 8 * 64, 64, 2)),        # head dim not contiguous
])
def test_tma_strides_rejects_misaligned_operands(offset, strides):
    base = torch.zeros(2 * 64 * 8 * 64 * 2 + 64, dtype=torch.bfloat16)
    t = base.as_strided((2, 64, 8, 64), strides, offset)
    with pytest.raises(ValueError):
        tma_strides(t)


def test_library_path_changes_with_a_header(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` (sm90.cuh, included by K2 and K3) rebuilds
    every kernel: the library's path hashes the headers beside the source."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    src, header = tmp_path / "k.cu", tmp_path / "sm90.cuh"
    src.write_text('#include "sm90.cuh"\n')
    header.write_text("// v1\n")
    first = _build.library_path(src, "k")
    assert first.parent == tmp_path / "_build"
    assert _build.library_path(src, "k") == first
    header.write_text("// v2\n")
    second = _build.library_path(src, "k")
    assert second != first
    src.write_text('#include "sm90.cuh"\n// edited\n')
    assert _build.library_path(src, "k") not in (first, second)


def _ssm_shape(cfg, seq: int):
    """(P, N, Q) of one SSM layer of ``cfg`` at ``seq`` tokens."""
    return cfg.ssm_head_dim, cfg.ssm_state, min(cfg.ssm_chunk, seq)


@pytest.mark.parametrize("dtype,shape,want", [
    (torch.bfloat16, _ssm_shape(ARCHS["mamba2-2.7b"], 2048), "wgmma"),
    (torch.bfloat16, _ssm_shape(ARCHS["zamba2-7b"], 2048), "wgmma"),
    (torch.bfloat16, (128, 256, 64), "wgmma"),
    (torch.bfloat16, (64, 192, 192), "wgmma"),
    (torch.float32, _ssm_shape(ARCHS["mamba2-2.7b"], 2048), "simt"),
    (torch.float32, (128, 64, 128), "simt"),
    (torch.bfloat16, _ssm_shape(reduced(ARCHS["mamba2-2.7b"]), 64), "simt"),
    (torch.bfloat16, (32, 16, 32), "simt"),        # kernel-test shape
    (torch.bfloat16, (32, 24, 96), "simt"),        # ragged N and chunk
    (torch.bfloat16, (16, 16, 1024), "simt"),      # the longest chunk
    (torch.bfloat16, (64, 128, 96), "simt"),       # Q not a multiple of 64
    (torch.bfloat16, (64, 320, 256), "simt"),      # N past 256
    (torch.bfloat16, (256, 128, 256), "simt"),     # P past 128
    (torch.bfloat16, (192, 128, 256), "simt"),     # P 192
])
def test_k3_variant_rule(dtype, shape, want):
    """bf16 at mamba2-2.7b's and zamba2-7b's layers (P 64; N 128 or 64;
    chunk 256) and other multiples of 64 up to (128, 256, 256) run the
    wgmma variant; f32 at any shape and the reduced or ragged shapes the
    SIMT kernel."""
    assert k3_variant_for(dtype, *shape) == want and want in K3_VARIANTS


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int32])
def test_k3_variant_rule_rejects_what_k3_does_not_take(dtype):
    with pytest.raises(TypeError):
        k3_variant_for(dtype, 64, 128, 256)


def test_k3_cpu_path_counts_no_launch():
    """A CPU tensor at a wgmma shape runs the plain version and counts no
    launch, by variant or in total."""
    g = np.random.default_rng(0)
    B, S, H, P, G, N, Q = 1, 128, 2, 64, 1, 64, 64
    x = torch.from_numpy(g.standard_normal((B, S, H, P),
                                           dtype=np.float32)).bfloat16()
    Bm = torch.from_numpy(g.standard_normal((B, S, G, N),
                                            dtype=np.float32)).bfloat16()
    Cm = torch.from_numpy(g.standard_normal((B, S, G, N),
                                            dtype=np.float32)).bfloat16()
    dt = torch.from_numpy(g.uniform(1e-3, 0.1, (B, S, H)).astype(np.float32))
    A = -torch.from_numpy(g.uniform(1, 16, H).astype(np.float32))
    assert k3_variant_for(x.dtype, P, N, Q) == "wgmma"
    total, before = ssd_scan.launches, dict(ssd_scan.launches_by_variant)
    y = ssd_scan.run(x, dt, A, Bm, Cm, Q)
    assert ssd_scan.launches == total
    assert ssd_scan.launches_by_variant == before
    assert torch.equal(y, ssd_scan_reference(x, dt, A, Bm, Cm, Q))


# -- on the card ----------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("variant", [None, "warp", "block"])
def test_k1_matches_plain_version_on_card(variant):
    """Every input under the rule (None) and each variant that takes it;
    one-run rows at every offset (the fleet's rows) beside the random,
    edge, long and sparse ones."""
    _cuda()
    one_run = np.zeros((64, 1101), np.float32)
    for r in range(64):
        a = 17 * r
        one_run[r, a:a + 1 + (r * 131) % (1101 - a)] = 0.25 + r / 128
    for u in matrices() + [long_row(200000, seed=5), one_run]:
        ran = k1_variant_for(u.shape[1]) if variant is None else variant
        if ran == "warp" and u.shape[1] > WARP_MAX_N:
            continue
        t = torch.from_numpy(u).cuda()
        ref = pattern_summary_reference(t)
        before = pattern_summary.launches_by_variant[ran]
        out = pattern_summary(t, variant=variant)
        torch.cuda.synchronize()
        assert pattern_summary.launches_by_variant[ran] == before + 1
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
        pattern_summary(torch.zeros((1, 3000), device="cuda"), variant="warp")
    with pytest.raises(ValueError):
        pattern_summary(u, variant="tile")
    empty = pattern_summary(torch.zeros((0, 7), device="cuda"))
    assert empty.shape == (0, 3)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["warp", "block"])
def test_k1_failed_launch_raises_and_counts_nothing(variant, monkeypatch):
    """A launch that returns a CUDA error raises; nothing falls back to the
    other variant or to the plain version."""
    _cuda()
    lib = pattern_summary.library()

    class Failing:
        k1_stage_limit = lib.k1_stage_limit
        k1_error_string = lib.k1_error_string

        def k1_warp(self, *args):
            return 1                    # cudaErrorInvalidValue

        k1_block = k1_warp

    monkeypatch.setattr(pattern_summary, "_lib", Failing())
    before = dict(pattern_summary.launches_by_variant)
    with pytest.raises(RuntimeError, match=f"{variant} launch"):
        pattern_summary(torch.ones((4, 64), device="cuda"), variant=variant)
    assert pattern_summary.launches_by_variant == before


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
    # an odd number of q heads per kv head (one head a block at D >= 64),
    # windowed and capped: the block's second 64 rows see kv tiles that
    # the window empties for them
    (2, 300, 300, 3, 1, 64, dict(window=90, softcap=20.0)),
    (1, 300, 300, 5, 1, 128, dict(window=100, softcap=30.0)),
    (1, 300, 300, 3, 1, 256, dict(window=64, softcap=50.0)),
]


def _k2_inputs(i, shape_q, shape_kv, dtype):
    g = torch.Generator(device="cuda").manual_seed(i)
    return (torch.randn(shape_q, generator=g, device="cuda").to(dtype),
            torch.randn(shape_kv, generator=g, device="cuda").to(dtype),
            torch.randn(shape_kv, generator=g, device="cuda").to(dtype))


def _bf16_within_limits(out, ref, lse, ref_lse):
    """The bf16 limits: 0.035 at most, elementwise 1e-3 + 2^-7 |ref| (one
    bf16 step), lse within 1e-3."""
    diff = (out.float() - ref.float()).abs()
    return (float(diff.max()) < 0.035
            and bool((diff <= 1e-3 + 2.0 ** -7 * ref.float().abs()).all())
            and float((lse - ref_lse).abs().max()) < 1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 0.035)])
def test_k2_matches_plain_version_on_card(dtype, tol):
    """Every case on the variant ``variant_for`` names: in bf16 at D >= 64
    the wgmma kernel (the ragged 1000-token layer with window 300 and
    softcap 50, the q_offset/kv_len case, GQA, MQA, odd G with a window),
    held elementwise to one bf16 step as well."""
    _cuda()
    for i, (B, Sq, Skv, H, KV, D, kw) in enumerate(K2_CASES):
        q, k, v = _k2_inputs(i, (B, Sq, H, D), (B, Skv, KV, D), dtype)
        ref, ref_lse = flash_attention_reference(q, k, v, **kw)
        variant = variant_for(dtype, D)
        total = flash_attention.launches
        before = dict(flash_attention.launches_by_variant)
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        assert flash_attention.launches == total + 1
        assert flash_attention.launches_by_variant == dict(
            before, **{variant: before[variant] + 1}), i
        assert out.dtype == dtype and out.shape == ref.shape
        assert float((out.float() - ref.float()).abs().max()) < tol, i
        assert float((lse - ref_lse).abs().max()) < 1e-3, i
        if dtype == torch.bfloat16:
            assert _bf16_within_limits(out, ref, lse, ref_lse), i


#: (B, S, causal, options) of K2 at MLA's (192, 128), 16 heads: the serve
#: forward's 4 x 48 tokens, a length that is no multiple of the 64-row kv
#: tile, and an offset cache read
K2_MLA_CASES = [(4, 48, {}), (1, 200, {}), (2, 130, dict(causal=False)),
                (1, 300, dict(window=100))]


@pytest.mark.gpu
def test_k2_at_mla_head_dims_matches_plain_version_on_card():
    """bf16 q/k (B, S, 16, 192) and v (B, S, 16, 128) on the wgmma kernel,
    the output (B, S, 16, 128) within one bf16 step of the plain version
    and lse within 1e-3; f32 at those dims raises before any launch."""
    _cuda()
    for i, (B, S, kw) in enumerate(K2_MLA_CASES):
        g = torch.Generator(device="cuda").manual_seed(40 + i)
        q, k = (torch.randn((B, S, 16, 192), generator=g, device="cuda")
                .bfloat16() for _ in range(2))
        v = torch.randn((B, S, 16, 128), generator=g, device="cuda").bfloat16()
        kw = dict(kw, scale=192 ** -0.5)
        before = flash_attention.launches_by_variant["wgmma"]
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        ref, ref_lse = flash_attention_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        assert flash_attention.launches_by_variant["wgmma"] == before + 1
        assert out.shape == (B, S, 16, 128)
        assert _bf16_within_limits(out, ref, lse, ref_lse), i
    before = flash_attention.launches
    with pytest.raises(ValueError, match="192, 128"):
        flash_attention(q.float(), k.float(), v.float())
    assert flash_attention.launches == before


#: (B, S, H, KV, options) of K2 at head dim 112 (zamba2-7b: 32 heads, 32
#: kv heads, window 4096): its training layer, the serve forward's 4 x 48,
#: a length that is no multiple of the 64-row kv tile, 8192 tokens on 4
#: heads where the window bites, and an even G (two heads a block)
K2_112_CASES = [(1, 2048, 32, 32, dict(window=4096)),
                (4, 48, 32, 32, dict(window=4096)),
                (1, 200, 32, 32, dict(window=4096)),
                (1, 8192, 4, 4, dict(window=4096)),
                (2, 300, 4, 2, dict(window=100, softcap=30.0))]


@pytest.mark.gpu
def test_k2_at_head_dim_112_matches_plain_version_on_card():
    """bf16 at D = Dv = 112 on the wgmma kernel (tiles of 128, columns
    112-127 zero-filled by TMA and not stored): within one bf16 step of
    the plain version and lse within 1e-5, also when q, k and v are views
    of one fused projection (a store past column 112 would zero the next
    head's first 16 columns).  f32 at 112 runs the SIMT kernel within
    2e-5."""
    _cuda()
    for i, (B, S, H, KV, kw) in enumerate(K2_112_CASES):
        q, k, v = _k2_inputs(60 + i, (B, S, H, 112), (B, S, KV, 112),
                             torch.bfloat16)
        before = flash_attention.launches_by_variant["wgmma"]
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        ref, ref_lse = flash_attention_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        assert flash_attention.launches_by_variant["wgmma"] == before + 1
        assert out.shape == (B, S, H, 112)
        assert _bf16_within_limits(out, ref, lse, ref_lse), i
        assert float((lse - ref_lse).abs().max()) < 1e-5, i
    g = torch.Generator(device="cuda").manual_seed(7)
    qkv = torch.randn((2, 130, 3, 8, 112), generator=g,
                      device="cuda").bfloat16()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out, lse = flash_attention(q, k, v, return_lse=True, window=64)
    ref, ref_lse = flash_attention_reference(q, k, v, window=64)
    assert _bf16_within_limits(out, ref, lse, ref_lse)
    q, k, v = _k2_inputs(70, (1, 256, 8, 112), (1, 256, 8, 112),
                         torch.float32)
    before = flash_attention.launches_by_variant["simt"]
    out, lse = flash_attention(q, k, v, return_lse=True, window=100)
    ref, ref_lse = flash_attention_reference(q, k, v, window=100)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_variant["simt"] == before + 1
    assert float((out - ref).abs().max()) < 2e-5
    assert float((lse - ref_lse).abs().max()) < 1e-5


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


@pytest.mark.gpu
def test_k2_wgmma_reads_q_k_v_sliced_from_one_fused_tensor():
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(5)
    qkv = torch.randn((2, 300, 4 + 2 + 2, 64), generator=g,
                      device="cuda").bfloat16()
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    kw = dict(window=100, softcap=30.0)
    before = flash_attention.launches_by_variant["wgmma"]
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    ref, ref_lse = flash_attention_reference(q, k, v, **kw)
    assert flash_attention.launches_by_variant["wgmma"] == before + 1
    assert _bf16_within_limits(out, ref, lse, ref_lse)
    shifted = torch.zeros(qkv.numel() + 1, dtype=torch.bfloat16,
                          device="cuda")[1:].view(qkv.shape)
    with pytest.raises(ValueError):            # base 2 bytes off 16
        flash_attention(shifted[:, :, :4], shifted[:, :, 4:6],
                        shifted[:, :, 6:])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_rows_the_mask_empties_give_zeros(dtype):
    """kv_len 0 empties every row: zeros and lse -1e30, on either
    variant."""
    _cuda()
    q, k, v = _k2_inputs(0, (1, 130, 4, 64), (1, 130, 2, 64), dtype)
    out, lse = flash_attention(q, k, v, return_lse=True, kv_len=0)
    torch.cuda.synchronize()
    assert float(out.float().abs().max()) == 0.0
    assert float(lse.max()) <= -1e29


@pytest.mark.gpu
def test_k2_counts_launches_by_variant():
    _cuda()
    cases = [(torch.float32, 256, "simt"), (torch.bfloat16, 32, "simt"),
             (torch.bfloat16, 16, "simt"), (torch.bfloat16, 64, "wgmma"),
             (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 256, "wgmma")]
    for dtype, D, variant in cases:
        q, k, v = _k2_inputs(D, (1, 96, 2, D), (1, 96, 1, D), dtype)
        total = flash_attention.launches
        before = dict(flash_attention.launches_by_variant)
        out = flash_attention(q, k, v, softcap=20.0)
        ref, _ = flash_attention_reference(q, k, v, softcap=20.0)
        torch.cuda.synchronize()
        assert flash_attention.launches == total + 1
        assert flash_attention.launches_by_variant == dict(
            before, **{variant: before[variant] + 1})
        tol = 2e-5 if dtype == torch.float32 else 0.035
        assert float((out.float() - ref.float()).abs().max()) < tol


#: (B, S, H, P, G, N, chunk): the SSD shapes of tests/test_kernels.py
K3_TEST_SHAPES = [(1, 64, 2, 16, 1, 8, 16), (2, 128, 4, 32, 2, 16, 32),
                  (1, 128, 4, 64, 4, 32, 64), (1, 32, 2, 16, 2, 16, 32)]
#: a ragged chunk (Q not a multiple of the kernel's 64-row tiles), the
#: longest chunk, and mamba2-2.7b's widths on fewer heads
K3_MODEL_SHAPES = [(2, 192, 3, 32, 3, 24, 96), (1, 1024, 1, 16, 1, 16, 1024),
                   (1, 512, 4, 64, 1, 128, 256)]


#: bf16 shapes of the wgmma variant, each with its dt/A ranges and whether
#: B and C are strided views of one (B, S, 2, G, N) tensor: mamba2-2.7b's
#: widths on 4 heads (and at the overflow end of its ranges), G 2 with N 64
#: (zamba2-7b's), chunks 64 and 128, P 128, N 192 at chunk 192, and N 256
#: at chunk 256 (whose scan pass takes two t tiles a block)
K3_WGMMA_CASES = [((1, 512, 4, 64, 1, 128, 256), "model", False),
                  ((1, 512, 4, 64, 1, 128, 256), "overflow", False),
                  ((2, 512, 8, 64, 2, 64, 256), "model", False),
                  ((1, 256, 4, 64, 1, 128, 64), "model", False),
                  ((2, 256, 4, 64, 2, 64, 128), "model", False),
                  ((1, 256, 2, 128, 1, 64, 128), "model", False),
                  ((2, 256, 4, 64, 2, 128, 128), "model", True),
                  ((1, 384, 2, 64, 1, 192, 192), "overflow", True),
                  ((1, 512, 2, 64, 1, 256, 256), "model", False)]


def _ssd(shape, seed, dtype, model_ranges=False, overflow=False,
         strided=False):
    """x, B, C standard normal; dt and A as tests/test_kernels.py draws
    them, or from mamba2's init ranges (dt log-uniform in [1e-3, 0.1], A
    in [-16, -1]), or at the far end of those (``overflow``: dt 0.1, A
    -16, where the upper triangle's decay overflows float32); with
    ``strided`` B and C are views of one (B, S, 2, G, N) tensor."""
    B, S, H, P, G, N, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=g, device="cuda")
    if overflow:
        dt = torch.full((B, S, H), 0.1, device="cuda")
        A = torch.full((H,), -16.0, device="cuda")
    elif model_ranges:
        u = torch.rand((B, S, H), generator=g, device="cuda")
        dt = torch.exp(u * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
        A = -(1.0 + 15.0 * torch.rand(H, generator=g, device="cuda"))
    else:
        dt = torch.nn.functional.softplus(randn(B, S, H))
        A = -torch.exp(torch.rand(H, generator=g, device="cuda"))
    x = randn(B, S, H, P).to(dtype)
    if strided:
        bc = randn(B, S, 2, G, N).to(dtype)
        return x, dt, A, bc[:, :, 0], bc[:, :, 1]
    return x, dt, A, randn(B, S, G, N).to(dtype), randn(B, S, G, N).to(dtype)


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
    |ref|, since both round an f32 sum to bf16.  Then the wgmma variant's
    bf16 cases (``K3_WGMMA_CASES``), each of which must run ``wgmma``, stay
    finite and meet the same elementwise limit."""
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
    for i, (shape, ranges, strided) in enumerate(K3_WGMMA_CASES):
        chunk = shape[-1]
        ins = _ssd(shape, 100 + i, torch.bfloat16, model_ranges=True,
                   overflow=ranges == "overflow", strided=strided)
        assert k3_variant_for(torch.bfloat16, shape[3], shape[5],
                              shape[6]) == "wgmma"
        before = dict(ssd_scan.launches_by_variant)
        out = ssd_scan.run(*ins, chunk)
        ref = ssd_scan_reference(*ins, chunk).float()
        torch.cuda.synchronize()
        assert ssd_scan.launches_by_variant == dict(
            before, wgmma=before["wgmma"] + 1), shape
        assert out.dtype == torch.bfloat16 and out.shape == ref.shape
        out = out.float()
        assert bool(torch.isfinite(out).all()), (shape, ranges)
        assert bool(((out - ref).abs()
                     <= 1e-3 + 2.0 ** -7 * ref.abs()).all()), (shape, ranges)


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


def _k4_inputs(variant, dtype, lead, width, seed, pad=0, scale_dtype=None):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    if variant == "plain":
        n = width
        ins = [r(*lead, n + pad).to(dtype)[..., :n],
               (1 + 0.1 * r(n)).to(scale_dtype or dtype)]
    else:
        H, P = width
        n = H * P
        ins = [r(*lead, H, P).to(dtype), r(*lead, H, P).to(dtype),
               1 + 0.5 * r(H), (2 * r(*lead, n)).to(dtype),
               (1 + 0.1 * r(n)).to(scale_dtype or dtype)]
    return ins, r(*lead, n).to(dtype)


def _k4_run(variant, ins, g):
    rms = K4.rms_norm
    if variant == "plain":
        out, rstd = rms.forward(ins[0], ins[1], 1e-5)
        return out, rstd, rms.backward(g, ins[0], ins[1], rstd)
    y, xs, D, z, scale = ins
    out, rstd = rms.forward(y, scale, 1e-5, xs, D, z)
    return out, rstd, rms.backward(g, y, scale, rstd, xs, D, z)


def _k4_plain(variant, ins, g):
    if variant == "plain":
        out, rstd = K4.rms_norm_reference(ins[0], ins[1], 1e-5)
        return out, rstd, K4.rms_norm_backward_reference(g, ins[0], ins[1],
                                                         rstd)
    out, rstd = K4.gated_rms_norm_reference(*ins, 1e-5)
    y, xs, D, z, scale = ins
    return out, rstd, K4.gated_rms_norm_backward_reference(
        g, y, xs, D, z, scale, rstd)


#: (variant, dtype, scale dtype, leading dims, width or (H, P), padding):
#: mamba2-2.7b's two norms, MLA's strided latent, widths off the vector
K4_CASES = [("plain", torch.bfloat16, None, (1, 2048), 2560, 0),
            ("plain", torch.float32, None, (2, 300), 2560, 0),
            ("gated", torch.bfloat16, None, (1, 2048), (80, 64), 0),
            ("gated", torch.float32, None, (1, 512), (80, 64), 0),
            ("plain", torch.bfloat16, None, (2, 256), 512, 64),
            ("plain", torch.bfloat16, torch.float32, (7,), 100, 0),
            ("gated", torch.bfloat16, torch.float32, (2, 9), (3, 12), 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", K4_CASES)
def test_k4_matches_plain_version_on_card(case):
    """The output within one bf16 step of the plain version elementwise
    (f32: 1e-5 of the largest), rstd within 1e-5, each gradient within
    2^-6 (bf16: the same f32 value rounded after sums in another order) or
    1e-4 (f32) of its largest; the backward the same bits run after run."""
    _cuda()
    variant, dtype, sdt, lead, width, pad = case
    ins, g = _k4_inputs(variant, dtype, lead, width, 3, pad, sdt)
    out, rstd, grads = _k4_run(variant, ins, g)
    again = _k4_run(variant, ins, g)[2]
    ref, ref_rstd, ref_grads = _k4_plain(variant, ins, g)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == ref.shape
    if dtype == torch.bfloat16:
        assert bool(((out.float() - ref.float()).abs()
                     <= 2.0 ** -7 * ref.float().abs()).all())
    else:
        assert float((out - ref).abs().max() / ref.abs().max()) < 1e-5
    assert float(((rstd - ref_rstd).abs() / ref_rstd).max()) < 1e-5
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-4
    for a, b, c in zip(grads, ref_grads, again):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()
                     / b.float().abs().max()) < tol
        assert torch.equal(a.view(torch.uint8), c.view(torch.uint8))


@pytest.mark.gpu
def test_k4_counts_launches_by_variant_and_direction():
    _cuda()
    K4.rms_norm.reset_counts()
    (x, s), g = _k4_inputs("plain", torch.bfloat16, (4, 8), 256, 1)
    x, s = x.requires_grad_(True), s.requires_grad_(True)
    torch.autograd.grad(K4.rms_norm(x, s, 1e-5), (x, s), g)
    ins, g = _k4_inputs("gated", torch.bfloat16, (4, 8), (4, 64), 2)
    ins = [t.requires_grad_(True) for t in ins]
    torch.autograd.grad(K4.rms_norm.gated(*ins, 1e-5), ins, g)
    torch.cuda.synchronize()
    assert K4.rms_norm.launches == 4
    assert K4.rms_norm.launches_by_variant == {"plain": 2, "gated": 2}
    assert K4.rms_norm.launches_by_direction == {"forward": 2,
                                                 "backward": 2}


@pytest.mark.gpu
def test_k4_rejects_what_it_does_not_take():
    _cuda()
    (x, s), _ = _k4_inputs("plain", torch.bfloat16, (4, 8), 256, 1)
    before = K4.rms_norm.launches
    with pytest.raises(TypeError):
        K4.rms_norm.forward(x.half(), s, 1e-5)
    with pytest.raises(ValueError):
        K4.rms_norm.forward(x.transpose(0, 1), s, 1e-5)
    with pytest.raises(ValueError):
        K4.rms_norm.forward(x[..., ::2], s[:128], 1e-5)
    assert K4.rms_norm.launches == before
