"""The port's step cost (``launch.step_cost``) and roofline
(``launch.analysis``) against the reference's, on the CPU.

* The FLOP and byte formulas on a plain matrix product and a grouped
  convolution; views and allocations count nothing.
* K2's and K3's forwards count by their kernels' formulas, with their
  inputs' and outputs' bytes, and nothing dispatched inside them counts:
  the count of a whole reduced step is the same whichever path the
  forward takes (the plain version, or another implementation patched in).
* Collectives: a one-rank ``gloo`` group's all-reduces by the reference's
  ring formula.
* ``model_flops`` equals the reference's for every config in the registry
  and every shape; ``roofline`` equals it on the same inputs with the
  port's H100 constants patched to the reference's.
* Recorded, not gated: the port's ``gemm_frac`` on ``tiny_train_setup()``
  beside the reference's, and the ratio of the port's step FLOPs to the
  reference's ``expanded_cost`` FLOPs on a reduced gemma2.
"""
import math
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.base import ALL_SHAPES as R_SHAPES
from repro.configs.registry import ARCHS as R_ARCHS
from repro.configs.registry import reduced as r_reduced
from repro.launch import analysis as RA
from repro.launch.hlo_cost import expanded_cost
from repro.models.transformer import Transformer as RTransformer
from repro.optim.adamw import AdamW as RAdamW
from repro.optim.adamw import OptConfig as ROptConfig
from repro.train.loop import Trainer as RTrainer
from repro.train.step import make_split_train_step as r_split
from repro.train.workload import tiny_train_setup as r_tiny_train_setup

from repro_torch.configs.base import ALL_SHAPES
from repro_torch.configs.registry import ARCHS, reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import flash_attention as K2
from repro_torch.kernels import ssd_scan as K3
from repro_torch.launch import analysis as A
from repro_torch.launch.step_cost import count_step
from repro_torch.models.attention_core import AttnSpec, blocked_attention
from repro_torch.models.convert import params_from_reference
from repro_torch.models.transformer import Transformer
from repro_torch.optim.adamw import AdamW, OptConfig
from repro_torch.train.loop import Trainer
from repro_torch.train.step import make_split_train_step
from repro_torch.train.workload import tiny_train_setup

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _count(fn, *args):
    return count_step(lambda a, b: fn(*args), None, None)


def test_matmul_flops_and_bytes():
    a = torch.randn(6, 10)
    b = torch.randn(10, 7)
    out = a @ b
    c = _count(lambda: a @ b)
    assert c.flops == 2 * 6 * 7 * 10
    assert c.bytes == _nbytes(a, b, out)
    # batched, with views on the way: the views count nothing
    x = torch.randn(3, 4, 5)
    w = torch.randn(3, 5, 2)
    c = _count(lambda: torch.bmm(x.transpose(1, 2).transpose(1, 2), w))
    assert c.flops == 2 * 3 * 4 * 2 * 5
    assert c.bytes == _nbytes(x, w, torch.bmm(x, w))
    assert c.coll_counts == {} and c.collective_total == 0.0


@pytest.mark.parametrize("groups", [1, 2])
def test_conv_flops_and_bytes(groups):
    x = torch.randn(2, 4, 9, 9)
    w = torch.randn(6, 4 // groups, 3, 3)
    bias = torch.randn(6)
    out = F.conv2d(x, w, bias, groups=groups)
    c = _count(lambda: F.conv2d(x, w, bias, groups=groups))
    # the reference's form: 2 * result * kernel_spatial * Cin / groups
    assert c.flops == 2.0 * out.numel() * 9 * (4 // groups)
    assert c.bytes == _nbytes(x, w, bias, out)


def test_elementwise_counts_bytes_not_flops():
    x = torch.randn(8, 8)
    c = _count(lambda: torch.tanh(x) * 2.0)
    assert c.flops == 0.0
    assert c.bytes == 4 * _nbytes(x)          # tanh: in, out; mul: in, out


def test_k2_forward_counts_its_formula():
    rng = np.random.default_rng(0)
    B, S, H, KV, D = 2, 64, 4, 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, h, D))
                                .astype(np.float32))
               for h in (H, KV, KV))
    spec = AttnSpec(causal=True, window=24, q_block=32, kv_block=32)
    out, lse = K2.flash_attention(q, k, v, causal=True, window=24,
                                  return_lse=True)
    c = _count(lambda: blocked_attention(q, k, v, spec))
    pairs = K2.unmasked_pairs(S, S, True, 24)
    assert c.flops == 2.0 * (D + D) * B * H * pairs
    assert c.detail_flops == {"flash_attention": c.flops}
    assert c.bytes == _nbytes(q, k, v, out, lse)


def test_k3_forward_counts_its_formula():
    rng = np.random.default_rng(1)
    B, S, H, P, G, N, Q = 1, 64, 4, 8, 2, 16, 32

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x, Bm, Cm = t(B, S, H, P), t(B, S, G, N), t(B, S, G, N)
    dt = torch.from_numpy(rng.uniform(0.01, 0.1, (B, S, H))
                          .astype(np.float32))
    Aa = -torch.from_numpy(rng.uniform(0.5, 2.0, H).astype(np.float32))
    y = K3.ssd_scan(x, dt, Aa, Bm, Cm, Q)
    c = _count(lambda: K3.ssd_scan(x, dt, Aa, Bm, Cm, Q))
    assert c.flops == K3.ssd_flops(x, Bm, Q)
    assert c.bytes == _nbytes(x, dt, Aa, Bm, Cm, y)


def _reduced_step(arch, seq=64):
    cfg = reduced(ARCHS[arch])
    model = Transformer(cfg)
    params = model.init(0, device="cpu")
    grad_fn, _ = make_split_train_step(model, AdamW(OptConfig()))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        cfg, DataConfig(batch=2, seq_len=seq)).batch_at(0).items()}
    return grad_fn, params, batch


def _other_attention(q, k, v, causal, window, softcap, scale, q_offset,
                     kv_len):
    """K2's function by other ops: one query block at a time, in f64."""
    outs, lses = [], []
    for i in range(0, q.shape[1], 16):
        o, lse = K2.flash_attention_reference(
            q[:, i:i + 16].double(), k.double(), v.double(), causal=causal,
            window=window, softcap=softcap, scale=scale,
            q_offset=q_offset + i, kv_len=kv_len)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, 1).to(q.dtype), torch.cat(lses, 1).float()


@pytest.mark.parametrize("arch", ["gemma2-2b", "zamba2-7b"])
def test_count_does_not_depend_on_the_kernel_path(arch, monkeypatch):
    """K2's and K3's custom ops count by formula, whatever their bodies run
    (the kernels on the card, the plain versions here, other ops below)."""
    grad_fn, params, batch = _reduced_step(arch)
    want = count_step(grad_fn, params, batch)
    monkeypatch.setattr(K2.flash_attention, "run", _other_attention)
    monkeypatch.setattr(K3.ssd_scan, "_run",
                        lambda x, dt, Aa, Bm, Cm, chunk:
                        K3.ssd_oracle(x, dt, Aa, Bm, Cm))
    got = count_step(grad_fn, params, batch)
    assert got.flops == want.flops and got.bytes == want.bytes
    assert got.detail_flops == want.detail_flops
    assert want.detail_flops["flash_attention"] > 0
    if arch == "zamba2-7b":
        assert want.detail_flops["ssd_scan"] > 0


def test_collectives_by_the_ring_formula():
    import torch.distributed as dist

    from repro_torch.optim.compress import psum_compressed
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        g = {"a": torch.randn(4, 8), "b": torch.randn(16)}
        c = _count(lambda: psum_compressed(g, None, "int8"))
        # per leaf: the shared scale (MAX, 4 bytes) and the int32 payload
        assert c.coll_counts == {"all-reduce": 4.0}
        size = 4 + 4 * 32 + 4 + 4 * 16
        # n = max(2, group size), as the reference's parser does
        assert c.coll_bytes["all-reduce"] == 2.0 * size * (2 - 1) / 2
        stats = A.CollectiveStats.from_cost(c)
        assert stats.total_bytes == c.collective_total
        assert stats.count_by_op == {"all-reduce": 4}
    finally:
        dist.destroy_process_group()


def test_model_flops_matches_reference_for_every_config():
    assert list(ARCHS) == list(R_ARCHS)
    n = 0
    for name in ARCHS:
        for shape, rshape in zip(ALL_SHAPES, R_SHAPES):
            assert A.model_flops(ARCHS[name], shape) == \
                RA.model_flops(R_ARCHS[name], rshape)
            n += 1
    assert n == len(ARCHS) * len(ALL_SHAPES)


def test_roofline_matches_reference_with_its_constants(monkeypatch):
    assert (A.PEAK_FLOPS, A.HBM_BW, A.ICI_BW) == (989e12, 3.35e12, 450e9)
    for k in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(A, k, getattr(RA, k))
    cost = {"flops": 3.1e15, "bytes accessed": 7.7e12}
    coll = {"all-reduce": 2.5e9, "all-gather": 4.0e8}
    counts = {"all-reduce": 7, "all-gather": 3}
    for fl, by in ((3.1e15, 7.7e12), (1e9, 9e12), (0.0, 0.0)):
        cost = {"flops": fl, "bytes accessed": by}
        got = A.roofline(cost, A.CollectiveStats(coll, counts), 256, 1.2e18)
        want = RA.roofline(cost, RA.CollectiveStats(coll, counts), 256,
                           1.2e18)
        assert got == want


def test_ring_traffic_matches_reference_parser():
    # the reference's parse_collectives on one line of each op
    for op, hlo_op in (("all-reduce", "all-reduce"),
                       ("all-gather", "all-gather"),
                       ("reduce-scatter", "reduce-scatter"),
                       ("all-to-all", "all-to-all"),
                       ("collective-permute", "collective-permute")):
        line = (f"  %x = f32[64,128]{{1,0}} {hlo_op}(f32[64,128]{{1,0}} %p)"
                f", replica_groups={{{{0,1,2,3}}}}")
        ref = RA.parse_collectives(line, 8)
        assert A.ring_traffic(op, 64 * 128 * 4, 4) == ref.bytes_by_op[op]


def test_recorded_gemm_frac_and_flops_ratio_to_reference():
    """Recorded for PERF.md, not gated: the port's gemm_frac on
    tiny_train_setup() beside the reference's, and the port's step FLOPs
    over the reference's expanded_cost FLOPs on a reduced gemma2."""
    rtr = RTrainer(*r_tiny_train_setup())
    rparams, _, _ = rtr.init_state()
    rb = {k: jnp.asarray(v) for k, v in rtr.loader.next().items()}
    rbundle = rtr.ensure_bundle(rparams, rb)
    rtr.loader.close()

    mc, dc, oc, tc = tiny_train_setup()
    tr = Trainer(mc, dc, oc, tc, device="cpu")
    params = params_from_reference(jax.tree_util.tree_map(np.asarray,
                                                          rparams), mc,
                                   device="cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in rb.items()}
    bundle = tr.ensure_bundle(params, batch)
    tr.loader.close()
    assert bundle.gemm_frac is not None and rbundle.gemm_frac is not None
    assert 0.05 <= bundle.gemm_frac <= 0.95

    rcfg = r_reduced(R_ARCHS["gemma2-2b"])
    rmodel = RTransformer(rcfg)
    rp = rmodel.init(jax.random.PRNGKey(0))
    rgrad, _ = r_split(rmodel, RAdamW(ROptConfig()))
    data = SyntheticLM(reduced(ARCHS["gemma2-2b"]),
                       DataConfig(batch=2, seq_len=64)).batch_at(0)
    rbatch = {k: jnp.asarray(v) for k, v in data.items()}
    text = jax.jit(rgrad).lower(rp, rbatch).compile().as_text()
    rcost = expanded_cost(text, num_devices=1)
    cfg = reduced(ARCHS["gemma2-2b"])
    model = Transformer(cfg)
    p = params_from_reference(jax.tree_util.tree_map(np.asarray, rp), cfg,
                              device="cpu")
    grad_fn, _ = make_split_train_step(model, AdamW(OptConfig()))
    cost = count_step(grad_fn, p, {k: torch.from_numpy(v)
                                   for k, v in data.items()})
    ratio = cost.flops / rcost.flops
    print(f"\n[step cost] gemm_frac port {bundle.gemm_frac:.4f} reference "
          f"{rbundle.gemm_frac:.4f}; reduced gemma2 FLOPs port "
          f"{cost.flops:.6g} reference {rcost.flops:.6g} ratio "
          f"{ratio:.4f}; bytes port {cost.bytes:.6g} reference "
          f"{rcost.bytes:.6g}")
    assert math.isfinite(ratio) and ratio > 0
