"""The slice's checks that need the card (marked ``gpu``; they skip without
one).  The file imports no JAX: the card's machine has none.

  python -m pytest -q -m gpu tests/test_torch_dist_gpu.py

* Two ``apply_moe`` calls on the card give the same bits (the combine has
  no atomics).
* K2 runs inside the attention core's local-shard region on a one-rank
  NCCL mesh: the wgmma kernel launches, and the output is the kernel's
  without a mesh, bit for bit.
* The step cost of a reduced gemma2 and a reduced zamba2 counted on the
  card equals the count on the CPU (K2 and K3 by their formulas, K4's ops
  by their bytes; the CPU count routes the norms to K4's plain versions,
  as the card routes them to the kernel).
* Under a one-rank mesh the RMS norm and mamba2's gated tail run their
  composed ops, not K4: one model computes norms on one device and on a
  mesh up to one bf16 step apart (a known divergence, until K4 runs in a
  local-shard region).
"""
import contextlib
import socket

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import ARCHS, reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import rms_norm as K4
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.step_cost import count_step
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.attention import attention_core
from repro_torch.models.attention_core import AttnSpec, blocked_attention
from repro_torch.models.transformer import Transformer, map_params
from repro_torch.optim.adamw import AdamW, OptConfig
from repro_torch.train.step import make_split_train_step


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_two_apply_moe_calls_are_bit_equal_on_card():
    _cuda()
    cfg = reduced(ARCHS["deepseek-v2-lite-16b"], d_model=256).with_overrides(
        num_experts=64, top_k=6, dtype="bfloat16", param_dtype="bfloat16")
    p = M.init_moe(torch.Generator(device="cuda").manual_seed(0), cfg,
                   torch.bfloat16, device="cuda")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 1024, cfg.d_model)).astype(np.float32)).to("cuda",
                                                       torch.bfloat16)
    y1, s1 = M.apply_moe(p, x, cfg)
    y2, s2 = M.apply_moe(p, x, cfg)
    torch.cuda.synchronize()
    assert torch.equal(y1.view(torch.int16), y2.view(torch.int16))
    assert torch.equal(s1, s2)


@contextlib.contextmanager
def _one_rank_mesh():
    """A one-rank NCCL process group and its (1, 1) ("data", "model")
    mesh, as a ``DistCtx``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist.sharding import DistCtx
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        yield DistCtx.from_mesh(init_device_mesh(
            "cuda", (1, 1), mesh_dim_names=("data", "model")))
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_k2_launches_inside_the_dist_region_on_card():
    _cuda()
    from torch.distributed.tensor import DTensor

    with _one_rank_mesh() as d:
        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (2, 512, h, 128)).astype(np.float32)).to("cuda", torch.bfloat16)
            for h in (8, 4, 4))
        spec = AttnSpec(causal=True, window=256)
        want = blocked_attention(q, k, v, spec)
        place = d.heads_spec
        dq, dk, dv = (d.distribute(t, d.placements(place(t)))
                      for t in (q, k, v))
        before = flash_attention.launches_by_variant["wgmma"]
        out = attention_core(blocked_attention, dq, dk, dv, spec, d)
        torch.cuda.synchronize()
        assert isinstance(out, DTensor)
        assert flash_attention.launches_by_variant["wgmma"] == before + 1
        assert torch.equal(out.full_tensor().view(torch.int16),
                           want.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["plain", "gated"])
def test_a_mesh_runs_the_composed_norm_up_to_one_bf16_step_from_k4(variant):
    """mamba2-2.7b's pre-norm and gated tail (bf16, 1 x 2048): on one device
    the models run K4; under a one-rank mesh, on replicated DTensors, they
    run the composed ops (no launch), bit for bit ``K4``'s plain versions
    there.  The two outputs sit within one bf16 step of each other
    elementwise and are not equal: the divergence a local-shard region for
    K4 would close.  The share of elements that differ is printed."""
    _cuda()
    from torch.distributed.tensor import Replicate, distribute_tensor

    g = torch.Generator(device="cuda").manual_seed(5)

    def r(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    if variant == "plain":
        ins = [r(1, 2048, 2560), 1 + 0.1 * r(2560)]

        def run(x, s):
            return L.apply_norm({"scale": s}, x, "rms", 1e-5)
        plain = K4.rms_norm_reference(*ins, 1e-5)[0]
    else:
        ins = [r(1, 2048, 80, 64), r(1, 2048, 80, 64),
               1 + 0.5 * r(80, dtype=torch.float32), 2 * r(1, 2048, 5120),
               1 + 0.1 * r(5120)]

        def run(*ts):
            return S.gated_norm(*ts, 1e-5)
        plain = K4.gated_rms_norm_reference(*ins, 1e-5)[0]
    before = K4.rms_norm.launches_by_variant[variant]
    one = run(*ins)
    assert K4.rms_norm.launches_by_variant[variant] == before + 1
    with _one_rank_mesh() as d:
        placed = [distribute_tensor(t, d.mesh, [Replicate(), Replicate()])
                  for t in ins]
        mesh = run(*placed).full_tensor()
        torch.cuda.synchronize()
    assert K4.rms_norm.launches_by_variant[variant] == before + 1
    assert torch.equal(mesh.view(torch.int16), plain.view(torch.int16))
    gap = (one.float() - mesh.float()).abs()
    assert bool((gap <= 2.0 ** -7 * mesh.float().abs()).all())
    differ = float((gap > 0).float().mean())
    print(f"[k4 vs mesh] {variant}: {differ:.4%} of elements differ, max "
          f"|diff| {float(gap.max()):.3g}")
    assert differ > 0


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma2-2b", "zamba2-7b"])
def test_step_count_is_the_same_on_card_and_cpu(arch, monkeypatch):
    _cuda()
    cfg = reduced(ARCHS[arch])
    model = Transformer(cfg)
    params = model.init(0, device="cpu")
    grad_fn, _ = make_split_train_step(model, AdamW(OptConfig()))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        cfg, DataConfig(batch=2, seq_len=128)).batch_at(0).items()}
    with monkeypatch.context() as m:
        m.setattr(K4, "takes", lambda t: type(t).__name__ != "DTensor")
        cpu = count_step(grad_fn, params, batch)
    card = count_step(grad_fn, map_params(lambda t: t.cuda(), params),
                      {k: v.cuda() for k, v in batch.items()})
    assert (card.flops, card.bytes) == (cpu.flops, cpu.bytes)
    assert card.detail_flops == cpu.detail_flops
    assert "rms_norm_bwd" in card.detail_bytes
