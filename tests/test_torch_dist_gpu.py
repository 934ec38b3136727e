"""The slice's checks that need the card (marked ``gpu``; they skip without
one).  The file imports no JAX: the card's machine has none.

  python -m pytest -q -m gpu tests/test_torch_dist_gpu.py

* Two ``apply_moe`` calls on the card give the same bits (the combine has
  no atomics).
* K2 runs inside the attention core's local-shard region on a one-rank
  NCCL mesh: the wgmma kernel launches, and the output is the kernel's
  without a mesh, bit for bit.
* The step cost of a reduced gemma2 and a reduced zamba2 counted on the
  card equals the count on the CPU (K2 and K3 by their formulas).
"""
import socket

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import ARCHS, reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.step_cost import count_step
from repro_torch.models import moe as M
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


@pytest.mark.gpu
def test_k2_launches_inside_the_dist_region_on_card():
    _cuda()
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import DistCtx
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        d = DistCtx.from_mesh(mesh)
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
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma2-2b", "zamba2-7b"])
def test_step_count_is_the_same_on_card_and_cpu(arch):
    _cuda()
    cfg = reduced(ARCHS[arch])
    model = Transformer(cfg)
    params = model.init(0, device="cpu")
    grad_fn, _ = make_split_train_step(model, AdamW(OptConfig()))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        cfg, DataConfig(batch=2, seq_len=128)).batch_at(0).items()}
    cpu = count_step(grad_fn, params, batch)
    card = count_step(grad_fn, map_params(lambda t: t.cuda(), params),
                      {k: v.cuda() for k, v in batch.items()})
    assert (card.flops, card.bytes) == (cpu.flops, cpu.bytes)
    assert card.detail_flops == cpu.detail_flops
