"""The published Zamba2 training cell (``drivers/train_zamba2_plain.py``)
at a toy size on the CPU, with hybrid layers in it (the harness's own toy
keeps two mamba layers): the cell runs correct, traced and not; each fault
planted in the program underneath a whole run turns ``correct`` false;
the control and the planted faults read by ``control_readings`` fail the
cell's limits where the program's own readings pass them; the generator's
layout is the program's parameter tree and its count the program's; and
a program without the published layout fails the cell's set-up at once."""
import json

import pytest
import torch

from perfbench.harness import context
from perfbench.tests import toy

CELL = "train.zamba2-7b-instruct.plain"
CONFIG = "zamba2-7b-instruct"
#: 12 layers, hybrid at 6 and 11 (blocks A, B), 2 groups of SSM state,
#: heads of 32 over concat(x, e), adapters of rank 8, in float32 (at 64
#: tokens bf16's rounding alone moves the median leaf past the limits set
#: at the cell's size)
ZAMBA = dict(num_layers=12, d_model=64, head_dim=16, d_state=16,
             n_groups=2, chunk_size=16, vocab_size=250,
             num_attention_heads=4, num_key_value_heads=4,
             intermediate_size=128, adapter_rank=8,
             param_dtype="float32", compute_dtype="float32",
             layers_block_type=["hybrid" if i in (6, 11) else "mamba"
                                for i in range(12)])


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    out = toy.toy_bench(tmp_path_factory.mktemp("bench"))
    path = out / "configs" / f"{CONFIG}.json"
    path.write_text(json.dumps({**toy.load_json(path), **ZAMBA}))
    traffic = out / "traffic" / "pretrain-4k.plain.json"
    traffic.write_text(json.dumps({**toy.load_json(traffic),
                                   "seq_len": 64}))
    return out


@pytest.mark.parametrize("trace", [False, True])
def test_cell_with_hybrid_layers_runs_correct(bench, trace):
    res = toy.run_toy(bench, CELL, trace=trace, seconds=0.3)
    assert res["correct"], res
    assert res["checks"]["structure_gap"]["value"] == 0.0
    if trace:
        assert {"train.forward_s", "train.backward_s"} <= set(res["metrics"])
        assert res["metrics"]["train.hybrid_mfu"]["value"] > 0


def _swap_blocks(monkeypatch):
    from repro_torch.train import step
    orig = step._grad_fn

    def wrap(model):
        g = orig(model)
        return lambda params, batch: g(
            {**params, "shared": params["shared"][::-1]}, batch)
    monkeypatch.setattr(step, "_grad_fn", wrap)


def _no_embed(monkeypatch):
    from repro_torch.models import transformer
    orig = transformer.apply_shared_block
    monkeypatch.setattr(transformer, "apply_shared_block",
                        lambda sp, x, e, *a: orig(sp, x, torch.zeros_like(e),
                                                  *a))


def _no_adapter(monkeypatch):
    from repro_torch.models import layers
    orig = layers.apply_mlp
    monkeypatch.setattr(layers, "apply_mlp", lambda p, x, kind, exact=False,
                        adapter=None: orig(p, x, kind, exact))


def _row_norm(monkeypatch):
    from repro_torch.models import ssm
    orig = ssm.gated_norm
    monkeypatch.setattr(ssm, "gated_norm", lambda *a: orig(*a[:6]))


@pytest.mark.parametrize("plant", [_swap_blocks, _no_embed, _no_adapter,
                                   _row_norm])
def test_a_fault_in_the_layout_is_caught(bench, monkeypatch, plant):
    plant(monkeypatch)
    res = toy.run_toy(bench, CELL, seconds=0.1)
    assert not res["correct"], res["checks"]


def test_control_and_planted_faults_fail_the_limits(bench):
    from perfbench.drivers.train_zamba2_plain import control_readings
    from perfbench.reference.zamba2 import FAULTS
    lim = toy.load_json(bench / "workloads" / f"{CELL}.json")["limits"]
    ctx = context(CELL, 2**31 + 23, False, bench_dir=bench, spec=toy.SPEC,
                  device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = control_readings(ctx, 0.0)
    finally:
        torch.set_num_threads(threads)
    assert all(r["program"][k] <= lim[k] for k in lim), r["program"]
    for name in ("control_fp8",) + FAULTS:
        assert any(r[name][k] > lim[k] for k in lim), (name, r[name])


def test_layout_and_count_are_the_programs(bench):
    from perfbench.drivers.train import nest
    from perfbench.drivers.train_zamba2_plain import port_config
    from perfbench.gen import zamba2 as gz
    from repro_torch.models.transformer import Transformer, param_leaves
    for c in (toy.load_json(bench / "configs" / f"{CONFIG}.json"),
              toy.load_json(toy.BENCH / "configs" / f"{CONFIG}.json")):
        cfg = port_config(c)
        assert gz.n_params(c) == cfg.param_counts()["total"]
    assert gz.n_params(c) == c["n_params"] == 2_733_050_240
    c = {**c, **ZAMBA}
    params = Transformer(port_config(c)).init(0, device="cpu")
    want = [(p, s) for p, s, _, _ in gz.layout(c)]
    assert [(p, tuple(x.shape)) for p, x in param_leaves(params)] == want
    tree = nest(gz.make_weights(c, 5, "cpu"))
    assert [(p, tuple(x.shape)) for p, x in param_leaves(tree)] == want


def test_step_flops_count_the_published_layout_by_hand():
    """The published 24-layer stage at 4096 tokens: each matrix a token
    passes through, counted by hand from the published widths, a shared
    block once for each of its two applications, and the attention and
    SSD cores; the backward twice the forward."""
    from perfbench.flops import ssd_flops
    from perfbench.hybrid_flops import step_flops
    c = toy.load_json(toy.BENCH / "configs" / f"{CONFIG}.json")
    d, di, S = 3584, 7168, 4096
    mamba = 2 * d * di + 2 * d * 128 + d * 112 + di * d    # z, x, B, C, dt, out
    extras = d * 128 + 128 * 2 * 14336 + d * d            # adapter, linear
    block = 3 * 2 * d * 7168 + 7168 * d + d * 2 * 14336 + 14336 * d
    matrices = 24 * mamba + 4 * extras + 32_000 * d + 4 * block
    attn = 4 * 2 * (224 + 224) * 32 * (S * (S + 1) // 2)
    ssd = 24 * ssd_flops(1, S, 112, 64, 2, 64, 256)
    want = 3 * (2 * S * matrices + attn + ssd)
    assert step_flops(c, 1, S) == pytest.approx(want, rel=1e-12)
    assert 87e12 < want < 88e12


def test_a_program_without_the_layout_fails_at_once(bench, monkeypatch):
    from repro_torch.configs import base
    fields = {f.name for f in base.dataclasses.fields(base.ModelConfig)}
    old = base.dataclasses.make_dataclass(
        "ModelConfig", [(f, object, None) for f in sorted(
            fields - {"hybrid_layer_ids", "num_mem_blocks", "adapter_rank",
                      "gelu_exact", "ssm_grouped_norm"})])
    monkeypatch.setattr(base, "ModelConfig", old)
    with pytest.raises(TypeError):
        toy.run_toy(bench, CELL, seconds=0.1)


@pytest.mark.gpu
def test_traced_run_reads_the_shared_blocks_and_k2_on_the_card(bench):
    """On the card a traced toy run reads the shared blocks' device time
    and K2's share of its bound, at most 100%, and the step's structure."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import time

    from perfbench.harness import run_cell
    res = run_cell(CELL, 2**31 + 79, 0.5, True, bench_dir=bench,
                   spec=toy.SPEC, t_start=time.perf_counter(),
                   emit=lambda line: None)
    assert res["correct"], res
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["train.shared_block_device_s"] > 0
    assert 0 < m["train.k2_roofline"] <= 100.0
    assert m["train.forward_device_s"] >= m["train.shared_block_device_s"]
