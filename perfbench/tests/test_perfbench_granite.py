"""The granite-4.0-h training cell (``drivers/train_granite_plain.py``) at a
toy size on the CPU, with an attention layer in it (the harness's own toy
keeps two mamba layers): the cell runs correct, traced and not; each fault
planted in the program underneath a whole run turns ``correct`` false;
the control and the planted faults read by ``control_readings`` fail the
cell's limits where the program's own readings pass them; the generator's
layout is the program's parameter tree and its count the program's; and a
program without the layout fails the cell's set-up at once."""
import json

import pytest
import torch

from perfbench.harness import context
from perfbench.tests import toy

CELL = "train.granite-4.0-h-small.plain"
CONFIG = "granite-4.0-h-small"
#: 10 layers, attention at 5 (heads of 16, scaled by 1/16 as the
#: published heads of 128 are by 1/128), 18 experts of which 2 are held,
#: top 4, a shared expert twice an expert's width, in float32 (at 128
#: tokens bf16's rounding alone moves the median leaf past the limits set
#: at the cell's size); 16 token ids, so that routing is uneven enough for
#: a capacity to drop pairs
GRANITE = dict(num_layers=10, d_model=64, head_dim=16, d_state=16,
               chunk_size=16, vocab_size=16, num_attention_heads=4,
               attention_multiplier=1 / 16,
               num_key_value_heads=2, intermediate_size=32,
               shared_intermediate_size=64, num_local_experts_published=18,
               num_local_experts=2, num_experts_per_tok=4,
               param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    out = toy.toy_bench(tmp_path_factory.mktemp("bench"))
    path = out / "configs" / f"{CONFIG}.json"
    path.write_text(json.dumps({**toy.load_json(path), **GRANITE}))
    traffic = out / "traffic" / "pretrain-8k.plain.json"
    traffic.write_text(json.dumps({**toy.load_json(traffic),
                                   "seq_len": 64}))
    return out


@pytest.mark.parametrize("trace", [False, True])
def test_cell_with_an_attention_layer_runs_correct(bench, trace):
    res = toy.run_toy(bench, CELL, trace=trace, seconds=0.3)
    assert res["correct"], res
    assert res["checks"]["structure_gap"]["value"] == 0.0
    if trace:
        assert {"train.forward_s", "train.backward_s"} <= set(res["metrics"])


def _softmax_first(monkeypatch):
    from repro_torch.models import moe
    orig = moe.route
    monkeypatch.setattr(moe, "route", lambda p, x, cfg, cap: orig(
        p, x, cfg.with_overrides(gate_topk_first=False), cap))


def _rope(monkeypatch):
    from repro_torch.models import attention
    orig = attention._qkv
    monkeypatch.setattr(attention, "_qkv", lambda p, x, cfg, pos: orig(
        p, x, cfg.with_overrides(position_embedding="rope"), pos))


def _no_ffn_scale(monkeypatch):
    from repro_torch.models import moe
    orig = moe.apply_moe

    def unscaled(p, x, cfg, dist=None):
        y, stats = orig(p, x, cfg, dist)
        return y / cfg.residual_multiplier, stats
    monkeypatch.setattr(moe, "apply_moe", unscaled)


def _no_shared(monkeypatch):
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "apply_mlp", lambda p, x, *a, **k: x * 0.0)


def _capacity(monkeypatch):
    """The capacity factor 1.25 of the capacity-bound layer: the pairs
    ranked past it weigh nothing, as if dropped."""
    from repro_torch.models import moe
    orig = moe.route

    def capped(p, x, cfg, cap):
        probs, eid_s, tid_s, gate_s, counts, pos, keep = orig(p, x, cfg, cap)
        past = pos >= moe._capacity(x.shape[0], cfg)
        return (probs, eid_s, tid_s, gate_s.masked_fill(past, 0.0), counts,
                pos, keep)
    monkeypatch.setattr(moe, "route", capped)


@pytest.mark.parametrize("plant", [_softmax_first, _rope, _no_ffn_scale,
                                   _no_shared, _capacity])
def test_a_fault_in_the_layout_is_caught(bench, monkeypatch, plant):
    plant(monkeypatch)
    res = toy.run_toy(bench, CELL, seconds=0.1)
    assert not res["correct"], res["checks"]


def test_control_and_planted_faults_fail_the_limits(bench):
    from perfbench.drivers.train_granite_plain import control_readings
    from perfbench.reference.granite_moe_hybrid import FAULTS
    lim = toy.load_json(bench / "workloads" / f"{CELL}.json")["limits"]
    ctx = context(CELL, 2**31 + 29, False, bench_dir=bench, spec=toy.SPEC,
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
    from perfbench.drivers.train_granite_plain import port_config
    from perfbench.gen import granite_moe_hybrid as gg
    from repro_torch.models.transformer import Transformer, param_leaves
    for c in (toy.load_json(bench / "configs" / f"{CONFIG}.json"),
              toy.load_json(toy.BENCH / "configs" / f"{CONFIG}.json")):
        cfg = port_config(c)
        assert gg.n_params(c) == cfg.param_counts()["total"]
    assert gg.n_params(c) == c["n_params"] == 2_320_321_152
    assert gg.layer_kinds(c) == ("mamba",) * 5 + ("attention",) \
        + ("mamba",) * 4
    c = {**c, **GRANITE}
    params = Transformer(port_config(c)).init(0, device="cpu")
    want = [(p, s) for p, s, _, _ in gg.layout(c)]
    assert [(p, tuple(x.shape)) for p, x in param_leaves(params)] == want
    tree = nest(gg.make_weights(c, 5, "cpu"))
    assert [(p, tuple(x.shape)) for p, x in param_leaves(tree)] == want


def test_expert_bound_counts_six_d_ff_a_pair():
    from perfbench.expert_bound import expert_bound_s, expert_flops
    assert expert_flops(18_200, 4096, 768) == 6 * 4096 * 768 * 18_200
    assert expert_bound_s(1e6, 4096, 768, "bfloat16") == pytest.approx(
        6 * 4096 * 768 * 1e6 / 989e12)


def test_step_flops_count_the_published_layout_by_hand():
    """The cell's stage (9 Mamba2 layers, attention at 5) at 2 x 8192
    tokens: each matrix a token passes through, counted by hand from the
    published widths, the held experts at 10 x 8 / 72 pairs a token and
    layer, and the attention and SSD cores; the backward twice the
    forward."""
    from perfbench.flops import ssd_flops
    from perfbench.granite_flops import step_flops
    c = toy.load_json(toy.BENCH / "configs" / f"{CONFIG}.json")
    d, di, B, S = 4096, 8192, 2, 8192
    mamba = 2 * d * di + 3 * d * 128 + di * d       # z, x, B, C, dt, out
    attn = d * 4096 + 2 * d * 1024 + 4096 * d       # q, k, v, o
    ffn = d * 72 + 3 * d * 1536                     # router, shared expert
    matrices = 9 * mamba + attn + 10 * ffn + 100_352 * d
    experts = 10 * 6 * d * 768 * (B * S * 10 * 8 / 72)
    core = 2 * (128 + 128) * B * 32 * (S * (S + 1) // 2)
    ssd = 9 * ssd_flops(B, S, 128, 64, 1, 128, 256)
    want = 3 * (2 * B * S * matrices + experts + core + ssd)
    assert step_flops(c, B, S) == pytest.approx(want, rel=1e-12)
    assert 170e12 < want < 180e12


def test_hybrid_mfu_reads_the_cells_step(bench):
    res = toy.run_toy(bench, CELL, trace=True, seconds=0.3)
    assert res["metrics"]["train.hybrid_mfu"]["value"] > 0


def test_a_program_without_the_layout_fails_at_once(bench, monkeypatch):
    from repro_torch.configs import base
    fields = {f.name for f in base.dataclasses.fields(base.ModelConfig)}
    old = base.dataclasses.make_dataclass(
        "ModelConfig", [(f, object, None) for f in sorted(
            fields - {"layer_types", "residual_multiplier",
                      "embedding_multiplier", "logits_scaling",
                      "position_embedding", "gate_topk_first", "shared_d_ff",
                      "moe_dropless", "experts_start", "experts_held"})])
    monkeypatch.setattr(base, "ModelConfig", old)
    with pytest.raises(TypeError):
        toy.run_toy(bench, CELL, seconds=0.1)


@pytest.mark.gpu
def test_traced_run_reads_the_moe_layers_and_experts_on_the_card(
        tmp_path_factory):
    """On the card a traced toy run reads the FFN blocks' device time, the
    held experts' share of their bound and K2's, each at most 100%, and
    the step's structure.  Its vocabulary is 32,768 ids, so that a (tokens
    x vocabulary) f32 block (16 MB) outweighs every other block the step
    allocates, as at the cell's size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import time

    from perfbench.harness import run_cell
    bench = toy.toy_bench(tmp_path_factory.mktemp("bench_card"))
    path = bench / "configs" / f"{CONFIG}.json"
    path.write_text(json.dumps({**toy.load_json(path), **GRANITE,
                                "vocab_size": 32_768}))
    traffic = bench / "traffic" / "pretrain-8k.plain.json"
    traffic.write_text(json.dumps({**toy.load_json(traffic),
                                   "seq_len": 64}))
    res = run_cell(CELL, 2**31 + 83, 0.5, True, bench_dir=bench,
                   spec=toy.SPEC, t_start=time.perf_counter(),
                   emit=lambda line: None)
    assert res["correct"], res
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["train.moe_device_s"] > 0
    assert 0 < m["train.expert_gemm_roofline"] <= 100.0
    assert 0 < m["train.k2_roofline"] <= 100.0
    assert 0 < m["train.hybrid_mfu"] <= 100.0
    assert m["train.forward_device_s"] >= m["train.moe_device_s"]
