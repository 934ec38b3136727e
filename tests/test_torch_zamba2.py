"""The published Zamba2 layout (``configs/zamba2_7b_instruct.py``) on the
port's training path, at a tiny size on the CPU: 12 layers with hybrid
layers 6 and 11 (shared blocks A, B), adapters of rank 8, 2 SSM groups
and the gated norm per group, in float32.

The port is held against the benchmark's plain reference
(``perfbench/reference/zamba2.py``, which imports nothing of the port):
logits, loss, every leaf's gradient and three AdamW steps; the reference
against ``transformers``' ``Zamba2ForCausalLM`` with the same weights;
four faults planted in the port each fail a tolerance; the counts of the
published sizes; K2 at head dim 224 in the step's count and the dry run's
fake op; the grouped gated norm's formula; and what this layout does not
run raises ``NotImplementedError``.  This file imports no JAX.
"""
import math
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.reference import mamba2 as refm  # noqa: E402
from perfbench.reference import zamba2 as refz  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.kernels import rms_norm as K4  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.transformer import Transformer, param_leaves  # noqa: E402
from repro_torch.optim.adamw import AdamW, OptConfig  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401,E402

HYBRID = (6, 11)
LAYERS = 12
#: logits: float32 sums in another order (the port's SSD through K3's plain
#: chunked version and its blocked online-softmax attention, the
#: reference's SSD listing and one softmax) put both ~1e-6 apart at these
#: widths; 2e-5 is ten times that and a tenth of the smallest fault's gap
LOGIT_ATOL = 2e-5
#: the loss, relative: one float32 reduction of the same logits
LOSS_RTOL = 1e-5
#: each leaf's gradient against its largest entry: float32 round-off
#: through 12 layers of backward (worst ~3e-5, on dt_bias) (the hybrid
#: family's tolerance, tests/test_torch_hybrid.py)
GRAD_RTOL = 1e-4
#: three AdamW steps: each leaf's change against the reference's, as the
#: benchmark's cell compares them; float32 agreement leaves them ~1e-5 apart
#: and the faults 0.1 or more
CHANGE_TOL = 1e-3


def tiny(**kw):
    return get_arch("zamba2-7b-instruct").with_overrides(
        num_layers=LAYERS, d_model=64, vocab_size=512, d_ff=128,
        num_heads=4, num_kv_heads=4, head_dim=32, attn_scale=16 ** -0.5,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=32, adapter_rank=8,
        hybrid_layer_ids=HYBRID, dtype="float32", param_dtype="float32",
        **kw)


def ref_config(cfg):
    """The reference's configuration dict for a port config."""
    return {"d_model": cfg.d_model, "num_layers": cfg.num_layers,
            "expand": cfg.ssm_expand, "head_dim": cfg.ssm_head_dim,
            "d_state": cfg.ssm_state, "n_groups": cfg.ssm_groups,
            "d_conv": cfg.conv_width, "chunk_size": cfg.ssm_chunk,
            "norm_eps": cfg.norm_eps, "vocab_size": cfg.vocab_size,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "intermediate_size": cfg.d_ff, "num_mem_blocks":
            cfg.num_mem_blocks, "rope_theta": cfg.rope_theta,
            "layers_block_type": ["hybrid" if i in cfg.hybrid_layer_ids
                                  else "mamba"
                                  for i in range(cfg.num_layers)],
            "adapter_rank": cfg.adapter_rank, "param_dtype": "float32",
            "pad_vocab_size_multiple": 256}


OPT = {"lr_peak": 1e-3, "warmup_steps": 0, "total_steps": 100,
       "min_lr_ratio": 0.1, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
       "weight_decay": 0.1, "clip_norm": 1.0,
       "no_decay": ["norm", "scale", "bias", "ln", "A_log", "dt_bias", "/D",
                    "bi", "bo", "bq", "bk", "bv"]}


@pytest.fixture(scope="module")
def setup():
    """The tiny model, the benchmark's seeded weights for it (fan-in
    scaled: the port's own init draws q/k/v and the MLP's gate_up at a
    fan-in of their head and gate axes, and activations that large turn
    float32 round-off into visible logit gaps), and a batch."""
    from perfbench.gen import zamba2 as gz
    cfg = tiny()
    w = gz.make_weights(ref_config(cfg), 3, "cpu")
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    lab = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    return cfg, w, tok, lab


def nest_like(cfg, w):
    """The port's tree holding the tensors of ``{path: tensor}``."""
    tree = Transformer(cfg).init(3, device="cpu")
    return T.unflatten_like(tree, [w[k].clone()
                                   for k, _ in param_leaves(tree)])


def port_run(cfg, w, tok, lab):
    """(logits, loss, {path: gradient}) of the port."""
    model = Transformer(cfg)
    p = nest_like(cfg, w)
    leaves = [t.requires_grad_(True) for _, t in param_leaves(p)]
    hidden, _, _ = model.forward(p, {"tokens": tok})
    logits = model.logits(p, hidden)
    loss, _ = model.loss(p, {"tokens": tok, "labels": lab})
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return (logits.detach(), float(loss.detach()),
            {k: gk for (k, _), gk in zip(param_leaves(p), grads)})


def ref_logits(model, w, tok):
    """The reference's forward, unblocked, to the logits."""
    with torch.no_grad():
        e = w["embed/table"][tok.long()]
        x = e
        for i in range(model.L):
            p = refz.sub(w, f"blocks/{i}/")
            if i in model.ids:
                sp = refz.sub(w, f"shared/{model.block_of(i)}/")
                x = model.hybrid_layer(p, sp, x, e)
            else:
                x = model.mamba_layer(p, x)
        x = model.rms(x, w["final_norm/scale"])
        return x @ w["embed/table"].t()


def within(port, ref_logits_, ref_loss, ref_grads):
    """The tolerances that fail (empty when the port agrees)."""
    logits, loss, grads = port
    bad = []
    if float((logits - ref_logits_).abs().max()) > LOGIT_ATOL:
        bad.append("logits")
    if abs(loss - ref_loss) > LOSS_RTOL * abs(ref_loss):
        bad.append("loss")
    for k, g in grads.items():
        if float((g - ref_grads[k]).abs().max()) \
                > GRAD_RTOL * float(ref_grads[k].abs().max()):
            bad.append(k)
    return bad


@pytest.fixture(scope="module")
def reference(setup):
    cfg, w, tok, lab = setup
    refm.no_tf32()
    model = refz.Model(ref_config(cfg))
    loss, grads = refz.loss_and_grads(model, w, tok, lab)
    return ref_logits(model, w, tok), loss, grads


def test_published_counts():
    """7,356,749,648 parameters, and 2,733,050,240 in the first 24 layers
    (hybrid at 6, 11, 17, 23), as transformers 4.57.6's Zamba2ForCausalLM
    counts them on the meta device; the JAX reference's simplified
    zamba2-7b keeps its own count."""
    cfg = get_arch("zamba2-7b-instruct")
    assert cfg.param_counts()["total"] == 7_356_749_648
    cut = cfg.with_overrides(num_layers=24)
    assert cut.hybrid_ids == (6, 11, 17, 23)
    assert cut.param_counts()["total"] == 2_733_050_240
    assert get_arch("zamba2-7b").param_counts()["total"] == 6_672_161_504
    assert (cfg.head_dim, cfg.num_heads, cfg.num_mem_blocks) == (224, 32, 2)
    assert cfg.attn_scale == pytest.approx(112 ** -0.5)


def test_tiny_layout_is_counted_and_cycles_the_blocks(setup):
    cfg, w, _, _ = setup
    assert sum(t.numel() for t in w.values()) == cfg.param_counts()["total"]
    assert [k for k in w if k.startswith("blocks/6/") and "mamba" not in k] \
        == ["blocks/6/adapter/a", "blocks/6/adapter/b", "blocks/6/linear",
            "blocks/6/ln/scale"]
    assert w["shared/0/ln1/scale"].shape == (128,)
    assert w["shared/0/attn/wq"].shape == (128, 4, 32)
    assert w["shared/1/attn/wo"].shape == (4, 32, 64)
    model = refz.Model(ref_config(cfg))
    assert [model.block_of(i) for i in HYBRID] == [0, 1]


def test_port_matches_the_reference(setup, reference):
    """Logits, loss and every leaf's gradient within their tolerances."""
    cfg, w, tok, lab = setup
    assert within(port_run(cfg, w, tok, lab), *reference) == []


def test_three_adamw_steps_match_the_reference(setup):
    """Three steps of the port's fused step against the reference's
    AdamW: each step's loss within 1e-5, and each leaf's first clipped
    gradient norm and change as the benchmark's cell compares them."""
    from perfbench.drivers.train import compare
    cfg, w, tok, lab = setup
    batches = [(tok, lab), (lab, tok), (tok.flip(1), lab.flip(1))]
    ref = refz.follow(ref_config(cfg), OPT, w, batches)
    model, opt = Transformer(cfg), AdamW(OptConfig(**{
        k: v for k, v in OPT.items() if k != "no_decay"}))
    step = make_train_step(model, opt)
    p = nest_like(cfg, w)
    state = opt.init(p)
    losses = []
    for i, (t, lb) in enumerate(batches):
        p, state, m = step(p, state, {"tokens": t, "labels": lb})
        losses.append(float(m["loss"]))
        if i == 0:
            grad1 = {k: float(x.double().norm()) / (1 - OPT["b1"])
                     for k, x in param_leaves(state["m"])}
    change = {k: float((x - w[k]).double().norm())
              for k, x in param_leaves(state["master"])}
    nums = compare(losses, grad1, change, ref)
    assert nums["loss_gap"] < 1e-5, nums
    for k in ("grad_gap", "change_gap"):
        assert nums[k] < CHANGE_TOL, nums


def _swap_blocks(cfg, w, monkeypatch):
    w = dict(w)
    for k in [k for k in w if k.startswith("shared/0/")]:
        k1 = "shared/1/" + k[len("shared/0/"):]
        w[k], w[k1] = w[k1], w[k]
    return cfg, w


def _no_embed(cfg, w, monkeypatch):
    orig = T.apply_shared_block
    monkeypatch.setattr(T, "apply_shared_block",
                        lambda sp, x, e, *a: orig(sp, x, torch.zeros_like(e),
                                                  *a))
    return cfg, w


def _no_adapter(cfg, w, monkeypatch):
    orig = L.apply_mlp
    monkeypatch.setattr(L, "apply_mlp", lambda p, x, kind, exact=False,
                        adapter=None: orig(p, x, kind, exact))
    return cfg, w


def _row_norm(cfg, w, monkeypatch):
    return cfg.with_overrides(ssm_grouped_norm=False), w


@pytest.mark.parametrize("plant", [_swap_blocks, _no_embed, _no_adapter,
                                   _row_norm])
def test_each_planted_fault_fails_a_tolerance(setup, reference, monkeypatch,
                                              plant):
    """Blocks A and B swapped, the embedding half of the concat zeroed, the
    adapters dropped, the gated norm over the whole row: each moves the
    logits or a gradient past its tolerance."""
    cfg, w, tok, lab = setup
    cfg, w = plant(cfg, w, monkeypatch)
    bad = within(port_run(cfg, w, tok, lab), *reference)
    assert bad, plant.__name__


def _hf_model(cfg, w, seq_len):
    """``transformers``' Zamba2ForCausalLM at the tiny sizes, holding
    ``w``.  ``time_step_min`` is set below any dt these weights give:
    ``transformers``' CPU path clamps dt there and the published CUDA path
    does not (the reference's departure).  Its chunk is the whole
    sequence: 4.57.6's CPU path (``Zamba2MambaMixer.torch_forward``) sums
    the chunk states over the target chunk's axis (``.sum(dim=2)`` where
    the source chunk's is 3), so past the first chunk it leaves the
    recurrence; one chunk takes that path out (the reference's chunked
    scan is held to the recurrence in perfbench's tests)."""
    transformers = pytest.importorskip("transformers")
    rc = ref_config(cfg)
    hc = transformers.Zamba2Config(
        vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads, intermediate_size=cfg.d_ff,
        mamba_d_state=cfg.ssm_state, mamba_headdim=cfg.ssm_head_dim,
        n_mamba_heads=cfg.ssm_heads, mamba_ngroups=cfg.ssm_groups,
        mamba_d_conv=cfg.conv_width, mamba_expand=cfg.ssm_expand,
        chunk_size=seq_len, num_mem_blocks=cfg.num_mem_blocks,
        adapter_rank=cfg.adapter_rank, use_mem_rope=True,
        use_shared_attention_adapter=False, hidden_act="gelu",
        rms_norm_eps=cfg.norm_eps, rope_theta=cfg.rope_theta,
        layers_block_type=rc["layers_block_type"], time_step_min=1e-9,
        max_position_embeddings=256, tie_word_embeddings=True,
        use_cache=False)
    hc._attn_implementation = "eager"
    m = transformers.Zamba2ForCausalLM(hc).float().eval()
    sd = {"model.embed_tokens.weight": w["embed/table"],
          "model.final_layernorm.weight": w["final_norm/scale"]}
    d, ff = cfg.d_model, cfg.d_ff
    for i in range(cfg.num_layers):
        b = f"blocks/{i}/"
        pre = f"model.layers.{i}." + ("mamba_decoder." if i in HYBRID
                                      else "")
        sd[pre + "input_layernorm.weight"] = w[b + "ln/scale"]
        mb = pre + "mamba."
        sd[mb + "in_proj.weight"] = torch.cat(
            [w[b + f"mamba/{k}"] for k in ("w_z", "w_x", "w_B", "w_C",
                                           "w_dt")], 1).t()
        sd[mb + "conv1d.weight"] = torch.cat(
            [w[b + f"mamba/conv_{k}_w"] for k in "xBC"])[:, None]
        sd[mb + "conv1d.bias"] = torch.cat(
            [w[b + f"mamba/conv_{k}_b"] for k in "xBC"])
        for k in ("A_log", "D", "dt_bias"):
            sd[mb + k] = w[b + f"mamba/{k}"]
        sd[mb + "norm.weight"] = w[b + "mamba/gate_norm"]
        sd[mb + "out_proj.weight"] = w[b + "mamba/out_proj"].t()
        if i in HYBRID:
            j = HYBRID.index(i)
            s = f"shared/{j % cfg.num_mem_blocks}/"
            lay = f"model.layers.{i}."
            sd[lay + "linear.weight"] = w[b + "linear"].t()
            st = lay + "shared_transformer."
            for k in ("q", "k", "v"):
                sd[st + f"self_attn.{k}_proj.weight"] = \
                    w[s + f"attn/w{k}"].reshape(2 * d, -1).t()
            sd[st + "self_attn.o_proj.weight"] = \
                w[s + "attn/wo"].reshape(-1, d).t()
            sd[st + "feed_forward.gate_up_proj.weight"] = \
                w[s + "mlp/wi"].reshape(d, 2 * ff).t()
            sd[st + "feed_forward.down_proj.weight"] = w[s + "mlp/wo"].t()
            sd[st + "input_layernorm.weight"] = w[s + "ln1/scale"]
            sd[st + "pre_ff_layernorm.weight"] = w[s + "ln2/scale"]
            ad = st + f"feed_forward.gate_up_proj_adapter_list.{j}."
            sd[ad + "0.weight"] = w[b + "adapter/a"].t()
            sd[ad + "1.weight"] = w[b + "adapter/b"].reshape(-1, 2 * ff).t()
    own = m.state_dict()
    missing = [k for k in own if k not in sd and k != "lm_head.weight"]
    assert not missing, missing
    m.load_state_dict({**own, **{k: v.float() for k, v in sd.items()}})
    return m


def test_reference_is_transformers_zamba2(setup, reference):
    """The reference's logits against ``Zamba2ForCausalLM``'s with the same
    weights, within float32 round-off of two SSD formulations (the
    reference's chunked listing, ``transformers``' segment sums)."""
    cfg, w, tok, _ = setup
    m = _hf_model(cfg, w, tok.shape[1])
    with torch.no_grad():
        hf = m(tok.long(), use_cache=False).logits
    assert float((hf - reference[0]).abs().max()) < LOGIT_ATOL


def test_grouped_gated_norm_backward_is_autograd_in_float64():
    """K4's gated variant with a norm per group (its plain version on the
    CPU): the forward is the grouped formula and the backward formula is
    autograd's, both in float64; one group is the whole-row norm."""
    g = torch.Generator().manual_seed(1)

    def r(*s):
        return torch.randn(s, generator=g, dtype=torch.float64)
    y, xs, z = r(2, 5, 8, 6), r(2, 5, 8, 6), r(2, 5, 48)
    D, scale = 1 + r(8), 1 + 0.1 * r(48)
    ins = [t.requires_grad_(True) for t in (y, xs, D, z, scale)]
    for groups in (1, 2, 4):
        out = K4.rms_norm.gated(*ins, 1e-5, groups)
        u = (ins[0] + ins[1].float().double() * ins[2][:, None]).reshape(
            2, 5, 48) * torch.nn.functional.silu(ins[3])
        ug = u.reshape(2, 5, groups, -1)
        want = (ug * torch.rsqrt(ug.square().mean(-1, keepdim=True) + 1e-5)
                ).reshape(2, 5, 48) * ins[4]
        assert float((out - want).abs().max()) < 1e-6
        dout = r(2, 5, 48)
        got = torch.autograd.grad(out, ins, dout)
        exp = torch.autograd.grad(want, ins, dout)
        for a, b in zip(got, exp):
            assert float((a - b).abs().max()) < 1e-6 * max(
                1.0, float(b.abs().max()))
    # the model's composed path takes the same groups
    out = S.gated_norm(y, xs, D, z, scale, 1e-5, 2)
    assert torch.allclose(out, K4.gated_rms_norm_reference(
        y, xs, D, z, scale, 1e-5, 2)[0].to(out.dtype), atol=1e-7)


def test_k2_counts_the_real_head_dim(setup):
    """The step's count adds K2 at its real head dim (a tiny model's 32
    here; 224 the published one's) for each hybrid layer, and the dry
    run's fake op takes bf16 at 224 on the card's route."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.step_cost import count_step
    from repro_torch.train.step import _grad_fn
    cfg, w, tok, lab = setup
    cost = count_step(_grad_fn(Transformer(cfg)), nest_like(cfg, w),
                      {"tokens": tok, "labels": lab})
    pairs = 64 * 65 // 2
    assert cost.detail_flops["flash_attention"] == \
        len(HYBRID) * 2.0 * (32 + 32) * 2 * 4 * pairs
    with FakeTensorMode():
        q = torch.empty((1, 256, 4, 224), dtype=torch.bfloat16,
                        device="cuda")
        out, lse = torch.ops.repro_torch.flash_attention_fwd(
            q, q, q, True, 0, 0.0, 112 ** -0.5, 0, None)
    assert out.shape == (1, 256, 4, 224) and lse.shape == (1, 256, 4)


def test_what_the_layout_does_not_run_raises(setup):
    cfg, w, tok, _ = setup
    model = Transformer(cfg)
    p = nest_like(cfg, w)
    with pytest.raises(NotImplementedError):
        model.init_cache(1, 16, device="cpu")
    with pytest.raises(NotImplementedError):
        model.decode_step(p, [], {"tokens": tok[:, :1]}, 0)
    with pytest.raises(NotImplementedError):
        model.forward(p, {"tokens": tok}, collect_cache=True)

    class Mesh:
        mesh = object()
    with pytest.raises(NotImplementedError):
        Transformer(cfg, dist=Mesh())
    assert math.isfinite(float(model.loss(p, {"tokens": tok,
                                              "labels": tok})[0]))
