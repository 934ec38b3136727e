"""The granite-4.0-h layout (``configs/granite_4_0_h_small.py``) on the
port's training path, at a tiny size on the CPU: 10 layers with attention
at 5, 18 experts of which a device holds 2 (the cell's ninth), top-4, a
shared expert twice an expert's width, in float32.

The port is held against the benchmark's plain reference
(``perfbench/reference/granite_moe_hybrid.py``, which imports nothing of
the port): logits, loss, every leaf's gradient and three AdamW steps; the
reference against ``transformers``' ``GraniteMoeHybridForCausalLM`` with
the same weights and every expert held; the nine shares of 2 experts add
up to the uncut layer; five faults planted in the port each fail a
tolerance; holding a share of the experts asks for dropless routing; the
published counts; the step's count of the held experts' products; and
what this layout does not run raises ``NotImplementedError``.  The ``gpu`` test holds the held-expert layer on
the card against its CPU result at the cell's widths.  This file imports
no JAX.
"""
import math
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.gen import granite_moe_hybrid as gg  # noqa: E402
from perfbench.reference import granite_moe_hybrid as refg  # noqa: E402
from perfbench.reference import mamba2 as refm  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.transformer import Transformer, param_leaves  # noqa: E402
from repro_torch.optim.adamw import AdamW, OptConfig  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

# autouse fixture: torch on one CPU thread
from _torch_inputs import one_torch_thread  # noqa: F401,E402

LAYERS = 10
EXPERTS, HELD, TOP_K = 18, 2, 4
#: logits: float32 sums in another order (the port's SSD through K3's plain
#: chunked version, its blocked online-softmax attention and its combine
#: in place order; the reference's SSD listing, one softmax and index_add
#: per expert) put both ~1e-6 apart at these widths; 2e-5 is the
#: published Zamba2 layout's tolerance (tests/test_torch_zamba2.py), ten
#: times that gap
LOGIT_ATOL = 2e-5
#: the loss, relative: one float32 reduction of the same logits
LOSS_RTOL = 1e-5
#: each leaf's gradient against its largest entry: float32 round-off
#: through 10 layers of backward (the hybrid families' tolerance)
GRAD_RTOL = 1e-4
#: three AdamW steps: each leaf's change against the reference's, as the
#: benchmark's cell compares them; float32 agreement leaves them ~1e-5
#: apart and the faults 0.1 or more
CHANGE_TOL = 1e-3


def tiny(**kw):
    return get_arch("granite-4.0-h-small").with_overrides(**{
        **dict(num_layers=LAYERS, d_model=64, vocab_size=512, d_ff=32,
               shared_d_ff=64, num_heads=4, num_kv_heads=2, head_dim=16,
               attn_scale=1 / 16, num_experts=EXPERTS, top_k=TOP_K,
               experts_held=HELD, ssm_state=16, ssm_head_dim=16,
               ssm_chunk=32, dtype="float32", param_dtype="float32"),
        **kw})


def ref_config(cfg):
    """The reference's configuration dict for a port config."""
    return {"d_model": cfg.d_model, "num_layers": cfg.num_layers,
            "expand": cfg.ssm_expand, "head_dim": cfg.ssm_head_dim,
            "d_state": cfg.ssm_state, "n_groups": cfg.ssm_groups,
            "d_conv": cfg.conv_width, "chunk_size": cfg.ssm_chunk,
            "norm_eps": cfg.norm_eps, "vocab_size": cfg.vocab_size,
            "pad_vocab_size_multiple": 256, "param_dtype": "float32",
            "layer_types": list(cfg.layer_types),
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "attention_multiplier": cfg.attn_scale,
            "rope_theta": cfg.rope_theta,
            "intermediate_size": cfg.d_ff,
            "shared_intermediate_size": cfg.shared_d_ff,
            "num_local_experts_published": cfg.num_experts,
            "num_local_experts": cfg.held_experts[1],
            "experts_start": cfg.experts_start,
            "num_experts_per_tok": cfg.top_k,
            "residual_multiplier": cfg.residual_multiplier,
            "embedding_multiplier": cfg.embedding_multiplier,
            "logits_scaling": cfg.logits_scaling,
            "router_aux_loss_coef": cfg.aux_loss_weight}


OPT = {"lr_peak": 1e-3, "warmup_steps": 0, "total_steps": 100,
       "min_lr_ratio": 0.1, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
       "weight_decay": 0.1, "clip_norm": 1.0,
       "no_decay": ["norm", "scale", "bias", "ln", "A_log", "dt_bias", "/D",
                    "bi", "bo", "bq", "bk", "bv"]}


def batch(seed=0, ids=512):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, ids, (2, 64), generator=g),
            torch.randint(0, 512, (2, 64), generator=g))


@pytest.fixture(scope="module")
def setup():
    """The tiny model, the benchmark's seeded weights for it and a
    batch."""
    cfg = tiny()
    w = gg.make_weights(ref_config(cfg), 3, "cpu")
    return (cfg, w) + batch()


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
        x = w["embed/table"][tok.long()] * model.emb
        for i, kind in enumerate(model.kinds):
            x = model.layer(refg.sub(w, f"blocks/{i}/"), x, kind)[0]
        x = model.rms(x, w["final_norm/scale"])
        return x @ w["embed/table"].t() / model.logit_div


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


def reference_of(cfg, w, tok, lab):
    refm.no_tf32()
    model = refg.Model(ref_config(cfg))
    loss, grads = refg.loss_and_grads(model, w, tok, lab)
    return ref_logits(model, w, tok), loss, grads


@pytest.fixture(scope="module")
def reference(setup):
    return reference_of(*setup)


def test_published_counts():
    """32,207,337,984 parameters as transformers 4.57.6 counts the
    published model on the meta device; the cell's first 10 layers with 8
    of 72 experts held are 2,320,321,152 (the router at its 72 outputs)."""
    cfg = get_arch("granite-4.0-h-small")
    assert cfg.param_counts()["total"] == 32_207_337_984
    assert cfg.layer_kinds.count("attention") == 4
    assert [i for i, k in enumerate(cfg.layer_kinds) if k == "attention"] \
        == [5, 15, 25, 35]
    cut = cfg.with_overrides(num_layers=10, experts_held=8)
    assert cut.param_counts()["total"] == 2_320_321_152
    # a router cut to the 8 held outputs would be 262,144 fewer a layer
    assert 2_320_321_152 - 10 * 4096 * 64 == 2_317_699_712
    assert (cfg.head_dim, cfg.attn_scale, cfg.position_embedding) == \
        (128, 1 / 128, "nope")


def test_tiny_layout_is_counted(setup):
    cfg, w, _, _ = setup
    assert sum(t.numel() for t in w.values()) == cfg.param_counts()["total"]
    assert w["blocks/5/attn/wq"].shape == (64, 4, 16)
    assert "blocks/5/mamba/w_x" not in w and "blocks/4/attn/wq" not in w
    assert w["blocks/0/moe/router"].shape == (64, EXPERTS)
    assert w["blocks/0/moe/router"].dtype == torch.float32
    assert w["blocks/0/moe/wi"].shape == (HELD, 64, 2, 32)
    assert w["blocks/0/moe/shared/wi"].shape == (64, 2, 64)
    tree = Transformer(cfg).init(0, device="cpu")
    assert [(k, tuple(t.shape)) for k, t in param_leaves(tree)] == \
        [(k, s) for k, s, _, _ in gg.layout(ref_config(cfg))]


def test_port_matches_the_reference(setup, reference):
    """Logits, loss and every leaf's gradient within their tolerances, and
    the held-expert layer ran dropless."""
    cfg, w, tok, lab = setup
    M.counters.reset()
    assert within(port_run(cfg, w, tok, lab), *reference) == []
    assert M.counters.dropped == 0 and M.counters.layers == 2 * LAYERS
    assert 0 < M.counters.largest <= M.counters.pairs


def test_three_adamw_steps_match_the_reference(setup):
    """Three steps of the port's fused step against the reference's
    AdamW: each step's loss within 1e-5, and each leaf's first clipped
    gradient norm and change as the benchmark's cell compares them."""
    from perfbench.drivers.train import compare
    cfg, w, tok, lab = setup
    batches = [(tok, lab), (lab, tok), (tok.flip(1), lab.flip(1))]
    ref = refg.follow(ref_config(cfg), OPT, w, batches)
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


def _softmax_first(cfg, monkeypatch):
    return cfg.with_overrides(gate_topk_first=False)


def _rope(cfg, monkeypatch):
    return cfg.with_overrides(position_embedding="rope")


def _no_ffn_scale(cfg, monkeypatch):
    orig = M.apply_moe

    def unscaled(p, x, c, dist=None):
        y, stats = orig(p, x, c, dist)
        return y / c.residual_multiplier, stats
    monkeypatch.setattr(M, "apply_moe", unscaled)
    return cfg


def _no_shared(cfg, monkeypatch):
    monkeypatch.setattr(L, "apply_mlp", lambda p, x, *a, **k: x * 0.0)
    return cfg


@pytest.mark.parametrize("plant", [_softmax_first, _rope, _no_ffn_scale,
                                   _no_shared])
def test_each_planted_fault_fails_a_tolerance(setup, reference, monkeypatch,
                                              plant):
    """The softmax before the top k, rotary embedding on q and k, the FFN's
    branch added without the residual multiplier, the shared expert
    dropped: each moves the logits or a gradient past its tolerance."""
    cfg, w, tok, lab = setup
    bad = within(port_run(plant(cfg, monkeypatch), w, tok, lab), *reference)
    assert bad, plant.__name__


def _capacity(cfg, monkeypatch):
    """``route`` with the capacity factor 1.25 of the capacity-bound layer:
    the pairs of held experts ranked past it weigh nothing, as if dropped
    (their gate is 0, so their rows add nothing and take no gradient).
    Returns the list to which each call adds the pairs it dropped."""
    orig, dropped = M.route, []

    def capped(p, x, c, capacity):
        probs, eid_s, tid_s, gate_s, counts, pos, keep = orig(p, x, c,
                                                              capacity)
        e0, n = c.held_experts
        past = (pos >= M._capacity(x.shape[0], c)) & (eid_s >= e0) \
            & (eid_s < e0 + n)
        dropped.append(int(past.sum()))
        return (probs, eid_s, tid_s, gate_s.masked_fill(past, 0.0), counts,
                pos, keep)
    monkeypatch.setattr(M, "route", capped)
    return dropped


def test_a_capacity_that_drops_pairs_fails_a_tolerance(setup, monkeypatch):
    """A capacity of 1.25 in place of dropless routing, on a batch of few
    distinct tokens (so that routing is uneven enough to pass the
    capacity): it drops pairs, and the result leaves the reference's."""
    cfg, w, _, _ = setup
    tok, lab = batch(seed=1, ids=6)
    ref = reference_of(cfg, w, tok, lab)
    assert within(port_run(cfg, w, tok, lab), *ref) == []
    dropped = _capacity(cfg, monkeypatch)
    bad = within(port_run(cfg, w, tok, lab), *ref)
    assert sum(dropped) > 0 and bad


def test_the_shares_add_up_to_the_uncut_layer(setup):
    """The routed outputs of the nine shares of 2 experts, each computed by
    the held-expert layer holding its share, plus the shared expert once,
    add up to the reference's layer with all 18 experts held."""
    cfg, w, tok, _ = setup
    full = cfg.with_overrides(experts_held=EXPERTS)
    wf = gg.make_weights(ref_config(full), 5, "cpu")
    p = {k[len("blocks/0/moe/"):]: v for k, v in wf.items()
         if k.startswith("blocks/0/moe/")}
    x = torch.randn(128, 64, generator=torch.Generator().manual_seed(2))
    total = L.apply_mlp({"wi": p["shared/wi"], "wo": p["shared/wo"]}, x,
                        "swiglu")
    for s in range(EXPERTS // HELD):
        share = cfg.with_overrides(experts_start=s * HELD)
        held = {"router": p["router"],
                "wi": p["wi"][s * HELD:(s + 1) * HELD],
                "wo": p["wo"][s * HELD:(s + 1) * HELD]}
        total = total + M._moe_held(held, x, share)[0]
    refm.no_tf32()
    model = refg.Model(ref_config(full))
    want = model.ffn({"moe/" + k: v for k, v in p.items()}, x[None])[0][0]
    assert float((total - want).abs().max()) < 1e-5 * float(
        want.abs().max())


def test_holding_a_share_asks_for_dropless_routing():
    """Only the dropless layer holds a share of the experts: a share with
    the capacity-bound layer raises, and without a share that layer is
    still ``_moe_local`` (deepseek's and llama4's), bit for bit."""
    cfg = tiny(moe_dropless=False)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(1, 96, 64, generator=g)
    with pytest.raises(ValueError):
        M.apply_moe(M.init_moe(g, cfg), x, cfg)
    full = cfg.with_overrides(experts_held=0)
    p = M.init_moe(g, full)
    y, stats = M.apply_moe(p, x, full)
    want, want_stats = M._moe_local(p, x[0], full, 0, EXPERTS,
                                    M._capacity(96, full))
    want = want + L.apply_mlp(p["shared"], x[0], full.mlp)
    assert torch.equal(y[0], want) and torch.equal(stats, want_stats)


def test_step_cost_counts_the_held_experts_products(setup):
    """The step's count (``launch.step_cost``) holds the held experts'
    grouped products as plain matrix products: one FFN block's forward
    and backward (to its input and weights) count the router (6 T d E),
    the held experts (18 d ff a pair routed to them) and the shared
    expert (18 T d ff_shared), and nothing else."""
    from repro_torch.launch.step_cost import count_step
    cfg, w, _, _ = setup
    p = {k[len("blocks/0/moe/"):]: v.clone() for k, v in w.items()
         if k.startswith("blocks/0/moe/")}
    tree = {"router": p["router"], "wi": p["wi"], "wo": p["wo"],
            "shared": {"wi": p["shared/wi"], "wo": p["shared/wo"]}}
    x = torch.randn(1, 100, 64, generator=torch.Generator().manual_seed(6))

    def grad_step(params, xb):
        leaves = [t.requires_grad_(True) for _, t in param_leaves(params)]
        y, _ = M.apply_moe(params, xb.requires_grad_(True), cfg)
        torch.autograd.grad(y.square().sum(), [xb] + leaves)
    M.counters.reset()
    cost = count_step(grad_step, tree, x)
    pairs = M.counters.pairs
    d, T = 64, 100
    want = 6 * T * d * EXPERTS + 18 * d * cfg.d_ff * pairs \
        + 18 * T * d * cfg.shared_d_ff
    assert pairs > 0 and cost.flops == want


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


def _hf_model(cfg, w, chunk):
    """``transformers``' GraniteMoeHybridForCausalLM at the tiny sizes,
    every expert held, holding ``w``, its SSD in chunks of ``chunk``."""
    transformers = pytest.importorskip("transformers")
    hc = transformers.GraniteMoeHybridConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads, intermediate_size=cfg.d_ff,
        shared_intermediate_size=cfg.shared_d_ff,
        num_local_experts=cfg.num_experts, num_experts_per_tok=cfg.top_k,
        mamba_n_heads=cfg.ssm_heads, mamba_d_head=cfg.ssm_head_dim,
        mamba_d_state=cfg.ssm_state, mamba_n_groups=cfg.ssm_groups,
        mamba_d_conv=cfg.conv_width, mamba_expand=cfg.ssm_expand,
        mamba_chunk_size=chunk, mamba_conv_bias=True,
        mamba_proj_bias=False, layer_types=list(cfg.layer_kinds),
        position_embedding_type="nope", attention_bias=False,
        attention_multiplier=cfg.attn_scale,
        residual_multiplier=cfg.residual_multiplier,
        embedding_multiplier=cfg.embedding_multiplier,
        logits_scaling=cfg.logits_scaling, rms_norm_eps=cfg.norm_eps,
        hidden_act="silu", tie_word_embeddings=True,
        max_position_embeddings=256, use_cache=False)
    hc._attn_implementation = "eager"
    m = transformers.GraniteMoeHybridForCausalLM(hc).float().eval()
    d = cfg.d_model
    sd = {"model.embed_tokens.weight": w["embed/table"],
          "model.norm.weight": w["final_norm/scale"]}
    for i, kind in enumerate(cfg.layer_kinds):
        b, pre = f"blocks/{i}/", f"model.layers.{i}."
        sd[pre + "input_layernorm.weight"] = w[b + "ln1/scale"]
        sd[pre + "post_attention_layernorm.weight"] = w[b + "ln2/scale"]
        if kind == "mamba":
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
        else:
            for k in ("q", "k", "v"):
                sd[pre + f"self_attn.{k}_proj.weight"] = \
                    w[b + f"attn/w{k}"].reshape(d, -1).t()
            sd[pre + "self_attn.o_proj.weight"] = \
                w[b + "attn/wo"].reshape(-1, d).t()
        moe = pre + "block_sparse_moe."
        sd[moe + "router.layer.weight"] = w[b + "moe/router"].t()
        sd[moe + "input_linear.weight"] = w[b + "moe/wi"].flatten(2) \
            .transpose(1, 2)
        sd[moe + "output_linear.weight"] = w[b + "moe/wo"].transpose(1, 2)
        sd[pre + "shared_mlp.input_linear.weight"] = \
            w[b + "moe/shared/wi"].reshape(d, -1).t()
        sd[pre + "shared_mlp.output_linear.weight"] = \
            w[b + "moe/shared/wo"].t()
    own = m.state_dict()
    missing = [k for k in own if k not in sd and k != "lm_head.weight"]
    assert not missing, missing
    m.load_state_dict({**own, **{k: v.float() for k, v in sd.items()}})
    return m


@pytest.mark.parametrize("chunk", [64, 16])
def test_reference_is_transformers_granite(setup, chunk):
    """The reference's logits against ``GraniteMoeHybridForCausalLM``'s
    with the same weights and all 18 experts held, within float32
    round-off of two SSD formulations (the reference's chunked listing in
    chunks of 32, ``transformers``' segment sums in one chunk of 64 or
    four of 16: unlike Zamba2's, 4.57.6's CPU path for this model carries
    the state across chunks right)."""
    cfg, _, tok, _ = setup
    full = cfg.with_overrides(experts_held=EXPERTS)
    w = gg.make_weights(ref_config(full), 7, "cpu")
    m = _hf_model(full, w, chunk)
    with torch.no_grad():
        hf = m(tok.long(), use_cache=False).logits
    refm.no_tf32()
    want = ref_logits(refg.Model(ref_config(full)), w, tok)
    assert float((hf - want).abs().max()) < LOGIT_ATOL


def _abs_rows(p, x, cfg):
    """Each token's largest column of ``|shared row| + sum |held rows|``
    (its routed rows weighed by their gates), and its pairs routed to held
    experts, in float32 on the CPU from the layer's bf16 operands: no value
    the bf16 layer adds up for a token (a row, a partial sum) is larger."""
    x = x.float()
    top, idx = torch.topk(x @ p["router"].float(), cfg.top_k)
    gates = torch.softmax(top, dim=-1)
    e0, n = cfg.held_experts
    f32 = {k: v.float() for k, v in p["shared"].items()}
    acc = L.apply_mlp(f32, x, cfg.mlp).abs()
    for e in range(n):
        t, j = (idx == e0 + e).nonzero(as_tuple=True)
        rows = L.apply_mlp({"wi": p["wi"][e].float(),
                            "wo": p["wo"][e].float()}, x[t], cfg.mlp)
        acc.index_add_(0, t, (rows * gates[t, j, None]).abs())
    held = ((idx >= e0) & (idx < e0 + n)).sum(-1)
    return acc.amax(-1), held


@pytest.mark.gpu
def test_held_layer_on_the_card_matches_its_cpu_result():
    """The held-expert layer at the cell's widths (d 4096, experts of 768,
    8 of 72 held, top 10, the shared expert of 1536) over 2048 bf16 tokens
    on the card against the same layer on the CPU, no pair dropped on
    either.  The f32 router's sums run in another order on the card, so a
    token whose 10th and 11th logits lie within that round-off may route
    elsewhere: at most 1% of the tokens may.

    Every output of the others lies within a bound counted from the
    layer's bf16 roundings.  Both sides round the same values, their f32
    sums taken in another order, so each rounding may land one bf16 ulp
    apart, the ulp of the largest value the token adds up (``_abs_rows``).
    A token with ``n`` pairs held passes ``4 n + 1`` such ulps: each held
    row's product rounded (1) and its bf16 gate, which moves the whole row
    by up to 2^-7 of it (2); the shared expert's product (1); and ``n``
    bf16 adds (``n - 1`` in the combine, whose first add is to zero and
    exact, and the shared expert's).  The roundings of h and of the
    activation upstream move a row's f32 sum by a few hundredths of an ulp,
    which the grid of its final rounding takes up."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = get_arch("granite-4.0-h-small").with_overrides(
        num_layers=1, experts_held=8)
    g = torch.Generator().manual_seed(8)
    p = M.init_moe(g, cfg, torch.bfloat16)
    x = torch.randn(2048, 4096, generator=g).to(torch.bfloat16)
    out = {}
    for dev in ("cpu", "cuda"):
        pd, xd = T.map_params(lambda t: t.to(dev), p), x.to(dev)
        M.counters.reset()
        y, _ = M.apply_moe(pd, xd[None], cfg)
        idx = torch.topk(xd.float() @ pd["router"], cfg.top_k).indices
        out[dev] = (y[0].cpu(), idx.sort(-1).values.cpu(),
                    M.counters.pairs, M.counters.dropped)
    (yc, ic, pc, dc), (yg, ig, pg, dg) = out["cpu"], out["cuda"]
    scale, held = _abs_rows(p, x, cfg)
    # the ulp of the binade of the largest value, the f32 sum's round-off
    # to the bf16 values it stands for (a few 2^-8) left room
    ulp = 2.0 ** (torch.floor(torch.log2(scale * (1 + 2 ** -5))) - 7)
    same = (ic == ig).all(-1)
    diff = (yg.float() - yc.float()).abs().amax(-1)[same] / ulp[same]
    bound = (4 * held + 1)[same].float()
    print(f"[granite moe card] tokens routed alike {int(same.sum())} of "
          f"2048; held pairs {pc} / {pg}; worst |diff| in ulps "
          f"{float(diff.max())!r} (bound {int(bound[diff.argmax()])}); "
          f"worst |diff| / bound {float((diff / bound).max())!r}; most "
          f"pairs a token {int(held.max())}")
    assert dc == dg == 0 and pc > 0
    assert float(same.float().mean()) >= 0.99
    assert bool((diff <= bound).all())
