"""The benchmark's frozen yardstick on the CPU: the generator, the plain
references and the arithmetic of bounds."""

import numpy as np
import pytest
import torch

from perfbench import flops
from perfbench.gen import mamba2 as gm
from perfbench.reference import mamba2 as refm
from perfbench.reference import patterns as ref
from perfbench.tests import toy


def test_batches_are_deterministic_per_seed():
    cfg = toy.load_json(toy.BENCH / "configs" / "mamba2-2.7b.json")
    traffic = {"batch": 2, "seq_len": 64}
    a = gm.batch(cfg, traffic, 2**31 + 9, 3)
    b = gm.batch(cfg, traffic, 2**31 + 9, 3)
    c = gm.batch(cfg, traffic, 2**31 + 10, 3)
    d = gm.batch(cfg, traffic, 2**31 + 9, 4)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].shape == c[k].shape == (2, 64)
        assert not np.array_equal(a[k], c[k]) and not np.array_equal(a[k],
                                                                     d[k])
    assert 0 <= a["tokens"].min() and a["tokens"].max() < cfg["vocab_size"]


def brute_region(u, mass=0.8):
    """Algorithm 1 by its definition: every gap bound from 0 up, regions
    split at zero-runs longer than it, trimmed, the max-mass one."""
    u = np.asarray(u, np.float32)
    n = len(u)
    total = float(u.sum(dtype=np.float64))
    if total <= 0:
        return 0, n
    for g in range(n + 1):
        regions, start, run = [], 0, 0
        for i in range(n):
            if u[i] <= 0:
                run += 1
                continue
            if run > g and i - run >= start:
                regions.append((start, i - run))
                start = i
            run = 0
        regions.append((start, n))
        best, best_m = None, -1.0
        for lo, hi in regions:
            while lo < hi and u[lo] <= 0:
                lo += 1
            while hi > lo and u[hi - 1] <= 0:
                hi -= 1
            m = float(u[lo:hi].sum(dtype=np.float64))
            if hi > lo and m >= mass * total - 1e-9 and m > best_m:
                best, best_m = (lo, hi), m
        if best is not None:
            return best


def test_algorithm1_matches_its_definition():
    rng = np.random.default_rng(0)
    for _ in range(400):
        n = int(rng.integers(1, 48))
        u = rng.random(n).astype(np.float32)
        u[rng.random(n) < rng.random()] = 0.0
        assert ref.critical_region(u) == brute_region(u), u


def test_row_stats_are_algorithm1_by_its_definition():
    rng = np.random.default_rng(1)
    for _ in range(60):
        n = int(rng.choice([5, 9, 30]))
        u = rng.random(n).astype(np.float32)
        u[rng.random(n) < rng.choice([0.0, 0.3, 1.0])] = 0.0
        st = ref.row_stats(u)
        if not u.any():
            assert st == (0.0, 0.0, float(n))
            continue
        lo, hi = brute_region(u)
        seg = u[lo:hi].astype(np.float64)
        np.testing.assert_allclose(st, [seg.mean(), seg.std(), hi - lo],
                                   rtol=1e-12, atol=1e-15)


def test_critical_seconds_match_a_fine_grid():
    """Events on a grid of 1/64 s: the winner of every grid cell by the
    priority, thread and leaf rules, summed, equals the sweep's seconds."""
    rng = np.random.default_rng(2)
    for _ in range(30):
        E = 8
        s = rng.integers(0, 60, E) / 64
        e = s + rng.integers(1, 20, E) / 64
        kind = rng.integers(0, 4, E)
        depth = rng.integers(0, 3, E)
        ok = (kind != ref.PYTHON) | (rng.random(E) < 0.8)
        got = ref.critical_seconds(kind, depth, ok, s, e, 1.0)
        want = np.zeros(E)
        for c in range(64):
            t0, t1 = c / 64, (c + 1) / 64
            on = (s <= t0) & (e >= t1) & ok
            if not on.any():
                continue
            best = kind[on].min()
            win = on & (kind == best)
            if best == ref.PYTHON:
                win &= depth == depth[win].max()
            want[win] += 1 / 64
        np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_worker_patterns_are_the_programs_summary(seed):
    """At float32 the plain summary of a window equals the program's,
    beta to round-off, mu and sigma to float32."""
    import repro_torch.core  # noqa: F401  (imports summarize after)
    from repro_torch.summarize.base import get_backend
    from repro_torch.summarize.engine import summarize_profile
    from perfbench.drivers.train import plain_profile
    prof = toy.worker_profile(seed)
    got, _ = summarize_profile(prof, backend=get_backend("torch", "cpu"))
    want = plain_profile(prof)
    assert set(got) == set(want)
    gap = ref.pattern_gap({k: (p.beta, p.mu, p.sigma) for k, p in
                           got.items()}, want)
    assert gap < 1e-6
    assert want["xla.other"][1] == 0.0        # no gpu_sm stream: no rows
    assert want["logger"][0] == 0.0           # off the training thread
    assert ref.pattern_gap(plain_profile(prof, "bfloat16"), want) > 1e-5


def test_pattern_gap_names_the_functions():
    want = {"a": np.array([0.5, 0.25, 0.125])}
    assert ref.pattern_gap({"a": [0.5, 0.25, 0.125]}, want) == 0.0
    assert ref.pattern_gap({"a": [0.5, 0.25, 0.135]}, want) == \
        pytest.approx(0.01)
    assert ref.pattern_gap({}, want) == float("inf")
    assert ref.pattern_gap({**want, "b": [0, 0, 0]}, want) == float("inf")


def test_k3_bound_is_the_programs_formula():
    from repro_torch.kernels.ssd_scan import bound_ms
    x = torch.empty((1, 2048, 80, 64), dtype=torch.bfloat16)
    dt = torch.empty((1, 2048, 80))
    Bm = torch.empty((1, 2048, 1, 128), dtype=torch.bfloat16)
    want, _ = bound_ms(x, dt, Bm, Bm, 256)
    got = flops.k3_bound_s(1, 2048, 80, 64, 1, 128, 256, "bfloat16")
    assert got * 1e3 == pytest.approx(want, rel=1e-12)


def test_six_n_d_is_the_programs_model_flops():
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.mamba2_2p7b import CONFIG
    from repro_torch.launch.analysis import model_flops
    n = CONFIG.param_counts()["active"]
    assert flops.train_flops(n, 2048) == model_flops(
        CONFIG, ShapeConfig("t", 2048, 1, "train"))


def test_n_params_is_counted_from_the_published_shapes():
    cfg = toy.load_json(toy.BENCH / "configs" / "mamba2-2.7b.json")
    pub = cfg["published"]["config.json"]
    assert (cfg["num_layers"], cfg["d_model"], cfg["vocab_size"]) == (
        pub["n_layer"], pub["d_model"], pub["vocab_size"])
    assert cfg["n_params"] == gm.n_params(
        {**cfg, "pad_vocab_size_multiple": pub["pad_vocab_size_multiple"]})


def test_mamba2_layout_is_the_programs_tree():
    from repro_torch.models.transformer import Transformer, param_leaves
    from perfbench.drivers.train import port_config
    c = {**toy.load_json(toy.BENCH / "configs" / "mamba2-2.7b.json"),
         **toy.MAMBA}
    tree = Transformer(port_config(c)).init(0, device="cpu")
    got = [(p, tuple(t.shape), str(t.dtype).split(".")[1])
           for p, t in param_leaves(tree)]
    assert got == [(p, s, d) for p, s, d, _ in gm.layout(c)]
    w = gm.make_weights(c, 2**31 + 3, "cpu")
    w2 = gm.make_weights(c, 2**31 + 3, "cpu")
    assert all(torch.equal(w[k], w2[k]) for k in w)


def naive_ssd(x, dt, A, Bm, Cm):
    b, s, h, p = x.shape
    rep = h // Bm.shape[2]
    Bh = Bm.repeat_interleave(rep, 2)
    Ch = Cm.repeat_interleave(rep, 2)
    st = torch.zeros(b, h, p, Bm.shape[3], dtype=x.dtype)
    ys = []
    for t in range(s):
        st = st * torch.exp(dt[:, t] * A)[..., None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dt[:, t], x[:, t], Bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", st, Ch[:, t]))
    return torch.stack(ys, 1)


def test_reference_ssd_is_the_recurrence():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 32, 4, 3, generator=g, dtype=torch.float64)
    dt = torch.rand(2, 32, 4, generator=g, dtype=torch.float64) * 0.2
    A = -torch.rand(4, generator=g, dtype=torch.float64) * 4
    Bm = torch.randn(2, 32, 2, 5, generator=g, dtype=torch.float64)
    Cm = torch.randn(2, 32, 2, 5, generator=g, dtype=torch.float64)
    m = refm.Model({**toy.MAMBA, "expand": 2, "n_groups": 1, "d_conv": 4,
                    "norm_eps": 1e-6, "chunk_size": 8}, "float32")
    torch.testing.assert_close(m.ssd(x, dt, A, Bm, Cm),
                               naive_ssd(x, dt, A, Bm, Cm))


@pytest.mark.parametrize("steps", [1, 2])
def test_reference_step_is_the_programs_in_float32(steps):
    """At a toy size in float32, the reference's losses, first gradients
    and change follow the program's own trainer closely."""
    from repro_torch.models.transformer import param_leaves
    from repro_torch.optim.adamw import AdamW, OptConfig
    from repro_torch.train.step import make_train_step
    from repro_torch.models.transformer import Transformer
    from perfbench.drivers.train import nest, port_config
    c = {**toy.load_json(toy.BENCH / "configs" / "mamba2-2.7b.json"),
         **toy.MAMBA, "param_dtype": "float32", "compute_dtype": "float32"}
    traffic = {"batch": 2, "seq_len": 32}
    w = gm.make_weights(c, 11, "cpu")
    o = c["optimizer"]
    opt = AdamW(OptConfig(**{k: o[k] for k in (
        "lr_peak", "warmup_steps", "total_steps", "min_lr_ratio", "b1", "b2",
        "eps", "weight_decay", "clip_norm")}))
    step = make_train_step(Transformer(port_config(c)), opt)
    params = nest({k: v.clone() for k, v in w.items()})
    state = opt.init(params)
    batches, losses = [], []
    for i in range(steps):
        b = gm.batch(c, traffic, 11, i)
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        batches.append((batch["tokens"], batch["labels"]))
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    r = refm.follow(c, o, w, batches)
    np.testing.assert_allclose(losses, r["losses"], rtol=1e-5)
    change = {p: float((x - w[p]).double().norm())
              for p, x in param_leaves(state["master"])}
    for k in change:
        assert change[k] == pytest.approx(r["change"][k], rel=2e-3,
                                          abs=1e-9), k
