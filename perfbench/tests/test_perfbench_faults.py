"""The correctness check catches what it must: each fault a cell can have,
planted in the program underneath a whole run at a toy size on the CPU
(the harness's look for a card skipped), turns ``correct`` false, as does
the control, the reference in the precision below the configuration's."""
import pytest
import torch

from perfbench.tests import toy

TRAIN = "train.mamba2-2.7b.profiled"


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return toy.toy_bench(tmp_path_factory.mktemp("bench"))


def _fails(bench, cell, **kw):
    res = toy.run_toy(bench, cell, **kw)
    return not res["correct"], res["checks"]


# -- the window summary: K1's answers altered, half its rows left out, the
# -- summary skipped


def _altered(self, u):
    from perfbench.drivers.train import PlantedK1
    return PlantedK1.alter(self._orig(u), "shift")


def _half_rows(self, u):
    from perfbench.drivers.train import PlantedK1
    return PlantedK1.alter(self._orig(u), "half")


@pytest.mark.parametrize("fault", [_altered, _half_rows])
def test_a_fault_in_k1_is_caught(bench, monkeypatch, fault):
    import repro_torch.core.service  # noqa: F401  (imports summarize after)
    from repro_torch.summarize import backends
    monkeypatch.setattr(backends.TorchBackend, "_orig",
                        backends.TorchBackend.batch_stats, raising=False)
    monkeypatch.setattr(backends.TorchBackend, "batch_stats", fault)
    bad, checks = _fails(bench, TRAIN, seconds=0.1)
    assert bad and checks["pattern_gap"]["value"] > \
        checks["pattern_gap"]["limit"], checks


def test_a_skipped_window_summary_is_caught(bench, monkeypatch):
    from repro_torch.core import daemon
    orig = daemon.summarize_and_upload

    def skipped(profile, *a, **kw):
        return orig(type(profile)(worker=profile.worker,
                                  window=profile.window), *a, **kw)
    monkeypatch.setattr(daemon, "summarize_and_upload", skipped)
    bad, checks = _fails(bench, TRAIN, seconds=0.1)
    assert bad and checks["pattern_gap"]["value"] > 1.0, checks


def test_summary_control_fails():
    """The plain summary with bfloat16 samples in the program's place
    reads over the limit."""
    from perfbench.drivers.train import plain_profile
    from perfbench.reference import patterns as ref
    lim = toy.load_json(toy.BENCH / "workloads" / f"{TRAIN}.json")["limits"]
    prof = toy.worker_profile(5)
    assert ref.pattern_gap(plain_profile(prof, "bfloat16"),
                           plain_profile(prof)) > 3 * lim["pattern_gap"]


# -- training: a state left unchanged, half the batch, a gradient altered


def _wrap_step(monkeypatch, grad=None, opt=None):
    from repro_torch.train import loop
    orig = loop.make_split_train_step

    def make(model, o):
        g, u = orig(model, o)
        return (grad(g) if grad else g), (opt(u) if opt else u)
    monkeypatch.setattr(loop, "make_split_train_step", make)


def test_a_step_that_leaves_the_state_unchanged_is_caught(bench,
                                                          monkeypatch):
    _wrap_step(monkeypatch,
               opt=lambda u: (lambda g, s, p: (p, s, {"lr": 0.0,
                                                      "grad_norm": 0.0})))
    bad, checks = _fails(bench, TRAIN, seconds=0.1)
    assert bad and checks["change_gap"]["value"] >= 0.99, checks


def test_a_step_on_half_the_batch_is_caught(bench, monkeypatch):
    def half(g):
        def step(params, batch):
            lab = batch["labels"].clone()
            lab[:, lab.shape[1] // 2:] = -1
            return g(params, {**batch, "labels": lab})
        return step
    _wrap_step(monkeypatch, grad=half)
    bad, checks = _fails(bench, TRAIN, seconds=0.1)
    assert bad, checks


def test_a_gradient_altered_where_it_is_produced_is_caught(bench,
                                                           monkeypatch):
    def altered(g):
        def step(params, batch):
            grads, m = g(params, batch)
            grads["blocks"][0]["mamba"]["w_x"] = \
                grads["blocks"][0]["mamba"]["w_x"] * 2
            return grads, m
        return step
    _wrap_step(monkeypatch, grad=altered)
    bad, checks = _fails(bench, TRAIN, seconds=0.1)
    assert bad, checks


def test_training_control_fails(bench):
    """The reference with float8 operands in the program's place reads
    over a limit."""
    from perfbench.drivers.train import compare
    from perfbench.gen import mamba2 as gm
    from perfbench.reference import mamba2 as refm
    lim = toy.load_json(toy.BENCH / "workloads" / f"{TRAIN}.json")["limits"]
    cfg = toy.load_json(bench / "configs" / "mamba2-2.7b.json")
    traffic = toy.load_json(bench / "traffic" / "pretrain-2k.profiled.json")
    batches = []
    for i in range(int(traffic["reference_steps"])):
        b = gm.batch(cfg, traffic, 17, i)
        batches.append((torch.from_numpy(b["tokens"]),
                        torch.from_numpy(b["labels"])))
    base = refm.follow(cfg, cfg["optimizer"],
                       gm.make_weights(cfg, 17, "cpu"), batches)
    ctl = refm.follow(cfg, cfg["optimizer"],
                      gm.make_weights(cfg, 17, "cpu"), batches, "fp8")
    nums = compare(ctl["losses"], ctl["grad1"], ctl["change"], base)
    assert any(nums[k] > lim[k] for k in lim if k in nums), nums
