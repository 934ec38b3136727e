"""The port's distribution (``dist/``, the models' ``dist``, ``Trainer`` and
``Engine`` under a mesh, elastic restore, compressed all-reduces) on the
CPU: 8 ``gloo`` ranks on a 2 x 4 ``("data", "model")`` mesh.

The ranks are spawned ONCE for the module (``tests/_torch_dist_ranks.py``,
8 processes): they run every check in turn and rank 0 writes the results,
and each test here asserts one of them.  The twins of tests/test_dist.py's
four tests come first; the sharded step is held against the port's OWN
single-device step (the reference's sharded test fails).  The placement
rule is held against the reference's ``_shard_leaf_fsdp``, run in a
subprocess with 8 host devices as tests/test_dist.py runs it.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
WORLD = 8


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_ranks")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                           str(REPO / "tests")]))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_dist_ranks.py"),
         str(r), str(WORLD), str(port), str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    path = out / "results.json"
    assert path.exists(), "rank 0 wrote no results:\n" + logs[0][-4000:]
    return json.loads(path.read_text())


def _result(ranks, name):
    r = ranks[name]
    assert r["ok"], r["error"]
    return r["result"]


def test_sharded_train_step_matches_single_device(ranks):
    r = _result(ranks, "sharded_step")
    assert abs(r["loss1"] - r["loss2"]) < 1e-3
    assert r["maxdiff"] < 5e-3


def test_moe_expert_parallel_matches_local(ranks):
    r = _result(ranks, "moe_expert_parallel")
    assert r["err"] < 5e-4 and r["perr"] < 1e-3
    assert r["count_err"] == 0.0


def test_moe_expert_parallel_gradients_match_local(ranks):
    """Every input's gradient through the expert-parallel region (router
    and x partial over shards, experts' FSDP gathers) within 1e-4 of its
    largest entry."""
    assert _result(ranks, "moe_expert_parallel")["grad_rel"] < 1e-4


def test_elastic_checkpoint_restore_new_mesh(ranks):
    r = _result(ranks, "elastic_restore")
    assert r["placements"] == ["S(0)", "S(1)"] and r["same_mesh"]
    assert r["step"] == 1 and r["local_shape"] == [4, 4]
    assert r["equal"] is True
    assert r["files_equal"] is True


def test_moe_expert_parallel_with_zero1_experts(ranks):
    r = _result(ranks, "moe_zero1")
    assert r["err"] < 5e-4 and r["perr"] < 1e-3
    assert r["grad_rel"] < 1e-4


def test_moe_expert_parallel_on_two_data_parallel_dims(ranks):
    r = _result(ranks, "mesh3_moe")
    assert r["err"] < 5e-4 and r["perr"] < 1e-3
    assert r["grad_rel"] < 1e-4


def test_grad_compression_psum(ranks):
    r = _result(ranks, "psum_compressed")
    assert r["bf16_err"] < 0.02 and r["int8_err"] < 0.05
    assert r["exact_err"] < 1e-6


def test_step_cost_counts_collectives_over_the_group(ranks):
    """int8 over 8 ranks: two all-reduces (the scale, 4 bytes; the int32
    payload, 32 x 4 bytes) at the ring traffic 2 size (n-1)/n, n = 8."""
    r = _result(ranks, "psum_compressed")
    assert r["int8_coll_counts"] == {"all-reduce": 2.0}
    assert r["int8_coll_bytes"]["all-reduce"] == \
        pytest.approx(2.0 * (4 + 128) * 7 / 8)


def test_phantom_head_padding_is_exact(ranks):
    """6 q heads on tp 4: padded to 8 with zero v and zero wo rows."""
    r = _result(ranks, "pad_heads")
    assert abs(r["loss_pad"] - r["loss1"]) < 1e-6
    assert abs(r["loss_nopad"] - r["loss1"]) < 1e-6
    assert r["grad_pad"] < 2e-5 and r["grad_nopad"] < 2e-5


def test_sharded_mamba_step_matches_single_device(ranks):
    r = _result(ranks, "mamba_step")
    assert abs(r["loss1"] - r["loss2"]) < 1e-5 and r["maxdiff"] < 5e-5


def test_sharded_moe_step_matches_single_device(ranks):
    r = _result(ranks, "moe_step")
    assert abs(r["loss1"] - r["loss2"]) < 1e-5 and r["maxdiff"] < 5e-5


def test_engine_under_dist_generates_the_same_tokens(ranks):
    r = _result(ranks, "engine")
    assert r["tokens1"] == r["tokens2"]


def test_trainer_under_dist_matches_and_counts_per_device(ranks):
    r = _result(ranks, "trainer")
    plain, sharded = r["plain"], r["dist"]
    assert all(abs(a - b) < 1e-5 for a, b in zip(plain["losses"],
                                                   sharded["losses"]))
    assert 0.05 <= sharded["gemm_frac"] <= 0.95
    # per device: the batch is split over the 2 data ranks
    assert sharded["flops"] < 0.6 * plain["flops"]
    assert plain["coll_counts"] == {}
    assert sharded["coll_counts"].get("all-gather", 0) > 0


REF_RULES = """
    import json
    import jax
    from jax.sharding import PartitionSpec
    from repro.dist.sharding import DistCtx
    SHAPES = {shapes}

    class Leaf:
        def __init__(self, shape):
            self.shape = shape

    out = {{}}
    for name, shape, axes in (("2x4", (2, 4), ("data", "model")),
                              ("2x2x2", (2, 2, 2),
                               ("pod", "data", "model"))):
        ctx = DistCtx.from_mesh(jax.make_mesh(shape, axes))
        rows = []
        for s in SHAPES:
            spec = tuple(ctx._shard_leaf_fsdp(Leaf(tuple(s))).spec)
            row = []
            for a in axes:
                dim = None
                for i, e in enumerate(spec):
                    if e == a or (isinstance(e, tuple) and a in e):
                        dim = i
                row.append(dim)
            rows.append(row)
        out[name] = rows
    print("RULES", json.dumps(out))
"""


def test_placement_rule_matches_reference(ranks):
    from _torch_dist_ranks import RULE_SHAPES
    code = textwrap.dedent(REF_RULES.format(
        shapes=[list(s) for s in RULE_SHAPES]))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_"
               "count=8", PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    line = next(ln for ln in r.stdout.splitlines()
                if ln.startswith("RULES "))
    want = json.loads(line[len("RULES "):])
    got = _result(ranks, "placement_rule")
    assert got == want
    # the rule does shard something on both meshes
    assert any(d is not None for row in got["2x2x2"] for d in row)
