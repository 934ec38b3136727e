"""The port's multi-pod dry run (``repro_torch.launch.dryrun``) and the
fake implementations of K2 and K3 it traces through, on the CPU.

* (a) Each fake implementation against the real call on CPU tensors: K2 at
  head dims 256, (192, 128) and 112 with GQA, a window and a softcap, K3 at
  mamba2-2.7b's and zamba2-7b's layer widths (the sequence cut to 512):
  the same shapes, dtypes and strides, the same errors, and on fake CUDA
  tensors the checks a launch makes before it reads data.
  ``torch.library.opcheck`` on both ops.
* (b) The dry count equals the real ``count_step`` on one device, exactly
  in ``flops``, ``bytes``, ``detail_flops`` and ``detail_bytes``, for a
  reduced train step of gemma2-2b, mamba2-2.7b, deepseek-v2-lite-16b and
  zamba2-7b (the optimizer step included) and a reduced decode step.
* (c) A reduced train, prefill and decode cell each complete on a (2, 2)
  fake mesh; train issues all-gathers and reduce-scatters (FSDP + TP);
  per-device FLOPs against one-device FLOPs / 4.
* (d) ``params_total``, ``params_active`` and the ``model_flops``-based
  useful ratio equal the reference's for every arch and shape.
* (e) ``argument_size_in_bytes`` of a reduced one-device train cell equals
  the reference's ``compiled.memory_analysis()``.
* (f) The keys of ``run_cell``'s JSON equal the reference's.

Each case that starts the fake process group runs in a subprocess of its
own, with its own timeout: a fake default group cannot share a process
with the real ones other tests start.
"""
import ast
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.base import ALL_SHAPES as R_SHAPES
from repro.configs.base import shapes_for as r_shapes_for
from repro.configs.registry import ARCHS as R_ARCHS
from repro.configs.registry import get_shape as r_get_shape
from repro.configs.registry import reduced as r_reduced
from repro.launch import analysis as RA
from repro.models import io as rio
from repro.models.transformer import Transformer as RTransformer
from repro.optim.adamw import AdamW as RAdamW
from repro.optim.adamw import OptConfig as ROptConfig
from repro.train.step import make_train_step as r_make_train_step

from repro_torch.configs.base import shapes_for
from repro_torch.configs.registry import ARCHS, reduced
from repro_torch.kernels import flash_attention as K2
from repro_torch.kernels import ssd_scan as K3
from repro_torch.launch import dryrun as D
from repro_torch.launch.step_cost import Cost, count_step
from repro_torch.models.io import synth_batch
from repro_torch.models.transformer import Transformer
from repro_torch.optim.adamw import AdamW, OptConfig
from repro_torch.train.step import make_serve_step, make_train_step

from _torch_inputs import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
REF_DRYRUN = ROOT / "src" / "repro" / "launch" / "dryrun.py"


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# -- (a) the fake implementations ------------------------------------------

#: (B, Sq, Skv, H, KV, D, Dv, window, softcap): gemma2-2b's layer (256,
#: GQA 8/4, window, softcap), MLA's (192, 128) and zamba2's 112
K2_CASES = [(1, 64, 64, 8, 4, 256, 256, 32, 50.0),
            (2, 48, 48, 4, 4, 192, 128, 0, 0.0),
            (1, 64, 64, 4, 2, 112, 112, 16, 0.0)]


def _k2_inputs(case, dtype=torch.float32, device="cpu"):
    B, Sq, Skv, H, KV, D, Dv, _, _ = case
    r = _rng(1)
    return (_t(r.normal(size=(B, Sq, H, D)), dtype).to(device),
            _t(r.normal(size=(B, Skv, KV, D)), dtype).to(device),
            _t(r.normal(size=(B, Skv, KV, Dv)), dtype).to(device))


def _meta(t):
    return tuple(t.shape), t.dtype, t.stride()


def _fake_like(mode, tensors, device=None, dtype=None):
    with mode:
        return [torch.empty_strided(t.shape, t.stride(),
                                    dtype=dtype or t.dtype,
                                    device=device or t.device)
                for t in tensors]


@pytest.mark.parametrize("case", K2_CASES, ids=["256", "192-128", "112"])
def test_k2_fake_matches_the_real_call(case):
    window, softcap = case[7], case[8]
    q, k, v = _k2_inputs(case)
    out, lse = K2.flash_attention(q, k, v, window=window, softcap=softcap,
                                  return_lse=True)
    mode = FakeTensorMode()
    fq, fk, fv = _fake_like(mode, (q, k, v))
    with mode:
        fo, fl = K2.flash_attention(fq, fk, fv, window=window,
                                    softcap=softcap, return_lse=True)
    assert _meta(fo) == _meta(out) and _meta(fl) == _meta(lse)
    assert fo.device == q.device
    # the card's route: bf16 fake CUDA tensors, whatever no CPU can launch
    cq, ck, cv = _fake_like(mode, (q, k, v), "cuda", torch.bfloat16)
    with mode:
        co, cl = K2.flash_attention(cq, ck, cv, window=window,
                                    softcap=softcap, return_lse=True)
    assert co.device.type == "cuda" and co.dtype == torch.bfloat16
    assert tuple(co.shape) == tuple(out.shape) and cl.dtype == torch.float32
    assert tuple(cl.shape) == tuple(lse.shape)
    args = (q, k, v, True, window, softcap, 0.0, 0, None)
    torch.library.opcheck(torch.ops.repro_torch.flash_attention_fwd.default,
                          args, test_utils=("test_schema", "test_faketensor"))


def test_k2_fake_raises_the_real_errors():
    case = K2_CASES[0]
    q, k, v = _k2_inputs(case)
    mode = FakeTensorMode()
    bad_kv = k[:, :, :3]                  # 8 heads over 3 kv heads
    with pytest.raises(ValueError, match="GQA"):
        K2.flash_attention(q, bad_kv, v[:, :, :3])
    fq, fk, fv = _fake_like(mode, (q, bad_kv, v[:, :, :3]))
    with mode, pytest.raises(ValueError, match="GQA"):
        K2.flash_attention(fq, fk, fv)
    # what a launch on the card rejects before reading data
    cq, ck, cv = _fake_like(mode, (q, k, v), "cuda", torch.bfloat16)
    with mode:
        ck32 = ck.float()
        with pytest.raises(TypeError, match="one type"):
            K2.flash_attention(cq, ck32, cv)
        mq, mk, mv = (t.float() for t in (cq, ck, cv))
    q2, k2, v2 = _k2_inputs(K2_CASES[1])
    f2 = _fake_like(mode, (q2, k2, v2), "cuda", torch.float32)
    with mode, pytest.raises(ValueError, match="192, 128"):
        K2.flash_attention(*f2)             # MLA's dims in f32: no kernel
    with mode:
        K2.flash_attention(mq, mk, mv)      # f32 at 256: the SIMT variant


#: (B, S, H, P, G, N, chunk): mamba2-2.7b's and zamba2-7b's layers
K3_CASES = [(1, 512, 80, 64, 1, 128, 256), (1, 512, 112, 64, 2, 64, 256)]


def _k3_inputs(case, dtype=torch.float32, device="cpu"):
    B, S, H, P, G, N, _ = case
    r = _rng(2)
    x = _t(r.normal(size=(B, S, H, P)), dtype)
    dt = _t(r.uniform(0.001, 0.1, size=(B, S, H)))
    A = _t(-r.uniform(1.0, 16.0, size=(H,)))
    Bm = _t(r.normal(size=(B, S, G, N)), dtype)
    Cm = _t(r.normal(size=(B, S, G, N)), dtype)
    return [t.to(device) for t in (x, dt, A, Bm, Cm)]


@pytest.mark.parametrize("case", K3_CASES, ids=["mamba2", "zamba2"])
def test_k3_fake_matches_the_real_call(case):
    chunk = case[-1]
    ins = _k3_inputs(case)
    y = K3.ssd_scan(*ins, chunk)
    mode = FakeTensorMode()
    fins = _fake_like(mode, ins)
    with mode:
        fy = K3.ssd_scan(*fins, chunk)
    assert _meta(fy) == _meta(y) and fy.device == y.device
    cins = _fake_like(mode, ins, "cuda")
    with mode:
        cins = [t.bfloat16() if i in (0, 3, 4) else t
                for i, t in enumerate(cins)]
        cy = K3.ssd_scan(*cins, chunk)
    assert cy.device.type == "cuda" and cy.dtype == torch.bfloat16
    assert tuple(cy.shape) == tuple(y.shape)
    small = [t[:, :64] if t.dim() > 1 else t for t in ins]
    torch.library.opcheck(torch.ops.repro_torch.ssd_scan_fwd.default,
                          (*small, 32),
                          test_utils=("test_schema", "test_faketensor"))


def test_k3_fake_raises_the_real_errors():
    x, dt, A, Bm, Cm = _k3_inputs(K3_CASES[0])
    mode = FakeTensorMode()
    with pytest.raises(ValueError, match="multiple of the chunk"):
        K3.ssd_scan(x[:, :500], dt[:, :500], A, Bm[:, :500], Cm[:, :500],
                    256)
    f = _fake_like(mode, (x[:, :500], dt[:, :500], A, Bm[:, :500],
                          Cm[:, :500]))
    with mode, pytest.raises(ValueError, match="multiple of the chunk"):
        K3.ssd_scan(*f, 256)
    f = _fake_like(mode, (x, dt, A[:3], Bm, Cm))
    with mode, pytest.raises(ValueError, match="SSD scan"):
        K3.ssd_scan(*f, 256)
    # the forward alone (``run``, the op): on a PyTorch built without CUDA
    # an error raised inside an autograd function on a CUDA tensor turns
    # into "not linked with support for cuda devices"
    c = _fake_like(mode, (x, dt, A, Bm, Cm), "cuda")
    with mode:
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            K3.ssd_scan.run(c[0].half(), c[1], c[2], c[3].half(),
                            c[4].half(), 256)
        with pytest.raises(TypeError, match="float32 dt"):
            K3.ssd_scan.run(c[0], c[1].bfloat16(), *c[2:], 256)
        B, S, H, P = c[0].shape
        xt = torch.empty_strided((B, S, H, P), (S * H * P, H * P, 1, H),
                                 dtype=torch.bfloat16, device="cuda")
        with pytest.raises(ValueError, match="contiguous"):
            K3.ssd_scan.run(xt, c[1], c[2], c[3].bfloat16(),
                            c[4].bfloat16(), 256)


def test_fake_implementation_is_never_reached_with_storage(monkeypatch):
    """Real tensors run the real implementation: the op's fake is not
    called by a CPU call (on the card the kernels' tests hold the same)."""
    calls = []
    real = K2._flash_attention_fwd_fake
    monkeypatch.setattr(K2, "_flash_attention_fwd_fake",
                        lambda *a: calls.append(1) or real(*a))
    q, k, v = _k2_inputs(K2_CASES[2])
    K2.flash_attention(q, k, v)
    K3.ssd_scan(*_k3_inputs(K3_CASES[1]), 256)
    assert calls == []


# -- (b) the dry count on one device equals the real one ------------------

def _count(arch, kind, fake):
    cfg = reduced(ARCHS[arch])
    model = Transformer(cfg)
    opt = AdamW(OptConfig())
    real = synth_batch(cfg, kind, 2, 64 if kind == "train" else 1,
                       device="cpu")
    with FakeTensorMode() if fake else contextlib.nullcontext():
        params = model.init(0, device="cpu")
        batch = {k: torch.empty(v.shape, dtype=v.dtype)
                 for k, v in real.items()} if fake else real
        if kind == "train":
            state = opt.init(params)
            step = make_train_step(model, opt)
            return count_step(lambda p, b: step(p, state, b), params, batch)
        cache = model.init_cache(2, 64, device="cpu")
        serve = make_serve_step(model)
        return count_step(lambda p, b: serve(p, cache, b, 63), params, batch)


@pytest.mark.parametrize("arch,kind", [
    ("gemma2-2b", "train"), ("mamba2-2.7b", "train"),
    ("deepseek-v2-lite-16b", "train"), ("zamba2-7b", "train"),
    ("gemma2-2b", "decode")])
def test_dry_count_equals_the_real_count(arch, kind):
    real, dry = _count(arch, kind, False), _count(arch, kind, True)
    assert dry.flops == real.flops and dry.bytes == real.bytes
    assert dry.detail_flops == real.detail_flops
    assert dry.detail_bytes == real.detail_bytes
    if kind == "train" and arch != "mamba2-2.7b":
        assert real.detail_flops["flash_attention"] > 0
    if arch in ("mamba2-2.7b", "zamba2-7b"):
        assert real.detail_flops["ssd_scan"] > 0


# -- (c), (f) cells on a (2, 2) fake mesh, in a subprocess -------------------

_MESH_SCRIPT = r"""
import json, sys
from pathlib import Path
import torch
torch.set_num_threads(1)
from repro_torch.configs.registry import ARCHS, reduced
from repro_torch.launch import dryrun as D
out = Path(sys.argv[1])
cfg = reduced(ARCHS["gemma2-2b"])
res = {}
for shape in ("train_4k", "prefill_32k", "decode_32k"):
    res[shape] = D.run_cell("gemma2-2b", shape, False, out, "full", False,
                            True, cfg=cfg, mesh_shape=(2, 2), device="cpu")
# the arguments of the train cell: each leaf's global bytes over the
# ranks that shard it
import math
with D.fake_world(4):
    low, _ = D.lower_cell("gemma2-2b", "train_4k", False, cfg=cfg,
                          mesh_shape=(2, 2), device="cpu")
    from torch.utils._pytree import tree_flatten
    res["shard_bytes"] = sum(
        t.numel() * t.element_size() // math.prod(
            t.device_mesh.size(i) for i, p in enumerate(t.placements)
            if p.is_shard())
        for t in tree_flatten(low.args)[0])
# one device, the same global batch: the FLOPs the mesh divides
one = D.run_cell("gemma2-2b", "train_4k", False, out, "full", False, True,
                 cfg=cfg, mesh_shape=(), device="cpu")
res["one_device_flops"] = one["roofline"]["hlo_flops_per_dev"]
try:
    D.main(["--arch", "no-such-arch", "--shape", "train_4k", "--device",
            "cpu", "--out", str(out / "fail")])
except SystemExit as e:
    res["main_exit"] = e.code
print("RESULT " + json.dumps(res))
"""


def _run_script(script, *args, timeout):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    p = subprocess.run([sys.executable, "-c", script, *map(str, args)],
                       capture_output=True, text=True, timeout=timeout,
                       env=env, cwd=ROOT)
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
    assert p.returncode == 0 and line, p.stdout[-3000:] + p.stderr[-3000:]
    return json.loads(line[-1][len("RESULT "):]), p.stdout


@pytest.fixture(scope="module")
def mesh_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    res, stdout = _run_script(_MESH_SCRIPT, out, timeout=150)
    return res, stdout, out


def test_cells_complete_on_a_fake_2x2_mesh(mesh_cells):
    res, stdout, out = mesh_cells
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        r = res[shape]
        assert (out / "2x2" / f"gemma2-2b__{shape}.json").exists()
        assert r["devices"] == 4 and r["mesh"] == "2x2"
        assert f"[ok] 2x2 gemma2-2b {shape}: dominant=" in stdout
        assert r["roofline"]["hlo_flops_per_dev"] > 0
        assert r["memory"]["temp_size_in_bytes"] > 0
    # the arguments are local shards, not global tensors
    assert res["train_4k"]["memory"]["argument_size_in_bytes"] == \
        res["shard_bytes"]
    counts = res["train_4k"]["roofline"]["collective_counts"]
    # FSDP gathers the parameters and reduce-scatters their gradients
    assert counts["all-gather"] > 0 and counts["reduce-scatter"] > 0
    # K2 and the batched products shard exactly over the 4 devices; DTensor
    # keeps some plain products (``mm``) whole over the model dim, which
    # ran 1.21 x a quarter of the one-device count, 1.059 x in all: held
    # between a quarter and 8% above it
    ratio = res["train_4k"]["roofline"]["hlo_flops_per_dev"] \
        / (res["one_device_flops"] / 4)
    assert 1.0 <= ratio <= 1.08


def test_a_failing_cell_is_logged_and_fails_the_run(mesh_cells):
    res, stdout, out = mesh_cells
    assert res["main_exit"] == 1
    assert "[FAIL] 16x16 no-such-arch train_4k:" in stdout
    log = (out / "fail" / "failures.log").read_text()
    assert "==== 16x16 no-such-arch train_4k" in log
    assert "Traceback" in log and "KeyError" in log


def _reference_keys():
    """The keys the reference's ``analyse`` returns and ``run_cell`` adds,
    read from its source (importing it would set XLA_FLAGS in this
    process's environment)."""
    tree = ast.parse(REF_DRYRUN.read_text())
    keys, mem = set(), set()
    for fn in (n for n in tree.body if isinstance(n, ast.FunctionDef)):
        for node in ast.walk(fn):
            if fn.name == "analyse" and isinstance(node, ast.Return) \
                    and isinstance(node.value, ast.Dict):
                keys |= {k.value for k in node.value.keys}
            if fn.name == "analyse" and isinstance(node, ast.Tuple) and all(
                    isinstance(e, ast.Constant) for e in node.elts):
                mem |= {e.value for e in node.elts}
            if fn.name == "run_cell" and isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, ast.Store):
                keys.add(node.slice.value)
    return keys, mem | {"total_per_device"}


def test_report_keys_equal_the_reference(mesh_cells):
    keys, mem = _reference_keys()
    assert "roofline" in keys and "lower_s" in keys and len(mem) == 6
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        r = mesh_cells[0][shape]
        assert set(r) == keys
        assert set(r["memory"]) == mem
        # what has no meaning without XLA's artifacts is None, not made up
        assert r["hlo_text_bytes"] is None and r["raw_cost_flops"] is None
        assert r["memory"]["alias_size_in_bytes"] is None
        assert r["unknown_trip_loops"] == 0


# -- (d) counts and the useful ratio against the reference -----------------

def test_param_counts_and_useful_ratio_equal_the_reference():
    cost = Cost(flops=3.0e15, bytes=2.0e12,
                coll_bytes={"all-gather": 5.0e9}, coll_counts={
                    "all-gather": 7.0})
    n = 256
    cells = 0
    for name, cfg in ARCHS.items():
        rcfg = R_ARCHS[name]
        assert [s.name for s in shapes_for(cfg)] == \
            [s.name for s in r_shapes_for(rcfg)]
        for shape in shapes_for(cfg):
            counts, terms = D.cell_terms(cfg, shape, cost, n)
            rshape = r_get_shape(shape.name)
            rterms = RA.roofline({"flops": cost.flops,
                                  "bytes accessed": cost.bytes},
                                 RA.CollectiveStats(), n,
                                 RA.model_flops(rcfg, rshape))
            rc = rcfg.param_counts()
            assert counts["total"] == rc["total"]
            assert counts["active"] == rc["active"]
            assert terms["model_flops"] == rterms["model_flops"]
            assert terms["useful_flops_ratio"] == \
                rterms["useful_flops_ratio"]
            cells += 1
    assert cells == 32 == sum(len(r_shapes_for(c)) for c in R_ARCHS.values())
    assert len(R_SHAPES) == 4


# -- (e) the arguments of a one-device train cell ---------------------------

def test_argument_bytes_equal_the_reference_memory_analysis(tmp_path):
    """A reduced gemma2-2b train_4k cell on one device: parameters,
    optimizer state (m, v, f32 master, int32 step) and batch.  The
    reference's jitted step donates nothing, so its argument size is the
    same sum, and the port's is held to it exactly; the port's output
    and temporaries are not comparable to XLA's (the port updates in
    place, XLA fuses), so they are not held."""
    res = D.run_cell("gemma2-2b", "train_4k", False, tmp_path, "none",
                     False, True, cfg=reduced(ARCHS["gemma2-2b"]),
                     mesh_shape=(), device="cpu")
    rcfg = r_reduced(R_ARCHS["gemma2-2b"])
    model = RTransformer(rcfg)
    opt = RAdamW(ROptConfig())
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    state = jax.eval_shape(opt.init, params)
    specs = rio.input_specs(rcfg, r_get_shape("train_4k"))
    ma = jax.jit(r_make_train_step(model, opt)).lower(
        params, state, specs).compile().memory_analysis()
    assert res["memory"]["argument_size_in_bytes"] == \
        ma.argument_size_in_bytes


# -- (g) the faults the dry run found, held against the reference ----------

def test_uneven_mesh_dims_take_the_product_of_the_sharding_dims():
    """A reshape keeps a shard only where the product of the mesh dims
    that shard the tensor dim divides it: zamba2-7b's d_inner 7168 over
    (pod 2, data 16) at long_500k's batch 1 splits 112 heads 32 ways,
    which each mesh dim alone divides and their product does not."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.dist.sharding import uneven_mesh_dims
    two = (Shard(1), Shard(1), Replicate())
    assert uneven_mesh_dims((1, 7168), two, (2, 16, 16), (1, 112, 64)) \
        == [0, 1]
    one = (Replicate(), Shard(1), Replicate())
    assert uneven_mesh_dims((1, 7168), one, (2, 16, 16), (1, 112, 64)) == []
    # a dim left in place keeps its shard whatever follows it
    assert uneven_mesh_dims((32, 7168), (Shard(0), Shard(0), Replicate()),
                            (2, 16, 16), (32, 112, 64)) == []


def test_a_leaf_the_loss_does_not_read_gets_a_zero_gradient():
    """musicgen-medium trains on audio embeddings, so its token table
    takes no part in the loss: ``jax.grad`` gives it zeros, and so does
    the port's step (its train_4k cell raised on it before)."""
    import jax.numpy as jnp

    from repro.models.io import synth_batch as r_synth_batch
    from repro_torch.models.convert import params_from_reference
    from repro_torch.train.step import make_split_train_step
    rcfg = r_reduced(R_ARCHS["musicgen-medium"])
    rmodel = RTransformer(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    rbatch = r_synth_batch(rcfg, "train", 2, 16)
    rgrads = jax.grad(lambda p: rmodel.loss(p, rbatch)[0])(rparams)
    assert float(jnp.abs(rgrads["embed"]["table"]).max()) == 0.0
    cfg = reduced(ARCHS["musicgen-medium"])
    params = params_from_reference(rparams, cfg, device="cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in rbatch.items()}
    grad_fn, _ = make_split_train_step(Transformer(cfg), AdamW(OptConfig()))
    grads, _ = grad_fn(params, batch)
    table = grads["embed"]["table"]
    assert table.shape == params["embed"]["table"].shape
    assert float(table.abs().max()) == 0.0
    assert float(grads["lm_head"].abs().max()) > 0.0
