"""One rank of tests/test_torch_dist.py: run as ``python
tests/_torch_dist_ranks.py RANK WORLD PORT OUT_DIR`` by 8 processes at once
(``gloo``, a 2 x 4 ``("data", "model")`` mesh).  Every rank runs every
check in the same order (their collectives must meet); rank 0 writes
``OUT_DIR/results.json``: per check, its numbers or the error it raised.
Imports no JAX."""
import json
import os
import sys
import tempfile
import time
import traceback
import warnings
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist


def _max_diff(tree_a, tree_b):
    """The largest |a - b| over two parameter trees (b's leaves may be
    DTensors)."""
    from repro_torch.models.transformer import param_leaves
    out = 0.0
    for (_, a), (_, b) in zip(param_leaves(tree_a), param_leaves(tree_b)):
        b = b.full_tensor() if hasattr(b, "full_tensor") else b
        out = max(out, float((a.detach() - b.detach()).abs().max()))
    return out


def _scalar(t):
    return float(t.full_tensor() if hasattr(t, "full_tensor") else t)


def _granite(**over):
    from repro_torch.configs.registry import ARCHS, reduced
    kw = dict(num_heads=4, num_kv_heads=4, vocab_size=512)
    kw.update(over)
    return reduced(ARCHS["granite-34b"], d_model=64).with_overrides(**kw)


def _train_step_pair(cfg, d, batch_size=4, seq=32):
    """One AdamW step of the same model single-device and sharded from
    the same init and batch: (loss single, loss sharded, max |param
    diff|)."""
    from repro_torch.models.io import synth_batch
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim.adamw import AdamW, OptConfig
    from repro_torch.train.step import make_train_step
    batch = synth_batch(cfg, "train", batch_size, seq, device="cpu")
    opt = AdamW(OptConfig())
    m1 = Transformer(cfg)
    p1 = m1.init(0, device="cpu")
    p1b, _, met1 = make_train_step(m1, opt)(p1, opt.init(p1), batch)
    m2 = Transformer(cfg, dist=d)
    p2 = m2.init(0, device="cpu")
    p2 = d.place(p2, d.params_shardings(p2))
    b2 = d.place(batch, d.batch_shardings(batch))
    p2b, _, met2 = make_train_step(m2, opt)(p2, opt.init(p2), b2)
    return {"loss1": float(met1["loss"]), "loss2": _scalar(met2["loss"]),
            "maxdiff": _max_diff(p1b, p2b)}


def check_sharded_step(d):
    """The twin of test_dist's sharded step: granite reduced, held against
    the port's own single-device step."""
    return _train_step_pair(_granite(), d)


def check_moe_step(d):
    """A deepseek (MLA + expert parallelism) sharded step."""
    from repro_torch.configs.registry import ARCHS, reduced
    cfg = reduced(ARCHS["deepseek-v2-lite-16b"], d_model=64).with_overrides(
        capacity_factor=8.0)
    return _train_step_pair(cfg, d)


def check_mamba_step(d):
    """A mamba2 sharded step: K3's plain version in its region."""
    from repro_torch.configs.registry import ARCHS, reduced
    return _train_step_pair(reduced(ARCHS["mamba2-2.7b"]), d)


def check_moe_expert_parallel(d, **ctx_kw):
    """The twin of test_dist's expert-parallel MoE, with gradients
    (``ctx_kw``: the context's ``zero1_moe`` / ``fsdp``)."""
    from repro_torch.configs.registry import ARCHS, reduced
    from repro_torch.dist.sharding import replicating
    from repro_torch.models import moe as M
    cfg = reduced(ARCHS["deepseek-v2-lite-16b"], d_model=64).with_overrides(
        num_experts=8, top_k=2, capacity_factor=8.0)
    p = M.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 16, cfg.d_model)).astype(np.float32))
    E = cfg.num_experts
    names = ("router", "wi", "wo")

    def loss_of(y, stats):
        return y.square().sum() + stats[E:].square().sum()
    leaves = [x.clone().requires_grad_(True)] + \
        [p[k].clone().requires_grad_(True) for k in names]
    y_local, stats_local = M.apply_moe(dict(p, **dict(zip(names,
                                                          leaves[1:]))),
                                       leaves[0], cfg)
    g_local = torch.autograd.grad(loss_of(y_local, stats_local), leaves)
    if ctx_kw:
        from repro_torch.dist.sharding import DistCtx
        d = DistCtx(mesh=d.mesh, **ctx_kw)
    shard = d.params_shardings({k: p[k] for k in names})
    pd = dict(p, **{k: d.distribute(p[k], shard[k]).requires_grad_(True)
                    for k in names})
    xd = d.distribute(x, d.batch_shardings({"x": x})["x"]) \
        .requires_grad_(True)
    with replicating():
        y_ep, stats_ep = M.apply_moe(pd, xd, cfg, dist=d)
        g_ep = torch.autograd.grad(loss_of(y_ep, stats_ep),
                                   [xd] + [pd[k] for k in names])
    return {
        "err": float((y_local - y_ep.full_tensor()).abs().max()),
        "perr": float((stats_local[E:] - stats_ep.full_tensor()[E:])
                      .abs().max()),
        "count_err": float((stats_local[:E] - stats_ep.full_tensor()[:E])
                           .abs().max()),
        "grad_rel": max(float((a - b.full_tensor()).abs().max()
                              / a.abs().max())
                        for a, b in zip(g_local, g_ep)),
    }


def check_moe_zero1(d):
    """Expert parallelism with ZeRO-1 experts (resident, no gathers; their
    gradients partial over the data dims)."""
    return check_moe_expert_parallel(d, zero1_moe=True)


def _mesh3():
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist.sharding import DistCtx
    return DistCtx.from_mesh(init_device_mesh(
        "cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model")))


def check_mesh3_moe(d):
    """Expert parallelism on the 2 x 2 x 2 mesh: experts gathered over
    (pod, data), 2 expert shards."""
    return check_moe_expert_parallel(_mesh3())


def check_elastic_restore(d, tmp):
    """The twin of test_dist's elastic restore: saved from the 2 x 4 mesh,
    restored onto a 2 x 2 mesh of ranks 0-3 (every rank builds it)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Shard

    from repro_torch.ckpt.checkpoint import Checkpointer
    from repro_torch.dist.sharding import NamedSharding
    tree = {"w": torch.arange(64.0).reshape(8, 8)}
    ck = Checkpointer(tmp)
    ck.save(1, {"w": d.distribute(tree["w"], (Shard(0), Shard(1)))},
            async_=False)
    dist.barrier()
    mesh2 = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                       mesh_dim_names=("data", "model"))
    sh2 = {"w": NamedSharding(mesh2, (Shard(0), Shard(1)))}
    t2, meta = ck.restore(1, tree, sh2)
    w = t2["w"]
    out = {"placements": [str(p) for p in w.placements],
           "same_mesh": w.device_mesh is mesh2, "step": meta["step"]}
    if dist.get_rank() == 0:
        # the files of a DTensor tree are those of the plain tree, byte for
        # byte (and so the reference's: tests/test_torch_ckpt.py)
        plain = Checkpointer(tmp + "_plain")
        plain.save(1, tree, async_=False)
        names = sorted(os.listdir(os.path.join(tmp, "step_1")))
        out["files_equal"] = names == sorted(os.listdir(
            os.path.join(tmp + "_plain", "step_1"))) and all(
            open(os.path.join(tmp, "step_1", n), "rb").read()
            == open(os.path.join(tmp + "_plain", "step_1", n), "rb").read()
            for n in names)
    if dist.get_rank() < 4:
        out["local_shape"] = list(w.to_local().shape)
        out["equal"] = bool((w.full_tensor() == tree["w"]).all())
    return out


def check_psum_compressed(d):
    """The twin of test_dist's compressed all-reduce over 8 ranks."""
    from repro_torch.optim.compress import psum_compressed
    g = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (8, 32))
                         .astype(np.float32))
    gl = {"g": g[dist.get_rank()]}
    group = dist.group.WORLD
    b16, _ = psum_compressed(gl, group, "bf16")
    i8, _ = psum_compressed(gl, group, "int8")
    exact, _ = psum_compressed(gl, group, "none")
    from repro_torch.launch.step_cost import count_step
    cost = count_step(lambda *_: psum_compressed(gl, group, "int8"),
                      None, None)
    return {"bf16_err": float((b16["g"] - exact["g"]).abs().max()),
            "int8_err": float((i8["g"] - exact["g"]).abs().max()),
            "exact_err": float((exact["g"] - g.mean(0)).abs().max()),
            "int8_coll_counts": cost.coll_counts,
            "int8_coll_bytes": cost.coll_bytes}


#: shapes the placement rule is held on against the reference's
RULE_SHAPES = [(), (7,), (8,), (64,), (6, 10), (12, 8), (4, 16, 8),
               (2, 3, 5), (512, 64), (64, 4, 16), (8, 64, 2, 32), (3, 4),
               (16, 16), (5, 12, 24)]


def check_placement_rule(d):
    """The ZeRO-3 dim this rule picks for ``RULE_SHAPES`` on the 2 x 4
    mesh and on a 2 x 2 x 2 ``("pod", "data", "model")`` mesh (two DP
    dims): per shape, the tensor dim each DP mesh dim shards, or None."""
    from torch.distributed.tensor import Shard
    out = {}
    for name, ctx in (("2x4", d), ("2x2x2", _mesh3())):
        rows = []
        for shape in RULE_SHAPES:
            pl = ctx._shard_leaf_fsdp(torch.empty(shape, device="meta"))
            rows.append([p.dim if isinstance(p, Shard) else None
                         for p in pl])
        out[name] = rows
    return out


def check_pad_heads(d):
    """Phantom heads at H % tp != 0 (6 q heads, 2 kv, tp 4): loss and every
    gradient against the single-device model and the sharded unpadded
    one."""
    from repro_torch.models.io import synth_batch
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim.adamw import AdamW, OptConfig
    from repro_torch.train.step import make_split_train_step
    cfg = _granite(num_heads=6, num_kv_heads=2)
    batch = synth_batch(cfg, "train", 4, 32, device="cpu")
    m1 = Transformer(cfg)
    p1 = m1.init(0, device="cpu")
    g1, met1 = make_split_train_step(m1, AdamW(OptConfig()))[0](p1, batch)
    out = {"loss1": float(met1["loss"])}
    p2 = d.place(p1, d.params_shardings(p1))
    b2 = d.place(batch, d.batch_shardings(batch))
    for name, pad in (("pad", True), ("nopad", False)):
        m2 = Transformer(cfg, dist=d, pad_heads=pad)
        g2, met2 = make_split_train_step(m2, AdamW(OptConfig()))[0](p2, b2)
        out[f"loss_{name}"] = _scalar(met2["loss"])
        out[f"grad_{name}"] = _max_diff(g1, g2)
    return out


def check_engine(d):
    """Greedy ``Engine.generate`` under ``dist`` (caches placed by
    ``cache_shardings``) against the undistributed engine."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = _granite()
    p1 = Transformer(cfg).init(0, device="cpu")
    prompts = np.random.default_rng(0).integers(0, 512, (4, 6)) \
        .astype(np.int32)
    sc = ServeConfig(batch=4, max_len=32)
    e1 = Engine(cfg, p1, sc, device="cpu").generate(prompts, 6)
    e2 = Engine(cfg, d.place(p1, d.params_shardings(p1)), sc, dist=d,
                device="cpu").generate(prompts, 6)
    return {"tokens1": e1.tolist(), "tokens2": e2.tolist()}


def check_ssm_engine(d):
    """Greedy ``Engine.generate`` of a reduced zamba2-7b (mamba2 layers
    and the shared attention block) under ``dist`` against the
    undistributed engine: the SSM decode under a mesh keeps the batch over
    the data dims and its small weights gathered."""
    from repro_torch.configs.registry import ARCHS, reduced
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = reduced(ARCHS["zamba2-7b"])
    p1 = Transformer(cfg).init(0, device="cpu")
    prompts = np.random.default_rng(1).integers(0, 512, (4, 5)) \
        .astype(np.int32)
    sc = ServeConfig(batch=4, max_len=16)
    e1 = Engine(cfg, p1, sc, device="cpu").generate(prompts, 4)
    e2 = Engine(cfg, d.place(p1, d.params_shardings(p1)), sc, dist=d,
                device="cpu").generate(prompts, 4)
    return {"tokens1": e1.tolist(), "tokens2": e2.tolist()}


def check_trainer(d):
    """``Trainer(dist=)``: 2 instrumented iterations against the
    undistributed trainer; the step cost counted per device."""
    from repro_torch.train.loop import Trainer
    from repro_torch.train.workload import tiny_train_setup
    from dataclasses import replace
    mc, dc, oc, tc = tiny_train_setup()
    mc = mc.with_overrides(num_heads=4, num_kv_heads=4)
    dc = replace(dc, batch=4)
    out = {}
    for name, ctx in (("plain", None), ("dist", d)):
        tr = Trainer(mc, dc, oc, tc, dist=ctx, device="cpu")
        params, opt_state, _ = tr.init_state(resume=False)
        losses = []
        for _ in range(2):
            params, opt_state, m = tr.train_iteration(params, opt_state)
            losses.append(_scalar(m["loss"]))
        tr.loader.close()
        cost = tr.bundle.cost
        out[name] = {"losses": losses, "gemm_frac": tr.bundle.gemm_frac,
                     "flops": cost.flops,
                     "coll_counts": dict(cost.coll_counts)}
    return out


CHECKS = ["sharded_step", "moe_expert_parallel", "elastic_restore",
          "psum_compressed", "placement_rule", "pad_heads", "mamba_step",
          "moe_step", "engine", "ssm_engine", "trainer", "moe_zero1",
          "mesh3_moe"]


def main():
    rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    # the suite runs beside timing-sensitive tests: take the CPU last
    os.nice(19)
    warnings.filterwarnings("ignore")
    import logging
    logging.getLogger("torch").setLevel(logging.ERROR)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=180))
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist.sharding import DistCtx
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    d = DistCtx.from_mesh(mesh)
    results = {}
    tmp = os.path.join(out_dir, "ckpt")
    for name in CHECKS:
        t0 = time.perf_counter()
        try:
            fn = globals()[f"check_{name}"]
            r = fn(d, tmp) if name == "elastic_restore" else fn(d)
            results[name] = {"ok": True, "result": r}
        except Exception:
            results[name] = {"ok": False, "error": traceback.format_exc()}
        results[name]["seconds"] = time.perf_counter() - t0
        dist.barrier()
    if rank == 0:
        with open(os.path.join(out_dir, "results.json"), "w") as f:
            json.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
