"""Multi-pod dry run (port of the reference's ``repro/launch/dryrun.py``):
trace every (architecture x input-shape) cell on the production meshes
without allocating anything, and derive the roofline terms from the count.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
      --shape train_4k --mesh single

The reference lowers and compiles each cell on 256/512 placeholder host
devices and reads FLOPs, bytes, collectives and memory from the compiled
module.  Here the process joins a ``"fake"`` process group of 256 ranks
(512 with ``--mesh multi``) as rank 0, builds the production mesh over it
(``launch.mesh``'s shapes and axis names), and runs the cell's step once under
a ``FakeTensorMode``: parameters, optimizer state, batch and cache are fake
tensors with the real init's shapes and dtypes, placed as DTensors by
``DistCtx``, and every op computes only the shapes of its results.  While
it runs, ``launch.step_cost.count_step`` counts this rank's FLOPs, bytes
and collectives (the reference's ``hlo_cost.expanded_cost``) and
``LiveBytes`` follows the storages it allocates and frees, which gives the
peak of live bytes (the compiled module's memory analysis).  K2 and K3 run
through the fake implementations of their custom ops
(``repro_torch::flash_attention_fwd``, ``repro_torch::ssd_scan_fwd``) and
count by their FLOP formulas, as on the card.

The reference's flags, with the same meanings.  One flag is the port's own:
``--device`` (default ``cuda``) is the route traced: ``cuda`` the card's
(a ``cuda`` mesh, K2 and K3 by their fake implementations after the checks
a launch makes), ``cpu`` the plain one.  Nothing is allocated on either, so
no card is needed; the ``cuda`` route needs a PyTorch built with CUDA,
whose device guard Python indexing of a CUDA tensor enters, fake or not.
The ``compile_s`` of a report is the seconds of the traced step,
``lower_s`` those of building its fake state; the keys that read XLA's
artifacts (``hlo_text_bytes``, ``raw_cost_flops``, ``raw_cost_bytes``, and
``alias_size_in_bytes`` and ``generated_code_size_in_bytes`` in
``memory``) are None.

The fake process group must be the process's only one: the run starts it
and destroys it, and nothing else may hold a group in the same process.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
import weakref
from contextlib import contextmanager, nullcontext
from pathlib import Path

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs.base import shapes_for
from repro_torch.configs.registry import ARCHS, get_arch, get_shape
from repro_torch.dist.sharding import DistCtx
from repro_torch.launch import analysis as an
from repro_torch.launch.mesh import (MULTI_POD_AXES, MULTI_POD_SHAPE,
                                     PRODUCTION_AXES, PRODUCTION_SHAPE,
                                     make_mesh)
from repro_torch.launch.step_cost import count_step, propagating
from repro_torch.models import io as mio
from repro_torch.models.transformer import Transformer
from repro_torch.optim.adamw import AdamW, OptConfig
from repro_torch.train.step import (make_prefill_step, make_serve_step,
                                    make_train_step)

DEFAULT_OUT = Path("reports/dryrun_torch")
DEVICES = ("cuda", "cpu")


# -- the fake world -----------------------------------------------------------

@contextmanager
def fake_world(size: int):
    """A ``"fake"`` default process group of ``size`` ranks, this process
    rank 0, for the block's length; a fake group of that size that is
    already up is used as it is.  Raises if another group holds the
    process."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != size:
            raise RuntimeError(f"a dry run needs the process's only process "
                               f"group to be a fake one of {size} ranks; "
                               f"found {dist.get_backend()} of "
                               f"{dist.get_world_size()}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), world_size=size,
                            rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_axes(mesh_shape) -> tuple:
    """The axis names of a mesh shape: ``(data, model)`` or ``(pod, data,
    model)``, as the production meshes name them."""
    return {2: PRODUCTION_AXES, 3: MULTI_POD_AXES}[len(mesh_shape)]


def mesh_tag(mesh_shape) -> str:
    """``16x16``, ``2x16x16``; ``1`` for one device with no mesh."""
    return "x".join(str(s) for s in mesh_shape) or "1"


# -- what a step holds and allocates ------------------------------------------

def _storages(tree):
    """The distinct storages of the tensors of ``tree``, a DTensor's local
    shard for a DTensor."""
    seen = {}
    for t in tree_flatten(tree)[0]:
        if not isinstance(t, torch.Tensor):
            continue
        if hasattr(t, "to_local"):
            t = t.to_local()
        st = t.untyped_storage()
        seen.setdefault(id(st), st)
    return list(seen.values())


def local_bytes(tree) -> int:
    """Bytes of this rank's share of ``tree``: every distinct storage
    counted once (a DTensor's local shard)."""
    return sum(st.nbytes() for st in _storages(tree))


def output_bytes(tree) -> int:
    """Bytes of a step's results, each result its own buffer as the
    reference's outputs are (this port updates in place)."""
    total = 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            t = t.to_local() if hasattr(t, "to_local") else t
            total += t.numel() * t.element_size()
    return total


class LiveBytes(TorchDispatchMode):
    """Follows the storages that the ops of one fake mode create, and the
    peak of live bytes.  ``hold(tree)`` adds tensors that exist before the
    step (its arguments).  DTensor ops pass through to their local ops, and
    the fake tensors of DTensor's sharding propagation (marked by
    ``step_cost.marking_propagation``) are not followed."""

    def __init__(self, fake_mode):
        super().__init__()
        self.fake_mode = fake_mode
        self.live = 0
        self.peak = 0
        self._refs = {}

    def _follow(self, st) -> None:
        key = id(st)
        if key in self._refs:
            return
        n = st.nbytes()

        def freed(_, key=key, n=n):
            if self._refs.pop(key, None) is not None:
                self.live -= n
        self._refs[key] = weakref.ref(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)

    def hold(self, tree) -> None:
        for st in _storages(tree):
            self._follow(st)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(type(t).__name__ == "DTensor"
               for t in tree_flatten((args, kwargs))[0]):
            return NotImplemented
        out = func(*args, **kwargs)
        if propagating() or func.overloadpacket.__name__ == "wait_tensor":
            # DTensor's sharding propagation allocates nothing on a device;
            # a wait returns the collective's own result
            return out
        for t in tree_flatten(out)[0]:
            if isinstance(t, FakeTensor) and t.fake_mode is self.fake_mode:
                self._follow(t.untyped_storage())
        return out


# -- a cell -------------------------------------------------------------------

class Lowered:
    """A cell's step and its fake arguments, ready to trace: what the
    reference's ``jax.jit(...).lower(...)`` returns."""

    def __init__(self, fake_mode, step, args):
        self.fake_mode = fake_mode
        self.step = step
        self.args = args


def _fake_batch(cfg, shape, device):
    """Fake inputs of ``io.input_specs``'s shapes and dtypes on
    ``device`` (under the fake mode)."""
    return {k: torch.empty(v.shape, dtype=v.dtype, device=device)
            for k, v in mio.input_specs(cfg, shape).items()}


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               remat: str = "none", folded: bool = False,
               pad_heads: bool = False, zero1_moe: bool = False,
               serve_no_fsdp: bool = False, accum: int = 1, *,
               cfg=None, shape=None, mesh_shape=None, device: str = "cuda"):
    """Builds the cell's fake state and step.  Returns (lowered, meta).
    ``cfg`` and ``shape`` (a ``ShapeConfig``) replace the registry's
    config of ``arch`` and shape ``shape_name``, and ``mesh_shape`` the
    production mesh: the tests pass ``reduced(...)`` and ``(2, 2)``, and
    ``()`` is one device with no mesh.  A mesh needs a process group of its
    size (``fake_world``)."""
    if device not in DEVICES:
        raise ValueError(f"--device is one of {DEVICES}, got {device!r}")
    if device == "cuda" and not torch.backends.cuda.is_built():
        raise RuntimeError("tracing the card's route needs a PyTorch built "
                           "with CUDA (Python indexing of a fake CUDA "
                           "tensor enters its device guard); --device cpu "
                           "traces the plain route")
    cfg = get_arch(arch) if cfg is None else cfg
    shape = get_shape(shape_name) if shape is None else shape
    if mesh_shape is None:
        mesh_shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    mesh_shape = tuple(mesh_shape)
    dctx = None
    if mesh_shape:
        mesh = make_mesh(mesh_shape, mesh_axes(mesh_shape),
                         device_type=device)
        dctx = DistCtx.from_mesh(mesh)
        if zero1_moe:
            dctx.zero1_moe = True
        if serve_no_fsdp and shape.kind == "decode":
            # serving: weights are read-only — replicate over DP, shard
            # over TP only (llama4's 400B stays FSDP: 50 GB/chip replicated
            # won't fit)
            dctx.fsdp = False
    model = Transformer(cfg, dist=dctx,
                        remat=remat if shape.kind == "train" else "none",
                        folded=folded, pad_heads=pad_heads)

    def place(tree, rule, ctx=dctx):
        return tree if ctx is None else ctx.place(tree, rule(tree))
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    with fake_mode:
        params = model.init(0, device=device)
        batch = place(_fake_batch(cfg, shape, device),
                      lambda b: dctx.batch_shardings(b))
        if shape.kind == "train":
            opt = AdamW(OptConfig())
            # opt state always fully sharded (ZeRO); with zero1_moe the
            # PARAMS are dp-replicated but m/v/master stay dp-sharded
            opt_dist = DistCtx.from_mesh(mesh) if dctx else None
            opt_state = place(opt.init(params), lambda st: opt.state_shardings(
                opt_dist.params_shardings(params), opt_dist.replicated()),
                opt_dist)
            params = place(params, lambda p: dctx.params_shardings(p))
            step = make_train_step(model, opt, accum_steps=accum)
            args = (params, opt_state, batch)
        elif shape.kind == "prefill":
            params = place(params, lambda p: dctx.params_shardings(p))
            step = make_prefill_step(model)
            args = (params, batch)
        else:  # decode
            B = shape.global_batch
            cache = place(model.init_cache(B, shape.seq_len, device=device),
                          lambda c: dctx.cache_shardings(c, B))
            params = place(params, lambda p: dctx.params_shardings(p))
            serve = make_serve_step(model)
            pos = shape.seq_len - 1        # the cache's last slot
            step = lambda p, c, b: serve(p, c, b, pos)  # noqa: E731
            args = (params, cache, batch)
    meta = {"cfg": cfg, "shape": shape, "mesh_shape": mesh_shape,
            "devices": math.prod(mesh_shape), "device": device}
    return Lowered(fake_mode, step, args), meta


def trace(lowered: Lowered):
    """Runs the step once under its fake mode, counted (``count_step``)
    and its storages followed (``LiveBytes``).  Returns (cost, argument
    bytes, peak live bytes, output bytes)."""
    live = LiveBytes(lowered.fake_mode)
    result = {}
    with lowered.fake_mode:
        live.hold(lowered.args)
        arg_bytes = live.live

        def run(args, _):
            result["out"] = lowered.step(*args)
        with live:
            cost = count_step(run, lowered.args, None)
        out = output_bytes(result.pop("out"))
    return cost, arg_bytes, live.peak, out


def cell_terms(cfg, shape, cost, n_dev: int):
    """The parameter counts and the roofline terms of a cell whose step
    costs each of ``n_dev`` devices ``cost`` (a ``step_cost.Cost``)."""
    coll = an.CollectiveStats.from_cost(cost)
    terms = an.roofline({"flops": cost.flops, "bytes accessed": cost.bytes},
                        coll, n_dev, an.model_flops(cfg, shape))
    return cfg.param_counts(), terms


def analyse(lowered: Lowered, meta, compile_s: float) -> dict:
    """The reference's report of a cell (module docstring)."""
    cfg, shape = meta["cfg"], meta["shape"]
    n_dev = meta["devices"]
    t0 = time.time()
    cost, arg_bytes, peak, out_bytes = trace(lowered)
    trace_s = time.time() - t0
    mem = {"argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": out_bytes,
           "temp_size_in_bytes": peak - arg_bytes,
           "alias_size_in_bytes": None,
           "generated_code_size_in_bytes": None}
    mem["total_per_device"] = (mem["argument_size_in_bytes"]
                               + mem["temp_size_in_bytes"])
    counts, terms = cell_terms(cfg, shape, cost, n_dev)
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": mesh_tag(meta["mesh_shape"]),
        "devices": n_dev,
        "compile_s": round(trace_s, 1),
        "hlo_text_bytes": None,
        "unknown_trip_loops": cost.unknown_trip_loops,
        "params_total": counts["total"],
        "params_active": counts["active"],
        "memory": mem,
        "raw_cost_flops": None,
        "raw_cost_bytes": None,
        "roofline": terms,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             remat: str, folded: bool, force: bool, tag: str = "",
             pad_heads: bool = False, zero1_moe: bool = False,
             serve_no_fsdp: bool = False, accum: int = 1, *,
             cfg=None, shape=None, mesh_shape=None,
             device: str = "cuda") -> dict:
    """Traces one cell in a fake world of its mesh's size and writes its
    report (``lower_cell`` for ``cfg``, ``shape``, ``mesh_shape`` and
    ``device``)."""
    if mesh_shape is None:
        mesh_shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    mtag = mesh_tag(mesh_shape)
    suffix = f"__{tag}" if tag else ""
    out = Path(out_dir) / mtag / f"{arch}__{shape_name}{suffix}.json"
    if out.exists() and not force:
        res = json.loads(out.read_text())
        print(f"[skip] {mtag} {arch} {shape_name} (cached)")
        return res
    out.parent.mkdir(parents=True, exist_ok=True)
    with fake_world(math.prod(mesh_shape)) if mesh_shape else nullcontext():
        t0 = time.time()
        lowered, meta = lower_cell(arch, shape_name, multi_pod, remat,
                                   folded, pad_heads, zero1_moe,
                                   serve_no_fsdp, accum, cfg=cfg, shape=shape,
                                   mesh_shape=mesh_shape, device=device)
        t_lower = time.time() - t0
        res = analyse(lowered, meta, t_lower)
    res["lower_s"] = round(t_lower, 1)
    res["remat"] = remat
    res["folded"] = folded
    res["pad_heads"] = pad_heads
    res["zero1_moe"] = zero1_moe
    res["serve_no_fsdp"] = serve_no_fsdp
    res["accum"] = accum
    out.write_text(json.dumps(res, indent=1))
    r = res["roofline"]
    print(f"[ok] {mtag} {arch} {shape_name}{suffix}: "
          f"dominant={r['dominant']} "
          f"tc={r['t_compute_s']:.4f}s tm={r['t_memory_s']:.4f}s "
          f"tcoll={r['t_collective_s']:.4f}s "
          f"useful={r['useful_flops_ratio']:.3f} "
          f"roofline={r['roofline_fraction']:.3f} "
          f"(lower {res['lower_s']}s compile {res['compile_s']}s)",
          flush=True)
    return res


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--remat", default="full",
                    choices=["none", "dots", "full"])
    ap.add_argument("--folded", action="store_true",
                    help="balanced causal folding in blocked attention")
    ap.add_argument("--pad-heads", action="store_true",
                    help="phantom-head TP padding (uneven head counts)")
    ap.add_argument("--zero1-moe", action="store_true",
                    help="ZeRO-1 expert weights (no per-layer FSDP gathers)")
    ap.add_argument("--serve-no-fsdp", action="store_true",
                    help="decode cells: replicate weights over DP")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation micro-batches (train)")
    ap.add_argument("--tag", default="", help="result filename suffix")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda", choices=DEVICES,
                    help="the route traced: the card's or the plain one")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    out_dir = Path(args.out)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    cells = []
    if args.all:
        for name, cfg in ARCHS.items():
            for shp in shapes_for(cfg):
                cells.append((name, shp.name))
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    failures = []
    for multi in meshes:
        mshape = MULTI_POD_SHAPE if multi else PRODUCTION_SHAPE
        with fake_world(math.prod(mshape)):
            for arch, shp in cells:
                try:
                    run_cell(arch, shp, multi, out_dir, args.remat,
                             args.folded, args.force, args.tag,
                             args.pad_heads, args.zero1_moe,
                             args.serve_no_fsdp, args.accum,
                             device=args.device)
                except Exception as e:
                    print(f"[FAIL] {mesh_tag(mshape)} {arch} {shp}: {e}",
                          flush=True)
                    failures.append((mesh_tag(mshape), arch, shp,
                                     traceback.format_exc()))
    if failures:
        flog = out_dir / "failures.log"
        flog.parent.mkdir(parents=True, exist_ok=True)
        with open(flog, "a") as f:
            for mtag, arch, shp, tb in failures:
                f.write(f"==== {mtag} {arch} {shp}\n{tb}\n")
        print(f"{len(failures)} failures -> {flog}")
        raise SystemExit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
