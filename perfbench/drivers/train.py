"""Driver of the training cells: the port's ``Trainer.train_iteration``
stepping a model back to back under EROICA's tracer.

Set-up builds one trainer with the configuration's model and AdamW, hands
it weights made on the card from the seed (``perfbench.gen.mamba2``) and a
loader of the benchmark's own token batches, and drives it through its
first ``reference_steps`` steps with the tracer's window open, by the
window's own call and feed.  It keeps each step's loss, each leaf's first
clipped gradient norm (read back from AdamW's first moment after step 1:
``m = (1 - b1) g``) and each leaf's change over those steps (the fp32 master
weights against the weights made from the seed).  Then it closes and
summarizes the tracer's window once, which builds and warms K1.

The window runs the same object on: every ``window_steps`` steps the
tracer's window closes (``Tracer.stop_window``), goes through
``summarize_and_upload`` on the same card as a worker's daemon does, and
reopens.  Every close keeps its raw profile and its upload.  After the
window, the check holds each upload's (beta, mu, sigma) against the plain
summary of its raw profile (``perfbench.reference.patterns``), frees the
program's state and runs the plain float32 reference through the same
first steps.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from perfbench import flops, trace
from perfbench.gen import mamba2 as gm
from perfbench.harness import Check
from perfbench.observe import ObservedBackend
from perfbench.reference import mamba2 as refm
from perfbench.reference import patterns as refp

K3_OP = "repro_torch::ssd_scan_fwd"
TRACED_STEPS = 2


class Loader:
    """The trainer's loader: the benchmark's batches, one a step."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.step = 0

    def next(self) -> Dict[str, np.ndarray]:
        b = gm.batch(self.cfg, self.traffic, self.seed, self.step)
        self.step += 1
        return b

    def close(self) -> None:
        pass


def port_config(c: Dict):
    """The program's ``ModelConfig`` for this configuration."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=c["name"], family="ssm", num_layers=c["num_layers"],
        d_model=c["d_model"], vocab_size=c["vocab_size"], attention="none",
        num_heads=0, num_kv_heads=0, d_ff=0, ssm_state=c["d_state"],
        ssm_head_dim=c["head_dim"], ssm_expand=c["expand"],
        ssm_groups=c["n_groups"], ssm_chunk=c["chunk_size"],
        conv_width=c["d_conv"], norm="rms", norm_eps=c["norm_eps"],
        tie_embeddings=c["tie_embeddings"], dtype=c["compute_dtype"],
        param_dtype=c["param_dtype"])


def nest(flat: Dict[str, torch.Tensor]):
    """The program's parameter tree from ``{path: tensor}``: dicts by key,
    lists where the key is a layer index."""
    root: Dict = {}
    for path, t in flat.items():
        parts = path.split("/")
        node = root
        for a in parts[:-1]:
            node = node.setdefault(a, {})
        node[parts[-1]] = t

    def fix(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [fix(node[str(i)]) for i in range(len(node))]
            return {k: fix(v) for k, v in node.items()}
        return node
    return fix(root)


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.lines: List[str] = []
        self.spans: Dict[str, List[float]] = {}
        #: (raw profile, upload) of every summarized window close
        self.summaries: List[Tuple] = []

    # -- the program ---------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.data.pipeline import DataConfig
        from repro_torch.instrument.tracer import ProcessSampler, Tracer
        from repro_torch.models.transformer import param_leaves
        from repro_torch.optim.adamw import OptConfig
        from repro_torch.summarize.base import get_backend
        from repro_torch.train.loop import TrainConfig, Trainer
        c, t, dev = self.ctx.config, self.ctx.traffic, self.ctx.device
        o = c["optimizer"]
        opt = OptConfig(**{k: o[k] for k in (
            "lr_peak", "warmup_steps", "total_steps", "min_lr_ratio", "b1",
            "b2", "eps", "weight_decay", "clip_norm")})
        tr = Trainer(port_config(c), DataConfig(batch=t["batch"],
                                                seq_len=t["seq_len"]),
                     opt, TrainConfig(perftracker=False, seed=0), device=dev)
        tr.loader.close()
        tr.loader = Loader(c, t, self.ctx.seed)
        self.trainer = tr
        params = nest(gm.make_weights(c, self.ctx.seed, dev))
        got = [(p, tuple(x.shape)) for p, x in param_leaves(params)]
        want = [(p, s) for p, s, _, _ in gm.layout(c)]
        if got != want:
            raise RuntimeError("the parameter tree is not the layout")
        opt_state = tr.opt.init(params)
        # the per-process cpu sampler, as the port's own training workers
        # use it: the machine-wide /proc/stat one reads a busy host's load,
        # and nothing at all on a host whose /proc/stat does not advance
        self.tracer = Tracer(worker=0, samplers={"cpu": ProcessSampler(
            rate_hz=float(t["sampler_hz"]))})
        self.backend = ObservedBackend(get_backend("cuda" if dev.type ==
                                                   "cuda" else "torch", dev))
        self.tracer.start_window()
        self.first_losses: List[float] = []
        for i in range(int(t["reference_steps"])):
            params, opt_state, m = tr.train_iteration(params, opt_state,
                                                      self.tracer)
            self.first_losses.append(float(m["loss"]))
            if i == 0:
                b1 = float(o["b1"])
                self.grad1 = {p: float(x.double().norm()) / (1 - b1)
                              for p, x in param_leaves(opt_state["m"])}
        init = gm.make_weights(c, self.ctx.seed, dev)
        self.change = {p: float((x - init[p].float()).double().norm())
                       for p, x in param_leaves(opt_state["master"])}
        del init
        self.params, self.opt_state = params, opt_state
        self._close()
        self.spans.clear()
        self._sync()

    def _sync(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def _close(self, summarize: bool = True) -> None:
        """Close the tracer's window, summarize it as the worker's daemon
        does, keep its phases' spans, and open the next one."""
        from repro_torch.core.daemon import summarize_and_upload
        t0 = time.perf_counter()
        with record_function("perfbench.window_close"):
            prof = self.tracer.stop_window()
            if summarize:
                up = summarize_and_upload(prof, backend=self.backend)
        if summarize:
            self.spans.setdefault("window_close", []).append(
                time.perf_counter() - t0)
            self.summaries.append((prof, up))
        for e in prof.events:
            if e.depth == 1:
                self.spans.setdefault(e.name, []).append(e.end - e.start)
        self.tracer.start_window()

    def _step(self) -> float:
        self.params, self.opt_state, m = self.trainer.train_iteration(
            self.params, self.opt_state, self.tracer)
        return float(m["loss"])

    def window(self, seconds: float) -> None:
        rec, t = self.ctx.record, self.ctx.traffic
        every = int(t["window_steps"])
        if self.ctx.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.ctx.device)
        steps, failed, since = 0, 0, 0
        walls = []
        t0 = time.perf_counter()
        while True:
            t1 = time.perf_counter()
            failed += not math.isfinite(self._step())
            walls.append(time.perf_counter() - t1)
            steps += 1
            since += 1
            if since == every:
                self._close()
                since = 0
            if time.perf_counter() - t0 >= seconds:
                break
        rec["window_s"] = time.perf_counter() - t0
        if self.ctx.device.type == "cuda":
            rec["window_memory_peak_bytes"] = torch.cuda.max_memory_allocated(
                self.ctx.device)
        if since:
            self._close(summarize=False)    # the last steps' spans, untimed
        rec["count"] = steps
        rec["step_tokens"] = int(t["batch"]) * int(t["seq_len"])
        rec["tokens"] = steps * rec["step_tokens"]
        rec["attempted"], rec["failed"] = steps, failed
        rec["n_params"] = int(self.ctx.config["n_params"])
        rec["spans"] = self.spans
        self.lines.append(
            f"[window] {steps} steps ({rec['tokens']} tokens) in "
            f"{rec['window_s']:.4f} s, {len(self.spans.get('window_close', ()))}"
            f" window closes; K1 calls {self.backend.calls}")
        self.lines.append(f"[window] seconds a step: "
                          f"{[round(w, 4) for w in walls]}")

    def traced(self):
        """``TRACED_STEPS`` more steps under the profiler, the tracer's
        window open."""
        self.ctx.record["traced_steps"] = TRACED_STEPS
        with trace.traced_window(self.ctx.device) as prof:
            for _ in range(TRACED_STEPS):
                with record_function("perfbench.train_iteration"):
                    self._step()
        t = time.perf_counter()
        summary = trace.summarize(prof, {"k3": K3_OP})
        c, tr = self.ctx.config, self.ctx.traffic
        di = c["expand"] * c["d_model"]
        self.ctx.record["k3_bound_s"] = flops.k3_bound_s(
            tr["batch"], tr["seq_len"], di // c["head_dim"], c["head_dim"],
            c["n_groups"], c["d_state"], c["chunk_size"], c["compute_dtype"])
        self.lines.append(
            f"[trace] read in {time.perf_counter() - t:.2f} s; K3 "
            f"{summary.anchors if summary else 'no trace'}; bound a call "
            f"{self.ctx.record['k3_bound_s']!r} s")
        return summary

    # -- the check -------------------------------------------------------------
    def free(self) -> None:
        """Drop the program's state, so that the reference has the card."""
        self.tracer.stop_window()
        del self.params, self.opt_state, self.trainer
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_batches(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        c, t, dev = self.ctx.config, self.ctx.traffic, self.ctx.device
        out = []
        for i in range(int(t["reference_steps"])):
            b = gm.batch(c, t, self.ctx.seed, i)
            out.append((torch.from_numpy(b["tokens"]).to(dev),
                        torch.from_numpy(b["labels"]).to(dev)))
        return out

    def check(self) -> List[Check]:
        """Every window summary against the plain summary of its raw
        profile, then the first steps against the plain float32 reference:
        the worst and the median leaf's first clipped gradient norm and
        change (module docstring)."""
        c = self.ctx.config
        t0 = time.perf_counter()
        gap = summary_gap(self.summaries)
        self.lines.append(
            f"[reference] {len(self.summaries)} window summaries in "
            f"{time.perf_counter() - t0:.2f} s; largest pattern gap {gap!r}")
        self.free()
        t0 = time.perf_counter()
        batches = self.reference_batches()
        ref = refm.follow(c, c["optimizer"], gm.make_weights(
            c, self.ctx.seed, self.ctx.device), batches)
        nums = compare(self.first_losses, self.grad1, self.change, ref)
        nums["pattern_gap"] = gap
        self.lines.append(
            f"[reference] {len(batches)} steps in "
            f"{time.perf_counter() - t0:.2f} s; losses program "
            f"{self.first_losses} reference {ref['losses']} (largest "
            f"relative gap {nums['loss_gap']!r}, not compared: PERF.md); "
            f"worst leaves {nums['worst']}")
        self.lines.append("[reference] readings " + " ".join(
            f"{k} {nums[k]!r}" for k in ("pattern_gap", "grad_gap",
                                         "grad_med", "change_gap",
                                         "change_med", "loss_gap")))
        lim = self.ctx.workload["limits"]
        return [Check(k, nums[k], float(lim[k])) for k in lim]

    def notes(self) -> List[str]:
        return self.lines


def plain_profile(prof, sample_dtype: str = "float32") -> Dict:
    """The reference's summary of one of the program's raw profiles, read
    by attribute: its executions, its streams' samples and its window."""
    events = [refp.Execution(e.name, int(e.kind), e.start, e.end, e.depth,
                             e.thread, e.resource) for e in prof.events]
    streams = {k: refp.Stream(s.rate_hz, s.t0, np.asarray(s.values))
               for k, s in prof.streams.items()}
    t0, t1 = prof.window
    return refp.worker_patterns(events, streams, t1 - t0, sample_dtype)


def summary_gap(summaries: List[Tuple]) -> float:
    """The largest pattern gap of any upload against the plain summary of
    its profile; infinite when there is none to compare."""
    if not summaries:
        return math.inf
    return max(refp.pattern_gap(up.unpack()[0], plain_profile(prof))
               for prof, up in summaries)


class PlantedK1:
    """A summarize backend whose answers are altered where K1 produces
    them: ``shift`` adds 0.01 to every row's mean, ``half`` zeroes the
    results of the second half of the rows."""

    def __init__(self, inner, how: str):
        self.inner, self.how, self.name = inner, how, inner.name

    def batch_stats(self, u):
        return self.alter(self.inner.batch_stats(u), self.how)

    @staticmethod
    def alter(stats, how: str) -> np.ndarray:
        out = np.array(stats, np.float64)
        if how == "shift":
            out[:, 0] += 0.01
        else:
            out[out.shape[0] // 2:] = 0.0
        return out


def control_readings(ctx, seconds: float) -> Dict:
    """The numbers the cell compares, read for its control and planted
    faults at the cell's own size (``perfbench/control.py``): the program
    runs set-up and a window of ``seconds``; each window summary's plain
    summary with bfloat16 samples is held against the float32 one, and
    each window's raw profile is summarized again by the program with K1's
    answers altered (``PlantedK1``) and with its profile emptied (the
    summary skipped); then the reference in float8 operands (the control),
    on half the batch, and with one leaf's gradient doubled where it is
    produced is held against the float32 reference."""
    from repro_torch.core.daemon import summarize_and_upload
    drv = Driver(ctx)
    drv.setup()
    drv.window(seconds)
    out = {"summaries": len(drv.summaries),
           "program": {"pattern_gap": summary_gap(drv.summaries)},
           "control_bf16": {"pattern_gap": max(
               refp.pattern_gap(plain_profile(p, "bfloat16"), plain_profile(p))
               for p, _ in drv.summaries)}}
    for how in ("shift", "half"):
        bad = PlantedK1(drv.backend, how)
        out[f"k1_{how}"] = {"pattern_gap": summary_gap(
            [(p, summarize_and_upload(p, backend=bad))
             for p, _ in drv.summaries])}
    out["summary_skipped"] = {"pattern_gap": summary_gap(
        [(p, summarize_and_upload(type(p)(worker=p.worker, window=p.window),
                                  backend=drv.backend))
         for p, _ in drv.summaries])}
    drv.free()
    c = ctx.config
    batches = drv.reference_batches()
    half = []
    for tok, lab in batches:
        lab = lab.clone()
        lab[:, lab.shape[1] // 2:] = -100
        half.append((tok, lab))
    runs = {}
    x2 = {"blocks/0/mamba/w_x": 2.0}
    for name, prec, bs, scale in (("reference", "float32", batches, None),
                                  ("control_fp8", "fp8", batches, None),
                                  ("half_batch", "float32", half, None),
                                  ("grad_altered", "float32", batches, x2)):
        t = time.perf_counter()
        runs[name] = refm.follow(c, c["optimizer"], gm.make_weights(
            c, ctx.seed, ctx.device), bs, prec, scale)
        runs[name]["seconds"] = time.perf_counter() - t
    base = runs.pop("reference")
    out["reference_s"] = base["seconds"]
    for name, r in runs.items():
        nums = compare(r["losses"], r["grad1"], r["change"], base)
        out[name] = {k: nums[k] for k in ("loss_gap", "grad_gap", "grad_med",
                                          "change_gap", "change_med")}
        out[name]["worst"] = nums["worst"]
    return out


def compare(losses: List[float], grad1: Dict[str, float],
            change: Dict[str, float], ref: Dict) -> Dict:
    """The numbers compared, each leaf's gap taken between the program's
    and the reference's norms (of the first clipped gradient, or of the
    change over the steps) against the larger of that leaf's reference norm
    and the median leaf's: ``*_gap`` by the worst leaf, ``*_med`` by the
    median leaf, and the largest relative gap of a step's loss.  Leaves whose reference
    gradient is under a thousandth of the median leaf's move by round-off
    alone and are left out of the change."""
    rl = ref["losses"]
    loss_gap = max((abs(a - b) / abs(b) if math.isfinite(a) else math.inf)
                   for a, b in zip(losses, rl))
    rg, rc = ref["grad1"], ref["change"]
    med_g = float(np.median(list(rg.values())))
    moved = [k for k in rg if rg[k] >= 1e-3 * med_g]
    med_c = float(np.median([rc[k] for k in moved]))

    def gaps(prog, refn, keys, med):
        out = {}
        for k in keys:
            v = abs(prog.get(k, math.inf) - refn[k]) / max(refn[k], med)
            out[k] = v if math.isfinite(v) else math.inf
        return out
    out = {"loss_gap": loss_gap, "worst": {},
           "left_out": sorted(set(rg) - set(moved))}
    for name, g in (("grad", gaps(grad1, rg, list(rg), med_g)),
                    ("change", gaps(change, rc, moved, med_c))):
        k = max(g, key=g.get)
        out[f"{name}_gap"] = g[k]
        out["worst"][name] = k
        out[f"{name}_med"] = float(np.median(list(g.values())))
    return out
