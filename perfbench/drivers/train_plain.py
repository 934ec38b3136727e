"""Driver of the training cells with EROICA off: the job as its owner runs
it without the tracer, through the fused step that ``Trainer.run`` runs
with PerfTracker off (``train/step.py::make_train_step``), each batch put
on the card by ``Trainer._batch``.

Set-up builds the trainer with the configuration's model and AdamW, hands
it weights made on the card from the seed and the benchmark's own batches
(``drivers/train.py``'s ``Loader``), and runs its first
``reference_steps`` steps by the window's own call and feed, keeping what
the check compares: each step's loss, each leaf's first clipped gradient
norm (from AdamW's first moment after step 1) and change over those steps.
No tracer window, sampler, fence or window close runs, and K1 is never
built.

The window steps back to back, reads the loss back every ``log_every``
steps as ``Trainer.run`` does, keeps every step's loss on the card, and
waits for the card before it reads its clock at the end; the losses are
checked for ``failed`` after it.  With ``--trace 1`` the program's span
record (``repro_torch.instrument.tracer.record_spans``) is on for the
window and its spans are kept by name; then ``TRACED_STEPS`` steps run
under the profiler, and each phase's device seconds come from the kernels
launched inside its span (``PHASES``).  A program without the record, or
without the spans, reads nothing there.
"""
from __future__ import annotations

import bisect
import gc
import time
from typing import Dict, List

import torch

from perfbench import trace
from perfbench.drivers import train as profiled
from perfbench.gen import mamba2 as gm
from perfbench.harness import Check
from perfbench.reference import mamba2 as refm

TRACED_STEPS = 2
#: each phase whose device time the traced steps read: the program's span,
#: and whether the span's own thread launches its kernels (the autograd
#: engine launches a backward's from a thread of its own)
PHASES = {"forward": ("train.forward", True),
          "backward": ("train.backward", False),
          "optimizer": ("optimizer.update", True)}


def span_record():
    """The program's switch of its in-memory span record, or None in a
    program that has none."""
    from repro_torch.instrument import tracer
    return getattr(tracer, "record_spans", None)


def launched_under(prof, name: str) -> Dict[str, float]:
    """As ``trace.summarize``'s anchors, for a range whose kernels another
    thread launches: the kernels and fills (copies left out) launched from
    any thread while a host range ``name`` was open in the trace's window."""
    host, device, launches = [], [], []
    for e in trace._events(prof):
        kind = trace._kind(e)
        if kind == "skip":
            continue
        iv = trace.Interval(e.name(), int(e.start_ns()),
                            int(e.start_ns() + e.duration_ns()),
                            corr=int(e.correlation_id()))
        {"host": host, "device": device, "launch": launches}[kind].append(iv)
    win = [h for h in host if h.name == trace.WINDOW]
    if not win:
        return {"ranges": 0.0, "kernels": 0.0, "device_s": 0.0}
    w0, w1 = win[0].start, win[0].end
    spans = sorted((h.start, h.end) for h in host
                   if h.name == name and h.end > w0 and h.start < w1)
    starts = [a for a, _ in spans]
    ids = set()
    for h in launches:
        i = bisect.bisect_right(starts, h.start) - 1
        if i >= 0 and h.start < spans[i][1]:
            ids.add(h.corr)
    kern = [d for d in device if d.corr in ids and not trace._is_copy(d.name)]
    return {"ranges": float(len(spans)), "kernels": float(len(kern)),
            "device_s": sum(d.end - d.start for d in kern) / 1e9}


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.lines: List[str] = []

    # -- the program ---------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.data.pipeline import DataConfig
        from repro_torch.models.transformer import param_leaves
        from repro_torch.optim.adamw import OptConfig
        from repro_torch.train.loop import TrainConfig, Trainer
        from repro_torch.train.step import make_train_step
        c, t, dev = self.ctx.config, self.ctx.traffic, self.ctx.device
        o = c["optimizer"]
        opt = OptConfig(**{k: o[k] for k in (
            "lr_peak", "warmup_steps", "total_steps", "min_lr_ratio", "b1",
            "b2", "eps", "weight_decay", "clip_norm")})
        tr = Trainer(profiled.port_config(c), DataConfig(
            batch=t["batch"], seq_len=t["seq_len"]), opt,
            TrainConfig(perftracker=False, seed=0), device=dev)
        tr.loader.close()
        tr.loader = profiled.Loader(c, t, self.ctx.seed)
        self.trainer = tr
        self.train_step = make_train_step(tr.model, tr.opt)
        self.params = profiled.nest(gm.make_weights(c, self.ctx.seed, dev))
        self.opt_state = tr.opt.init(self.params)
        self.first_losses: List[float] = []
        for i in range(int(t["reference_steps"])):
            self.first_losses.append(float(self._step()["loss"]))
            if i == 0:
                b1 = float(o["b1"])
                self.grad1 = {p: float(x.double().norm()) / (1 - b1)
                              for p, x in param_leaves(self.opt_state["m"])}
        init = gm.make_weights(c, self.ctx.seed, dev)
        self.change = {p: float((x - init[p].float()).double().norm())
                       for p, x in param_leaves(self.opt_state["master"])}
        del init
        self._sync()

    def _sync(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def _step(self) -> Dict[str, torch.Tensor]:
        tr = self.trainer
        self.params, self.opt_state, m = self.train_step(
            self.params, self.opt_state, tr._batch(tr.loader.next()))
        return m

    def window(self, seconds: float) -> None:
        rec, t = self.ctx.record, self.ctx.traffic
        every = int(t["log_every"])
        record = span_record() if self.ctx.trace else None
        if self.ctx.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.ctx.device)
        losses = []
        if record is not None:
            record(True)
        t0 = time.perf_counter()
        while True:
            losses.append(self._step()["loss"])
            if len(losses) % every == 0:
                float(losses[-1])
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        rec["window_s"] = time.perf_counter() - t0
        spans: Dict[str, List[float]] = {}
        if record is not None:
            for s in record(False):
                spans.setdefault(s.name, []).append(s.end - s.start)
        if self.ctx.device.type == "cuda":
            rec["window_memory_peak_bytes"] = torch.cuda.max_memory_allocated(
                self.ctx.device)
        steps = len(losses)
        rec["count"] = steps
        rec["step_tokens"] = int(t["batch"]) * int(t["seq_len"])
        rec["tokens"] = steps * rec["step_tokens"]
        rec["attempted"] = steps
        rec["failed"] = int((~torch.isfinite(torch.stack(losses))).sum())
        rec["spans"] = spans
        state = ("off" if not self.ctx.trace else "on" if record is not None
                 else "absent from the program")
        self.lines.append(
            f"[window] {steps} steps ({rec['tokens']} tokens) in "
            f"{rec['window_s']:.4f} s; span record {state}; spans a step "
            f"(mean s): " + ", ".join(
                f"{k} {sum(v) / len(v):.6f} x{len(v)}"
                for k, v in spans.items()))

    def traced(self):
        """``TRACED_STEPS`` more steps under the profiler; each phase's
        device seconds a step go to ``rec["phase_device_s"]``."""
        rec = self.ctx.record
        rec["traced_steps"] = TRACED_STEPS
        with trace.traced_window(self.ctx.device) as prof:
            for _ in range(TRACED_STEPS):
                self._step()
        t = time.perf_counter()
        summary = trace.summarize(prof, {k: n for k, (n, same) in
                                         PHASES.items() if same})
        if summary is None:
            return None
        for k, (name, same) in PHASES.items():
            if not same:
                summary.anchors[k] = launched_under(prof, name)
        rec["phase_device_s"] = {k: a["device_s"] / TRACED_STEPS
                                 for k, a in summary.anchors.items()
                                 if a["kernels"]}
        self.lines.append(
            f"[trace] read in {time.perf_counter() - t:.2f} s; busy "
            f"{summary.busy_s!r} s of {summary.window_s!r} s; phases "
            f"{summary.anchors}")
        return summary

    # -- the check -------------------------------------------------------------
    def free(self) -> None:
        """Drop the program's state, so that the reference has the card."""
        del self.params, self.opt_state, self.trainer, self.train_step
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> List[Check]:
        """The first steps against the plain float32 reference, as the
        profiled cell compares them (``drivers/train.py::compare``)."""
        c = self.ctx.config
        self.free()
        t0 = time.perf_counter()
        batches = profiled.Driver(self.ctx).reference_batches()
        ref = refm.follow(c, c["optimizer"], gm.make_weights(
            c, self.ctx.seed, self.ctx.device), batches)
        nums = profiled.compare(self.first_losses, self.grad1, self.change,
                                ref)
        self.lines.append(
            f"[reference] {len(batches)} steps in "
            f"{time.perf_counter() - t0:.2f} s; losses program "
            f"{self.first_losses} reference {ref['losses']} (largest "
            f"relative gap {nums['loss_gap']!r}, not compared: PERF.md); "
            f"worst leaves {nums['worst']}")
        self.lines.append("[reference] readings " + " ".join(
            f"{k} {nums[k]!r}" for k in ("grad_gap", "grad_med",
                                         "change_gap", "change_med",
                                         "loss_gap")))
        lim = self.ctx.workload["limits"]
        return [Check(k, nums[k], float(lim[k])) for k in lim]

    def notes(self) -> List[str]:
        return self.lines


def control_readings(ctx, seconds: float) -> Dict:
    """The numbers the cell compares, read at the cell's own size
    (``perfbench/control.py``; no window is needed, so ``seconds`` goes
    unused): the program's set-up steps, the reference in float8 operands
    (the control), on half the batch, and with one leaf's gradient doubled
    where it is produced, each held against the float32 reference."""
    drv = Driver(ctx)
    drv.setup()
    drv.free()
    c = ctx.config
    batches = profiled.Driver(ctx).reference_batches()
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
    runs["program"] = {"losses": drv.first_losses, "grad1": drv.grad1,
                       "change": drv.change}
    out = {"reference_s": base["seconds"]}
    for name, r in runs.items():
        nums = profiled.compare(r["losses"], r["grad1"], r["change"], base)
        out[name] = {k: nums[k] for k in ("loss_gap", "grad_gap", "grad_med",
                                          "change_gap", "change_med")}
        out[name]["worst"] = nums["worst"]
    return out
