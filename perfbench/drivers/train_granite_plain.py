"""Driver of the granite-4.0-h training cell with EROICA off: the job as
``drivers/train_plain.py`` runs it (the fused step of ``train/step.py``,
each batch put on the card by ``Trainer._batch``, the loss read every
``log_every`` steps), on the configuration's layout
(``perfbench.gen.granite_moe_hybrid``: Mamba2 and attention layers, each
followed by an MoE whose held experts are the configuration's share, and a
shared expert) and checked against its plain reference
(``perfbench.reference.granite_moe_hybrid``).

Set-up also counts what one step runs, over the ``reference_steps`` steps
it makes: the program's ``moe.layer`` spans (with its span record on,
where the program has one), the held-expert layer's counters (pairs routed
to held experts, pairs dropped, the largest expert's pairs in a layer),
and the launches of K2 at the attention's head dim, K3, the gated K4, K5
and K6.  The check holds them to the layout, as ``structure_gap`` (limit
0): a span for each layer, no pair dropped, and on the card K3 and a gated
K4 forward and backward for each mamba layer, K2 for each attention
layer, K5 three times each way for each mamba layer, and K6 once each way
(the CPU's plain versions count no launch), and no block of (tokens x
vocabulary) f32 bytes allocated in the last of those steps (on the card,
by the allocator's record).

With ``--trace 1`` the traced steps give, besides the phases of
``drivers/train_plain.py``, the device seconds of the kernels launched
inside ``moe.layer`` (the forward's FFN blocks) and inside ``moe.experts``
against the held experts' least time (``perfbench/expert_bound.py``, from
the pairs counter over the traced steps), and K3's and K2's device time
against their least time a call.  A program without the layout fails its
set-up at once: it has no held-expert counters, and its ``ModelConfig``
takes none of the layout's fields.

The record also holds the step's model operations
(``perfbench/granite_flops.py``), which ``train.hybrid_mfu`` reads over
the measured window.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

from perfbench import expert_bound, flops, granite_flops, k2_bound, trace
from perfbench.drivers import train as profiled
from perfbench.drivers import train_plain as plain
from perfbench.drivers import train_zamba2_plain as zamba2
from perfbench.gen import granite_moe_hybrid as gg
from perfbench.harness import Check
from perfbench.reference import granite_moe_hybrid as refg

MOE_SPAN = "moe.layer"
EXPERTS_SPAN = "moe.experts"


def port_config(c: Dict):
    """The program's ``ModelConfig`` for this configuration."""
    from repro_torch.configs.base import ModelConfig
    heads, kv, hd = gg.attention_dims(c)
    return ModelConfig(
        name=c["name"], family="hybrid", num_layers=c["num_layers"],
        d_model=c["d_model"], vocab_size=c["vocab_size"], norm="rms",
        norm_eps=c["norm_eps"], mlp={"silu": "swiglu"}[c["hidden_act"]],
        d_ff=c["intermediate_size"], tie_embeddings=c["tie_embeddings"],
        attention="gqa", num_heads=heads, num_kv_heads=kv, head_dim=hd,
        attn_scale=float(c["attention_multiplier"]),
        position_embedding=c["position_embedding_type"],
        rope_theta=float(c["rope_theta"]),
        num_experts=c["num_local_experts_published"],
        top_k=c["num_experts_per_tok"], num_shared_experts=1,
        shared_d_ff=c["shared_intermediate_size"], gate_topk_first=True,
        moe_dropless=True, experts_start=c["experts_start"],
        experts_held=c["num_local_experts"],
        aux_loss_weight=float(c["router_aux_loss_coef"]),
        ssm_state=c["d_state"], ssm_head_dim=c["head_dim"],
        ssm_expand=c["expand"], ssm_groups=c["n_groups"],
        ssm_chunk=c["chunk_size"], conv_width=c["d_conv"],
        layer_types=tuple(c["layer_types"]),
        residual_multiplier=float(c["residual_multiplier"]),
        embedding_multiplier=float(c["embedding_multiplier"]),
        logits_scaling=float(c["logits_scaling"]),
        dtype=c["compute_dtype"], param_dtype=c["param_dtype"])


def counts() -> Dict[str, int]:
    """The program's counters this cell reads: K2's launches by head dim
    and K4's gated ones (``drivers/train_zamba2_plain.py``), K3's, K5's
    and K6's by direction, and the held-expert layer's."""
    from repro_torch.kernels.causal_conv import causal_conv_silu
    from repro_torch.kernels.cross_entropy import cross_entropy
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.moe import counters
    out = {**zamba2.counts(), "k3": ssd_scan.launches,
           "pairs": counters.pairs, "dropped": counters.dropped}
    for name, k in (("k5", causal_conv_silu), ("k6", cross_entropy)):
        for way, n in k.launches_by_direction.items():
            out[f"{name}_{way}"] = n
    return out


def idle_inside(prof, name: str) -> float:
    """The device's idle seconds while a host range ``name`` was open in
    the trace's window: the gaps between its kernels (copies included)
    that fall inside those ranges."""
    host, device = [], []
    for e in trace._events(prof):
        kind = trace._kind(e)
        iv = (int(e.start_ns()), int(e.start_ns() + e.duration_ns()))
        if kind == "device":
            device.append(iv)
        elif kind == "host":
            host.append((e.name(), iv))
    win = [iv for n, iv in host if n == trace.WINDOW]
    if not win:
        return 0.0
    w0, w1 = win[0]
    busy = trace._union([(max(a, w0), min(b, w1)) for a, b in device
                         if b > w0 and a < w1])
    idle, prev = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            idle.append((prev, a))
        prev = max(prev, b)
    spans = trace._union([iv for n, iv in host if n == name])
    return sum(max(0, min(b, d) - max(a, c)) for a, b in spans
               for c, d in idle) / 1e9


class Driver(plain.Driver):
    # -- the program ---------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.data.pipeline import DataConfig
        from repro_torch.models.moe import counters
        from repro_torch.models.transformer import param_leaves
        from repro_torch.optim.adamw import OptConfig
        from repro_torch.train.loop import TrainConfig, Trainer
        from repro_torch.train.step import make_train_step
        c, t, dev = self.ctx.config, self.ctx.traffic, self.ctx.device
        cfg = port_config(c)
        o = c["optimizer"]
        opt = OptConfig(**{k: o[k] for k in (
            "lr_peak", "warmup_steps", "total_steps", "min_lr_ratio", "b1",
            "b2", "eps", "weight_decay", "clip_norm")})
        tr = Trainer(cfg, DataConfig(batch=t["batch"], seq_len=t["seq_len"]),
                     opt, TrainConfig(perftracker=False, seed=0), device=dev)
        tr.loader.close()
        tr.loader = profiled.Loader(c, t, self.ctx.seed)
        self.trainer = tr
        self.train_step = make_train_step(tr.model, tr.opt)
        self.params = profiled.nest(gg.make_weights(c, self.ctx.seed, dev))
        got = [(p, tuple(x.shape)) for p, x in param_leaves(self.params)]
        if got != [(p, s) for p, s, _, _ in gg.layout(c)]:
            raise RuntimeError("the parameter tree is not the layout")
        self.opt_state = tr.opt.init(self.params)
        record = plain.span_record()
        counters.reset()
        before = counts()
        if record is not None:
            record(True)
        steps = int(t["reference_steps"])
        self.first_losses: List[float] = []
        for i in range(steps):
            if i == steps - 1:
                logit_blocks = self._f32_logit_blocks()
            else:
                self.first_losses.append(float(self._step()["loss"]))
            if i == 0:
                b1 = float(o["b1"])
                self.grad1 = {p: float(x.double().norm()) / (1 - b1)
                              for p, x in param_leaves(self.opt_state["m"])}
        spans = record(False) if record is not None else None
        after = counts()
        self.per_step = {k: (after[k] - before.get(k, 0)) / steps
                         for k in after}
        self.per_step["f32_logit_blocks"] = logit_blocks
        self.largest = counters.largest
        if spans is not None:
            self.per_step["spans"] = sum(s.name == MOE_SPAN
                                         for s in spans) / steps
        self.hd = cfg.head_dim
        init = gg.make_weights(c, self.ctx.seed, dev)
        self.change = {p: float((x - init[p].float()).double().norm())
                       for p, x in param_leaves(self.opt_state["master"])}
        del init
        self.ctx.record["step_model_flops"] = granite_flops.step_flops(
            c, int(t["batch"]), int(t["seq_len"]))
        self._sync()

    def _f32_logit_blocks(self) -> int:
        """One step, its loss kept, and on the card in a bf16 step the count
        of blocks of at least (tokens x vocabulary) f32 bytes it allocated
        (the allocator's record; none where the loss runs K6)."""
        import torch
        if self.ctx.device.type != "cuda" \
                or self.ctx.config["compute_dtype"] == "float32":
            # off the card, or where the head's own product is f32
            self.first_losses.append(float(self._step()["loss"]))
            return 0
        t = self.ctx.traffic
        size = int(t["batch"]) * int(t["seq_len"]) \
            * int(self.ctx.config["vocab_size"]) * 4
        self._sync()
        torch.cuda.memory._record_memory_history(max_entries=1_000_000)
        try:
            self.first_losses.append(float(self._step()["loss"]))
            snap = torch.cuda.memory._snapshot()
        finally:
            torch.cuda.memory._record_memory_history(enabled=None)
        return sum(e["action"] == "alloc" and e["size"] >= size
                   for trace_ in snap["device_traces"] for e in trace_)

    def traced(self):
        """``TRACED_STEPS`` more steps under the profiler: each phase's
        device seconds a step, and the anchors of K3, K2, the FFN blocks
        and the held experts (module docstring)."""
        from repro_torch.models.moe import counters
        rec, c, tr = self.ctx.record, self.ctx.config, self.ctx.traffic
        rec["traced_steps"] = plain.TRACED_STEPS
        pairs = counters.pairs
        with trace.traced_window(self.ctx.device) as prof:
            for _ in range(plain.TRACED_STEPS):
                self._step()
        pairs = counters.pairs - pairs
        t = time.perf_counter()
        anchors = {k: n for k, (n, same) in plain.PHASES.items() if same}
        anchors.update(k3=profiled.K3_OP, k2=zamba2.K2_OP, moe=MOE_SPAN,
                       experts=EXPERTS_SPAN)
        summary = trace.summarize(prof, anchors)
        if summary is None:
            return None
        for k, (name, same) in plain.PHASES.items():
            if not same:
                summary.anchors[k] = plain.launched_under(prof, name)
        rec["phase_device_s"] = {k: summary.anchors[k]["device_s"]
                                 / plain.TRACED_STEPS for k in plain.PHASES
                                 if summary.anchors[k]["kernels"]}
        for key, name in (("moe", "moe_device_s"),
                          ("experts", "experts_device_s")):
            a = summary.anchors[key]
            if a["kernels"]:
                rec[name] = a["device_s"] / plain.TRACED_STEPS
        dt = c["compute_dtype"]
        rec["expert_bound_s"] = expert_bound.expert_bound_s(
            pairs / plain.TRACED_STEPS, c["d_model"], c["intermediate_size"],
            dt)
        B, S = int(tr["batch"]), int(tr["seq_len"])
        di = c["expand"] * c["d_model"]
        rec["k3_bound_s"] = flops.k3_bound_s(
            B, S, di // c["head_dim"], c["head_dim"], c["n_groups"],
            c["d_state"], c["chunk_size"], dt)
        heads, _, hd = gg.attention_dims(c)
        rec["k2_bound_s"] = k2_bound.k2_bound_s(B, S, heads, hd, hd, dt)
        self.lines.append(
            f"[trace] read in {time.perf_counter() - t:.2f} s; busy "
            f"{summary.busy_s!r} s of {summary.window_s!r} s; the device "
            f"idle a step inside {MOE_SPAN} "
            f"{idle_inside(prof, MOE_SPAN) / plain.TRACED_STEPS!r} s, "
            f"inside moe.route "
            f"{idle_inside(prof, 'moe.route') / plain.TRACED_STEPS!r} s; "
            f"anchors {summary.anchors}; held pairs a step "
            f"{pairs / plain.TRACED_STEPS!r}, their bound "
            f"{rec['expert_bound_s']!r} s; K3 bound a call "
            f"{rec['k3_bound_s']!r} s, K2 {rec['k2_bound_s']!r} s")
        return summary

    # -- the check -------------------------------------------------------------
    def structure(self) -> Dict[str, Tuple[float, float]]:
        """What a step ran against what the layout asks (module
        docstring): ``{name: (got, want)}``."""
        kinds = gg.layer_kinds(self.ctx.config)
        m, a = kinds.count("mamba"), kinds.count("attention")
        card = self.ctx.device.type == "cuda"
        launches = {f"k2_d{self.hd}": a, "k3": m, "k4_gated": 2 * m,
                    "k5_forward": 3 * m, "k5_backward": 3 * m,
                    "k6_forward": 1, "k6_backward": 1}
        want = {k: n if card else 0 for k, n in launches.items()}
        want["dropped"] = 0
        want["f32_logit_blocks"] = 0
        if "spans" in self.per_step:
            want["spans"] = len(kinds)
        return {k: (self.per_step.get(k, 0.0), w) for k, w in want.items()}

    def check(self) -> List[Check]:
        """The first steps against the plain float32 reference, compared
        as the mamba2 cells compare them (``drivers/train.py::compare``),
        and the step's structure."""
        c = self.ctx.config
        st = self.structure()
        self.free()
        t0 = time.perf_counter()
        batches = profiled.Driver(self.ctx).reference_batches()
        ref = refg.follow(c, c["optimizer"], gg.make_weights(
            c, self.ctx.seed, self.ctx.device), batches)
        nums = profiled.compare(self.first_losses, self.grad1, self.change,
                                ref)
        self.lines.append(
            f"[structure] a step (got, want): {st}; held pairs a step "
            f"{self.per_step.get('pairs')!r}, the largest expert's in a "
            f"layer {self.largest!r}")
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
        gap = sum(abs(g - w) for g, w in st.values())
        return [Check(k, nums[k], float(lim[k])) for k in lim] + [
            Check("structure_gap", gap, 0.0)]


def control_readings(ctx, seconds: float) -> Dict:
    """The numbers the cell compares, read at the cell's own size
    (``perfbench/control.py``; no window is needed, so ``seconds`` goes
    unused): the program's set-up steps, the reference in float8 operands
    (the control) and with each planted fault of
    ``perfbench.reference.granite_moe_hybrid.FAULTS``, each held against
    the float32 reference."""
    drv = Driver(ctx)
    drv.setup()
    structure = drv.structure()
    drv.free()
    c = ctx.config
    batches = profiled.Driver(ctx).reference_batches()
    runs = {}
    for name, prec, fault in ([("reference", "float32", None),
                               ("control_fp8", "fp8", None)]
                              + [(f, "float32", f) for f in refg.FAULTS]):
        t = time.perf_counter()
        runs[name] = refg.follow(c, c["optimizer"], gg.make_weights(
            c, ctx.seed, ctx.device), batches, prec, fault=fault)
        runs[name]["seconds"] = time.perf_counter() - t
    base = runs.pop("reference")
    runs["program"] = {"losses": drv.first_losses, "grad1": drv.grad1,
                       "change": drv.change}
    out = {"reference_s": base["seconds"], "structure": structure}
    for name, r in runs.items():
        nums = profiled.compare(r["losses"], r["grad1"], r["change"], base)
        out[name] = {k: nums[k] for k in ("loss_gap", "grad_gap", "grad_med",
                                          "change_gap", "change_med")}
        out[name]["worst"] = nums["worst"]
    return out
