"""Driver of the published Zamba2 training cell with EROICA off: the job as
``drivers/train_plain.py`` runs it (the fused step of ``train/step.py``,
each batch put on the card by ``Trainer._batch``, the loss read every
``log_every`` steps), on the configuration's published Zamba2 layout
(``perfbench.gen.zamba2``) and checked against its plain reference
(``perfbench.reference.zamba2``).

Set-up also counts what one step runs, over the ``reference_steps`` steps
it makes: the program's ``hybrid.shared_block`` spans (with its span
record on, where the program has one), K2's launches at the attention's
head dim and K4's gated launches.  The check holds them to the layout, as
``structure_gap`` (limit 0): a span and a K2 launch for each hybrid layer
held, a gated K4 forward and backward for each layer (on the card; the
CPU's plain versions count no launch).  It also puts the layout's model
operations a step (``perfbench/hybrid_flops.py``) in the record, which
``train.hybrid_mfu`` reads over the window's time.

With ``--trace 1`` the traced steps give, besides the phases of
``drivers/train_plain.py``, the device seconds of the kernels launched
inside ``hybrid.shared_block`` (the forward's shared blocks), and K3's and
K2's device time against their least time a call (``perfbench.flops``'s
``k3_bound_s`` at the configuration's N, G and heads, and
``perfbench/k2_bound.py``).  A program without the published layout fails
its set-up at once: its ``ModelConfig`` takes none of the layout's fields.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

from perfbench import flops, hybrid_flops, k2_bound, trace
from perfbench.drivers import train as profiled
from perfbench.drivers import train_plain as plain
from perfbench.gen import zamba2 as gz
from perfbench.harness import Check
from perfbench.reference import zamba2 as refz

K2_OP = "repro_torch::flash_attention_fwd"
SHARED_SPAN = "hybrid.shared_block"


def port_config(c: Dict):
    """The program's ``ModelConfig`` for this configuration."""
    from repro_torch.configs.base import ModelConfig
    heads, kv, hd = gz.attention_dims(c)
    return ModelConfig(
        name=c["name"], family="hybrid", num_layers=c["num_layers"],
        d_model=c["d_model"], vocab_size=c["vocab_size"], norm="rms",
        norm_eps=c["norm_eps"], mlp="geglu",
        gelu_exact=c["hidden_act"] == "gelu", d_ff=c["intermediate_size"],
        tie_embeddings=c["tie_embeddings"], attention="gqa",
        num_heads=heads, num_kv_heads=kv, head_dim=hd,
        attn_scale=(hd / 2) ** -0.5, rope_theta=float(c["rope_theta"]),
        ssm_state=c["d_state"], ssm_head_dim=c["head_dim"],
        ssm_expand=c["expand"], ssm_groups=c["n_groups"],
        ssm_chunk=c["chunk_size"], conv_width=c["d_conv"],
        ssm_grouped_norm=True,
        hybrid_layer_ids=tuple(i for i, k in enumerate(c["layers_block_type"])
                               if k == "hybrid"),
        num_mem_blocks=c["num_mem_blocks"], adapter_rank=c["adapter_rank"],
        dtype=c["compute_dtype"], param_dtype=c["param_dtype"])


def counts() -> Dict[str, int]:
    """The program's launch counters this cell reads: K2's by head dim
    and K4's by variant."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rms_norm import rms_norm
    return {**{f"k2_d{d}": n
               for d, n in flash_attention.launches_by_head_dim.items()},
            "k4_gated": rms_norm.launches_by_variant["gated"]}


class Driver(plain.Driver):
    # -- the program ---------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.data.pipeline import DataConfig
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
        self.params = profiled.nest(gz.make_weights(c, self.ctx.seed, dev))
        got = [(p, tuple(x.shape)) for p, x in param_leaves(self.params)]
        if got != [(p, s) for p, s, _, _ in gz.layout(c)]:
            raise RuntimeError("the parameter tree is not the layout")
        self.opt_state = tr.opt.init(self.params)
        record = plain.span_record()
        before = counts()
        if record is not None:
            record(True)
        steps = int(t["reference_steps"])
        self.first_losses: List[float] = []
        for i in range(steps):
            self.first_losses.append(float(self._step()["loss"]))
            if i == 0:
                b1 = float(o["b1"])
                self.grad1 = {p: float(x.double().norm()) / (1 - b1)
                              for p, x in param_leaves(self.opt_state["m"])}
        spans = record(False) if record is not None else None
        after = counts()
        self.per_step = {k: (after[k] - before.get(k, 0)) / steps
                         for k in after}
        if spans is not None:
            self.per_step["spans"] = sum(s.name == SHARED_SPAN
                                         for s in spans) / steps
        self.hd = cfg.head_dim
        init = gz.make_weights(c, self.ctx.seed, dev)
        self.change = {p: float((x - init[p].float()).double().norm())
                       for p, x in param_leaves(self.opt_state["master"])}
        del init
        self.ctx.record["step_model_flops"] = hybrid_flops.step_flops(
            c, int(t["batch"]), int(t["seq_len"]))
        self._sync()

    def traced(self):
        """``TRACED_STEPS`` more steps under the profiler: each phase's
        device seconds a step, and the anchors of K3, K2 and the shared
        blocks (module docstring)."""
        rec, c, tr = self.ctx.record, self.ctx.config, self.ctx.traffic
        rec["traced_steps"] = plain.TRACED_STEPS
        with trace.traced_window(self.ctx.device) as prof:
            for _ in range(plain.TRACED_STEPS):
                self._step()
        t = time.perf_counter()
        anchors = {k: n for k, (n, same) in plain.PHASES.items() if same}
        anchors.update(k3=profiled.K3_OP, k2=K2_OP, shared=SHARED_SPAN)
        summary = trace.summarize(prof, anchors)
        if summary is None:
            return None
        for k, (name, same) in plain.PHASES.items():
            if not same:
                summary.anchors[k] = plain.launched_under(prof, name)
        rec["phase_device_s"] = {k: summary.anchors[k]["device_s"]
                                 / plain.TRACED_STEPS for k in plain.PHASES
                                 if summary.anchors[k]["kernels"]}
        shared = summary.anchors["shared"]
        if shared["kernels"]:
            rec["shared_block_device_s"] = shared["device_s"] \
                / plain.TRACED_STEPS
        B, S = int(tr["batch"]), int(tr["seq_len"])
        di = c["expand"] * c["d_model"]
        rec["k3_bound_s"] = flops.k3_bound_s(
            B, S, di // c["head_dim"], c["head_dim"], c["n_groups"],
            c["d_state"], c["chunk_size"], c["compute_dtype"])
        heads, _, hd = gz.attention_dims(c)
        rec["k2_bound_s"] = k2_bound.k2_bound_s(B, S, heads, hd, hd,
                                                c["compute_dtype"])
        self.lines.append(
            f"[trace] read in {time.perf_counter() - t:.2f} s; busy "
            f"{summary.busy_s!r} s of {summary.window_s!r} s; anchors "
            f"{summary.anchors}; K3 bound a call {rec['k3_bound_s']!r} s, "
            f"K2 {rec['k2_bound_s']!r} s")
        return summary

    # -- the check -------------------------------------------------------------
    def structure(self) -> Dict[str, Tuple[float, float]]:
        """What a step ran against what the layout asks (module
        docstring): ``{name: (got, want)}``."""
        c = self.ctx.config
        n_h, L = len(gz.hybrid_ids(c)), int(c["num_layers"])
        card = self.ctx.device.type == "cuda"
        want = {f"k2_d{self.hd}": n_h if card else 0,
                "k4_gated": 2 * L if card else 0}
        if "spans" in self.per_step:
            want["spans"] = n_h
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
        ref = refz.follow(c, c["optimizer"], gz.make_weights(
            c, self.ctx.seed, self.ctx.device), batches)
        nums = profiled.compare(self.first_losses, self.grad1, self.change,
                                ref)
        self.lines.append(
            f"[structure] a step (got, want): {st}")
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
    ``perfbench.reference.zamba2.FAULTS``, each held against the float32
    reference."""
    drv = Driver(ctx)
    drv.setup()
    structure = drv.structure()
    drv.free()
    c = ctx.config
    batches = profiled.Driver(ctx).reference_batches()
    runs = {}
    for name, prec, fault in ([("reference", "float32", None),
                               ("control_fp8", "fp8", None)]
                              + [(f, "float32", f) for f in refz.FAULTS]):
        t = time.perf_counter()
        runs[name] = refz.follow(c, c["optimizer"], gz.make_weights(
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
