"""train.k2_roofline: K2's least time a call (perfbench/k2_bound.py: 2 (D +
Dv) FLOPs per unmasked causal pair and head, D the heads' real width, at
the bf16 peak) times the calls of the custom op
repro_torch::flash_attention_fwd in two traced steps, over the profiler's
device time of the kernels launched under those calls, in percent."""


def read(rec):
    tr = rec.get("trace")
    k2 = tr.anchors.get("k2") if tr is not None else None
    if not k2 or not k2["kernels"] or k2["device_s"] <= 0:
        return None
    return 100.0 * k2["ranges"] * rec["k2_bound_s"] / k2["device_s"]
