"""train.k3_roofline: K3's least time a call (perfbench/flops.py: the
bytes of x, dt, B, C and y against the operations at the bf16 peak) times
the calls of the custom op repro_torch::ssd_scan_fwd in two traced steps,
over the profiler's device time of the kernels launched under those
calls, in percent."""


def read(rec):
    tr = rec.get("trace")
    k3 = tr.anchors.get("k3") if tr is not None else None
    if not k3 or not k3["kernels"] or k3["device_s"] <= 0:
        return None
    return 100.0 * k3["ranges"] * rec["k3_bound_s"] / k3["device_s"]
