"""train.expert_gemm_roofline: the held experts' least time in the forward
of two traced steps (perfbench/expert_bound.py: 6 d ff FLOPs for each pair
routed to a held expert, the pairs from the program's counter, at the bf16
peak) over the profiler's device time of the kernels launched under the
program's span moe.experts in those steps (the gather of the routed rows
and the held experts' products), in percent."""


def read(rec):
    s = rec.get("experts_device_s")
    if not s or rec.get("expert_bound_s") is None:
        return None
    return 100.0 * rec["expert_bound_s"] / s
