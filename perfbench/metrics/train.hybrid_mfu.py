"""train.hybrid_mfu: the published Zamba2 layout's model operations a
step (perfbench/hybrid_flops.py: every matrix a token passes through, a
shared block once for each application, the attention and SSD cores, the
backward twice the forward) times the steps of the measured window, over
the window's time (host clock, as train.tokens_per_s), as a share of the
bf16 peak of one H100, in percent."""

from perfbench import flops


def read(rec):
    f = rec.get("step_model_flops")
    if not f or not rec.get("count"):
        return None
    return 100.0 * f * rec["count"] / rec["window_s"] / flops.H100_BF16_FLOPS
