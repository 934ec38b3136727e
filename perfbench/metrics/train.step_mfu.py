"""train.step_mfu: 6 N D of one step's tokens (N counted from the
published shapes; no recompute counted; perfbench/flops.py) over the mean
train.step span (forward and backward, ended by a sync on the gradients)
of the window's closed windows, as a share of the bf16 peak of one H100,
in percent."""

from perfbench import flops
from perfbench.harness import span_mean


def read(rec):
    step_s = span_mean(rec, "train.step")
    if not step_s:
        return None
    done = flops.train_flops(rec["n_params"], rec["step_tokens"]) / step_s
    return 100.0 * done / flops.H100_BF16_FLOPS
