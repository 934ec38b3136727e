"""train.step_s: the tracer's train.step span (forward and backward,
ended by a sync on the gradients), mean per step of the window's closed
windows."""

from perfbench.harness import span_mean


def read(rec):
    return span_mean(rec, "train.step")
