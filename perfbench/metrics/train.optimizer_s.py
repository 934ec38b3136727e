"""train.optimizer_s: the tracer's optimizer.step span (AdamW, fenced on
the new parameters), mean per step of the window's closed windows."""

from perfbench.harness import span_mean


def read(rec):
    return span_mean(rec, "optimizer.step")
