"""train.optimizer_update_s: the program's span optimizer.update
(AdamW.update in optim/adamw.py: the per-leaf update's enqueue), mean a
step of the measured window; the span record is on in the window of a
--trace 1 run."""

from perfbench.harness import span_mean


def read(rec):
    return span_mean(rec, "optimizer.update")
