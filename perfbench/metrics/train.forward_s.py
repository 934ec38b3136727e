"""train.forward_s: the program's span train.forward (the forward,
model.loss in train/step.py::_grad_fn: its enqueue and any wait inside
it), mean a step of the measured window; the span record is on in the
window of a --trace 1 run."""

from perfbench.harness import span_mean


def read(rec):
    return span_mean(rec, "train.forward")
