"""train.backward_s: the program's span train.backward (the backward,
torch.autograd.grad in train/step.py::_grad_fn), mean a step of the
measured window; the span record is on in the window of a --trace 1 run."""

from perfbench.harness import span_mean


def read(rec):
    return span_mean(rec, "train.backward")
