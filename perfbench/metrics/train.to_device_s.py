"""train.to_device_s: the program's span dataloader.to_device (the batch's
copy to the card in train/loop.py::Trainer._batch, with its wait behind
the card's queue: a copy from pageable memory waits for it), mean a step
of the measured window; the span record is on in the window of a --trace
1 run."""

from perfbench.harness import span_mean


def read(rec):
    return span_mean(rec, "dataloader.to_device")
