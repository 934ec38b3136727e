"""train.dataloader_s: the tracer's dataloader.next span (the batch and
its copy to the card), mean per step of the window's closed windows."""

from perfbench.harness import span_mean


def read(rec):
    return span_mean(rec, "dataloader.next")
