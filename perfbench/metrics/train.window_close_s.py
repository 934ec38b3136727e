"""train.window_close_s: the benchmark's own span around closing the
tracer's window (Tracer.stop_window, which packs the profile) and
summarize_and_upload (K1), mean per window closed in the window."""

from perfbench.harness import span_mean


def read(rec):
    return span_mean(rec, "window_close")
