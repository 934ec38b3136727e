"""train_memory_peak_gb: the most device memory the job held allocated at
once during the measured window (``torch.cuda.max_memory_allocated``,
reset as the window opens), in GB of 1e9 bytes; None off the card."""


def read(rec):
    v = rec.get("window_memory_peak_bytes")
    return v / 1e9 if v else None
