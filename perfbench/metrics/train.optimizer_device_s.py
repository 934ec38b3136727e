"""train.optimizer_device_s: the device seconds a traced step of the
kernels and fills (copies left out) launched under the program's span
optimizer.update, launched from the span's own thread (profiler trace;
drivers/train_plain.py)."""


def read(rec):
    return rec.get("phase_device_s", {}).get("optimizer")
