"""train.backward_device_s: the device seconds a traced step of the kernels
and fills (copies left out) launched under the program's span
train.backward, launched from any thread while the span is open: the
autograd engine launches the backward's kernels from a thread of its own
(profiler trace; drivers/train_plain.py)."""


def read(rec):
    return rec.get("phase_device_s", {}).get("backward")
