"""train.shared_block_device_s: the device seconds a traced step of the
kernels and fills (copies left out) launched under the program's span
hybrid.shared_block (each application of a published Zamba2 shared block
in the forward: its norms, attention with K2 and MLP), launched from the
span's own thread (profiler trace; drivers/train_zamba2_plain.py)."""


def read(rec):
    return rec.get("shared_block_device_s")
