"""train.moe_device_s: the device seconds a traced step of the kernels and
fills (copies left out) launched under the program's span moe.layer (each
FFN block of a granite-4.0-h layer in the forward: the router, the held
experts' products, the combine and the shared expert), launched from the
span's own thread (profiler trace; drivers/train_granite_plain.py)."""


def read(rec):
    return rec.get("moe_device_s")
