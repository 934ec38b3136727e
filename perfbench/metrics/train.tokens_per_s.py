"""train.tokens_per_s: every token trained in the measured window over
the window's time, window closes included (host clock; each step ends on
the fenced optimizer update).  The job's rate, read per layer: the host's
pace moves it too widely for a bound (PERF.md)."""


def read(rec):
    return rec["tokens"] / rec["window_s"] if rec.get("count") else None
