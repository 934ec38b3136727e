"""train.idle_share: the share of the untraced window's time in which the
card would be idle, in percent: the device's busy seconds in the traced
steps (profiler) against as many steps of the measured window, which no
profiler slows (its seconds over its steps, window closes included)."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or tr.busy_s <= 0 or not rec.get("count"):
        return None
    steps_s = rec["traced_steps"] * rec["window_s"] / rec["count"]
    return 100.0 * (1.0 - tr.busy_s / steps_s)
