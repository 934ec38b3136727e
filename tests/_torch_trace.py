"""Window-by-window traces of an online run, shared by the port's online and
catalog parity tests (``tests/test_torch_{online,catalog}.py``).  Reads the
reference's and the port's objects alike, through attributes both packages
have; imports neither package."""
import numpy as np


def record_ema(runner) -> list:
    """Wrap ``runner.pipeline.window_tick`` so that each tick appends a copy
    of the EMA's ``(W, F, 3)`` matrix and its column names; returns the list
    the copies land in."""
    pipe = runner.pipeline
    snaps = []
    tick = pipe.window_tick

    def traced(*args, **kwargs):
        report = tick(*args, **kwargs)
        mat, names = pipe.ema.matrix()
        snaps.append((mat.copy(), list(names)))
        return report
    pipe.window_tick = traced
    return snaps


def _plans(plans):
    return [(p.action.value, [int(w) for w in p.workers], p.detail)
            for p in plans]


def window_trace(report) -> dict:
    """What one tick decided: diagnoses (function, workers, kind, rule,
    hint, channel), incident transitions, the next escalation set, the
    rates used, the present mask and the executed plans."""
    return {
        "diagnoses": [(d.abnormality.function,
                       np.asarray(d.abnormality.workers).tolist(),
                       int(d.abnormality.kind), d.abnormality.reason,
                       d.hint, d.abnormality.channel)
                      for d in report.diagnoses],
        "changed": [(i.id, i.state, i.function, i.channel,
                     [int(w) for w in i.workers]) for i in report.changed],
        "escalated": [int(w) for w in report.escalated],
        "rates": None if report.rates is None else report.rates.tolist(),
        "present": (None if report.present is None
                    else np.flatnonzero(report.present).tolist()),
        "mitigations": [str(m) for m in report.mitigations],
    }


def incident_trace(inc) -> tuple:
    """An incident's whole life: identity, state, ladder, applied plans,
    escalations, recurrence link and transition log."""
    return (inc.id, inc.state, inc.function, inc.channel,
            [int(w) for w in inc.workers], list(inc.workers_seen),
            inc.escalations, inc.rung, inc.recurrence_of, inc.chronic,
            inc.opened_at, inc.confirmed_at, inc.resolved_at,
            inc.escalated_at, list(inc.history), _plans(inc.plans),
            [(t, p.action.value, [int(w) for w in p.workers])
             for t, p in inc.applied])


def run_trace(runner, result) -> dict:
    """Everything compared between the two packages' runs of one schedule."""
    pipe = runner.pipeline
    engine = runner.engine
    return {
        "windows": [window_trace(r) for r in result.reports],
        "incidents": [incident_trace(i) for i in result.incidents],
        "triggers": [(t.reason, t.time) for t in pipe.detector.triggers],
        "recoveries": [(r.reason, r.time) for r in pipe.detector.recoveries],
        "timeline": result.timeline(),
        "spans": list(result.spans),
        "engine": None if engine is None else [
            (m.window, m.incident_id, m.rung, m.plan.action.value,
             [int(w) for w in m.plan.workers], m.cured, m.remapped,
             m.dropped, m.replacements, m.checkpoint_step, m.restored_step,
             m.lost_steps, m.rollback_verified, m.rollback_failed)
            for m in engine.log],
        "active": (None if runner.sim is None
                   else [int(w) for w in runner.sim.active_workers]),
    }


def assert_same_ema(ref_snaps, port_snaps, atol=None):
    """Per window: the same column names, and EMA matrices bit-equal
    (``atol=None``) or within ``atol``."""
    assert len(ref_snaps) == len(port_snaps)
    for i, ((a, na), (b, nb)) in enumerate(zip(ref_snaps, port_snaps)):
        assert na == nb, i
        assert a.shape == b.shape and a.dtype == b.dtype, i
        if atol is None:
            np.testing.assert_array_equal(a, b, err_msg=f"window {i}")
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                       err_msg=f"window {i}")
