"""First-class detector-channel registry (DESIGN.md §13).

PR 8 threaded a second detector channel (``numerics``) through the
incident pipeline as bare strings with scattered
``getattr(x, "channel", "perf")`` defaults — silently coercing typos and
unknown channels to ``perf``.  This module makes channels explicit: the
three known channels are constants, every carrier (``Trigger``,
``Recovery``, ``Abnormality``, ``Incident``, ``ExpectedIncident``)
validates its channel at construction, and consumers resolve an object's
channel through :func:`channel_of`, which RAISES on anything unknown
instead of guessing.

Channels:
  * ``perf``     — anchor-duration degradation (slowdown / blockage);
  * ``numerics`` — loss-spike / grad-explosion / NaN divergence;
  * ``slo``      — serving latency-SLO violations (p99 TTFT / TBT).
"""
from __future__ import annotations

PERF = "perf"
NUMERICS = "numerics"
SLO = "slo"

#: every channel the incident pipeline knows how to route
CHANNELS = (PERF, NUMERICS, SLO)


class UnknownChannelError(ValueError):
    """Raised when a trigger/abnormality/incident names a channel the
    registry does not know — a typo'd channel must fail loudly, not
    silently coerce to ``perf``."""


def validate_channel(name: str) -> str:
    """Return ``name`` if it is a registered channel; raise otherwise."""
    if name not in CHANNELS:
        raise UnknownChannelError(
            f"unknown detector channel {name!r}; registered channels: "
            f"{', '.join(CHANNELS)}")
    return name


def channel_of(obj) -> str:
    """The validated channel of a Trigger/Recovery/Abnormality/Incident.

    Carriers declare ``channel`` as a first-class attribute (no getattr
    default): an object without one is a bug, and an object with an
    unregistered one raises :class:`UnknownChannelError`.
    """
    return validate_channel(obj.channel)
