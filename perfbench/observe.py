"""Observers the drivers put around objects of the program: they add a
profiler range and change nothing."""
from __future__ import annotations

from torch.profiler import record_function

#: the host range around each summarize-backend call: K1's device time
K1_RANGE = "perfbench.k1"


class ObservedBackend:
    """A summarize backend (K1 on the card), each call inside ``K1_RANGE``."""

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name
        self.calls = 0

    def batch_stats(self, u):
        self.calls += 1
        with record_function(K1_RANGE):
            return self.inner.batch_stats(u)
