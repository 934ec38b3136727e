"""PerfTracker core — the paper's contribution (see DESIGN.md §1).

Pipeline: detector (§4.1) -> profiling window -> behavior patterns (§4.2,
Algorithm 1) -> differential localization (§4.3) -> report + mitigation.
"""
from repro_torch.core.detector import DetectorConfig, IterationDetector, Trigger  # noqa: F401
from repro_torch.core.events import (FunctionEvent, Kind, SampleStream,  # noqa: F401
                                     WorkerProfile, profile_from_reference)
from repro_torch.core.localizer import Localizer  # noqa: F401
from repro_torch.core.patterns import Pattern, critical_duration, summarize_worker  # noqa: F401


def __getattr__(name):
    # the service imports ``repro_torch.summarize``, whose packing imports
    # ``repro_torch.core.events``: importing it here, eagerly, would make
    # ``import repro_torch.summarize`` in a fresh interpreter a cycle
    if name == "PerfTrackerService":
        from repro_torch.core.service import PerfTrackerService
        return PerfTrackerService
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
