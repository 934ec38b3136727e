"""Backend-pluggable batched summarization (DESIGN.md §3-4).

    pack_profile / pack_fleet -> SummarizeBackend -> summarize_profile /
        summarize_fleet -> PatternAggregator -> Localizer

Backends: ``python`` (oracle loop), ``numpy`` (vectorized feasibility
passes), ``torch`` (plain torch version of kernel K1), ``cuda`` (K1).  Select
per call, per service, or via the ``REPRO_TORCH_SUMMARIZE_BACKEND`` env var.
"""
from repro_torch.summarize.base import (ENV_BACKEND, SummarizeBackend,  # noqa: F401
                                        default_backend, get_backend,
                                        register_backend)
from repro_torch.summarize import backends as _backends  # noqa: F401 (registers)
from repro_torch.summarize.packing import (PackedEvents, pack_profile,  # noqa: F401
                                           resolve_kinds)
from repro_torch.summarize.engine import summarize_profile  # noqa: F401
from repro_torch.summarize.aggregate import PatternAggregator  # noqa: F401
from repro_torch.summarize.fleet import (FleetSummary, pack_fleet,  # noqa: F401
                                         summarize_fleet)
