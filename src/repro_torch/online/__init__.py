"""Online incident pipeline (DESIGN.md §7, §9): continuous detection,
cross-window EMA aggregation, incident lifecycles with a closed
act->verify->escalate mitigation loop, and differential escalation over
the fleet-batched diagnosis path (kernel K1 on the card)."""
from repro_torch.online.catalog import (FAULT_CLASSES, SCENARIOS,
                                        ExpectedIncident, Scenario, evaluate,
                                        run_scenario)
from repro_torch.online.ema import EmaPatternAggregator
from repro_torch.online.escalation import EscalationPolicy
from repro_torch.online.incident import (CONFIRMED, ESCALATED, MITIGATING,
                                         OPEN, RESOLVED, STATES, VERIFYING,
                                         Incident, IncidentManager)
from repro_torch.online.mitigation import (DEFAULT_CURES, AppliedMitigation,
                                           MitigationEngine)
from repro_torch.online.pipeline import OnlinePipeline, WindowReport
from repro_torch.online.scenario import (ScenarioResult, ScenarioRunner,
                                         ScheduledFault, default_detector_cfg)
from repro_torch.online.workload import (SimWorkload, WindowData,
                                         WorkloadSource,
                                         merge_anchor_durations,
                                         synth_anchor_events)

__all__ = [
    "FAULT_CLASSES", "SCENARIOS", "ExpectedIncident", "Scenario",
    "evaluate", "run_scenario",
    "EmaPatternAggregator", "EscalationPolicy",
    "OPEN", "CONFIRMED", "MITIGATING", "VERIFYING", "RESOLVED",
    "ESCALATED", "STATES",
    "Incident", "IncidentManager",
    "DEFAULT_CURES", "AppliedMitigation", "MitigationEngine",
    "OnlinePipeline", "WindowReport",
    "ScenarioResult", "ScenarioRunner", "ScheduledFault",
    "default_detector_cfg",
    "WorkloadSource", "SimWorkload", "WindowData",
    "merge_anchor_durations", "synth_anchor_events",
]
