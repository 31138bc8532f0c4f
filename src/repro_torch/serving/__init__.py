"""Online serving runtime around the cluster emulator.

Modules:
  * ``traces``     — trace-driven scenario engine (diurnal, MMPP bursts,
                     flash crowds, heavy-tailed Azure-like arrivals, mixes);
  * ``autoscaler`` — pluggable warm-pool / vGPU autoscaler policies
                     (EWMA pre-warm, HAS-GPU-style fine-grained, none);
  * ``gateway``    — admission-control front end (open-loop injection,
                     per-app AFW queues, load shedding of doomed requests);
  * ``telemetry``  — per-stage latency histograms, SLO attainment, cost,
                     utilization, cold-start and shed counters.
"""
from repro_torch.serving.autoscaler import (AUTOSCALERS, AutoscalerPolicy,
                                      EwmaPrewarm, FineGrained, NoPrewarm,
                                      VerticalFineGrained, get_autoscaler)
from repro_torch.serving.gateway import Gateway
from repro_torch.serving.telemetry import LatencyHistogram, Telemetry, format_table
from repro_torch.serving.traces import (SCENARIOS, Arrival, Scenario,
                                  TraceReplayScenario, get_scenario)

__all__ = [
    "AUTOSCALERS", "AutoscalerPolicy", "EwmaPrewarm", "FineGrained",
    "NoPrewarm", "VerticalFineGrained", "get_autoscaler", "Gateway",
    "LatencyHistogram", "Telemetry", "format_table", "SCENARIOS", "Arrival",
    "Scenario", "TraceReplayScenario", "get_scenario",
]
