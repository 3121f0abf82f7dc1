"""Observability layer (the port of ``repro.obs``): metrics registry,
dual-timeline span tracing, profiling hooks, structured run logging,
learning-health monitoring.

Public surface (the reference's names):

  * ``ObsConfig`` — frozen config threaded through ``SimConfig`` /
    ``launch/train.py`` (zero overhead when absent/disabled).
  * ``make_telemetry`` / ``Telemetry`` / ``NULL_TELEMETRY`` — the handle
    the engine emits through.
  * ``MetricsRegistry`` + ``current_registry``/``set_registry``/
    ``use_registry`` — named counters/gauges/histograms with labels; the
    ambient registry serves modules that cannot thread a handle
    (wireless pricing, sync-step builders).
  * ``SpanTracer`` / ``validate_trace`` — virtual+host clock spans,
    Chrome/Perfetto trace-event JSON export.
  * ``StepClock`` / ``program_costs`` / ``live_bytes`` — first-step vs
    steady step timing, op flop/byte/launch counts, the card's
    live-memory probe (``torchprof``).
  * ``RunLogger`` — console + JSONL structured run log.
  * ``HealthMonitor`` and its rules — the learning-health monitor.
"""
from repro_torch.obs.config import ObsConfig
from repro_torch.obs.health import (
    DEFAULT_RULES, NULL_HEALTH, HealthMonitor, NullHealthMonitor, Rule,
    Window,
)
from repro_torch.obs.metrics import (
    NULL_REGISTRY, MetricsRegistry, current_registry, set_registry,
    use_registry,
)
from repro_torch.obs.runlog import (
    EVENT_SCHEMAS, SCHEMA_VERSION, RunLogger, validate_event,
    validate_runlog,
)
from repro_torch.obs.spans import (
    HOST_PID, VIRTUAL_PID, SpanTracer, to_jsonable, validate_trace,
)
from repro_torch.obs.telemetry import (
    NULL_TELEMETRY, NullTelemetry, Telemetry, make_telemetry,
)
from repro_torch.obs.torchprof import StepClock, live_bytes, program_costs

__all__ = [
    "ObsConfig", "StepClock", "live_bytes", "program_costs",
    "NULL_REGISTRY", "MetricsRegistry", "current_registry", "set_registry",
    "use_registry", "RunLogger", "HOST_PID", "VIRTUAL_PID", "SpanTracer",
    "to_jsonable", "validate_trace", "NULL_TELEMETRY", "NullTelemetry",
    "Telemetry", "make_telemetry", "DEFAULT_RULES", "NULL_HEALTH",
    "HealthMonitor", "NullHealthMonitor", "Rule", "Window",
    "EVENT_SCHEMAS", "SCHEMA_VERSION", "validate_event", "validate_runlog",
]
