"""Learning-health observability (the port of ``repro.obs.health``):
per-tier divergence monitors and streaming anomaly detection over the
quantities the paper's "no accuracy loss" claim rests on (consensus drift,
error-feedback residuals, Ω overlap, staleness, participation fairness).

See ``monitor.HealthMonitor`` for the data flow; ``rules.DEFAULT_RULES``
for the anomaly catalogue.
"""
from repro_torch.obs.health.monitor import (
    NULL_HEALTH, HealthMonitor, NullHealthMonitor,
)
from repro_torch.obs.health.rules import DEFAULT_RULES, Rule, Window

__all__ = [
    "NULL_HEALTH", "HealthMonitor", "NullHealthMonitor",
    "DEFAULT_RULES", "Rule", "Window",
]
