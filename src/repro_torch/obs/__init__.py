"""Observability: only the disabled telemetry handle so far
(``telemetry.NullTelemetry``); the rest is ROADMAP Queue 1 item 14."""
from repro_torch.obs.telemetry import NULL_TELEMETRY, NullTelemetry, make_telemetry  # noqa: F401
