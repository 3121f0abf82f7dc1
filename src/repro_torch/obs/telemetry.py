"""The disabled half of ``repro.obs.telemetry``: ``NullTelemetry`` and
``make_telemetry``.

The simulator holds a telemetry handle; with telemetry off (the only mode
ported) its ``enabled`` guard is False, so runs are the reference's with
its telemetry off, whose emit sites (spans, metrics, health monitoring,
the Chrome-trace export) the port's engine leaves out. An enabled config
raises: they are ROADMAP Queue 1 item 14.
"""
from __future__ import annotations


class NullTelemetry:
    """Disabled telemetry: the one guard the engine reads is False."""

    enabled = False


NULL_TELEMETRY = NullTelemetry()


def make_telemetry(cfg) -> NullTelemetry:
    """Resolve an observability config (or None) to a telemetry handle."""
    if cfg is None or not getattr(cfg, "enabled", False):
        return NULL_TELEMETRY
    raise NotImplementedError("telemetry (spans, metrics, health) is not "
                              "ported yet: ROADMAP Queue 1 item 14")
