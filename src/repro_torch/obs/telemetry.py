"""Telemetry facade: one handle bundling the registry + span tracer (the
port of ``repro.obs.telemetry``).

The engine (and anything else holding a telemetry handle) talks to this
object only; ``make_telemetry`` resolves an ``ObsConfig`` to either a live
``Telemetry`` or the shared ``NULL_TELEMETRY``, whose every method is a
no-op and whose ``enabled`` flag is the one attribute the hot loops check.

Conservation contract: every ``PayloadLedger.record`` in the engine is
mirrored by exactly one ``tracer.link_span`` carrying the identical float,
in the same order — ``check_conservation`` asserts the per-link sums are
bit-for-bit equal at engine teardown (measured accounting).
"""
from __future__ import annotations

import sys
import time

from repro_torch.obs.config import ObsConfig
from repro_torch.obs.health import NULL_HEALTH, HealthMonitor
from repro_torch.obs.metrics import (
    NULL_REGISTRY, MetricsRegistry, NullRegistry, set_registry,
)
from repro_torch.obs.spans import SpanTracer, open_span, set_tracer
from repro_torch.obs.torchprof import live_bytes


class Telemetry:
    """Live telemetry: registry + dual-timeline tracer + heartbeat."""

    enabled = True

    def __init__(self, cfg: ObsConfig = ObsConfig()):
        self.cfg = cfg
        self.registry = MetricsRegistry()
        self.tracer = SpanTracer(max_events=cfg.max_trace_events)
        self.host = bool(cfg.host_spans)
        if getattr(cfg, "health", False):
            self.health = HealthMonitor(
                window=getattr(cfg, "health_window", 64),
                registry=self.registry, tracer=self.tracer)
        else:
            self.health = NULL_HEALTH
        # heartbeat state (events/s + live bytes on the card, long runs)
        self._hb_every = int(cfg.heartbeat_events)
        self._events = 0
        self._hb_last = 0
        self._hb_t = time.perf_counter()
        # install as the ambient registry so wireless pricing / sync-step
        # builders (which cannot thread a handle) emit into this run
        set_registry(self.registry)
        # and the tracer as the ambient one of the program's spans
        set_tracer(self.tracer if self.host else None)

    # --- spans ------------------------------------------------------------

    def host_span(self, name: str, track: str = "engine"):
        """Host-clock span around an engine step call; with host spans
        configured off (virtual tracing can stay on alone) only the
        profiler's mark, while it records."""
        return open_span(name, None, self.tracer if self.host else None, track)

    # --- run lifecycle ----------------------------------------------------

    def reset_run(self) -> None:
        self.tracer.reset_run()
        self.health.reset_run()
        self._events = 0
        self._hb_last = 0
        self._hb_t = time.perf_counter()

    def tick(self, n: int = 1) -> None:
        """One engine event processed; drives the events/s heartbeat."""
        self._events += n
        if not self._hb_every or self._events - self._hb_last < self._hb_every:
            return
        now = time.perf_counter()
        dt = max(now - self._hb_t, 1e-9)
        rate = (self._events - self._hb_last) / dt
        self._hb_last, self._hb_t = self._events, now
        lb = live_bytes()
        self.registry.gauge("sim.events_per_s_host").set(rate)
        self.registry.gauge("host.live_bytes").set(lb)
        print(f"[obs] events={self._events} events/s={rate:.1f} "
              f"live_mb={lb / 1e6:.1f}", file=sys.stderr)

    def check_conservation(self, ledger) -> None:
        """Engine-teardown bugcheck: per-link span payload bits must equal
        the ``PayloadLedger`` totals EXACTLY (same floats, same order —
        not approximately). Covers the duplicate-residency and
        repriced-broadcast paths because every record site emits its span
        from the record's own return value."""
        for link, total in ledger.bits.items():
            spanned = self.tracer.link_bits.get(link, 0.0)
            if spanned != total:
                raise AssertionError(
                    f"span/ledger bit conservation violated on link "
                    f"{link!r}: spans sum to {spanned!r} but the ledger "
                    f"recorded {total!r}")

    def export_chrome(self, path: str, metadata=None) -> None:
        self.tracer.export(path, metadata=metadata)


class NullTelemetry:
    """Disabled telemetry: every emit is a no-op, every guard is False.

    One shared instance serves all disabled runs; ``host_span`` returns a
    shared context manager (a profiler mark while ``torch.profiler``
    records) and no method allocates, so the disabled path
    costs one attribute check at the guarded sites and nothing at all in
    memory."""

    enabled = False
    host = False
    cfg = None
    registry: NullRegistry = NULL_REGISTRY
    tracer = None
    health = NULL_HEALTH

    def host_span(self, name: str, track: str = "engine"):
        return open_span(name, None, None, track)

    def reset_run(self) -> None:
        pass

    def tick(self, n: int = 1) -> None:
        pass

    def check_conservation(self, ledger) -> None:
        pass

    def export_chrome(self, path: str, metadata=None) -> None:
        raise RuntimeError("telemetry is disabled; nothing to export")


NULL_TELEMETRY = NullTelemetry()


def make_telemetry(cfg) -> "Telemetry | NullTelemetry":
    """Resolve an ``ObsConfig`` (or None) to a telemetry handle."""
    if cfg is None or not getattr(cfg, "enabled", False):
        return NULL_TELEMETRY
    return Telemetry(cfg)
