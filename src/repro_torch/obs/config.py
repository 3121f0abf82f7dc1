"""Observability configuration (``ObsConfig``): the port of
``repro.obs.config``.

A plain frozen dataclass (hashable, replace-able) with no package imports,
so it can be embedded in ``configs.base.SimConfig`` — the thread that
carries it from the CLI (``launch/train.py``) through
``scenarios.build_engine`` into the engine — without import cycles.

``obs=None`` / ``enabled=False`` resolve to the shared null telemetry
(``repro_torch.obs.telemetry.NULL_TELEMETRY``): every emit site in the hot
loops is guarded by one attribute check (``obs.enabled``), so a run
without observability pays nothing and replays bit-identically (tracing
only ever *reads* engine state; it never touches the RNG or the virtual
clock).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ObsConfig:
    """Knobs for the telemetry layer (``repro_torch.obs``)."""

    enabled: bool = True
    # Chrome/Perfetto trace-event JSON output path (--trace-viz); None
    # keeps spans in memory only (still available for the conservation
    # check and tests)
    trace_path: Optional[str] = None
    # structured run-log JSONL path (--metrics-out); consumed by
    # launch/train.py's RunLogger, carried here so one config travels
    metrics_path: Optional[str] = None
    # host-clock spans around the engine's step calls (train/sync). On the
    # card the calls return once their kernels are queued, so a span
    # measures dispatch unless the call itself waits for the card (a host
    # copy of a loss or a bit count); on the CPU it measures the work
    host_spans: bool = True
    # emit a live events/s + live-bytes heartbeat every N engine events
    # (gauges in the registry + one stderr line); 0 = off
    heartbeat_events: int = 0
    # count the flops, bytes and launches of the first train step and the
    # first sync step as they run (launch/op_cost; opt-in)
    hlo_cost: bool = False
    # span-event cap: fleet-scale runs keep the trace bounded. Past the
    # cap events are counted (``dropped_events`` in the export metadata)
    # but not stored; per-link bit accumulation continues regardless, so
    # the conservation check stays exact.
    max_trace_events: int = 2_000_000
    # learning-health monitoring (--obs-health): in-sync statistics
    # (consensus drift, residual norms, Ω overlap), streaming anomaly
    # rules, fleet participation-fairness. The statistics only read the
    # sync's buffers — the state stays bit-identical.
    health: bool = False
    # streaming-window length (observations) for the health aggregators;
    # anomaly rules evaluate over this window
    health_window: int = 64
