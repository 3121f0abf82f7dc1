"""Structured run logger: console lines + optional JSONL stream (the port
of ``repro.obs.runlog``, the same schema).

``launch/train.py``'s reporting goes through this instead of ad-hoc
``print()``: every event is one console line (same human-readable format
as before) AND, with ``--metrics-out run.jsonl``, one JSON object per line
with the machine-readable fields — so a run's config, per-step losses,
compile/steady timing, simulator summary, health anomalies, and the final
metrics-registry snapshot are all greppable/parseable after the fact.

JSONL schema (versioned): ``{"schema": 1, "event": <kind>,
"t_host_s": <since logger start>, ...}`` with event-specific fields;
numpy scalars are converted on the way out. ``EVENT_SCHEMAS`` names the
required fields per event kind and ``validate_event``/``validate_runlog``
check a stream against them — ``tools/run_compare.py`` re-implements the
same rules stdlib-only so it works without the package installed.
"""
from __future__ import annotations

import json
import time

from repro_torch.obs.spans import to_jsonable

SCHEMA_VERSION = 1

# required event-specific fields per kind (beyond the envelope keys
# ``schema``/``event``/``t_host_s``). Empty tuple = console-only event
# whose JSONL record is just the envelope. Grow this table when a new
# ``log.log(kind, ...)`` call site lands — the paper-fig3 validation
# test walks a real run and fails on any unknown kind.
EVENT_SCHEMAS = {
    "config": ("arch", "clusters", "mus_per_cluster", "period", "sync",
               "steps"),
    "sampling": (),
    "hlo_cost": ("fn",),
    "step": ("step", "loss"),
    "sim_summary": ("discipline", "residency"),
    "sim_measured": (),
    "sim_latency": (),
    "trace_out": ("path",),
    "trace_viz": ("path", "events", "dropped"),
    "timing": ("steps", "compile_s"),
    "eval": ("eval_loss",),
    "checkpoint": ("path",),
    "metrics": ("metrics",),
    # health monitor (--obs-health): one record per fired anomaly, one
    # summary at run end
    "health": ("rule", "signal", "stat", "value", "t_virtual_s"),
    "health_summary": ("anomalies", "by_rule"),
}


def validate_event(rec) -> list:
    """Schema errors for one parsed JSONL record (empty list == valid)."""
    if not isinstance(rec, dict):
        return ["record is not a JSON object"]
    errs = []
    if rec.get("schema") != SCHEMA_VERSION:
        errs.append(f"schema version {rec.get('schema')!r} != "
                    f"{SCHEMA_VERSION}")
    ev = rec.get("event")
    if not isinstance(ev, str):
        errs.append("missing/non-string 'event'")
        return errs
    t = rec.get("t_host_s")
    if not isinstance(t, (int, float)) or isinstance(t, bool) or t < 0:
        errs.append(f"event {ev!r} has bad t_host_s {t!r}")
    required = EVENT_SCHEMAS.get(ev)
    if required is None:
        errs.append(f"unknown event kind {ev!r}")
    else:
        missing = [k for k in required if k not in rec]
        if missing:
            errs.append(f"event {ev!r} missing fields {missing}")
    return errs


def validate_runlog(path) -> list:
    """Validate a ``--metrics-out`` JSONL file; returns per-line errors
    (empty list == every record validates)."""
    errs = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                errs.append(f"line {i}: not JSON: {e}")
                continue
            errs.extend(f"line {i}: {e}" for e in validate_event(rec))
    return errs


class RunLogger:
    """Console + JSONL event logger (``close()`` flushes the stream)."""

    def __init__(self, jsonl_path=None, echo: bool = True):
        self.echo = echo
        self._t0 = time.perf_counter()
        self._f = open(jsonl_path, "w") if jsonl_path else None

    def log(self, event: str, msg=None, **fields) -> None:
        """One event: ``msg`` is the console line (skipped when None),
        ``fields`` are the JSONL payload."""
        if self.echo and msg is not None:
            print(msg, flush=True)
        if self._f is not None:
            rec = {"schema": SCHEMA_VERSION, "event": event,
                   "t_host_s": time.perf_counter() - self._t0}
            rec.update(to_jsonable(fields))
            self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
