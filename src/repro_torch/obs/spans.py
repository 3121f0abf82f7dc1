"""Dual-timeline span tracing with Chrome/Perfetto trace-event export (the
port of ``repro.obs.spans``).

Two clock domains, rendered as two trace "processes":

  * **virtual** (pid 1) — the simulator's event clock. Every simulator
    event (compute, UL, DL, fronthaul, sync, re-association, repricing)
    lands as a complete span (``ph="X"``) whose start/duration the engine
    already knows analytically; 1 virtual second = 1 trace second.
  * **host** (pid 2) — ``time.perf_counter`` around the engine's step
    calls (span start is captured on ``__enter__``), so first-call stalls
    (kernel build, allocator growth) and dispatch cost line up against
    the virtual timeline. On the card a call returns once its kernels are
    queued, so a span measures dispatch unless the call waits.

Tracks ("threads") are named lazily — ``cluster3``, ``link:mu_ul``,
``fronthaul``, ``fleet``, ``engine`` — and emitted as ``thread_name``
metadata events, one track per cluster/link per the trace-viz contract.

Payload-carrying spans go through ``link_span``: besides the span event
(bits in ``args``), the tracer accumulates per-link bit totals **in emit
order** into ``link_bits``. The engine mirrors every ``PayloadLedger``
record with one ``link_span`` carrying the exact recorded float, so the
per-link sums match the ledger bit-for-bit (same addends, same order) —
that is the engine-teardown conservation check, and it survives the JSON
round-trip (``json`` floats round-trip exactly).

Program spans. ``span(name, args)`` marks a layer of the port's own code
(the train step, the flat sync, the paper engine, each blocking
device->host read) at no cost when nothing listens: while
``torch.profiler`` records, it is a ``record_function`` mark, which lands
in the profiler's trace as a ``user_annotation`` event on the device
trace's clock, nested under the span open around it; while a
``Telemetry`` with host spans is installed (``set_tracer``), it is also a
host event of the ambient tracer; otherwise the shared ``NULL_SPAN``.
``SpanTracer.host_span`` (the engine's step calls) is the same span with
its tracer given. ``args`` is the HFL step index (or a dict of event args):
the tracer's event carries it, and ``record_function`` is handed it as
its string argument (torch's Chrome export leaves that out: there a
step's spans are grouped by nesting under the step's own span).
``metadata["host_epoch_ns"]`` of the export is the epoch time of the host
clock's zero, so a host track lays over a profiler trace, whose events
sit at ``ts + baseTimeNanoseconds``.

The export is the plain Chrome trace-event JSON object format —
``{"traceEvents": [...], "metadata": {...}}`` — loadable in
``chrome://tracing`` and Perfetto. ``validate_trace`` checks the schema
(also used by ``tools/trace_summary.py --check`` and the tests).
"""
from __future__ import annotations

import contextlib
import json
import time

import torch

VIRTUAL_PID = 1
HOST_PID = 2
PROCESS_NAMES = {VIRTUAL_PID: "virtual clock (HCN)", HOST_PID: "host clock"}

_REQUIRED_KEYS = ("name", "ph", "pid", "tid", "ts")


class _Span:
    """One live span: a ``torch.profiler`` mark while the profiler records
    and/or a host-clock complete event into ``tracer``."""

    __slots__ = ("name", "args", "tracer", "track", "mark", "t0")

    def __init__(self, name, args, tracer, track, profiling):
        self.name, self.args, self.tracer, self.track = name, args, tracer, track
        self.mark = None
        if profiling:
            self.mark = torch.profiler.record_function(
                name, None if args is None else str(args))

    def __enter__(self):
        # the host clock is read first and last: both clocks then mark the
        # span's ends (the profiler's first mark takes a while to open)
        if self.tracer is not None:
            self.t0 = time.perf_counter()
        if self.mark is not None:
            self.mark.__enter__()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.mark is not None:
            self.mark.__exit__(*exc)
        tr = self.tracer
        if tr is not None:
            t0 = self.t0 - tr.host_t0
            args = self.args
            tr.span(self.name, track=self.track, t0=t0, dur=t1 - tr.host_t0 - t0,
                    pid=HOST_PID, cat="host",
                    args=args if args is None or isinstance(args, dict)
                    else {"step": args})
        return False


class _NullSpan:
    """Shared no-op context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()

# the ambient tracer of program spans: the installed Telemetry's, when it
# records host spans (``Telemetry`` installs it as it installs its registry)
_tracer = None


def current_tracer():
    return _tracer


def set_tracer(tracer) -> None:
    global _tracer
    _tracer = tracer


@contextlib.contextmanager
def use_tracer(tracer):
    """Scoped ``set_tracer`` (tests; nested runs)."""
    global _tracer
    prev, _tracer = _tracer, tracer
    try:
        yield tracer
    finally:
        _tracer = prev


def open_span(name: str, args=None, tracer=None, track: str = "engine"):
    """A span into ``tracer`` (None: none) and, while the profiler records,
    the profiler's trace; ``NULL_SPAN`` when neither listens."""
    profiling = torch.autograd._profiler_enabled()
    if tracer is None and not profiling:
        return NULL_SPAN
    return _Span(name, args, tracer, track, profiling)


def span(name: str, args=None):
    """The program's span of one layer boundary (module docstring): into
    the profiler's trace and the ambient tracer, whichever listens."""
    return open_span(name, args, _tracer)


class SpanTracer:
    """Appends trace events; bounded by ``max_events`` (excess spans are
    counted in ``dropped`` but not stored — per-link bit accumulation in
    ``link_bits`` continues regardless, keeping conservation exact)."""

    def __init__(self, max_events: int = 2_000_000):
        self.max_events = int(max_events)
        self.events: list = []
        self.dropped = 0
        self.link_bits: dict = {}
        self.host_t0 = time.perf_counter()
        self.host_epoch_ns = time.time_ns()  # the epoch time of host_t0
        # (pid, track-name) -> tid; insertion order fixes tid assignment
        self._tids: dict = {}

    # --- tracks ----------------------------------------------------------

    def _tid(self, pid: int, track: str) -> int:
        key = (pid, track)
        tid = self._tids.get(key)
        if tid is None:
            tid = len(self._tids) + 1
            self._tids[key] = tid
        return tid

    # --- emission --------------------------------------------------------

    def span(self, name: str, *, track: str, t0: float, dur: float,
             pid: int = VIRTUAL_PID, cat: str = "sim", args=None) -> None:
        """One complete event; ``t0``/``dur`` in (virtual or host) seconds."""
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        ev = {"name": name, "cat": cat, "ph": "X", "pid": pid,
              "tid": self._tid(pid, track),
              "ts": t0 * 1e6, "dur": dur * 1e6}
        if args is not None:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, *, track: str, t: float,
                pid: int = VIRTUAL_PID, cat: str = "sim", args=None) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t", "pid": pid,
              "tid": self._tid(pid, track), "ts": t * 1e6}
        if args is not None:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, *, track: str, t: float, values: dict,
                pid: int = VIRTUAL_PID, cat: str = "health") -> None:
        """One Chrome counter sample (``ph="C"``): Perfetto renders each
        key of ``values`` as a stacked series on the named track. The
        health monitor emits its divergence/residual/staleness series
        here so they plot against the same virtual timeline as the spans.
        Callers must emit in nondecreasing ``t`` per track (the validator
        enforces the same ordering rule as for spans)."""
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append({"name": name, "cat": cat, "ph": "C", "pid": pid,
                            "tid": self._tid(pid, track), "ts": t * 1e6,
                            "args": {k: float(v) for k, v in values.items()}})

    def link_span(self, link: str, *, t0: float, dur: float, bits: float,
                  name=None, track=None, args=None) -> None:
        """Payload-carrying span: the span's ``args["bits"]`` is the exact
        float the ledger recorded, and ``link_bits[link]`` accumulates it
        in emit order (the conservation-check side of the books)."""
        self.link_bits[link] = self.link_bits.get(link, 0.0) + bits
        a = {"link": link, "bits": bits}
        if args:
            a.update(args)
        self.span(name if name is not None else link,
                  track=track if track is not None else f"link:{link}",
                  t0=t0, dur=dur, cat="comm", args=a)

    def host_span(self, name: str, track: str = "engine"):
        """Host-clock span context manager (the engine's step calls); also
        a profiler mark while the profiler records."""
        return open_span(name, None, self, track)

    def reset_run(self) -> None:
        """Fresh per-run accumulators (the ledger is also rebuilt per
        run); stored events persist so a multi-run trace stays viewable."""
        self.link_bits = {}

    # --- export ----------------------------------------------------------

    def to_chrome(self, metadata=None) -> dict:
        """Chrome trace-event JSON object (``chrome://tracing``-loadable)."""
        events = []
        for pid, pname in PROCESS_NAMES.items():
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "tid": 0, "args": {"name": pname}})
        for (pid, track), tid in self._tids.items():
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": track}})
            # sort_index keeps track order stable (tid assignment order)
            events.append({"name": "thread_sort_index", "ph": "M",
                           "pid": pid, "tid": tid,
                           "args": {"sort_index": tid}})
        events.extend(self.events)
        meta = {"clock_domains": {str(p): n for p, n in PROCESS_NAMES.items()},
                "dropped_events": self.dropped,
                "link_bits": dict(self.link_bits),
                "host_epoch_ns": self.host_epoch_ns}
        if metadata:
            meta.update(metadata)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "metadata": meta}

    def export(self, path: str, metadata=None) -> None:
        with open(path, "w") as f:
            json.dump(to_jsonable(self.to_chrome(metadata)), f)


def to_jsonable(obj):
    """numpy scalars -> python floats/ints (shared with the run logger)."""
    import numpy as np

    if isinstance(obj, dict):
        return {k: to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def validate_trace(obj) -> None:
    """Raise ``ValueError`` unless ``obj`` is a well-formed Chrome
    trace-event JSON object: the container shape, per-event required keys,
    numeric non-negative ``ts``/``dur``, known phases, and per-track
    nondecreasing span starts on the VIRTUAL timeline (the engine emits in
    virtual-time order; host spans are emitted on exit, so nested ones are
    legitimately out of file order)."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("not a trace-event object: missing 'traceEvents'")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    last_ts: dict = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        ph = ev.get("ph")
        if ph == "M":
            continue
        for k in _REQUIRED_KEYS:
            if k not in ev:
                raise ValueError(f"event {i} missing key {k!r}")
        if ph not in ("X", "i", "B", "E", "C"):
            raise ValueError(f"event {i} has unknown phase {ph!r}")
        ts = ev["ts"]
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"event {i} has bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < -1e-9:
                raise ValueError(f"event {i} has bad dur {dur!r}")
        if ev["pid"] == VIRTUAL_PID:
            key = (ev["pid"], ev["tid"])
            if ts + 1e-6 < last_ts.get(key, 0.0):
                raise ValueError(
                    f"event {i} ts went backwards on track {key}: "
                    f"{ts} < {last_ts[key]}")
            last_ts[key] = ts
