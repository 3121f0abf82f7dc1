"""The program's own spans in the device trace (``repro_torch.obs.spans``:
``hfl.*``, ``fused.*``, ``faithful.*``, ``wait.*``), read beside the
device's operations.

The port marks its layers with ``torch.profiler.record_function``, so each
span is a host event of ``Trace.host`` on the device trace's clock.  An
operation belongs to a span when its launch (``Trace.launch``) lies inside
the span, on any host thread: the backward launches from autograd's own
thread while the main thread waits in ``grad``.  Idle time is read as
``device_idle.*`` reads it, so that the profiler's own cost a call does
not inflate it: a span's share of the profiled units' idle time, times
the clean window's idle time a unit (a round of the LM cells, an
iteration of the paper engine).

Every reader returns None where the trace holds none of the program's
spans (a program without them) and, for device time, where the trace holds
no device operation (a CPU run).
"""
from __future__ import annotations

import bisect

PREFIXES = ("hfl.", "fused.", "faithful.", "wait.")


def intervals(trace, name: str = None, prefix: str = None):
    """Sorted (start, end) of the host events named ``name`` (or whose name
    starts with ``prefix``), on every thread, in the window."""
    out = []
    for evs in trace.host.values():
        for a, b, n in evs:
            if (n == name if name is not None else n.startswith(prefix)) \
                    and b > trace.t0 and a < trace.t1:
                out.append((a, b))
    return sorted(out)


def count(trace, name: str = None, prefix: str = None) -> int:
    return len(intervals(trace, name, prefix))


def present(trace) -> bool:
    """The trace holds the program's spans."""
    return trace is not None and any(
        n.startswith(PREFIXES) for evs in trace.host.values() for _, _, n in evs)


def _union(ivs):
    out = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covers(merged, t) -> bool:
    i = bisect.bisect_right(merged, [t, float("inf")]) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


def device_s_launched_in(trace, name: str) -> float:
    """Device seconds of the operations launched inside a span ``name``."""
    merged = _union(intervals(trace, name))
    secs = 0.0
    for a, b, _, c in trace.ops:
        where = trace.launch.get(c)
        if where is not None and _covers(merged, where[1]):
            secs += b - a
    return secs


def idle_gaps(trace):
    """The window's idle stretches: [start, end) with no device operation."""
    out, t = [], trace.t0
    for a, b in trace.busy_intervals() + [[trace.t1, trace.t1]]:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    return out


def idle_s_in(trace, name: str) -> float:
    """Idle seconds of the profiled window inside the spans ``name``."""
    merged = _union(intervals(trace, name))
    secs, j = 0.0, 0
    for a, b in idle_gaps(trace):
        while j < len(merged) and merged[j][1] <= a:
            j += 1
        k = j
        while k < len(merged) and merged[k][0] < b:
            secs += max(0.0, min(b, merged[k][1]) - max(a, merged[k][0]))
            k += 1
    return secs


def idle_s_from(trace, prefix: str) -> float:
    """Idle seconds of the gaps that begin inside a span whose name starts
    with ``prefix``: the device ran out of work while the host was there."""
    merged = _union(intervals(trace, prefix=prefix))
    return sum(b - a for a, b in idle_gaps(trace) if _covers(merged, a))


def units(info):
    """(units in the clean window, profiled units): rounds of the LM cells,
    iterations of the paper engine."""
    if "trace_iterations" in info:
        return info["iterations"], info["trace_iterations"]
    return info["rounds"], info["trace_rounds"]


def clean_idle_s(trace, info) -> float:
    """Idle seconds a unit in the clean window: its time a unit less the
    profiled units' busy time a unit."""
    n, traced = units(info)
    return info["window_s"] / n - trace.busy_s / traced


def device_ok(ctx) -> bool:
    """The trace holds the program's spans and device operations."""
    return present(ctx.trace) and ctx.trace.busy_s > 0 and ctx.trace.window_s > ctx.trace.busy_s


def idle_ms_per(ctx, idle_s: float, per: float) -> float:
    """Clean idle ms a unit that ``idle_s`` of the profiled idle time stands
    for (its share of that time, times ``clean_idle_s``), over ``per`` (the
    spans a unit)."""
    t = ctx.trace
    return 1e3 * idle_s / (t.window_s - t.busy_s) * clean_idle_s(t, ctx.info) / per


def per_unit(ctx, name: str) -> float:
    """Spans ``name`` a unit of the profiled ones."""
    return count(ctx.trace, name) / units(ctx.info)[1]



def steps_ok(ctx) -> bool:
    """As ``device_ok``, with the train step's spans to count steps by."""
    return device_ok(ctx) and count(ctx.trace, "hfl.train_step") > 0


def optimizer_ms(ctx):
    """Device ms a train step launched inside ``hfl.train.optimizer``."""
    if not steps_ok(ctx):
        return None
    return 1e3 * device_s_launched_in(ctx.trace, "hfl.train.optimizer") / count(
        ctx.trace, "hfl.train_step")
