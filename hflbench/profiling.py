"""Spans and the device trace of a ``--trace 1`` run.

``Spans`` times the harness's calls into the program's layers on the host
clock, with the device synchronized at both ends of each call.  ``Profile``
records a bounded stretch of the window with ``torch.profiler`` (host and
device activity), writes the trace as Chrome JSON under ``TMPDIR``, reads
it back into a ``Trace`` and deletes the file.  A ``Trace`` holds the
device's operations (kernels, copies, fills) inside the marked window, and
the host's events, so the per-layer readers can ask for time by kernel
name, time under a host operation, the busy and idle shares and the
longest idle gaps by what the host was doing.
"""
from __future__ import annotations

import bisect
import gc
import json
import os
import resource
import sys
import tempfile
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

WINDOW = "hflbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def print_round_times(marks, held=()):
    """The window's round times (from successive marks) on stderr; their
    spread is not a metric yet.  ``held``: the device memory allocated after
    each round, whose growth would show something kept from round to round."""
    times = [b - a for a, b in zip(marks, marks[1:])]
    d = sorted(times)
    print(f"rounds {len(d)}: min {d[0]:.4f} s, median {d[len(d) // 2]:.4f} s, max {d[-1]:.4f} s; "
          f"in order: {' '.join(f'{t:.3f}' for t in times)}", file=sys.stderr)
    if any(held):
        print(f"allocated after each round (GB): {' '.join(f'{b / 1e9:.3f}' for b in held)}",
              file=sys.stderr)


def allocated(device) -> int:
    return torch.cuda.memory_allocated(device) if device.type == "cuda" else 0


def print_memory(when: str, device):
    if device.type == "cuda":
        print(f"memory {when}: allocated {torch.cuda.memory_allocated(device) / 1e9:.3f} GB, "
              f"peak since the last reading {torch.cuda.max_memory_allocated(device) / 1e9:.3f} GB",
              file=sys.stderr)


def peak_since_reset(device) -> int:
    """The device's peak allocation since the last call (or the run's
    start), its counter reset for the next stretch."""
    if device.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    return peak


def _steal_s():
    """The machine's CPU steal time so far (s): time its virtual CPUs were
    ready but ran something of the host's; None where /proc/stat is unread."""
    try:
        with open("/proc/stat") as fh:
            fields = fh.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return None


class HostLoad:
    """What the host did while the window ran, on stderr: the Python
    collector's passes and their seconds, the process's CPU seconds and
    context switches (involuntary ones: another thread or process took the
    core), and the machine's steal time.  It tells a run slowed by its own
    host work from one slowed by a busy host."""

    def __enter__(self):
        self.gc_n, self.gc_s, self._t = 0, 0.0, 0.0
        gc.callbacks.append(self._on_gc)
        self.t0, self.ru0, self.steal0 = time.perf_counter(), resource.getrusage(
            resource.RUSAGE_SELF), _steal_s()
        return self

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.gc_n += 1
            self.gc_s += time.perf_counter() - self._t

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on_gc)
        wall = time.perf_counter() - self.t0
        ru, steal = resource.getrusage(resource.RUSAGE_SELF), _steal_s()
        st = f"{steal - self.steal0:.2f} s" if steal is not None and self.steal0 is not None else "unread"
        print(f"host in the window ({wall:.3f} s): gc {self.gc_n} passes {self.gc_s:.4f} s; "
              f"cpu user {ru.ru_utime - self.ru0.ru_utime:.3f} s sys "
              f"{ru.ru_stime - self.ru0.ru_stime:.3f} s; switches voluntary "
              f"{ru.ru_nvcsw - self.ru0.ru_nvcsw} involuntary {ru.ru_nivcsw - self.ru0.ru_nivcsw}; "
              f"machine steal {st}", file=sys.stderr)
        return False


class Spans:
    """Named host-clock durations of calls, the device synchronized at both
    ends (``sync``), each also marked for the profiler."""

    def __init__(self, sync):
        self.sync = sync
        self.seconds = defaultdict(list)

    @contextmanager
    def span(self, name: str):
        self.sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function("hflbench." + name):
            yield
            self.sync()
        self.seconds[name].append(time.perf_counter() - t0)

    def wrap(self, name: str, fn):
        def call(*args, **kw):
            with self.span(name):
                return fn(*args, **kw)
        return call

    def mean_ms(self, name: str):
        s = self.seconds.get(name)
        return 1e3 * sum(s) / len(s) if s else None


class Profile:
    """``with Profile() as prof:`` ... ``prof.trace`` afterwards.  The body
    runs inside one ``hflbench.window`` mark, which bounds the window read."""

    def __init__(self):
        self.trace = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._mark = torch.profiler.record_function(WINDOW)
        self._mark.__enter__()
        return self

    def __exit__(self, *exc):
        self._mark.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                self._prof.export_chrome_trace(path)
                with open(path) as fh:
                    self.trace = Trace(json.load(fh).get("traceEvents", []))
        return False


class Trace:
    """The device and host events of one profiled window (times in s)."""

    def __init__(self, events):
        xs = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
        win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") in HOST_CATS]
        if not win:
            raise ValueError("the profiled trace has no window mark")
        w = win[0]
        self.t0, self.t1 = float(w["ts"]) * 1e-6, (float(w["ts"]) + float(w["dur"])) * 1e-6
        self.window_tid = w.get("tid")
        self.ops = []  # (start, end, name, correlation) on the device, clipped
        for e in xs:
            if e.get("cat") not in DEVICE_CATS:
                continue
            a = float(e["ts"]) * 1e-6
            b = a + float(e["dur"]) * 1e-6
            a, b = max(a, self.t0), min(b, self.t1)
            if b > a:
                self.ops.append((a, b, e["name"], (e.get("args") or {}).get("correlation")))
        self.ops.sort()
        self.host = defaultdict(list)  # tid -> [(start, end, name)]
        self.launch = {}  # correlation -> (tid, time of the launch call)
        for e in xs:
            if e.get("cat") in HOST_CATS:
                a = float(e["ts"]) * 1e-6
                self.host[e.get("tid")].append((a, a + float(e["dur"]) * 1e-6, e["name"]))
                c = (e.get("args") or {}).get("correlation")
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and c is not None:
                    self.launch[c] = (e.get("tid"), a)
        for v in self.host.values():
            v.sort()
        # events longer than a millisecond (spans, steps): few, checked whole
        self.long = {tid: [e for e in v if e[1] - e[0] > 1e-3] for tid, v in self.host.items()}

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self):
        out = []
        for a, b, _, _ in self.ops:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernels(self, needle: str):
        """(seconds, launches) of the device operations whose name holds
        ``needle`` as a whole identifier."""
        secs, n = 0.0, 0
        for a, b, name, _ in self.ops:
            if _holds(name, needle):
                secs += b - a
                n += 1
        return secs, n

    def busy_in(self, mark: str):
        """Device-busy seconds inside each host event named ``mark`` (a span's
        mark: the device was synchronized at both of its ends)."""
        busy = self.busy_intervals()
        out = []
        for a, b, name in self.host.get(self.window_tid, []):
            if name == mark:
                out.append(sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy))
        return out

    def _enclosing(self, tid, t):
        """Names of the host events of thread ``tid`` that cover time t."""
        evs = self.host.get(tid, [])
        i = bisect.bisect_right(evs, (t, float("inf"), ""))
        near = [e for e in evs[max(0, i - 64):i] if e[0] <= t <= e[1]]
        far = [e for e in self.long.get(tid, []) if e[0] <= t <= e[1] and e not in near]
        return [name for _, _, name in sorted(near + far)]

    def under_host_op(self, needle: str) -> float:
        """Device seconds of the operations launched inside a host operation
        whose name holds ``needle``."""
        secs = 0.0
        for a, b, _, c in self.ops:
            where = self.launch.get(c)
            if where and any(needle in n for n in self._enclosing(*where)):
                secs += b - a
        return secs

    def breakdown(self, top: int = 10):
        """{"device_ops": [[name, s]], "idle_gaps": [[host activity, s]]}:
        the device operations that took most time, and the idle time by the
        innermost host event of the window's thread covering each gap."""
        by_op = defaultdict(float)
        for a, b, name, _ in self.ops:
            by_op[name[:120]] += b - a
        gaps = defaultdict(float)
        t = self.t0
        for a, b in self.busy_intervals() + [[self.t1, self.t1]]:
            if a > t:
                names = self._enclosing(self.window_tid, (t + a) / 2)
                inner = [n for n in names if n != WINDOW]
                gaps[inner[-1][:120] if inner else "host outside any marked call"] += a - t
            t = max(t, b)
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_op), "idle_gaps": rank(gaps)}


def _holds(name: str, needle: str) -> bool:
    i = name.find(needle)
    while i >= 0:
        before = name[i - 1] if i > 0 else " "
        j = i + len(needle)
        after = name[j] if j < len(name) else " "
        if not (before.isalnum() or before == "_") and not (after.isalnum() or after == "_"):
            return True
        i = name.find(needle, i + 1)
    return False
