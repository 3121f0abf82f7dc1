"""The port's copy of ``repro.sim.events``.

Deterministic virtual-clock event queue.

The simulator's notion of time is *virtual* seconds on the HCN wall clock —
never the host's clock — so a run is a pure function of (scenario, seed).
Determinism guarantees:

  * events at distinct times pop in time order;
  * events at the SAME time pop in insertion (FIFO) order — ties are broken
    by a monotonically increasing sequence number, never by comparing
    payloads (which would make ordering depend on payload contents);
  * ``now`` is monotonically non-decreasing, and pushing an event into the
    past raises immediately rather than silently reordering history.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Optional


@dataclass
class Event:
    """A scheduled occurrence. ``kind`` routes dispatch inside the engine."""

    kind: str
    cluster: int = -1  # owning cluster, -1 = global
    round: int = 0  # per-cluster round index (async) / period index (lockstep)
    data: Optional[dict] = None


class EventQueue:
    """Min-heap of (time, seq, event) with FIFO tie-breaking.

    ``seq`` is the insertion counter: heap entries never compare ``Event``
    payloads, so two events at the same virtual time pop in push order.
    """

    def __init__(self, start: float = 0.0):
        self._heap: list = []
        self._seq = 0
        self.now = float(start)

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, time: float, event: Event) -> None:
        t = float(time)
        if t < self.now:
            raise ValueError(
                f"cannot schedule into the past: t={t} < now={self.now}"
            )
        heapq.heappush(self._heap, (t, self._seq, event))
        self._seq += 1

    def peek_time(self) -> float:
        if not self._heap:
            raise IndexError("peek on empty EventQueue")
        return self._heap[0][0]

    def pop(self):
        """-> (time, event); advances ``now`` to the event's time."""
        if not self._heap:
            raise IndexError("pop on empty EventQueue")
        t, _, ev = heapq.heappop(self._heap)
        assert t >= self.now, "heap invariant violated"
        self.now = t
        return t, ev
