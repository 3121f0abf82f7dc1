"""Streaming windows + declarative anomaly rules for learning health (the
port of ``repro.obs.health.rules``).

A ``Window`` is a fixed-length deque of float observations with
deterministic order statistics (``p95`` sorts a copy — no streaming
sketch, so two runs fed the same values report the same quantile). A
``Rule`` names a signal, a window statistic, a comparison and a
threshold; the ``HealthMonitor`` evaluates every rule whose ``signal``
matches each new observation and fires a structured anomaly on breach
*entry* (latched until the signal recovers, so a sustained breach emits
one event, not one per step).

``DEFAULT_RULES`` covers six anomaly classes: divergence blowup, residual
runaway, dead/starved cluster, staleness p95 breach, loss spike,
payload-bits outlier. Thresholds are
deliberately conservative — a 4-step CI smoke must not trip them; the
fault-injection scenario (``fault-dead-cluster``) must.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass


class Window:
    """Fixed-length streaming window of float observations."""

    __slots__ = ("_q",)

    def __init__(self, maxlen: int):
        self._q = deque(maxlen=int(maxlen))

    def push(self, v: float) -> None:
        self._q.append(float(v))

    @property
    def count(self) -> int:
        return len(self._q)

    def stat(self, name: str):
        """Named statistic over the window; None when undefined (empty
        window, or ``ratio_to_mean`` with no history / zero mean)."""
        q = self._q
        if not q:
            return None
        if name == "last":
            return q[-1]
        if name == "mean":
            return sum(q) / len(q)
        if name == "max":
            return max(q)
        if name == "p95":
            s = sorted(q)
            return s[max(0, -(-95 * len(s) // 100) - 1)]
        if name == "ratio_to_mean":
            # newest value vs the mean of its predecessors: a spike
            # detector that self-scales to the signal's running level
            if len(q) < 2:
                return None
            prev = list(q)[:-1]
            m = sum(prev) / len(prev)
            return q[-1] / m if m > 0.0 else None
        raise ValueError(f"unknown window statistic {name!r}")


@dataclass(frozen=True)
class Rule:
    """One declarative anomaly rule: fire when ``stat(signal) op
    threshold`` over the streaming window, once at least ``min_samples``
    observations have landed."""

    name: str
    signal: str
    stat: str        # last | mean | max | p95 | ratio_to_mean
    op: str          # ">" or "<"
    threshold: float
    min_samples: int = 1

    def breached(self, value: float) -> bool:
        return value > self.threshold if self.op == ">" else \
            value < self.threshold


DEFAULT_RULES = (
    # consensus drift ||w_n − w̄||/||w̄|| jumping 3x over its own window
    # mean — the "comms optimization silently hurt the model" canary
    Rule("divergence-blowup", "drift", "ratio_to_mean", ">", 3.0,
         min_samples=8),
    # error-feedback residuals (eps/e/e_dl) growing to dwarf the weights:
    # sparsification is no longer being paid back
    Rule("residual-runaway", "resid_ratio", "last", ">", 10.0,
         min_samples=4),
    # a cluster that has not contributed an update for >6 consecutive
    # rounds is dead or starved (deadline/dropout/fault)
    Rule("dead-cluster", "idle_rounds", "last", ">", 6.0, min_samples=1),
    # async staleness p95 past the point where (1+s)^-exp weights the
    # update to noise
    Rule("staleness-breach", "staleness", "p95", ">", 16.0, min_samples=8),
    Rule("loss-spike", "loss", "ratio_to_mean", ">", 2.5, min_samples=8),
    # per-sync payload bits jumping 3x the window mean (codec/accounting
    # regression, or a φ override gone wrong)
    Rule("payload-outlier", "payload_bits", "ratio_to_mean", ">", 3.0,
         min_samples=8),
)
