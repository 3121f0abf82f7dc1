"""Learning-health monitor: streaming aggregation + anomaly detection
(the port of ``repro.obs.health.monitor``).

The monitor is the host-side half of the health tentpole. The sync step
(``core/hfl.py`` with ``collect_stats=True``, or the simulator's async
per-cluster sync) returns a small dict of values it already holds on the
card — consensus drift per cluster, residual norms, the top-k index sets,
update/weight norms. The monitor ingests those (plus fleet signals the
engine computes array-level: participation, staleness, residency churn)
and fans each observation out three ways:

  * a ``health.*`` gauge in the metrics registry (last value, labelled
    by cluster where applicable),
  * a Chrome/Perfetto counter sample (``ph="C"``) on a ``health:*``
    track of the ``--trace-viz`` export, plotted on the virtual
    timeline,
  * a streaming ``Window`` that the declarative rules evaluate; a breach
    *entry* fires one structured anomaly: a ``health`` JSONL event (when
    a RunLogger is attached), a trace instant, and a
    ``health.anomalies`` counter increment.

Ω overlap between consecutive syncs is counted where the index sets live:
each sync's sets stay on the card as one bit per position (``_SetMarks``,
3.2× smaller than the int32 sets at φ = 0.9), the next sync's sets are
read back from those bits, and one count per cluster comes to the host.
Ω's index sets are distinct positions (a top-k), so the count is the
reference's ``np.intersect1d(prev, cur).size`` and the fraction (count /
k) is exactly its value — without a host sort of millions of indices at
every sync. The scalar statistics come to the host in one copy per sync.

Everything is behind the zero-overhead pattern: ``NULL_HEALTH`` (one
shared instance, ``enabled=False``) serves every run without
``--obs-health``; the engine guards each ingest site with one attribute
check. The monitor only *reads* values the run already produced — it
never touches the RNG, the virtual clock, or model state — so replay
stays bit-identical with monitoring on vs off (tested).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.obs.health.rules import DEFAULT_RULES, Window
from repro_torch.obs.metrics import NULL_REGISTRY


def _host(*xs) -> np.ndarray:
    """Scalars/vectors (tensors on any device, or numpy/python numbers)
    -> one float64 host array, in ONE device-to-host copy when they are
    tensors (the reference's ``np.asarray(x, np.float64)`` of each)."""
    if all(torch.is_tensor(x) for x in xs):
        flat = torch.cat([x.reshape(-1).to(torch.float64) for x in xs])
        return flat.cpu().numpy()
    return np.concatenate([np.asarray(x.cpu() if torch.is_tensor(x) else x,
                                      np.float64).reshape(-1) for x in xs])


class _SetMarks:
    """Ω index sets kept for the next sync's overlap as one bit per
    position (LSB first), row by row: Q/8 bytes a row where the int32 set
    itself takes 4·k (k = Q/10 at φ = 0.9: 3.2× more), on the sets'
    device. A 1-D set is one row; ``shape`` is the sets' own. The
    temporaries are a few k-entry vectors in the sets' own dtype."""

    def __init__(self, sets):
        if not torch.is_tensor(sets):
            sets = torch.as_tensor(np.asarray(sets))
        self.shape = tuple(sets.shape)
        rows = sets.reshape(-1, sets.shape[-1])
        nbytes = (int(rows.max()) + 8) // 8
        self.bits = torch.empty((rows.shape[0], nbytes), dtype=torch.uint8,
                                device=rows.device)
        acc = torch.empty(nbytes, dtype=torch.int32, device=rows.device)
        for out, row in zip(self.bits, rows):
            # a position's bit is 1 << (position & 7) in byte position >> 3;
            # the positions are distinct, so adding the bits is or-ing them
            bit = torch.bitwise_left_shift(torch.ones_like(row), row & 7)
            acc.zero_().index_add_(0, row >> 3, bit.to(torch.int32))
            out.copy_(acc)

    def overlap(self, cur) -> np.ndarray:
        """Per row, how many of ``cur``'s indices are marked in the same row
        -> int64 [rows] on the host, in one copy. Ω's index sets hold
        distinct positions, so this is ``np.intersect1d(prev[n],
        cur[n]).size`` of the marked sets ``prev``."""
        if not torch.is_tensor(cur):
            cur = torch.as_tensor(np.asarray(cur))
        nbytes = self.bits.shape[1]
        counts = []
        for bits, row in zip(self.bits, cur.reshape(-1, cur.shape[-1])):
            byte = bits.index_select(0, (row >> 3).clamp_max(nbytes - 1))
            hit = torch.bitwise_right_shift(byte, (row & 7).to(torch.uint8)) & 1
            counts.append((hit.bool() & (row < 8 * nbytes)).sum())
        return torch.stack(counts).cpu().numpy()


class HealthMonitor:
    """Live monitor: windows + rules + three-way emission."""

    enabled = True

    def __init__(self, window: int = 64, registry=None, tracer=None,
                 rules=DEFAULT_RULES):
        self.window = int(window)
        self.registry = registry if registry is not None else NULL_REGISTRY
        self.tracer = tracer
        self.rules = tuple(rules)
        # attached by launch/train.py when --metrics-out is also on
        self.runlog = None
        self.anomalies: list = []
        self._windows: dict = {}      # (signal, label) -> Window
        self._breached: set = set()   # (rule-name, label) latched breaches
        self._prev_ul_idx: dict = {}  # scope-key -> _SetMarks of Ω indices
        self._prev_dl_idx = None
        self._idle = None             # per-cluster consecutive idle rounds
        self._idle_by: dict = {}      # async variant: cluster -> consec idle

    # --- lifecycle --------------------------------------------------------

    def reset_run(self) -> None:
        self._windows.clear()
        self._breached.clear()
        self._prev_ul_idx.clear()
        self._prev_dl_idx = None
        self._idle = None
        self._idle_by.clear()
        self.anomalies = []

    # --- core observation path --------------------------------------------

    def observe(self, signal: str, value, *, t: float, label: str = "") -> None:
        """One observation: gauge + window + rule evaluation. ``t`` is
        virtual seconds (the anomaly timestamp and counter-track x-axis)."""
        v = float(value)
        if not math.isfinite(v):
            # NaN/inf IS the anomaly — a diverged signal must not be
            # silently dropped from the windows
            self._fire("non-finite", signal, label, "last", v, None, t)
            return
        labels = {"cluster": label} if label else {}
        self.registry.gauge(f"health.{signal}").set(v, **labels)
        key = (signal, label)
        w = self._windows.get(key)
        if w is None:
            w = self._windows[key] = Window(self.window)
        w.push(v)
        for rule in self.rules:
            if rule.signal != signal or w.count < rule.min_samples:
                continue
            stat = w.stat(rule.stat)
            if stat is None:
                continue
            rkey = (rule.name, label)
            if rule.breached(stat):
                if rkey not in self._breached:
                    self._breached.add(rkey)
                    self._fire(rule.name, signal, label, rule.stat,
                               stat, rule.threshold, t)
            else:
                self._breached.discard(rkey)

    def _counter(self, name: str, t: float, values: dict) -> None:
        if self.tracer is not None and values:
            self.tracer.counter(f"health.{name}", track=f"health:{name}",
                                t=t, values=values)

    def _fire(self, name, signal, label, stat, value, threshold, t) -> None:
        rec = {"rule": name, "signal": signal, "label": label, "stat": stat,
               "value": float(value),
               "threshold": None if threshold is None else float(threshold),
               "t_virtual_s": float(t)}
        self.anomalies.append(rec)
        labels = {"cluster": label} if label else {}
        self.registry.counter("health.anomalies").inc(rule=name, **labels)
        if self.tracer is not None:
            self.tracer.instant(f"anomaly:{name}", track="health:anomaly",
                                t=t, cat="health", args=rec)
        if self.runlog is not None:
            where = f" [{label}]" if label else ""
            self.runlog.log(
                "health",
                msg=f"[health] ANOMALY {name}{where}: {signal}.{stat}="
                    f"{value:.4g} vs {threshold}",
                **rec)

    # --- sync-step statistics (from core/hfl collect_stats) ---------------

    def ingest_sync_stats(self, stats: dict, *, t: float) -> None:
        """Consume the stats dict a lockstep sync step returned: per-
        cluster drift/eps norms, global e/wref/update norms, Ω index
        sets. The scalars come to the host in one copy, the Ω overlap
        counts in another."""
        drift = _host(stats["drift"])
        N = drift.size
        h = _host(stats["eps_norm"], stats["wref_norm"], stats["e_norm"],
                  stats["update_norm"])
        eps, wref, e, upd_n = h[:N], float(h[N]), float(h[N + 1]), h[N + 2]
        denom = max(wref, 1e-30)
        for n in range(N):
            self.observe("drift", drift[n], t=t, label=f"c{n}")
            self.observe("eps_norm", eps[n], t=t, label=f"c{n}")
        self.observe("e_norm", e, t=t)
        resid = (e + float(eps.max())) / denom if eps.size else e / denom
        self.observe("resid_ratio", resid, t=t)
        upd = float(upd_n) / denom
        self.observe("update_ratio", upd, t=t)
        self._counter("drift", t, {f"c{n}": drift[n] for n in range(N)})
        self._counter("residual", t,
                      {"resid_ratio": resid, "update_ratio": upd})
        ul = stats.get("ul_idx")
        if ul is not None:
            prev = self._prev_ul_idx.get("all")
            if prev is not None and prev.shape == tuple(ul.shape):
                counts = prev.overlap(ul)
                ov = {}
                for n in range(ul.shape[0]):
                    frac = int(counts[n]) / ul.shape[1]
                    self.observe("omega_overlap_ul", frac, t=t, label=f"c{n}")
                    ov[f"c{n}"] = frac
                self._counter("omega_overlap", t, ov)
            self._prev_ul_idx["all"] = _SetMarks(ul)
        dl = stats.get("dl_idx")
        if dl is not None:
            if self._prev_dl_idx is not None and \
                    self._prev_dl_idx.shape == tuple(dl.shape):
                frac = int(self._prev_dl_idx.overlap(dl)[0]) / dl.shape[0]
                self.observe("omega_overlap_dl", frac, t=t)
            self._prev_dl_idx = _SetMarks(dl)

    def ingest_async_sync_stats(self, stats: dict, n: int, staleness: int,
                                *, t: float) -> None:
        """Per-cluster variant for the async discipline: scalar stats for
        the one cluster that just synced, plus its staleness."""
        label = f"c{n}"
        keys = ["drift", "eps_norm", "wref_norm", "update_norm"]
        if "e_dl_norm" in stats:
            keys.append("e_dl_norm")
        h = dict(zip(keys, _host(*(stats[k] for k in keys)).tolist()))
        drift = h["drift"]
        epsn = h["eps_norm"]
        denom = max(h["wref_norm"], 1e-30)
        self.observe("drift", drift, t=t, label=label)
        self.observe("eps_norm", epsn, t=t, label=label)
        resid = epsn
        if "e_dl_norm" in h:
            resid += h["e_dl_norm"]
        self.observe("resid_ratio", resid / denom, t=t, label=label)
        self.observe("update_ratio", h["update_norm"] / denom, t=t,
                     label=label)
        self.observe("staleness", float(staleness), t=t, label=label)
        self._counter("drift", t, {label: drift})
        self._counter("staleness", t, {label: float(staleness)})
        ul = stats.get("ul_idx")
        if ul is not None:
            prev = self._prev_ul_idx.get(n)
            if prev is not None and prev.shape == tuple(ul.shape):
                frac = int(prev.overlap(ul)[0]) / ul.shape[0]
                self.observe("omega_overlap_ul", frac, t=t, label=label)
                self._counter("omega_overlap", t, {label: frac})
            self._prev_ul_idx[n] = _SetMarks(ul)

    # --- fleet signals (from sim/engine) ----------------------------------

    def ingest_round(self, participated, *, t: float) -> None:
        """One lockstep/deadline round: boolean participation per cluster
        (array-level; drives the dead/starved-cluster rule)."""
        part = np.asarray(participated, bool)
        if self._idle is None or self._idle.size != part.size:
            self._idle = np.zeros(part.size, np.int64)
        self._idle = np.where(part, 0, self._idle + 1)
        for n in range(part.size):
            self.observe("idle_rounds", float(self._idle[n]), t=t,
                         label=f"c{n}")
        self._counter("participation", t,
                      {f"c{n}": float(part[n]) for n in range(part.size)})

    def ingest_cluster_round(self, n: int, participated: bool, *,
                             t: float) -> None:
        """Async variant of ``ingest_round``: one cluster's round outcome
        at a time (rounds interleave, so there is no per-round [N] mask)."""
        c = 0 if participated else self._idle_by.get(n, 0) + 1
        self._idle_by[n] = c
        self.observe("idle_rounds", float(c), t=t, label=f"c{n}")

    def ingest_loss(self, loss: float, *, t: float) -> None:
        self.observe("loss", loss, t=t)
        self._counter("loss", t, {"loss": float(loss)})

    def ingest_payload(self, bits: float, *, t: float) -> None:
        self.observe("payload_bits", bits, t=t)

    def ingest_churn(self, moved: float, *, t: float) -> None:
        self.observe("residency_churn", moved, t=t)
        self._counter("churn", t, {"moved": float(moved)})

    # --- reporting --------------------------------------------------------

    def summary(self) -> dict:
        """Plain-JSON run summary (the ``health_summary`` JSONL event)."""
        by_rule: dict = {}
        for a in self.anomalies:
            by_rule[a["rule"]] = by_rule.get(a["rule"], 0) + 1
        return {"anomalies": len(self.anomalies),
                "by_rule": dict(sorted(by_rule.items())),
                "signals": sorted({s for s, _ in self._windows})}


class NullHealthMonitor:
    """Disabled monitor: one shared instance, every method a no-op."""

    enabled = False
    runlog = None
    anomalies: list = []

    def reset_run(self) -> None:
        pass

    def observe(self, signal, value, *, t, label="") -> None:
        pass

    def ingest_sync_stats(self, stats, *, t) -> None:
        pass

    def ingest_async_sync_stats(self, stats, n, staleness, *, t) -> None:
        pass

    def ingest_round(self, participated, *, t) -> None:
        pass

    def ingest_cluster_round(self, n, participated, *, t) -> None:
        pass

    def ingest_loss(self, loss, *, t) -> None:
        pass

    def ingest_payload(self, bits, *, t) -> None:
        pass

    def ingest_churn(self, moved, *, t) -> None:
        pass

    def summary(self) -> dict:
        return {}


NULL_HEALTH = NullHealthMonitor()
