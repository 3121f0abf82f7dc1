"""The observability layer of the port (``repro_torch.obs``, the engine's
emit sites, ``launch.op_cost``) against the reference's ``repro.obs``: the
same inputs through both packages.

Tolerances:
  * exact: registry counters and histograms, the snapshots of registries
    fed the same observations, the virtual-clock trace events (name,
    track, ``ts``, ``dur``, args, link bits), event kinds and counts, the
    run log's records (``t_host_s`` aside), health anomalies, Ω overlaps
    and launch counts, and the state with telemetry on against off
    (bitwise);
  * rtol 1e-4 (f32 model math, as the async parity of
    ``tests/test_torch_sim_async.py``): the values that come from the
    model — the health norms (drift, residual, update, whose sums the port
    accumulates in f64 and the reference in f32) and the losses;
  * not compared: host-clock spans and series (``host.live_bytes``,
    ``sim.events_per_s_host``).

The engine runs use the reference's own observability test model: a
quadratic loss on a 12-parameter vector (``tests/test_obs.py``), 3
clusters x 2 MUs, H = 2, so every discipline runs in about a second.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as J
from repro.configs.base import HFLConfig as JHFL
from repro.configs.base import parse_tiers_spec as j_parse
from repro.core import hfl as jhfl
from repro.obs import metrics as jmetrics
from repro.optim import SGDM as JSGDM
from repro.sim import scenarios as JS
from repro.wireless.latency import LatencyParams as JLP
import repro_torch.obs as T
from repro_torch.configs import HFLConfig as THFL
from repro_torch.configs import parse_tiers_spec as t_parse
from repro_torch.core import hfl as thfl
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs.health.monitor import _SetMarks
from repro_torch.optim import SGDM as TSGDM
from repro_torch.sim import scenarios as TS
from repro_torch.utils.tree import tree_leaves
from repro_torch.wireless.latency import LatencyParams as TLP

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

RTOL = 1e-4
D = 12
# registry series read off the host clock: not compared
HOST_SERIES = ("host.live_bytes", "sim.events_per_s_host")
# gauges and counter tracks whose values come from the model
MODEL_GAUGES = ("health.drift", "health.eps_norm", "health.e_norm",
                "health.resid_ratio", "health.update_ratio", "health.loss")
MODEL_TRACKS = ("health.drift", "health.residual", "health.loss")


@pytest.fixture(autouse=True)
def _ambient_registries():
    """Telemetry() installs its registry as the ambient one in each
    package; restore both defaults after every test."""
    prev = jmetrics.current_registry(), tmetrics.current_registry()
    yield
    jmetrics.set_registry(prev[0])
    tmetrics.set_registry(prev[1])


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------


def _feed(reg, rng, order):
    """A seeded stream of counter/gauge/histogram observations."""
    links = ["ul", "dl", "fh"]
    for i in order:
        reg.counter("bits").inc(float(rng.integers(1, 1 << 20)),
                                link=links[i % 3])
        reg.counter("events").inc()
    reg.gauge("rate").set(float(rng.random()), fn="a")
    reg.gauge("rate").set(2.5, fn="b")
    vals = 10.0 ** rng.uniform(-7, 13, 40)
    vals[[3, 7]] = (np.inf, np.nan)  # non-finite observations are skipped
    reg.histogram("lat").observe(vals, cluster="c0")
    reg.histogram("lat").observe(float(vals[0]), cluster="c1")
    reg.histogram("one").observe(np.full(5, 0.25))
    return reg.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshots_equal_the_reference(seed):
    order = np.random.default_rng(seed).permutation(30)
    j = _feed(J.MetricsRegistry(), np.random.default_rng(seed), order)
    t = _feed(T.MetricsRegistry(), np.random.default_rng(seed), order)
    assert t == j  # float for float, key for key
    h = t["lat"]["series"]["cluster=c0"]
    assert h["count"] == 38 and h["p50"] <= h["p95"] <= h["p99"] <= h["max"]
    assert t["one"]["series"][""]["p99"] == 0.25  # exact on one value
    assert json.loads(json.dumps(t)) == t


def test_format_metrics_equals_the_reference():
    from repro.utils.format import format_metrics as jfmt
    from repro_torch.utils.format import format_metrics as tfmt

    m = {"scenario": "scale-1m", "mus": 1050000, "t_s": 27.797267718748042,
         "ratio": 1e-7, "ok": True}
    for skip in ((), ("scenario",), ("t_s", "ok")):
        assert tfmt(m, skip=skip) == jfmt(m, skip=skip)


def test_registry_kinds_null_and_ambient_scoping():
    for pkg in (J, T):
        reg = pkg.MetricsRegistry()
        reg.counter("x")
        with pytest.raises(TypeError, match="counter"):
            reg.gauge("x")
        assert pkg.NULL_REGISTRY.counter("a") is pkg.NULL_REGISTRY.gauge("b")
        assert pkg.NULL_REGISTRY.snapshot() == {}
    assert T.current_registry() is T.NULL_REGISTRY
    reg = T.MetricsRegistry()
    with T.use_registry(reg):
        assert T.current_registry() is reg
    assert T.current_registry() is T.NULL_REGISTRY
    assert T.make_telemetry(None) is T.NULL_TELEMETRY
    assert T.make_telemetry(T.ObsConfig(enabled=False)) is T.NULL_TELEMETRY
    tele = T.make_telemetry(T.ObsConfig())
    assert T.current_registry() is tele.registry  # installed as ambient


def test_build_and_pricing_counters_equal_the_reference():
    """The ambient-registry emitters: ``core.hfl._count_build`` at each
    step builder and ``wireless.latency._emit_pricing`` at each pricing."""
    from repro.wireless import latency as jlat
    from repro_torch.wireless import latency as tlat

    jr, tr = J.MetricsRegistry(), T.MetricsRegistry()
    with J.use_registry(jr), T.use_registry(tr):
        for spec, impl in (("3x2:H=2", "topk"), ("2x2:H=2", "fused"),
                           ("2x2x2:H=2,2", "hist")):
            jh = JHFL(tiers=j_parse(spec), omega_impl=impl)
            th = THFL(tiers=t_parse(spec), omega_impl=impl)
            jhfl.make_sync(jhfl.SyncPlan.from_config(jh))
            thfl.make_sync(thfl.SyncPlan(th))
        for pkg, lat in ((jhfl, jlat), (thfl, tlat)):
            pkg.make_cluster_train_step(None, None, None)
            pkg.make_masked_cluster_train_step(None, None, None)
            lat._emit_pricing("hfl_latency", 3.5e8, 0.25, 0.125,
                              np.array([0.1, 0.2, np.inf]))
    assert tr.snapshot() == jr.snapshot()
    assert "layout=hier" in ",".join(tr.snapshot()["hfl.sync_step_builds"]["series"])


# ---------------------------------------------------------------------------
# Spans and the Chrome trace
# ---------------------------------------------------------------------------


def _drive_tracer(tr):
    tr.span("round", track="cluster0", t0=0.0, dur=2.0, args={"round": 0})
    tr.span("iter", track="cluster0", t0=0.0, dur=1.0)  # nested, same t0
    with tr.host_span("train_step"):
        with tr.host_span("inner"):
            pass
    tr.link_span("mu_ul", t0=0.0, dur=1.0, bits=8.5, name="train_ul",
                 args={"participants": 3})
    tr.link_span("mu_ul", t0=1.0, dur=1.0, bits=0.25, track="cluster1")
    tr.instant("reprice", track="fleet", t=1.5, args={"dt_s": 0.5})
    tr.counter("health.drift", track="health:drift", t=2.0,
               values={"c0": np.float32(0.5), "c1": 1})
    return tr.to_chrome(metadata={"engine_meta": {"x": 1}})


def test_span_nesting_and_export_equal_the_reference():
    j, t = _drive_tracer(J.SpanTracer()), _drive_tracer(T.SpanTracer())
    J.validate_trace(j)
    T.validate_trace(t)
    host = lambda o: [(e["name"], e["pid"], e["tid"]) for e in o["traceEvents"]
                      if e.get("pid") == T.HOST_PID and e.get("ph") == "X"]
    assert host(t) == host(j) == [("inner", 2, 2), ("train_step", 2, 2)]
    strip = lambda o: [e for e in o["traceEvents"] if e["pid"] != T.HOST_PID
                       or e.get("ph") == "M"]
    assert strip(t) == strip(j)  # virtual events and track metadata
    # the port's export also gives its host clock's epoch time
    assert isinstance(t["metadata"].pop("host_epoch_ns"), int)
    assert t["metadata"] == j["metadata"]
    inner, outer = [e for e in t["traceEvents"]
                    if e.get("pid") == T.HOST_PID and e.get("ph") == "X"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3


def _bad_traces():
    tr = T.SpanTracer()
    tr.span("b", track="x", t0=5.0, dur=1.0)
    tr.span("a", track="x", t0=1.0, dur=1.0)  # virtual time ran backwards
    ok = {"name": "n", "ph": "X", "pid": 1, "tid": 1, "ts": 0.0, "dur": 1.0}
    return [{"events": []}, {"traceEvents": {}}, {"traceEvents": [3]},
            tr.to_chrome(), {"traceEvents": [{"ph": "X", "name": "n"}]},
            {"traceEvents": [dict(ok, ph="Q")]},
            {"traceEvents": [dict(ok, ts=-1.0)]},
            {"traceEvents": [dict(ok, dur="x")]}]


@pytest.mark.parametrize("i", range(8))
def test_validate_trace_rejects_what_the_reference_rejects(i):
    bad = _bad_traces()[i]
    with pytest.raises(ValueError) as jerr:
        J.validate_trace(bad)
    with pytest.raises(ValueError) as terr:
        T.validate_trace(bad)
    assert str(terr.value) == str(jerr.value)


def test_event_cap_drops_spans_but_conserves_bits():
    out = []
    for pkg in (J, T):
        tr = pkg.SpanTracer(max_events=2)
        tr.link_span("ul", t0=0.0, dur=1.0, bits=8.0)
        tr.instant("x", track="fleet", t=0.5)
        tr.link_span("ul", t0=1.0, dur=1.0, bits=16.0)  # past the cap
        tr.counter("c", track="h", t=2.0, values={"a": 1.0})
        assert len(tr.events) == 2 and tr.dropped == 2
        assert tr.link_bits["ul"] == 24.0  # accumulation never stops
        out.append(tr.to_chrome()["metadata"])
    out[1].pop("host_epoch_ns")  # the port's alone
    assert out[0] == out[1]


def test_telemetry_conservation_check_raises_on_mismatch():
    tele = T.Telemetry(T.ObsConfig())
    tele.tracer.link_span("mu_ul", t0=0.0, dur=1.0, bits=8.0)

    class Ledger:
        bits = {"mu_ul": 16.0}

    with pytest.raises(AssertionError, match="conservation"):
        tele.check_conservation(Ledger())
    Ledger.bits = {"mu_ul": 8.0}
    tele.check_conservation(Ledger())


# ---------------------------------------------------------------------------
# Run log
# ---------------------------------------------------------------------------


def _log_stream(pkg, path):
    log = pkg.RunLogger(str(path), echo=False)
    log.log("config", "[train] x", arch="a", clusters=3, mus_per_cluster=2,
            period=2, sync="sparse", steps=4, extra=np.float32(0.5))
    log.log("step", None, step=1, loss=np.float64(6.25))
    log.log("timing", "t", steps=4, compile_s=1.5, steady_s_per_step=None)
    log.log("metrics", None, metrics={"a": {"kind": "counter",
                                            "series": {"": 2.0}}})
    log.close()
    return [json.loads(l) for l in path.read_text().splitlines()]


def test_run_logger_jsonl_and_validation_equal_the_reference(tmp_path, capsys):
    j = _log_stream(J, tmp_path / "j.jsonl")
    t = _log_stream(T, tmp_path / "t.jsonl")
    for rec in j + t:
        assert rec.pop("t_host_s") >= 0
    assert t == j
    assert T.EVENT_SCHEMAS == J.EVENT_SCHEMAS
    assert T.SCHEMA_VERSION == J.SCHEMA_VERSION
    assert T.validate_runlog(tmp_path / "t.jsonl") == []
    # a tampered stream: a missing field, an unknown kind, a bad envelope
    lines = (tmp_path / "t.jsonl").read_text().splitlines()
    bad = json.loads(lines[0])
    del bad["arch"]
    lines[0] = json.dumps(bad)
    lines.insert(1, json.dumps({"schema": 1, "event": "nope", "t_host_s": 0}))
    lines.insert(2, json.dumps({"schema": 2, "event": "eval", "t_host_s": -1}))
    lines.insert(3, "{not json")
    (tmp_path / "bad.jsonl").write_text("\n".join(lines) + "\n")
    terr = T.validate_runlog(tmp_path / "bad.jsonl")
    assert len(terr) == 6
    assert [e.split(":")[0] for e in terr] == \
        [e.split(":")[0] for e in J.validate_runlog(tmp_path / "bad.jsonl")]
    for rec in ([1], {"schema": 1}, {"schema": 1, "event": "x", "t_host_s": True}):
        assert T.validate_event(rec) == J.validate_event(rec)
    log = T.RunLogger(None)
    log.log("eval", "[train] printed", eval_loss=1.0)
    assert capsys.readouterr().out == "[train] printed\n"


# ---------------------------------------------------------------------------
# Health: windows, rules, monitor
# ---------------------------------------------------------------------------


def test_windows_and_rules_equal_the_reference():
    from repro.obs.health.rules import DEFAULT_RULES as JR
    from repro.obs.health.rules import Window as JW
    from repro_torch.obs.health.rules import DEFAULT_RULES as TR
    from repro_torch.obs.health.rules import Window as TW

    assert TR == tuple(T.Rule(**r.__dict__) for r in JR)
    rng = np.random.default_rng(4)
    jw, tw = JW(7), TW(7)
    for v in rng.lognormal(size=30):
        jw.push(v)
        tw.push(v)
        for stat in ("last", "mean", "max", "p95", "ratio_to_mean"):
            assert tw.stat(stat) == jw.stat(stat)
    assert TW(3).stat("mean") is None
    with pytest.raises(ValueError):
        tw.stat("median")
    for rj, rt in zip(JR, TR):
        for v in (0.0, rj.threshold, rj.threshold * 2):
            assert rt.breached(v) == rj.breached(v)


def _health_stream(mon, idx, *, t0=0.0):
    """A seeded stream through every ingest path of a monitor: losses with
    a spike, lockstep sync stats with drifting Ω index sets, async stats,
    rounds with a cluster that stops, churn, payloads, a NaN."""
    rng = np.random.default_rng(7)
    N, Q, k = 3, 500, 40
    for r in range(12):
        t = t0 + r
        mon.ingest_loss(2.0 if r != 10 else 9.0, t=t)
        ul = np.stack([np.sort(rng.choice(Q, k, replace=False))
                       for _ in range(N)])
        dl = np.sort(rng.choice(Q, k, replace=False))
        stats = {"drift": rng.random(N).astype(np.float32) * (1 + 5 * (r == 11)),
                 "eps_norm": rng.random(N).astype(np.float32),
                 "e_norm": np.float32(rng.random()),
                 "wref_norm": np.float32(2.0), "update_norm": np.float32(0.5),
                 "ul_idx": idx(ul), "dl_idx": idx(dl)}
        if r % 2:  # a third of the sets repeat: overlaps well above chance
            stats["ul_idx"] = stats_prev["ul_idx"]
        mon.ingest_sync_stats(stats, t=t)
        stats_prev = stats
        mon.ingest_round(np.array([True, r < 3, True]), t=t)
        n = r % N
        a = {"drift": np.float32(rng.random()), "eps_norm": np.float32(1.0),
             "wref_norm": np.float32(2.0), "update_norm": np.float32(0.25),
             "e_dl_norm": np.float32(0.125),
             "ul_idx": idx(np.sort(rng.choice(Q, k, replace=False)))}
        mon.ingest_async_sync_stats(a, n, staleness=r % 4, t=t)
        mon.ingest_cluster_round(n, r < 6 or n != 1, t=t)
        mon.ingest_payload(1e6 * (1 + 4 * (r == 9)), t=t)
        mon.ingest_churn(float(r % 3), t=t)
    mon.observe("drift", float("nan"), t=t0 + 12, label="c0")
    return mon


def test_health_monitor_equals_the_reference_on_the_same_streams():
    jr, tr = J.MetricsRegistry(), T.MetricsRegistry()
    jt, tt = J.SpanTracer(), T.SpanTracer()
    jm = _health_stream(J.HealthMonitor(window=8, registry=jr, tracer=jt),
                        lambda a: a)
    tm = _health_stream(T.HealthMonitor(window=8, registry=tr, tracer=tt),
                        torch.from_numpy)  # the index sets as tensors
    assert repr(tm.anomalies) == repr(jm.anomalies)  # NaN values included
    assert {a["rule"] for a in tm.anomalies} >= {
        "dead-cluster", "loss-spike", "payload-outlier", "non-finite"}
    assert tm.summary() == jm.summary()
    assert tr.snapshot() == jr.snapshot()
    t_chrome = tt.to_chrome()
    t_chrome["metadata"].pop("host_epoch_ns")  # the port's alone
    assert json.dumps(t_chrome) == json.dumps(jt.to_chrome())  # NaN too
    ov = tr.snapshot()["health.omega_overlap_ul"]["series"]
    assert ov and any(v == 1.0 for v in ov.values())
    tm.reset_run()
    assert tm.anomalies == [] and tm.summary()["signals"] == []
    assert T.NULL_HEALTH.summary() == {} and not T.NULL_HEALTH.enabled


def test_set_marks_overlap_is_intersect1d():
    rng = np.random.default_rng(3)
    prev = np.stack([rng.choice(10_000, 300, replace=False) for _ in range(4)])
    cur = np.stack([np.concatenate([p[:k], rng.choice(
        np.setdiff1d(np.arange(10_000), p), 300 - k, replace=False)])
        for p, k in zip(prev, (0, 1, 150, 300))])
    marks = _SetMarks(torch.from_numpy(prev))
    assert marks.shape == (4, 300) and marks.bits.dtype == torch.uint8
    got = marks.overlap(torch.from_numpy(cur))
    want = [np.intersect1d(p, c).size for p, c in zip(prev, cur)]
    assert got.tolist() == want == [0, 1, 150, 300]
    assert _SetMarks(prev[2]).overlap(cur[2]).tolist() == [150]  # numpy, 1-D
    # positions past the marked span are not in the set
    assert _SetMarks(np.array([0, 7])).overlap(np.array([7, 8, 9000])).tolist() == [1]


# ---------------------------------------------------------------------------
# Engine runs with telemetry on: both packages
# ---------------------------------------------------------------------------


def _run_both(name, *, obs, collect, accounting="analytic", steps=4,
              spec="3x2:H=2", codec="bitmap", async_root=False):
    """Both packages' engines for scenario ``name`` with the telemetry of
    ``obs`` (an ``ObsConfig`` kwargs dict; None = off), on the quadratic
    model from the same zero init and the same seeded batches -> ((engine,
    state, trace) reference, (engine, state, trace) port). ``collect``:
    the lockstep sync returns its health statistics; ``async_root``: the
    root tier runs clock-free (the unit scheduler)."""
    out = []
    for pkg in ("ref", "port"):
        ref = pkg == "ref"
        S, HFL, parse, H, SGDM, LP, O = (
            (JS, JHFL, j_parse, jhfl, JSGDM, JLP, J) if ref else
            (TS, THFL, t_parse, thfl, TSGDM, TLP, T))
        scn = S.get_scenario(name)
        hfl = S.apply_hfl_overrides(scn, HFL(
            tiers=parse(spec), payload_accounting=accounting, codec=codec))
        if async_root:
            top = dataclasses.replace(hfl.tiers[-1], discipline="async")
            hfl = dataclasses.replace(hfl, tiers=hfl.tiers[:-1] + (top,))
        eng = S.build_engine(scn, hfl, seed=0, lp=LP(M=32, model_params=1e5),
                             obs=None if obs is None else O.ObsConfig(**obs))
        opt = SGDM(momentum=0.0)
        rng = np.random.default_rng(1)
        N, B = hfl.num_clusters, hfl.mus_per_cluster * 2
        if ref:
            state = H.hfl_init({"w": jnp.zeros((D,), jnp.float32)}, opt, hfl)
            loss = lambda p, b: (jnp.mean((p["w"][None, :] - b) ** 2), {})
            train = jax.jit(H.make_cluster_train_step(loss, opt, lambda t: 0.2))
            sync = H.jit_sync_step(H.make_sync(H.SyncPlan.from_config(
                hfl, collect_stats=collect and hfl.depth == 2)))
            batch = lambda x: jnp.asarray(x)
        else:
            state = H.hfl_init({"w": torch.zeros(D)}, opt, hfl)
            loss = lambda p, b: (((p["w"][None, :] - b) ** 2).mean(), {})
            train = H.make_cluster_train_step(loss, opt, lambda t: 0.2)
            sync = H.make_sync(H.SyncPlan(
                hfl, collect_stats=collect and hfl.depth == 2))
            batch = torch.from_numpy

        def gen():
            while True:
                yield batch(rng.normal(size=(N, B, D)).astype(np.float32))

        state, trace = eng.run(state, train, sync, gen(), steps)
        out.append((eng, state, trace))
    return out


def _close(a, b):
    return a == b or abs(a - b) <= RTOL * max(abs(a), abs(b))


def _check_same_telemetry(jeng, teng):
    """Virtual-clock trace events exact (the model's counter samples and
    anomaly values to RTOL), registry snapshots exact but for the model's
    gauges (RTOL) and the host series, health summaries equal."""
    jt, tt = jeng.obs.tracer.to_chrome(), teng.obs.tracer.to_chrome()
    T.validate_trace(tt)
    virt = lambda o: [e for e in o["traceEvents"] if e["pid"] == T.VIRTUAL_PID]
    jv, tv = virt(jt), virt(tt)
    assert len(tv) == len(jv) > 0
    for a, b in zip(jv, tv):
        if a.get("ph") == "C" and a["name"] in MODEL_TRACKS:
            assert a.keys() == b.keys() and a["args"].keys() == b["args"].keys()
            assert all(_close(a["args"][k], b["args"][k]) for k in a["args"])
            assert {k: a[k] for k in a if k != "args"} == \
                {k: b[k] for k in b if k != "args"}
        elif a["name"].startswith("anomaly:"):
            assert _close(a["args"].pop("value"), b["args"].pop("value"))
            assert a == b
        else:
            assert b == a
    assert tt["metadata"]["link_bits"] == jt["metadata"]["link_bits"]
    assert tt["metadata"]["dropped_events"] == jt["metadata"]["dropped_events"]
    js, ts = jeng.obs.registry.snapshot(), teng.obs.registry.snapshot()
    for name in HOST_SERIES:
        js.pop(name, None)
        ts.pop(name, None)
    # the port's own count of the rows it ranks exactly, by route (the
    # reference keeps none): on the CPU every row takes the torch ops
    exact = ts.pop("sparsify.exact_topk_rows", None)
    assert exact is None or set(exact["series"]) == {"route=plain"}
    # ... and of the leaves SGDM updates, by route: on the CPU the torch ops
    sgdm = ts.pop("optim.sgdm_leaves", None)
    assert sgdm is None or set(sgdm["series"]) == {"route=plain"}
    assert ts.keys() == js.keys()
    for name in js:
        if name in MODEL_GAUGES:
            sj, st = js[name]["series"], ts[name]["series"]
            assert st.keys() == sj.keys()
            assert all(_close(sj[k], st[k]) for k in sj), name
        else:
            assert ts[name] == js[name], name
    jh, th = jeng.obs.health.summary(), teng.obs.health.summary()
    assert th == jh
    assert [a["rule"] for a in teng.obs.health.anomalies] == \
        [a["rule"] for a in jeng.obs.health.anomalies]
    return ts


HEALTH = {"health": True, "heartbeat_events": 3}


@pytest.mark.parametrize("name,accounting", [
    ("paper-fig3", "measured"), ("stragglers", "analytic"),
    ("mobility", "measured"), ("async", "measured"), ("dropout", "analytic"),
    ("hier-3tier", "measured"), ("hier-deadline", "analytic")])
def test_engine_telemetry_equals_the_reference(name, accounting):
    """Per discipline (lockstep, deadline, async, the depth-3 cascade):
    the virtual-clock trace, the registry and the health summary of the
    port's run are the reference's."""
    (je, _, jtr), (te, _, ttr) = _run_both(name, obs=HEALTH, collect=True,
                                           accounting=accounting)
    assert ttr.meta == jtr.meta
    snap = _check_same_telemetry(je, te)
    assert snap["sim.train_launches"]["series"][""] == ttr.meta["train_launches"]
    if accounting == "measured":
        assert snap["comm.bits"]["series"]
    if name == "async":
        assert snap["sim.staleness"]["kind"] == "histogram"
        assert "health.drift" in snap
    if name == "mobility":
        assert snap["sim.reprices"]["series"][""] > 0


def test_unit_scheduler_telemetry_equals_the_reference():
    """The async-root depth-3 tree (the unit scheduler) with telemetry on:
    per-unit rounds, pushes and the staleness histogram."""
    (je, _, _), (te, _, _) = _run_both(
        "hier-3tier", obs=HEALTH, collect=False, async_root=True, steps=8)
    snap = _check_same_telemetry(je, te)
    assert set(snap["sim.staleness"]["series"]) >= {"cluster=e0", "cluster=e1"}


@pytest.mark.parametrize("name", ["stragglers", "async", "hier-3tier"])
def test_telemetry_on_and_off_compute_the_same_run(name):
    """Tracing and the health monitor only read the run: the port's state
    (bitwise), trace rows and meta are those of the same run without."""
    (_, _, _), (te_on, s_on, t_on) = _run_both(
        name, obs=HEALTH, collect=True, accounting="measured")
    (_, _, _), (te_off, s_off, t_off) = _run_both(
        name, obs=None, collect=False, accounting="measured")
    assert te_on.obs.health.enabled and not te_off.obs.enabled
    assert t_on.rows == t_off.rows and t_on.meta == t_off.meta
    for a, b in zip(tree_leaves(s_on._asdict()), tree_leaves(s_off._asdict())):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_fault_dead_cluster_fires_its_anomaly():
    (je, _, _), (te, _, _) = _run_both("fault-dead-cluster", obs=HEALTH,
                                       collect=True, steps=16)
    _check_same_telemetry(je, te)
    dead = [a for a in te.obs.health.anomalies if a["rule"] == "dead-cluster"]
    assert dead and all(a["label"] == "c2" for a in dead)
    part = te.obs.registry.snapshot()["sim.participation_rate"]["series"]
    assert part["cluster=c2"] == 0.0
    assert te.obs.registry.snapshot()["sim.drop_gini"]["series"][""] > 0.0


def test_async_collect_stats_tracks_cluster_signals():
    (je, _, _), (te, _, _) = _run_both("async", obs={"health": True},
                                       collect=False, steps=8)
    snap = _check_same_telemetry(je, te)
    assert set(snap["health.drift"]["series"]) == {"cluster=c0", "cluster=c1",
                                                   "cluster=c2"}
    assert snap["health.omega_overlap_ul"]["series"]


# ---------------------------------------------------------------------------
# program_costs: the narrow olmo's train step
# ---------------------------------------------------------------------------


def test_program_costs_flops_match_the_reference_and_leave_the_run_alone():
    """``program_costs`` of the narrow olmo's train step counts 2·M·N·K per
    matrix product, as the reference's HLO walk counts 2·numel·K per dot.
    Both are costed with ``remat=False`` here (each layer's forward
    products once; ``test_program_costs_count_remat_like_the_reference``
    holds the two with remat on). Then the two count the same products
    but the attention backward's P·V recompute, which the port's plain
    version skips (five of the reference's six products per tile):
    measured 0.993 of the reference's count, hence rel 0.02. The counted
    call is a real step: its state is bitwise that of an uncounted step
    from the same init."""
    from repro.configs import get_config as j_get
    from repro.launch.steps import make_loss_fn as j_loss
    from repro.models.transformer import init_model as j_init
    from repro_torch.configs import get_config as t_get
    from repro_torch.launch.op_cost import FirstCallCosts, op_costs
    from repro_torch.launch.steps import make_loss_fn as t_loss
    from repro_torch.utils.convert import state_from_numpy

    narrow = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                  head_dim=16, d_ff=128, vocab_size=128)
    jcfg = dataclasses.replace(j_get("olmo-1b").reduced(), remat=False, **narrow)
    tcfg = dataclasses.replace(t_get("olmo-1b").reduced(), remat=False, **narrow)
    jh = JHFL(tiers=j_parse("2x2:H=2"))
    th = THFL(tiers=t_parse("2x2:H=2"))
    jopt, topt = JSGDM(momentum=0.9), TSGDM(momentum=0.9)
    jstate = jhfl.hfl_init(j_init(jax.random.PRNGKey(0), jcfg), jopt, jh)
    toks = np.random.default_rng(0).integers(0, 128, (2, 4, 16))
    jtrain = jax.jit(jhfl.make_cluster_train_step(j_loss(jcfg), jopt,
                                                  lambda t: 0.1))
    jc = J.program_costs(jtrain, jstate, {"tokens": jnp.asarray(toks)})
    ttrain = thfl.make_cluster_train_step(t_loss(tcfg), topt, lambda t: 0.1)
    tb = {"tokens": torch.from_numpy(toks)}
    host = lambda: jax.tree.map(np.array, jstate)  # fresh copies each
    counted, plain = state_from_numpy(host(), "cpu"), state_from_numpy(host(), "cpu")
    seen = []
    step = FirstCallCosts(ttrain, seen.append)
    counted, closs = step(counted, tb)
    plain, ploss = ttrain(plain, tb)
    tc = seen[0]
    assert set(tc) == {"flops", "hbm_bytes", "collective_bytes", "launches"}
    assert tc["flops"] > 0 and tc["hbm_bytes"] > 0 and tc["launches"] > 0
    assert tc["flops"] / jc["flops"] == pytest.approx(1.0, rel=0.02)
    assert torch.equal(closs, ploss)
    for a, b in zip(tree_leaves(counted._asdict()), tree_leaves(plain._asdict())):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    step(counted, tb)  # only the first call is counted
    assert len(seen) == 1
    _, again = op_costs(ttrain, plain, tb)
    assert again["flops"] == tc["flops"]  # the count is the step's, not the run's
    assert T.program_costs(ttrain, plain, tb)["flops"] == tc["flops"]


def test_program_costs_count_remat_like_the_reference():
    """With ``remat=True`` (the configs' default) both backwards run each
    layer's forward again: the port's checkpointed layers and the
    reference's ``jax.checkpoint`` scan bodies. The two counts then agree
    as without remat (measured 0.994; rel 0.02 as there), and each
    exceeds its own count without remat."""
    from repro.configs import get_config as j_get
    from repro.launch.steps import make_loss_fn as j_loss
    from repro.models.transformer import init_model as j_init
    from repro_torch.configs import get_config as t_get
    from repro_torch.launch.op_cost import op_costs
    from repro_torch.launch.steps import make_loss_fn as t_loss
    from repro_torch.utils.convert import state_from_numpy

    narrow = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                  head_dim=16, d_ff=128, vocab_size=128)
    toks = np.random.default_rng(0).integers(0, 128, (2, 4, 16))
    jh = JHFL(tiers=j_parse("2x2:H=2"))
    jopt, topt = JSGDM(momentum=0.9), TSGDM(momentum=0.9)
    counts = {}
    for remat in (False, True):
        jcfg = dataclasses.replace(j_get("olmo-1b").reduced(), remat=remat, **narrow)
        tcfg = dataclasses.replace(t_get("olmo-1b").reduced(), remat=remat, **narrow)
        jstate = jhfl.hfl_init(j_init(jax.random.PRNGKey(0), jcfg), jopt, jh)
        jtrain = jax.jit(jhfl.make_cluster_train_step(j_loss(jcfg), jopt,
                                                      lambda t: 0.1))
        jc = J.program_costs(jtrain, jstate, {"tokens": jnp.asarray(toks)})
        ttrain = thfl.make_cluster_train_step(t_loss(tcfg), topt, lambda t: 0.1)
        tstate = state_from_numpy(jax.tree.map(np.array, jstate), "cpu")
        _, tc = op_costs(ttrain, tstate, {"tokens": torch.from_numpy(toks)})
        counts[remat] = (jc["flops"], tc["flops"])
    assert counts[True][1] / counts[True][0] == pytest.approx(1.0, rel=0.02)
    assert counts[True][0] > counts[False][0] and counts[True][1] > counts[False][1]
