"""Fleet-scale and oversubscribed scenarios on the port against the
reference: ``flash-crowd`` (hotspot-drift replay, ``duplicate``
residency over 16 MUs per 2-slot cluster), ``scale-100k`` and ``scale-1m``
(the live 105,000- and 1,050,000-MU fleets behind 28 training slots,
``rate_model='single'``, mobility batched per 600 virtual s), and the
train CLI on a trace file with a residency policy.

The tolerances are ``tests/test_torch_sim_async.py``'s (timeline and meta
exact, per-event losses rtol 1e-4 in f32 model math, each row's gap
<= 0.25 of its move). ``scale-1m`` runs its whole fleet with the narrow
model; the reference's leg takes about 30 s of the test.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_sim import _run_both  # noqa: E402
from test_torch_sim_async import check_async_run  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.filterwarnings("ignore:scenario 'scale-100k'")
@pytest.mark.parametrize("name", ["flash-crowd", "scale-100k", "scale-1m"])
def test_fleet_scale_scenarios_replay_the_reference(name):
    jtrace, ttrace, gap, _, rows = _run_both(name, masked=True, dtype="float32",
                                             row_gaps=True)
    check_async_run(jtrace, ttrace, gap, rows)
    meta = ttrace.meta
    assert meta["residency"] == ("duplicate" if name == "flash-crowd" else "move")
    if name == "scale-1m":
        assert meta["sync_launches"] == 14 and meta["train_launches"] == 28


def test_scale_fleet_keeps_its_shards():
    """A 105k-MU fleet moved past the 600 s repricing interval: some MUs
    re-associate, ``move`` residency follows them, every shard is held
    exactly once and the cached radio pricing and round times are
    dropped."""
    from repro_torch.configs import HFLConfig, parse_tiers_spec
    from repro_torch.sim import scenarios as TS

    with pytest.warns(UserWarning, match="scale-100k"):
        scn = TS.get_scenario("scale-100k")
    hfl = TS.apply_hfl_overrides(scn, HFLConfig(tiers=parse_tiers_spec("2x2:H=2")))
    eng = TS.build_engine(scn, hfl)
    assert eng.fleet.K == 105_000 and eng._oversub
    cid0 = eng.fleet.cid.copy()
    eng._aux, eng._crt = {}, np.zeros(7)
    eng._advance_fleet(599.0)  # under the interval: deferred
    assert eng._crt is not None and np.array_equal(eng.fleet.cid, cid0)
    eng._advance_fleet(1e4)
    assert eng._aux is None and eng._crt is None
    assert int((eng.fleet.cid != cid0).sum()) > 0
    eng.residency.check_conservation()
    K = eng.fleet.K
    assert eng.residency.holds[eng.fleet.cid, np.arange(K)].all()
    assert eng.residency.holds.sum() == K


def test_cli_runs_trace_replay_with_a_trace_file_on_cpu(tmp_path):
    """``--scenario trace-replay --trace-in FILE --residency duplicate``
    through the train CLI, and its ``[sim]`` lines against the reference
    CLI's."""
    from repro_torch.sim import traces as ttr

    path = tmp_path / "walk.csv"
    ttr.generate("manhattan", 8, 600.0, seed=1).save(str(path))
    args = ["--scenario", "trace-replay", "--trace-in", str(path),
            "--residency", "duplicate", "--steps", "4", "--batch-per-mu", "1",
            "--seq", "16"]
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    port = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           "--device", "cpu"] + args, capture_output=True,
                          text=True, timeout=300, cwd=ROOT, env=env)
    assert port.returncode == 0, port.stderr
    ref = subprocess.run([sys.executable, "-m", "repro.launch.train"] + args,
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env=env)
    assert ref.returncode == 0, ref.stderr
    sim = lambda out: [l for l in out.splitlines() if l.startswith("[sim]")]
    assert sim(port.stdout) == sim(ref.stdout) and len(sim(port.stdout)) == 2
    assert "discipline=async" in sim(port.stdout)[0]
    assert port.stdout.splitlines()[-1].startswith("[train] first-loss=")
