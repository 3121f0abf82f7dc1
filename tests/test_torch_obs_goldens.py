"""The reference's regression gate on the port's runs: the train CLI with
CI's scenario-smoke flags (``.github/workflows/ci.yml``) on the CPU, its
``--metrics-out`` JSONL held by ``tools/run_compare.py --check`` against
the committed goldens (``benchmarks/goldens/*.summary.json``, never
re-blessed here) and its ``--trace-viz`` export by ``tools/trace_summary.py
--check``.

``run_compare`` gates exactly the config echo, the per-kind event counts,
the launch counts and the health anomalies, and to rtol 1e-6 the
virtual-clock bit totals, participation rates, the drop Gini and the
simulator's latencies; losses and host timings are informational (the
port's init is its own generator's, so its losses differ from the
golden's)."""
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TOOLS = ROOT / "tools"


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


run_compare = _tool("run_compare")
trace_summary = _tool("trace_summary")


@pytest.mark.parametrize("scenario", ["paper-fig3", "hier-3tier"])
def test_port_run_passes_the_reference_golden(scenario, tmp_path):
    from repro_torch.obs import validate_runlog, validate_trace

    run, trace = tmp_path / "run.jsonl", tmp_path / "trace.json"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--scenario", scenario, "--steps", "4", "--tiers", "3x2:H=2",
         "--batch-per-mu", "1", "--seq", "16", "--obs-health",
         "--trace-viz", str(trace), "--metrics-out", str(run)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    golden = ROOT / "benchmarks" / "goldens" / f"{scenario}.summary.json"
    assert run_compare.main([str(golden), str(run), "--check"]) == 0
    assert trace_summary.main([str(trace), "--check"]) == 0
    assert validate_runlog(run) == []
    obj = json.loads(trace.read_text())
    validate_trace(obj)
    recs = [json.loads(line) for line in run.read_text().splitlines()]
    hs = next(r for r in recs if r["event"] == "health_summary")
    assert hs["anomalies"] == 0 and hs["signals"]
    tracks = {e["name"] for e in obj["traceEvents"] if e.get("ph") == "C"}
    assert {"health.loss", "health.participation"} <= tracks
    if scenario == "paper-fig3":  # depth 2: the sync's own statistics
        assert {"health.drift", "health.residual",
                "health.omega_overlap"} <= tracks
    # the console lines are the port's, one per logged event
    assert res.stdout.splitlines()[0].startswith("[train] arch=olmo-1b-smoke")
    assert "[health] anomalies=0" in res.stdout
