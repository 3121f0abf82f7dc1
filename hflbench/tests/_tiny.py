"""Helpers of the benchmark's CPU tests: runs of a cell at the tests' size."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from hflbench import harness  # noqa: E402

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
KEYS = ("correct", "attempted", "failed", "metrics", "device")


def command(root: Path, cell: str, *extra: str, seed: int = 7, trace: int = 0):
    """The command the driver runs, at the tests' size (``--tiny``), from
    ``root``; -> (exit code, stdout, stderr)."""
    # one thread: the test workers run side by side on a few cores
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "hflbench/run.py", "--workload", cell, "--seed", str(seed),
         "--seconds", "0.2", "--trace", str(trace), "--tiny", *extra],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    return proc.returncode, proc.stdout, proc.stderr


def in_process(cell: str, fault=None, seed: int = 11):
    """The result line of one tiny run in this process (the command without
    its check of the process's modules, which other tests' imports would
    trip)."""
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", "0.05", "--trace", "0",
            "--tiny"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.measure(harness.parse(argv), time.perf_counter(), fault=fault)
    finally:
        torch.set_num_threads(threads)
