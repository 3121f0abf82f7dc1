"""Cells, configurations, drivers and metrics are found by name: a cell added
as new files in a copy of the benchmark runs without an edit to any file;
and a checkout that holds only the benchmark (no program) gives no result."""
import json
import shutil

from _tiny import ROOT, command


def _copy(tmp_path, with_program=True):
    shutil.copytree(ROOT / "hflbench", tmp_path / "hflbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    if with_program:
        (tmp_path / "src").symlink_to(ROOT / "src")
    return tmp_path


def test_a_new_cell_is_found_from_its_files(tmp_path):
    root = _copy(tmp_path)
    traffic = json.loads((root / "hflbench/traffic/sync-h2.json").read_text())
    traffic.update(period=3, omega_impl="hist")
    (root / "hflbench/traffic/sync-h3-hist.json").write_text(json.dumps(traffic))
    cell = json.loads((root / "hflbench/workloads/olmo1b-sync-h2.json").read_text())
    cell.update(traffic="sync-h3-hist", why="a cell added as files")
    (root / "hflbench/workloads/olmo1b-sync-h3-hist.json").write_text(json.dumps(cell))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "olmo1b-sync-h3-hist", "config": "olmo-1b",
                               "traffic": "sync-h3-hist", "chips": 1, "why": "added"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "olmo1b-sync-h2" in m.get("workloads", []):
            m["workloads"].append("olmo1b-sync-h3-hist")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, out, err = command(root, "olmo1b-sync-h3-hist")
    assert rc == 0, err[-2000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and "train_tokens_per_s" in line["metrics"]


def test_without_the_program_there_is_no_result(tmp_path):
    root = _copy(tmp_path, with_program=False)
    rc, out, _ = command(root, "olmo1b-sync-h2")
    assert rc != 0 and not out.strip()
