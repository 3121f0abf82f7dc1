"""``BENCHMARK.json`` and the files it names agree, and it keeps to the
contract's names, units, sizes and budget."""
import ast
import json
import re

import pytest

from _tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
HERE = ROOT / "hflbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj", "head", "expansion",
               "experts_per_token", "d_model", "d_ff", "width")


def test_top_level_keys_and_command():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "hflbench/run.py"]
    assert BENCH["paths"] == ["hflbench"] and (HERE / "run.py").is_file()
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)


def test_a_full_check_fits_its_budget_at_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_one_line_texts(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_and_reductions(cfg):
    path = ROOT / cfg["file"]
    assert path.is_file() and cfg["file"].startswith("hflbench/")
    data = json.loads(path.read_text())
    assert sorted(data["reduced"]) == sorted(cfg["reduced"]) and len(cfg["reduced"]) <= 16
    for key in cfg["reduced"]:
        assert NAME.match(key) and not key.endswith(("_dim", "_rank"))
        assert not any(w in key for w in WIDTH_WORDS)
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_agree(cell):
    data = json.loads((HERE / "workloads" / f"{cell['name']}.json").read_text())
    for key in ("config", "traffic", "chips", "why"):
        assert data[key] == cell[key]
    assert cell["chips"] == 1
    assert (HERE / "traffic" / f"{cell['traffic']}.json").is_file()
    assert (HERE / "drivers" / f"{data['driver']}.py").is_file()
    assert any(c["name"] == cell["config"] for c in BENCH["configs"])


def _reported(cell):
    return {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_setup_another_metric_and_a_layer(cell):
    e2e = _reported(cell)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell in m.get("workloads", []) for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader_and_its_cells_report_what_it_moves(metric):
    assert (HERE / "metrics" / f"{metric['name']}.py").is_file()
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert metric["workloads"]
    for cell in metric["workloads"]:
        assert metric["moves"] in _reported(cell)
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_end_to_end_bounds():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert {"setup_s", "train_tokens_per_s", "long_train_tokens_per_s", "train_images_per_s",
            "peak_mem_gb"} == names
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_every_layer_is_named_in_perf_md():
    perf = (ROOT / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert "`" + m["layer"] + "`" in perf, m["layer"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & {"jax", "jaxlib", "ml_dtypes", "flax", "repro"}
    if "reference" in path.relative_to(HERE).parts:
        assert "repro_torch" not in set(_imports(path))
    assert "benchmarks" not in set(_imports(path))
