"""Every LM cell runs end to end through the command at the tests' size and
prints the contract's last line; its check passes on the sound program."""
import json

import pytest

from _tiny import CELLS, KEYS, ROOT, command

LM = [c for c in CELLS if c.startswith("olmo")]


@pytest.mark.parametrize("cell", LM)
def test_lm_cell_prints_the_contracts_last_line(cell):
    rc, out, err = command(ROOT, cell)
    assert rc == 0, err[-2000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert tuple(line)[:5] == KEYS and list(line)[-1] == "compared"
    assert line["correct"] is True, line["compared"]
    rate = json.loads((ROOT / f"hflbench/workloads/{cell}.json").read_text()).get(
        "rate_metric", "train_tokens_per_s")
    assert {"setup_s", "peak_mem_gb", rate} == set(line["metrics"])
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "limit" in err.strip().splitlines()[-1]


def test_lm_traced_run_reads_its_spans_and_window():
    rc, out, err = command(ROOT, "olmo1b-sync-h2", trace=1)
    assert rc == 0, err[-2000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert {"train_step_ms.lm", "sync_ms.lm", "mfu.lm"} <= set(line["metrics"])
    # no kernel of the card runs on the CPU: its rooflines and idle share stay silent
    assert not any(k.endswith("_roofline.lm") or k.startswith("device_idle") for k in line["metrics"])
    assert line["device"]["window_s"] > 0 and set(line["breakdown"]) == {"device_ops", "idle_gaps"}
