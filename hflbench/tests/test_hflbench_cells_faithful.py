"""The faithful cell runs end to end through the command at the tests' size."""
import json

from _tiny import KEYS, ROOT, command


def test_faithful_cell_prints_the_contracts_last_line():
    rc, out, err = command(ROOT, "resnet18-paper")
    assert rc == 0, err[-2000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert tuple(line)[:5] == KEYS
    assert line["correct"] is True, line["compared"]
    assert {"setup_s", "peak_mem_gb", "train_images_per_s"} == set(line["metrics"])


def test_faithful_traced_run_reads_the_consensus_and_mfu():
    rc, out, err = command(ROOT, "resnet18-paper", trace=1)
    assert rc == 0, err[-2000:]
    metrics = json.loads(out.strip().splitlines()[-1])["metrics"]
    assert "mfu.faithful" in metrics and "conv_ms.faithful" not in metrics
