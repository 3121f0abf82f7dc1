"""The check catches each fault a training cell can have, planted in the timed
path underneath a run whose look for a chip is skipped: a step that returns
its state unchanged, half of each batch left out, the exchange left out, and
an answer altered where it is produced.  The sound run passes."""
import pytest

from _tiny import in_process

FAULTS = ["unchanged", "half_batch", "no_exchange", "altered"]


@pytest.mark.parametrize("cell", ["olmo1b-sync-h2", "olmo1b-train4k-h4", "resnet18-paper"])
def test_sound_run_is_correct(cell):
    assert in_process(cell)["correct"] is True


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", ["olmo1b-sync-h2", "olmo1b-train4k-h4", "resnet18-paper"])
def test_planted_fault_comes_out_not_correct(cell, fault):
    line = in_process(cell, fault)
    assert line["correct"] is False, line["compared"]
