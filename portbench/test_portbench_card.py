"""On the card (``-m gpu``; skipped where there is none): a short run
of each cell is correct, and the control at the cell's own size is
not."""
import pytest
import torch

from portbench import harness

torch.set_num_threads(1)

CELLS = ["deep-1t1m.stream-dev", "deep-sram.stream-dev",
         "deep-1t1m.stream-host", "deep-sram.stream-host"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_is_correct_and_the_control_is_not(card, workload):
    cell = harness.load_cell(workload)
    r = harness.run_cell(cell, 2 ** 31 + 77, 1.0, False, device=card)
    assert r["correct"], r["check"]
    assert r["device"]["platform"] == "gpu"
    v = harness.control_verdict(cell, 2 ** 31 + 77, device=card)
    assert not v["correct"]
    assert v["check"]["out_gap"]["value"] > \
        cell.config["check"]["out_gap_limit"]
