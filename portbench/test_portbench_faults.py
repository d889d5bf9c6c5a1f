"""A run whose timed path is broken underneath comes out not correct:
the harness's look for a card is skipped and the rest of a run is
driven on the CPU at a small batch, once for each fault a stream cell
can have (it has no state of its own to leave unchanged beyond its
outputs, and no exchange between chips)."""
import pytest
import torch

from portbench import harness

torch.set_num_threads(1)

CELLS = ["deep-1t1m.stream-dev", "deep-sram.stream-host"]


def _stale(call):
    """Every call returns the first call's outputs: state unchanged."""
    first = []

    def f(x):
        y = call(x)
        if not first:
            first.append(y.clone())
        return first[0]
    return f


def _half(call):
    """Half the batch left out, the mean of the rest in its place."""
    def f(x):
        y = call(x).clone()
        h = y.shape[0] // 2
        y[h:] = y[:h].mean(dim=0)
        return y
    return f


def _altered(call):
    """One answer altered where it is produced."""
    def f(x):
        y = call(x).clone()
        y[0, 0] += 0.5
        return y
    return f


def _short(call):
    """An answer that never comes: the last row missing."""
    def f(x):
        return call(x)[:-1]
    return f


@pytest.mark.parametrize("workload", CELLS)
def test_an_unbroken_run_is_correct(workload):
    r = harness.run_cell(harness.load_cell(workload), 2 ** 31 + 5, 0.2,
                         False, device="cpu", batch=256)
    assert r["correct"] and r["failed"] == 0


@pytest.mark.parametrize("fault", [_stale, _half, _altered, _short],
                         ids=["stale", "half", "altered", "short"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_run_is_not_correct(workload, fault):
    r = harness.run_cell(harness.load_cell(workload), 2 ** 31 + 5, 0.2,
                         False, device="cpu", batch=256, wrap=fault)
    assert not r["correct"]
    value = r["check"]["out_gap"]["value"]
    assert value == "inf" or value > r["check"]["out_gap"]["limit"]
