"""The card scripts' bookkeeping, on the CPU: what ``chip_smoke.py``
reports under each key of a kernel row, and how ``scripts/kernel_ab.py``
refuses to run without trees or a card. Nothing here times anything."""
import importlib.util
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def smoke(monkeypatch):
    """chip_smoke with its two timers replaced: the host-paced one
    returns 2.0 ms, the card's own 1.0 ms."""
    module = _load("chip_smoke", ROOT / "chip_smoke.py")
    monkeypatch.setattr(module, "_time_ms", lambda torch, fn: 2.0)
    monkeypatch.setattr(module, "_device_ms", lambda torch, fn: 1.0)
    return module


def test_smoke_ms_keys_are_host_paced_and_device_keys_the_cards(smoke):
    """``ms``, ``plain_ms`` and ``library_ms`` keep the first slice's
    meaning (CUDA events at the host's launch pace); the card's own
    times go under ``device_*`` keys."""
    t = smoke._times(None, None, None, None)
    assert {k: t[k] for k in ("ms", "plain_ms", "library_ms")} == \
        {"ms": 2.0, "plain_ms": 2.0, "library_ms": 2.0}
    assert {k: t[k] for k in ("device_ms", "plain_device_ms",
                              "library_device_ms")} == \
        {"device_ms": 1.0, "plain_device_ms": 1.0, "library_device_ms": 1.0}


def test_smoke_kernel_row_sums_layers_and_bounds_each(smoke):
    layers = [{"max_abs_err": 1e-6, "bytes_ms": 0.05, "ops_ms": 0.04,
               "ops_ms_f32_cuda_cores": 0.1,
               **smoke._times(None, None, None, None)},
              {"max_abs_err": 3e-6, "bytes_ms": 0.01, "ops_ms": 0.02,
               "ops_ms_f32_cuda_cores": 0.03,
               **smoke._times(None, None, None, None)}]
    row = smoke._kernel_row("k", "src", "ref:1", 39, layers)
    assert row["launches"] == 39 and row["max_abs_err"] == 3e-6
    assert row["ms"] == 4.0 and row["device_ms"] == 2.0
    assert row["library_ms"] == 4.0 and row["plain_device_ms"] == 2.0
    # each layer's bound is the larger of its bytes and operations
    assert row["bound_ms"] == pytest.approx(0.05 + 0.02)
    assert row["bound_ms_f32_cuda_cores"] == pytest.approx(0.1 + 0.03)
    assert row["bound_by"] == "bytes"
    assert row["share_of_bound"] == pytest.approx(0.07 / 4.0)
    assert row["device_share_of_bound"] == pytest.approx(0.07 / 2.0)


@pytest.mark.parametrize("args", [[], ["."], ["--rounds", "1", "."]])
def test_kernel_ab_refuses_without_trees_or_a_card(args):
    """No tree: usage and exit 2. Without a card: exit 2 before anything
    is built (where a card is visible the script would run)."""
    if args and torch.cuda.is_available():
        pytest.skip("a card is visible: the script would run")
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" /
                                               "kernel_ab.py"), *args],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT)
    assert proc.returncode == 2
    assert proc.stdout == ""
