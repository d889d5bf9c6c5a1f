"""Shared tier-1 fixtures and markers.

Two things live here:

* ``slow`` / ``distributed`` / ``chaos`` markers, OFF by default so
  the tier-1 gate (`pytest -x -q`) stays fast: opt in with
  ``--run-slow`` / ``--run-distributed`` / ``--run-chaos`` (or
  ``REPRO_RUN_SLOW=1`` / ``REPRO_RUN_DISTRIBUTED=1`` /
  ``REPRO_RUN_CHAOS=1`` for CI matrices that can't pass flags).
  The distributed suite spawns real multi-process ``jax.distributed``
  fleets — minutes, not seconds; the chaos suite additionally KILLS
  workers mid-serve to exercise the failure paths.

* subprocess fixtures over :mod:`repro.launch.simdev`, the one place
  that knows how to pin XLA's simulated-device count (and the
  localhost rendezvous) into a child's environment before jax
  initializes. Tests and benchmarks used to copy-paste that env
  boilerplate; they now share the same recipe.
"""
import os

import pytest

from repro.launch import simdev


def pytest_addoption(parser):
    parser.addoption(
        "--run-slow", action="store_true", default=False,
        help="run tests marked slow (skipped by default)")
    parser.addoption(
        "--run-distributed", action="store_true", default=False,
        help="run tests marked distributed (multi-process "
             "jax.distributed fleets; skipped by default)")
    parser.addoption(
        "--run-chaos", action="store_true", default=False,
        help="run tests marked chaos (multi-process fleets with "
             "injected worker kills; skipped by default)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running; excluded from the default "
        "tier-1 run (enable with --run-slow / REPRO_RUN_SLOW=1)")
    config.addinivalue_line(
        "markers", "distributed: spawns a multi-process "
        "jax.distributed fleet; excluded from the default tier-1 run "
        "(enable with --run-distributed / REPRO_RUN_DISTRIBUTED=1)")
    config.addinivalue_line(
        "markers", "chaos: spawns a multi-process fleet and kills "
        "workers mid-serve; excluded from the default tier-1 run "
        "(enable with --run-chaos / REPRO_RUN_CHAOS=1)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips (decided in a "
        "fixture) where there is none")


def pytest_collection_modifyitems(config, items):
    run_slow = config.getoption("--run-slow") or \
        os.environ.get("REPRO_RUN_SLOW") == "1"
    run_dist = config.getoption("--run-distributed") or \
        os.environ.get("REPRO_RUN_DISTRIBUTED") == "1"
    run_chaos = config.getoption("--run-chaos") or \
        os.environ.get("REPRO_RUN_CHAOS") == "1"
    skip_slow = pytest.mark.skip(
        reason="slow test: pass --run-slow (or REPRO_RUN_SLOW=1)")
    skip_dist = pytest.mark.skip(
        reason="distributed test: pass --run-distributed "
               "(or REPRO_RUN_DISTRIBUTED=1)")
    skip_chaos = pytest.mark.skip(
        reason="chaos test: pass --run-chaos (or REPRO_RUN_CHAOS=1)")
    for item in items:
        if "chaos" in item.keywords and not run_chaos:
            item.add_marker(skip_chaos)
        elif "distributed" in item.keywords and not run_dist:
            item.add_marker(skip_dist)
        elif "slow" in item.keywords and not run_slow:
            item.add_marker(skip_slow)


@pytest.fixture
def sim_subprocess():
    """Run a python script string in a subprocess seeing ``n_devices``
    simulated CPU devices; asserts exit 0 and returns the script's
    last JSON stdout line (the repo's subprocess result convention)."""

    def run(script, *, n_devices=2, timeout=600.0):
        out = simdev.run_simulated(script, n_devices=n_devices,
                                   timeout=timeout)
        assert out.returncode == 0, out.stderr[-3000:]
        return simdev.last_json_line(out.stdout)

    return run


@pytest.fixture
def launch_fleet():
    """:func:`repro.launch.simdev.launch_local_fleet`, as a fixture:
    spawn + supervise one subprocess per rank of a localhost
    ``jax.distributed`` fleet (any death kills the survivors)."""
    return simdev.launch_local_fleet
