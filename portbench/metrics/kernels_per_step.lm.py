"""kernels_per_step.lm: ``kernels_per_batch`` (``kernels_per_batch.py``)
read in the LM decode cell, where a call is one decode step and it moves
``batch_p95_ms``."""
from pathlib import Path

from portbench.harness import load_module

read = load_module(Path(__file__).with_name("kernels_per_batch.py")).read
