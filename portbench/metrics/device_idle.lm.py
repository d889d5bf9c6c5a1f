"""device_idle.lm: ``device_idle`` (``device_idle.py``) read in the LM
decode cell, where it moves ``batch_p95_ms``."""
from pathlib import Path

from portbench.harness import load_module

read = load_module(Path(__file__).with_name("device_idle.py")).read
