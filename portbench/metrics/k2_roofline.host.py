"""k2_roofline.host: ``k2_roofline`` (``k2_roofline.py``) read in the host-handover cells,
where it moves ``batch_p95_ms``."""
from pathlib import Path

from portbench.harness import load_module

read = load_module(Path(__file__).with_name("k2_roofline.py")).read
