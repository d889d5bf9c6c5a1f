"""glue_ms.host: ``glue_ms`` (``glue_ms.py``) read in the host-handover cells,
where it moves ``batch_p95_ms``."""
from pathlib import Path

from portbench.harness import load_module

read = load_module(Path(__file__).with_name("glue_ms.py")).read
