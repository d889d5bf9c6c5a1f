"""stream_mfu.host: ``stream_mfu`` (``stream_mfu.py``) read in the host-handover cells,
where it moves ``batch_p95_ms``."""
from pathlib import Path

from portbench.harness import load_module

read = load_module(Path(__file__).with_name("stream_mfu.py")).read
