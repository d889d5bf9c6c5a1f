"""repro_torch.obs — the telemetry the serving loop records into.

Port of the parts of ``repro.obs`` the chip's serving path uses: the
process-wide :class:`Telemetry` switchboard, the metrics registry with
bounded reservoirs, and the Chrome/Perfetto span tracer. Numpy only.
"""
from repro_torch.obs.core import (NULL_RECORDER, NullRecorder, StepRecorder,
                                  Telemetry, configure, current, disable)
from repro_torch.obs.metrics import (DEFAULT_RESERVOIR, Counter, Gauge,
                                     Histogram, MetricsRegistry, Reservoir,
                                     merge_snapshots)
from repro_torch.obs.trace import LANE_TID_BASE, Tracer

__all__ = [
    "Counter", "DEFAULT_RESERVOIR", "Gauge", "Histogram",
    "LANE_TID_BASE", "MetricsRegistry", "NULL_RECORDER",
    "NullRecorder", "Reservoir", "StepRecorder", "Telemetry",
    "Tracer", "configure", "current", "disable", "merge_snapshots",
]
