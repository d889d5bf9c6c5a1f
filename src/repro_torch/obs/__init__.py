"""repro_torch.obs — the telemetry the serving loop records into.

Port of the parts of ``repro.obs`` the chip's and the fleet's serving
paths use: the process-wide :class:`Telemetry` switchboard, the metrics
registry with bounded reservoirs, the Chrome/Perfetto span tracer (its
spans timed on the card too, :meth:`Tracer.span`), and the cross-rank
snapshot gather (:func:`allgather_snapshots`) that, with
:func:`merge_snapshots`, rolls every rank's registry into one
fleet-wide view.
"""
from repro_torch.obs.core import (NULL_RECORDER, NullRecorder, SpanRecorder,
                                  StepRecorder, Telemetry, configure, current,
                                  disable)
from repro_torch.obs.dist import allgather_snapshots
from repro_torch.obs.metrics import (DEFAULT_RESERVOIR, Counter, Gauge,
                                     Histogram, MetricsRegistry, Reservoir,
                                     merge_snapshots)
from repro_torch.obs.trace import LANE_TID_BASE, Tracer

__all__ = [
    "Counter", "DEFAULT_RESERVOIR", "Gauge", "Histogram",
    "LANE_TID_BASE", "MetricsRegistry", "NULL_RECORDER",
    "NullRecorder", "Reservoir", "SpanRecorder", "StepRecorder",
    "Telemetry", "Tracer", "allgather_snapshots", "configure", "current",
    "disable", "merge_snapshots",
]
