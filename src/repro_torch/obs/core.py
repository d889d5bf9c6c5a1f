"""The process-wide telemetry switchboard.

Port of ``repro.obs.core``: the same numpy-only code, except that
``configure`` reads the host rank from ``torch.distributed``.

One :class:`Telemetry` pair (metrics registry + tracer) is current per
process; every instrumented component resolves it through
:func:`current` at use time, so ``configure()`` lights up telemetry in
an already-running stack and ``disable()`` returns it to the shared
inert pair. The disabled path is ONE module attribute read and a bool
check per engine step.

:class:`StepRecorder` is the engine-step instrument: the scheduler
opens one per traced step, brackets the named phases (admit, dispatch,
device_step, gather, finish) with ``phase(...)``, and ``close()``
emits the step span plus per-phase histograms — the measured
scatter/compute/gather split of an engine step.
``NULL_RECORDER`` is its inert twin for the un-traced path.

:class:`SpanRecorder` is the stream path's instrument
(:meth:`Telemetry.spans`): spans on one device, each timed on the card
by :meth:`Tracer.span`'s event pair. The stream path's hooks call
``rec.span(name)`` on it or on ``NULL_RECORDER``, whose spans are
no-ops.
"""
from __future__ import annotations

import sys
import time
from typing import Optional

from repro_torch.obs.metrics import DEFAULT_RESERVOIR, MetricsRegistry
from repro_torch.obs.trace import NULL_SPAN, Tracer


class Telemetry:
    __slots__ = ("metrics", "tracer")

    def __init__(self, metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        self.metrics = metrics if metrics is not None else \
            MetricsRegistry(enabled=False)
        self.tracer = tracer if tracer is not None else \
            Tracer(enabled=False)

    @property
    def active(self) -> bool:
        return self.metrics.enabled or self.tracer.enabled

    def spans(self, device, cat: str = "span"):
        """The span recorder for work on ``device``
        (``NULL_RECORDER`` while the tracer is off)."""
        if not self.tracer.enabled:
            return NULL_RECORDER
        return SpanRecorder(self.tracer, device, cat)


_DISABLED = Telemetry()
_CURRENT = _DISABLED


def current() -> Telemetry:
    """The process-wide telemetry pair (inert unless configured)."""
    return _CURRENT


def configure(*, metrics: bool = True, trace: bool = True,
              reservoir: int = DEFAULT_RESERVOIR,
              max_events: int = 500_000,
              pid: Optional[int] = None) -> Telemetry:
    """Install (and return) a live telemetry pair. ``pid`` tags every
    trace event with the host rank; when omitted it is taken from an
    already-initialized ``torch.distributed`` process group (never
    initializing one from here)."""
    global _CURRENT
    if pid is None:
        pid = 0
        dist = sys.modules.get("torch.distributed")
        if dist is not None and dist.is_available() and \
                dist.is_initialized():
            pid = dist.get_rank()
    tel = Telemetry(
        MetricsRegistry(enabled=metrics, reservoir=reservoir),
        Tracer(enabled=trace, pid=int(pid), max_events=max_events))
    _CURRENT = tel
    return tel


def disable() -> None:
    """Return the process to the shared inert pair."""
    global _CURRENT
    _CURRENT = _DISABLED


# ------------------------------------------------------------------- #
# per-engine-step phase recording
# ------------------------------------------------------------------- #
class _Phase:
    __slots__ = ("rec", "name", "args", "t0")

    def __init__(self, rec: "StepRecorder", name: str, args):
        self.rec = rec
        self.name = name
        self.args = args

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        rec = self.rec
        rec.phases[self.name] = rec.phases.get(self.name, 0.0) + dur
        rec.tel.tracer.complete(self.name, self.t0, dur, tid=0,
                                cat="phase", args=self.args)
        return False


class NullRecorder:
    """The inert recorder the un-traced step body and stream path run
    against."""
    __slots__ = ()
    phases: dict = {}

    def phase(self, name: str, **args):
        return NULL_SPAN

    def span(self, name: str, **args):
        return NULL_SPAN


NULL_RECORDER = NullRecorder()


class SpanRecorder:
    """Spans of one category on one device (:meth:`Tracer.span`)."""
    __slots__ = ("tracer", "device", "cat")

    def __init__(self, tracer: Tracer, device, cat: str):
        self.tracer = tracer
        self.device = device
        self.cat = cat

    def span(self, name: str, **args):
        return self.tracer.span(name, device=self.device, cat=self.cat,
                                args=args)


class StepRecorder:
    __slots__ = ("tel", "tags", "phases")

    def __init__(self, tel: Telemetry, tags: Optional[dict] = None):
        self.tel = tel
        self.tags = tags or {}
        self.phases: dict = {}

    def phase(self, name: str, **args):
        """Bracket one named phase of the step; re-entering a name
        accumulates (``device_step`` runs once per payload key)."""
        return _Phase(self, name, args or None)

    def close(self, t0: float, *, emitted: int, step: int,
              idle: bool = False) -> None:
        """Emit the enclosing step span + metrics. The span covers
        everything since ``t0``, so Σ phase durations ≈ step duration
        (the --selftest tolerance check)."""
        dur = time.perf_counter() - t0
        args = dict(self.tags)
        args["emitted"] = emitted
        if idle:
            args["idle"] = True
        self.tel.tracer.complete("engine.step", t0, dur, tid=0,
                                 cat="step", args=args)
        m = self.tel.metrics
        m.histogram("engine.step_s").record(dur)
        for name, p_dur in self.phases.items():
            m.histogram("engine.phase_s", phase=name).record(p_dur)
