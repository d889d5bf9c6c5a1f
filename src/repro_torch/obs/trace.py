"""Span tracer emitting Chrome/Perfetto trace-event JSON.

Port copy of ``repro.obs.trace``: the same plain Python (it imports
no JAX, but ``repro``'s package does, so ``repro_torch`` keeps its
own copy).

One :class:`Tracer` per process accumulates events host-side (no
I/O until ``write``) and serializes the Trace Event Format that
``chrome://tracing`` and https://ui.perfetto.dev load directly:

  * complete spans (``ph: "X"`` with ``pid/tid/ts/dur``) — engine
    steps and their phases on the engine track (tid 0), per-request
    lane-resident spans on one track per lane;
  * async spans (``ph: "b"/"e"`` keyed by request uid) — the full
    submit → done request lifetime, queueing included, which may
    overlap arbitrarily across lanes;
  * instants (``ph: "i"``) — HA membership changes, takeovers,
    recalibrations, reprograms: the control-plane events on the same
    timeline as the data plane that felt them.

Timestamps are ``time.perf_counter`` seconds relative to the tracer's
epoch, in microseconds (the format's unit). All recording methods are
no-ops when ``enabled=False``; the event buffer is bounded
(``max_events``), dropping newest-first with an exact drop counter —
a tracer never becomes the memory leak it exists to find.

Two readers of the recorded events are the port's own:
:func:`phase_breakdown` (the step-phase sums the telemetry selftest and
``chip_smoke.py`` print) and :func:`trace_ok` (a written trace's schema,
nesting and async pairing).
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

# track (tid) layout: 0 = engine steps/phases; lanes start here
LANE_TID_BASE = 100


class Tracer:
    def __init__(self, *, enabled: bool = True, pid: int = 0,
                 max_events: int = 500_000):
        self.enabled = bool(enabled)
        self.pid = int(pid)
        self.max_events = int(max_events)
        self.dropped = 0
        self.t0 = time.perf_counter()
        self._events: List[Dict[str, Any]] = []

    # ---------------- clock ---------------------------------------- #
    def ts_us(self, t_perf: float) -> float:
        """perf_counter seconds → trace microseconds (epoch-relative).
        Clamped at 0 so stamps taken before the tracer existed (e.g. a
        request submitted before telemetry was enabled) stay on the
        timeline."""
        return max(0.0, (t_perf - self.t0) * 1e6)

    def _append(self, ev: Dict[str, Any]) -> None:
        if len(self._events) >= self.max_events:
            self.dropped += 1
            return
        self._events.append(ev)

    # ---------------- recording ------------------------------------ #
    def complete(self, name: str, t_start: float, dur_s: float, *,
                 tid: int = 0, cat: str = "", args: Optional[dict] = None
                 ) -> None:
        """One complete span (``ph: "X"``); ``t_start`` is a
        perf_counter stamp, ``dur_s`` seconds."""
        if not self.enabled:
            return
        ev: Dict[str, Any] = {
            "name": name, "ph": "X", "cat": cat or "span",
            "pid": self.pid, "tid": int(tid),
            "ts": self.ts_us(t_start), "dur": max(0.0, dur_s * 1e6)}
        if args:
            ev["args"] = args
        self._append(ev)

    def instant(self, name: str, *, cat: str = "event",
                args: Optional[dict] = None, tid: int = 0,
                t: Optional[float] = None) -> None:
        """A zero-duration marker (``ph: "i"``, process scope)."""
        if not self.enabled:
            return
        ev: Dict[str, Any] = {
            "name": name, "ph": "i", "s": "p", "cat": cat,
            "pid": self.pid, "tid": int(tid),
            "ts": self.ts_us(time.perf_counter() if t is None else t)}
        if args:
            ev["args"] = args
        self._append(ev)

    def async_span(self, name: str, span_id, t_begin: float,
                   t_end: float, *, cat: str = "request",
                   args: Optional[dict] = None) -> None:
        """A begin/end pair (``ph: "b"``/``"e"``) for spans that
        overlap freely — request lifetimes across lanes."""
        if not self.enabled:
            return
        sid = str(span_id)
        begin: Dict[str, Any] = {
            "name": name, "ph": "b", "cat": cat, "id": sid,
            "pid": self.pid, "tid": 0, "ts": self.ts_us(t_begin)}
        if args:
            begin["args"] = args
        self._append(begin)
        self._append({"name": name, "ph": "e", "cat": cat, "id": sid,
                      "pid": self.pid, "tid": 0,
                      "ts": self.ts_us(t_end)})

    def request_span(self, st, key=None) -> None:
        """Trace one finished request from its
        :class:`repro_torch.serving.engine.ItemRequestState` stamps: a
        lane-resident complete span (admit → done, on the lane's
        track — lane occupancy never overlaps within a lane) plus an
        async submit → done lifetime span carrying the queueing
        delay."""
        if not self.enabled:
            return
        req = st.request
        args = {"uid": req.uid,
                "wait_ms": round(st.wait_s * 1e3, 3),
                "items": len(st.outputs),
                "admit_step": st.admit_step,
                "done_step": st.done_step}
        if key is not None:
            args["key"] = str(key)
        if st.t_first:
            args["first_item_ms"] = round(
                (st.t_first - req.t_submit) * 1e3, 3)
        self.complete("request", st.t_admit, st.t_done - st.t_admit,
                      tid=LANE_TID_BASE + st.slot, cat="request",
                      args=args)
        self.async_span("request", req.uid, req.t_submit, st.t_done,
                        args=args)

    # ---------------- export --------------------------------------- #
    def trace_events(self) -> List[Dict[str, Any]]:
        return list(self._events)

    def to_dict(self) -> dict:
        """The loadable trace object, with process/thread naming
        metadata so Perfetto labels the tracks."""
        tids = sorted({ev["tid"] for ev in self._events})
        meta: List[Dict[str, Any]] = [
            {"name": "process_name", "ph": "M", "pid": self.pid,
             "tid": 0, "args": {"name": f"repro host {self.pid}"}}]
        for tid in tids:
            label = "engine" if tid == 0 else \
                f"lane {tid - LANE_TID_BASE}"
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": self.pid, "tid": tid,
                         "args": {"name": label}})
        return {"traceEvents": meta + self._events,
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
            f.write("\n")
        return path


def phase_breakdown(events) -> dict:
    """Σ durations (µs) of the traced steps and of each step phase:
    ``{"steps": n, "step_us": total, "phases": {name: total}}``."""
    steps = [e for e in events if e.get("cat") == "step"]
    phases = {}
    for e in events:
        if e.get("cat") == "phase":
            phases[e["name"]] = phases.get(e["name"], 0.0) + e["dur"]
    return {"steps": len(steps), "step_us": sum(e["dur"] for e in steps),
            "phases": phases}


def trace_ok(doc: dict, n_requests: int) -> bool:
    """A written Chrome trace is schema-valid: every complete span has
    pid/tid/ts/dur and a name, every phase span nests inside a step
    span of its thread, and the async request begin/end events pair up
    (``n_requests`` of them)."""
    evs = doc.get("traceEvents", [])
    complete = [e for e in evs if e.get("ph") == "X"]
    schema = bool(complete) and all(
        isinstance(e.get("pid"), int) and isinstance(e.get("tid"), int)
        and isinstance(e.get("ts"), (int, float))
        and isinstance(e.get("dur"), (int, float)) and e.get("name")
        for e in complete)
    steps = [e for e in complete if e.get("cat") == "step"]
    nested = all(
        any(st["pid"] == p["pid"] and st["tid"] == p["tid"] and
            st["ts"] - 1e-3 <= p["ts"] and
            p["ts"] + p["dur"] <= st["ts"] + st["dur"] + 1e-3
            for st in steps)
        for p in complete if p.get("cat") == "phase")
    begins = sorted(e["id"] for e in evs if e.get("ph") == "b")
    ends = sorted(e["id"] for e in evs if e.get("ph") == "e")
    return schema and nested and begins == ends and \
        len(begins) == n_requests
