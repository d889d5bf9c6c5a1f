"""Span tracer emitting Chrome/Perfetto trace-event JSON.

Port of ``repro.obs.trace`` (``repro``'s package imports JAX, so
``repro_torch`` keeps its own), with spans timed on the card.

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

:meth:`Tracer.span` brackets work that may run on the card: beside the
host stamps, a pair of timing CUDA events from a pool brackets the
work on the device's current stream, and the pair's elapsed time lands
in the span's ``args.device_ms`` once the card has passed both events
— found lazily, with no synchronise on the recording path
(:meth:`Tracer.resolve_device_times` after the caller's own). Spans
nest: each carries its id (``args.span``), its parent's
(``args.parent``) and its root's (``args.call``).

The tracer's clock anchor (a ``perf_counter_ns`` / ``time_ns`` pair
taken back to back) maps its timestamps onto the Unix-epoch
nanoseconds ``torch.profiler``'s events carry (:meth:`Tracer.unix_ns`,
and ``otherData.clock`` of a written trace), so a trace of the program
and a profile of the card lay on one timeline.

Two readers of the recorded events are the port's own:
:func:`phase_breakdown` (the step-phase sums the telemetry selftest and
``chip_smoke.py`` print) and :func:`trace_ok` (a written trace's schema,
nesting and async pairing).
"""
from __future__ import annotations

import collections
import itertools
import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

# track (tid) layout: 0 = engine steps/phases; lanes start here
LANE_TID_BASE = 100
# back-to-back clock reads the anchor keeps the tightest of
ANCHOR_TRIES = 16


def clock_anchor() -> Tuple[int, int, int]:
    """(``perf_counter_ns``, ``time_ns``, error ns): the Unix time read
    between two monotonic reads, the tightest of ``ANCHOR_TRIES``
    pairs; the monotonic stamp is the pair's midpoint and the error
    half its width."""
    best = None
    for _ in range(ANCHOR_TRIES):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[2]:
            best = ((a + b) // 2, u, b - a)
    perf, unix, width = best
    return perf, unix, width // 2


class _NullSpan:
    """The inert span: what every recorder hands out with tracing off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass


NULL_SPAN = _NullSpan()


class _Span:
    """One live span (:meth:`Tracer.span`)."""
    __slots__ = ("tracer", "name", "cat", "args", "device", "t0", "pair",
                 "stream")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict,
                 device):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.device = device
        self.pair = None

    def set(self, **args) -> None:
        """Add to the span's args (e.g. what is known only at its end)."""
        self.args.update(args)

    def __enter__(self):
        tr = self.tracer
        stack = tr._open_spans()
        sid = next(tr._ids)
        args = self.args
        args["span"] = sid
        if stack:
            parent = stack[-1].args
            args["parent"] = parent["span"]
            args["call"] = parent["call"]
        else:
            args["call"] = sid
        stack.append(self)
        self.t0 = time.perf_counter()
        dev = self.device
        if dev is not None and dev.type == "cuda":
            self.stream = torch.cuda.current_stream(dev)
            self.pair = tr._take_pair(self.stream)
            if self.pair is not None:
                self.pair[0].record(self.stream)
        return self

    def __exit__(self, *exc):
        tr = self.tracer
        if self.pair is not None:
            self.pair[1].record(self.stream)
        dur = time.perf_counter() - self.t0
        stack = tr._open_spans()
        stack.pop()
        ev = {"name": self.name, "ph": "X", "cat": self.cat,
              "pid": tr.pid, "tid": 0, "ts": tr.ts_us(self.t0),
              "dur": dur * 1e6, "args": self.args}
        kept = tr._append(ev)
        if self.pair is not None:
            tr._settle(ev if kept else None, self.pair)
        if not stack:
            tr._poll()
        return False


class Tracer:
    def __init__(self, *, enabled: bool = True, pid: int = 0,
                 max_events: int = 500_000):
        self.enabled = bool(enabled)
        self.pid = int(pid)
        self.max_events = int(max_events)
        self.dropped = 0
        # spans that got no event pair (the budget was spent)
        self.dropped_device = 0
        self.t0 = time.perf_counter()
        self.clock = clock_anchor()
        self._events: List[Dict[str, Any]] = []
        self._ids = itertools.count(1)
        self._local = threading.local()
        # (event or None, (start, end, device index)) in the order the
        # ends were recorded; idle pairs by device index
        self._pending: collections.deque = collections.deque()
        self._free: Dict[int, list] = {}
        self._lock = threading.Lock()

    # ---------------- clock ---------------------------------------- #
    def ts_us(self, t_perf: float) -> float:
        """perf_counter seconds → trace microseconds (epoch-relative).
        Clamped at 0 so stamps taken before the tracer existed (e.g. a
        request submitted before telemetry was enabled) stay on the
        timeline."""
        return max(0.0, (t_perf - self.t0) * 1e6)

    def unix_ns(self, ts_us: float) -> int:
        """A trace timestamp (µs from the tracer's epoch) → Unix-epoch
        nanoseconds, the clock of ``torch.profiler``'s events."""
        perf, unix, _ = self.clock
        return unix + round(self.t0 * 1e9 + ts_us * 1e3) - perf

    def _append(self, ev: Dict[str, Any]) -> bool:
        if len(self._events) >= self.max_events:
            self.dropped += 1
            return False
        self._events.append(ev)
        return True

    # ---------------- spans with device time ----------------------- #
    def span(self, name: str, *, device=None, cat: str = "span",
             args: Optional[dict] = None):
        """A context manager that records one complete span around its
        body (on the engine track, tid 0), nested under the span open on
        this thread. On a CUDA
        ``device`` a pair of timing events brackets the body on the
        device's current stream; their elapsed ms become
        ``args.device_ms`` once the card has passed them. That is the
        card's time from the body's first queued work to its last: the
        body's own work where the host runs ahead of the card, plus the
        card's waits for the body's launches where the host paces it."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, cat, dict(args or ()), device)

    def _open_spans(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _take_pair(self, stream):
        """An idle event pair of ``stream``'s device, or None when
        pending pairs and events have spent ``max_events``."""
        idx = stream.device_index
        with self._lock:
            free = self._free.setdefault(idx, [])
            if free:
                return free.pop()
            if len(self._events) + len(self._pending) >= self.max_events:
                self.dropped_device += 1
                return None
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True), idx)

    def _settle(self, ev, pair) -> None:
        with self._lock:
            self._pending.append((ev, pair))

    def _resolve(self, ev, pair) -> None:
        start, end, idx = pair
        if ev is not None:
            ev["args"]["device_ms"] = start.elapsed_time(end)
        self._free[idx].append(pair)

    def _poll(self) -> None:
        """Resolve the pending pairs the card has passed, oldest first,
        up to the first it has not; waits for nothing."""
        with self._lock:
            pending = self._pending
            while pending and pending[0][1][1].query():
                self._resolve(*pending.popleft())

    def resolve_device_times(self) -> int:
        """Resolve every pending pair the card has passed (call after a
        synchronise to resolve them all); returns how many are left."""
        with self._lock:
            left = collections.deque()
            for ev, pair in self._pending:
                if pair[1].query():
                    self._resolve(ev, pair)
                else:
                    left.append((ev, pair))
            self._pending = left
            return len(left)

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
        metadata so Perfetto labels the tracks; device times the card
        has finished are resolved first (nothing is waited for)."""
        self.resolve_device_times()
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
        perf, unix, err = self.clock
        return {"traceEvents": meta + self._events,
                "displayTimeUnit": "ms",
                "otherData": {
                    "dropped_events": self.dropped,
                    "dropped_device_times": self.dropped_device,
                    # ts µs → Unix ns: epoch_unix_ns + 1000 · ts
                    "clock": {"epoch_unix_ns": self.unix_ns(0.0),
                              "perf_counter_ns": perf, "unix_ns": unix,
                              "error_ns": err}}}

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
