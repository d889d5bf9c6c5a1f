"""Continuous-batching serving: the slot-scheduled streaming engine.

Port of the item-stream half of ``repro.serving.engine``: the generic
slot-scheduled streaming contract (:class:`StreamingEngine` /
:class:`SlotScheduler`) — a fixed pool of lanes, arriving requests
admitted into free lanes without stalling others, ONE batched step for
all active lanes per engine step, lanes retiring the moment their
request completes — and the item-stream schedulers the compiled chip
plugs into (:class:`KeyedItemStreamScheduler`,
:class:`ItemStreamScheduler`), and the dense transformer's greedy decode
:class:`Engine`. The scheduler is plain Python and numpy; the batched
payload step (``_stream_batch``, or one batched decode) is where the
device work happens.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Protocol, \
    runtime_checkable

import numpy as np
import torch

from repro_torch.models import model as model_lib
from repro_torch.obs.core import NULL_RECORDER, StepRecorder
from repro_torch.obs.core import current as _obs_current
from repro_torch.obs.metrics import DEFAULT_RESERVOIR, Reservoir
from repro_torch.serving import kvcache


# --------------------------------------------------------------------- #
# the generic streaming contract
# --------------------------------------------------------------------- #
@runtime_checkable
class StreamingEngine(Protocol):
    """What it means to serve a stream: submit requests, step the whole
    active set as one batch, drain. Any engine exposing this contract
    plugs into the same driver loops / examples / benchmarks."""

    slots: int

    def submit(self, request) -> bool: ...

    def step(self) -> int:
        """Admit waiting requests and advance every active lane one
        item. Returns the number of items emitted."""
        ...

    def run_until_drained(self, max_steps: int = 10_000) -> List: ...


class SlotScheduler:
    """Slot bookkeeping shared by every StreamingEngine here.

    Subclasses implement the payload hooks:
      _begin(request, slot) -> state   admit one request into a lane
      _step_active() -> int            one batched step over ``active``
      _done(state) -> bool             has this lane's request finished?
      _release(state)                  free lane-held resources
      _on_finish(state)                observe a lane retiring

    Lane states must expose ``.slot`` and a writable ``.finished``.

    ``queue_limit`` bounds the admission queue: once ``queue_limit``
    requests are waiting, ``submit`` returns False instead of enqueuing
    — the backpressure signal a bounded upstream source
    (a bounded sensor feed) needs to stop producing. The default
    (None) keeps the historic unbounded behavior.

    ``step_when_idle`` makes ``step()`` run ``_step_active`` even with
    no active lane. A single-process engine never wants this (an idle
    step is wasted work), but a lockstep engine over a multi-process
    fleet (:class:`repro_torch.fleet.DistributedFleetRouter`) steps on
    every rank together, so that every rank counts the same steps — a
    locally idle rank that skipped its steps would fall out of step
    with the ranks that still have traffic.
    """

    def __init__(self, slots: int, *, queue_limit: Optional[int] = None,
                 step_when_idle: bool = False):
        self.slots = slots
        self.queue_limit = queue_limit
        self.step_when_idle = step_when_idle
        self.free: Deque[int] = deque(range(slots))
        self.active: Dict[int, Any] = {}       # slot -> state
        self.queue: Deque[Any] = deque()
        self.finished: List[Any] = []
        self.steps = 0                  # engine steps that did work
        self.items_emitted = 0          # Σ items over all steps
        self.rejected = 0               # submits refused by queue_limit

    # ---------------- request lifecycle ---------------------------- #
    def submit(self, request) -> bool:
        """Enqueue a request; False = queue full (admission control)."""
        if self.queue_limit is not None and \
                len(self.queue) >= self.queue_limit:
            self.rejected += 1
            return False
        self.queue.append(request)
        return True

    def _admit(self) -> None:
        while self.queue and self.free:
            req = self.queue.popleft()
            slot = self.free.popleft()
            st = self._begin(req, slot)
            self.active[slot] = st
            self._maybe_finish(st)

    def _maybe_finish(self, st) -> None:
        if self._done(st) and not st.finished:
            st.finished = True
            self.finished.append(st)
            del self.active[st.slot]
            self._release(st)
            self.free.append(st.slot)
            self._on_finish(st)

    # ---------------- one engine step ------------------------------ #
    def step(self) -> int:
        """Backfill free lanes from the queue, then advance every
        active lane one item. Returns the number of items emitted.

        With process telemetry configured (:mod:`repro_torch.obs`) the step
        is bracketed as a traced span split into named phases; the
        disabled path is one global read + bool check."""
        tel = _obs_current()
        if tel.active:
            return self._step_traced(tel)
        self._admit()
        if not self.active and not self.step_when_idle:
            return 0
        emitted = self._step_active()
        self.steps += 1
        self.items_emitted += emitted
        return emitted

    def _step_traced(self, tel) -> int:
        """The instrumented step body: identical bookkeeping to
        :meth:`step`, with the admit phase and the active-set phases
        (see :meth:`_step_active_observed`) recorded so Σ phase
        durations tiles the step span."""
        rec = StepRecorder(tel, self._obs_tags())
        t0 = time.perf_counter()
        with rec.phase("admit"):
            self._admit()
        idle = not self.active and not self.step_when_idle
        emitted = 0
        if not idle:
            emitted = self._step_active_observed(rec)
            self.steps += 1
            self.items_emitted += emitted
            m = tel.metrics
            m.counter("engine.steps").inc()
            m.counter("engine.items").inc(emitted)
            m.gauge("engine.active_lanes").set(len(self.active))
            m.gauge("engine.queue_depth").set(len(self.queue))
        rec.close(t0, emitted=emitted, step=self.steps, idle=idle)
        return emitted

    def _step_active_observed(self, rec) -> int:
        """Hook for phase-split step tracing: the base scheduler has
        no payload structure to split, so the whole active-set step is
        one ``active`` phase (the keyed scheduler overrides this with
        dispatch/device_step/gather/finish)."""
        with rec.phase("active"):
            return self._step_active()

    def _obs_tags(self) -> Dict[str, Any]:
        """Static-ish span tags; routers override to add
        chip/lane/app/host identity."""
        return {"engine": type(self).__name__, "lanes": self.slots}

    def run_until_drained(self, max_steps: int = 10_000) -> List:
        steps = 0
        while (self.queue or self.active) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    # ---------------- payload hooks -------------------------------- #
    def _begin(self, request, slot: int):
        raise NotImplementedError

    def _step_active(self) -> int:
        raise NotImplementedError

    def _done(self, st) -> bool:
        raise NotImplementedError

    def _release(self, st) -> None:
        pass

    def _on_finish(self, st) -> None:
        pass


# --------------------------------------------------------------------- #
# the generic item-stream engine (chips, sharded fleets, ...)
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class ItemRequest:
    """A stream of items: (n_items, d_in) float array (a single
    (d_in,) item is promoted to a 1-item stream).

    ``key`` names the payload stream this request belongs to on a
    payload-keyed scheduler (``repro.deploy`` tags it with the app
    name); ``None`` is the single anonymous stream every legacy engine
    schedules."""
    uid: int
    items: np.ndarray
    t_submit: float = 0.0               # stamped by submit()
    key: Any = None                     # payload stream (None = default)


@dataclasses.dataclass
class ItemRequestState:
    request: ItemRequest
    slot: int
    pos: int = 0                        # next item to feed
    outputs: List[np.ndarray] = dataclasses.field(default_factory=list)
    finished: bool = False
    # latency accounting (perf_counter seconds / engine step indices)
    t_admit: float = 0.0
    t_first: float = 0.0                # first item emitted
    t_done: float = 0.0
    admit_step: int = 0
    done_step: int = 0

    @property
    def result(self) -> np.ndarray:
        """(n_items, d_out) outputs in request order."""
        return np.stack(self.outputs) if self.outputs else \
            np.zeros((0, 0), np.float32)

    @property
    def wait_s(self) -> float:
        """Queueing delay: submit → admission into a lane."""
        return self.t_admit - self.request.t_submit

    @property
    def latency_s(self) -> float:
        """Submit → last item emitted."""
        return self.t_done - self.request.t_submit


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """One payload-keyed stream: its item width, lane budget and
    admission-queue bound (the per-tenant knobs ``repro.deploy`` maps
    an ``AppSpec`` onto)."""
    d_in: int
    lanes: int
    queue_limit: Optional[int] = None


def _key_label(key) -> str:
    """Render a stream key as a metrics label (None = the anonymous
    single stream)."""
    return "default" if key is None else str(key)


class KeyedItemStreamScheduler(SlotScheduler):
    """Slot-scheduled streaming of item sequences through one batched
    stream function *per payload key* per engine step.

    The slot pool is carved into contiguous per-key lane blocks
    (``streams``: an ordered ``{key: StreamSpec}``); a request is
    admitted only into a lane of ITS key's block, each key keeps its
    own admission budget (``StreamSpec.queue_limit``), and one engine
    step advances EVERY key's active lanes — each key's lanes gathered
    into one ``(lanes_key, d_in_key)`` batch and dispatched through
    ``_stream_batch_key(key, batch)``. Free lanes are zero-padded so
    every step runs each key's one compiled shape — no retracing as
    lanes retire.

    With a single anonymous stream this is exactly the historic
    single-payload scheduler (:class:`ItemStreamScheduler`, the facade
    the chip engine and fleet router subclass); with one stream per
    app it is the multi-tenant engine under
    :class:`repro.deploy.MultiAppRouter`.

    ``step_when_idle`` additionally pins the *dispatch schedule*: every
    key's stream function runs on every step, idle or not, in stream
    declaration order — the lockstep obligation of an SPMD fleet,
    where each key's batched step is a collective all ranks must enter
    identically.
    """

    def __init__(self, streams, *, step_when_idle: bool = False,
                 latency_reservoir: int = DEFAULT_RESERVOIR):
        self._streams: Dict[Any, StreamSpec] = dict(streams)
        if not self._streams:
            raise ValueError("KeyedItemStreamScheduler needs at least "
                             "one stream")
        for key, spec in self._streams.items():
            if spec.lanes < 1:
                raise ValueError(f"stream {key!r}: needs lanes >= 1")
        super().__init__(sum(s.lanes for s in self._streams.values()),
                         step_when_idle=step_when_idle)
        self._slot_key: Dict[int, Any] = {}
        self._base: Dict[Any, int] = {}
        self._batches: Dict[Any, np.ndarray] = {}
        self._queued: Dict[Any, int] = {}
        self.items_by_key: Dict[Any, int] = {}
        self.rejected_by_key: Dict[Any, int] = {}
        # bounded per-request latency/wait accounting: exact for runs
        # up to the reservoir size, uniform subsample after — what
        # RouterStats percentiles and the cross-host latency gathers
        # read, so a long serve cannot grow their memory or wire size
        self.latency_reservoir = int(latency_reservoir)
        self._lat_all = Reservoir(self.latency_reservoir)
        self._wait_all = Reservoir(self.latency_reservoir)
        self._lat_by_key: Dict[Any, Reservoir] = {}
        self._wait_by_key: Dict[Any, Reservoir] = {}
        base = 0
        for key, spec in self._streams.items():
            self._base[key] = base
            for slot in range(base, base + spec.lanes):
                self._slot_key[slot] = key
            self._batches[key] = np.zeros((spec.lanes, spec.d_in),
                                          np.float32)
            self._queued[key] = 0
            self.items_by_key[key] = 0
            self.rejected_by_key[key] = 0
            self._lat_by_key[key] = Reservoir(self.latency_reservoir)
            self._wait_by_key[key] = Reservoir(self.latency_reservoir)
            base += spec.lanes

    # ---------------- payload hook --------------------------------- #
    def _stream_batch_key(self, key, batch: np.ndarray) -> np.ndarray:
        """(lanes_key, d_in_key) → (lanes_key, d_out_key), one batched
        payload step for one stream."""
        raise NotImplementedError

    def _request_key(self, request):
        return getattr(request, "key", None)

    def _entry_key(self, entry):
        """Stream key of a queue entry — a fresh :class:`ItemRequest`
        OR an in-flight :class:`ItemRequestState` re-admitted by
        :meth:`requeue` (eviction/resize/failover put *states* back on
        the queue so their progress is preserved)."""
        if isinstance(entry, ItemRequestState):
            return self._request_key(entry.request)
        return self._request_key(entry)

    # ---------------- keyed admission ------------------------------ #
    def submit(self, request: ItemRequest) -> bool:
        """Enqueue a request on its key's stream; False = that stream's
        admission queue is full (per-tenant backpressure).

        ``t_submit`` is stamped BEFORE the admission check — a
        rejected request carries its arrival time, so rejection rates
        can be time-bucketed, and a later re-submit keeps the ORIGINAL
        stamp (latency is measured from first arrival, not from the
        retry that finally got in)."""
        if not request.t_submit:
            request.t_submit = time.perf_counter()
        key = self._request_key(request)
        spec = self._streams.get(key)
        if spec is None:
            raise ValueError(
                f"request {getattr(request, 'uid', '?')}: unknown "
                f"stream key {key!r} (streams: "
                f"{sorted(map(repr, self._streams))})")
        if spec.queue_limit is not None and \
                self._queued[key] >= spec.queue_limit:
            self.rejected += 1
            self.rejected_by_key[key] += 1
            tel = _obs_current()
            if tel.active:
                tel.metrics.counter("engine.rejected",
                                    key=_key_label(key)).inc()
            return False
        self.queue.append(request)
        self._queued[key] += 1
        return True

    def _admit(self) -> None:
        # FIFO per key, and across keys as far as lane availability
        # allows: a head-of-line request for a saturated key never
        # blocks another key's admission. Re-pass while progress is
        # made so a request that finishes AT admission (zero items)
        # frees its lane for the next queued request in the same
        # admit — the single-stream scheduler's historic behavior.
        progress = True
        while progress and self.queue and self.free:
            progress = False
            free_by_key: Dict[Any, Deque[int]] = {}
            for slot in self.free:
                free_by_key.setdefault(self._slot_key[slot],
                                       deque()).append(slot)
            waiting = list(self.queue)
            self.queue.clear()
            for idx, req in enumerate(waiting):
                key = self._entry_key(req)
                lanes = free_by_key.get(key)
                if not lanes:
                    self.queue.append(req)
                    continue
                slot = lanes.popleft()
                self.free.remove(slot)
                self._queued[key] -= 1
                try:
                    st = self._resume(req, slot) \
                        if isinstance(req, ItemRequestState) \
                        else self._begin(req, slot)
                except BaseException:
                    # a malformed request must cost only ITSELF: give
                    # its lane back and re-file the untouched tail so
                    # nothing behind it is dropped or phantom-counted
                    self.free.append(slot)
                    self.queue.extend(waiting[idx + 1:])
                    raise
                self.active[slot] = st
                self._maybe_finish(st)
                progress = True

    # ---------------- request lifecycle ---------------------------- #
    def _begin(self, req: ItemRequest, slot: int) -> ItemRequestState:
        items = np.asarray(req.items, np.float32)
        if items.ndim == 1:
            items = items[None, :]
        d_in = self._streams[self._slot_key[slot]].d_in
        if items.shape[-1] != d_in:
            raise ValueError(f"request {req.uid}: items have "
                             f"{items.shape[-1]} features, engine "
                             f"streams {d_in}")
        req.items = items
        return ItemRequestState(req, slot,
                                t_admit=time.perf_counter(),
                                admit_step=self.steps)

    def _resume(self, st: ItemRequestState, slot: int) -> ItemRequestState:
        """Re-admit an evicted in-flight state into a (possibly
        different) lane of its key's block: progress (``pos``),
        already-emitted ``outputs`` and the original admission stamps
        are preserved — nothing is re-streamed, latency stays measured
        from the ORIGINAL submit/admit."""
        st.slot = slot
        return st

    def _done(self, st: ItemRequestState) -> bool:
        return st.pos >= st.request.items.shape[0]

    def _on_finish(self, st: ItemRequestState) -> None:
        st.t_done = time.perf_counter()
        st.done_step = self.steps
        key = self._request_key(st.request)
        self._lat_all.add(st.latency_s)
        self._wait_all.add(st.wait_s)
        res = self._lat_by_key.get(key)
        if res is not None:
            res.add(st.latency_s)
            self._wait_by_key[key].add(st.wait_s)
        tel = _obs_current()
        if tel.active:
            label = _key_label(key)
            m = tel.metrics
            m.counter("engine.requests_finished", key=label).inc()
            m.histogram("request.latency_s", key=label).record(
                st.latency_s)
            m.histogram("request.wait_s", key=label).record(st.wait_s)
            tel.tracer.request_span(st, key)

    # ---------------- eviction / re-admission / live resize --------- #
    def evict_active(self) -> List[ItemRequestState]:
        """Detach every active lane's state, returning them slot-
        ordered (admission order within a key). Progress and outputs
        are preserved; the lanes go back to the free pool. The caller
        owns the states — :meth:`requeue` puts them back at the front
        of the admission queue (the degraded-mode / resize path)."""
        states = [self.active[slot] for slot in sorted(self.active)]
        self.active.clear()
        for st in states:
            self.free.append(st.slot)
        return states

    def requeue(self, entries) -> None:
        """Front-of-queue re-admission, BYPASSING the per-key queue
        limit: these entries were already admitted once (a resize's
        evicted lanes, a dead host's replayed frames) — bouncing them
        on a full queue would break the no-drop invariant. The queue
        may transiently exceed its bound; per-key budgets still count
        the overage, so fresh ``submit`` calls see backpressure until
        it drains. Accepts :class:`ItemRequest`s and in-flight
        :class:`ItemRequestState`s alike; order is preserved (first
        entry is admitted first)."""
        for entry in reversed(list(entries)):
            key = self._entry_key(entry)
            if key not in self._streams:
                raise ValueError(f"requeue: unknown stream key {key!r}")
            self.queue.appendleft(entry)
            self._queued[key] += 1

    def resize_streams(self, streams) -> List[ItemRequestState]:
        """Live lane-topology change (elastic resize / degraded mode):
        evict every active lane, rebuild the contiguous per-key lane
        blocks for the new ``{key: StreamSpec}``, and requeue the
        evicted states at the FRONT so they resume before anything
        queued behind them. Keys and item widths must match — a resize
        changes lane budgets, not what the streams compute. Counters
        (steps, items, finished, rejections) carry over: accounting
        survives the topology change. Returns the evicted states."""
        new = dict(streams)
        if set(new) != set(self._streams):
            raise ValueError(
                f"resize_streams: keys must match (have "
                f"{sorted(map(repr, self._streams))}, got "
                f"{sorted(map(repr, new))})")
        for key, spec in new.items():
            if spec.lanes < 1:
                raise ValueError(f"stream {key!r}: needs lanes >= 1")
            if spec.d_in != self._streams[key].d_in:
                raise ValueError(
                    f"stream {key!r}: cannot change d_in live "
                    f"({self._streams[key].d_in} -> {spec.d_in})")
        evicted = self.evict_active()
        self._streams = new
        self.slots = sum(s.lanes for s in new.values())
        self.free = deque(range(self.slots))
        self._slot_key.clear()
        self._base.clear()
        self._batches.clear()
        base = 0
        for key, spec in new.items():
            self._base[key] = base
            for slot in range(base, base + spec.lanes):
                self._slot_key[slot] = key
            self._batches[key] = np.zeros((spec.lanes, spec.d_in),
                                          np.float32)
            base += spec.lanes
        self.requeue(evicted)
        return evicted

    # ---------------- one keyed engine step ------------------------ #
    def _step_active(self) -> int:
        return self._run_step_active(NULL_RECORDER)

    def _step_active_observed(self, rec) -> int:
        return self._run_step_active(rec)

    def _run_step_active(self, rec) -> int:
        """One keyed step, bracketed into the traced phases: dispatch
        (scatter active lanes into per-key batches), device_step (one
        batched payload call per key — the device-bound part), gather
        (distribute outputs back to lane states), finish (retire
        completed lanes). ``rec`` is the per-step recorder, or the
        shared null recorder on the un-traced path."""
        with rec.phase("dispatch"):
            by_key: Dict[Any, list] = {}
            for slot, st in self.active.items():
                by_key.setdefault(self._slot_key[slot],
                                  []).append((slot, st))
            # idle keys still dispatch under step_when_idle (class doc)
            keys = list(self._streams) if self.step_when_idle else \
                [k for k in self._streams if k in by_key]
            for key in keys:
                batch = self._batches[key]
                batch[:] = 0.0
                base = self._base[key]
                for slot, st in by_key.get(key, ()):
                    batch[slot - base] = st.request.items[st.pos]
        outs = {}
        for key in keys:
            with rec.phase("device_step", key=_key_label(key)):
                outs[key] = np.asarray(
                    self._stream_batch_key(key, self._batches[key]))
        now = time.perf_counter()
        emitted = 0
        with rec.phase("gather"):
            for key in keys:
                out = outs[key]
                base = self._base[key]
                for slot, st in by_key.get(key, ()):
                    st.outputs.append(out[slot - base])
                    if st.pos == 0:
                        st.t_first = now
                    st.pos += 1
                    emitted += 1
                    self.items_by_key[key] += 1
        with rec.phase("finish"):
            for key in keys:
                for slot, st in by_key.get(key, ()):
                    self._maybe_finish(st)
        return emitted


class ItemStreamScheduler(KeyedItemStreamScheduler):
    """The single-payload facade over the keyed scheduler: one
    anonymous stream (key ``None``) spanning all ``slots`` lanes,
    advanced through one ``_stream_batch`` call per engine step — the
    historic contract the compiled chip
    (:class:`repro_torch.chip.ChipEngine`) and the sharded multi-chip fleet
    (:class:`repro_torch.fleet.FleetRouter`) plug into.
    """

    def __init__(self, d_in: int, *, slots: int = 4,
                 queue_limit: Optional[int] = None,
                 step_when_idle: bool = False,
                 latency_reservoir: int = DEFAULT_RESERVOIR):
        super().__init__({None: StreamSpec(d_in, slots, queue_limit)},
                         step_when_idle=step_when_idle,
                         latency_reservoir=latency_reservoir)
        self.d_in = d_in
        self.queue_limit = queue_limit
        self._batch = self._batches[None]

    def resize_streams(self, streams) -> List[ItemRequestState]:
        evicted = super().resize_streams(streams)
        self._batch = self._batches[None]       # refresh the alias
        return evicted

    def resize_slots(self, slots: int) -> List[ItemRequestState]:
        """Live lane-count change for the anonymous stream (see
        :meth:`KeyedItemStreamScheduler.resize_streams`)."""
        return self.resize_streams(
            {None: StreamSpec(self.d_in, slots, self.queue_limit)})

    def _stream_batch(self, batch: np.ndarray) -> np.ndarray:
        """(slots, d_in) → (slots, d_out), one batched payload step."""
        raise NotImplementedError

    def _stream_batch_key(self, key, batch: np.ndarray) -> np.ndarray:
        return self._stream_batch(batch)


# --------------------------------------------------------------------- #
# the transformer decode engine
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: int = -1            # -1: never; stop on max_new_tokens


@dataclasses.dataclass
class RequestState:
    request: Request
    slot: int
    pos: int                    # next position to write
    generated: List[int] = dataclasses.field(default_factory=list)
    prefill_s: float = 0.0
    finished: bool = False


def greedy(logits: torch.Tensor, generator: torch.Generator
           ) -> torch.Tensor:
    """The default sampler: argmax, the first index on ties."""
    return torch.argmax(logits, dim=-1)


class Engine(SlotScheduler):
    """Continuous-batching greedy decode of a language model of any
    family: one B = 1 prefill a request at admission, written into its
    lane of the cache (``kvcache.write_slot`` at the stack's
    ``cache_axes``: attention rings and recurrent states alike), then
    ONE batched per-slot decode over every lane a step (idle lanes
    decode junk that position masking ignores and the next admit
    overwrites). Runs where ``params`` live. ``sampler(logits,
    generator)`` picks each lane's next token (default: greedy).

    Unlike the reference's engine (ROADMAP R12), each hybrid or xLSTM
    lane keeps its own request's state."""

    def __init__(self, cfg, params, *, slots: int = 4,
                 cache_len: int = 256,
                 sampler: Optional[Callable] = None):
        super().__init__(slots)
        self.cfg = cfg.replace(decode_per_slot=True)
        self.params = params
        self.device = params["final_norm"].device
        self.cache_len = cache_len
        self.sampler = sampler or greedy
        self.cache = model_lib.init_cache(self.cfg, slots, cache_len,
                                          device=self.device)
        self.axes = model_lib.cache_axes(self.cfg)
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        # per-lane scratch (host-side; tiny)
        self._next_tok = np.zeros((slots,), np.int32)
        self._pos = np.zeros((slots,), np.int32)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        return self.sampler(logits, self.generator).cpu().numpy() \
            .astype(np.int32)

    # ---------------- scheduler hooks ------------------------------ #
    def _begin(self, req: Request, slot: int) -> RequestState:
        t0 = time.perf_counter()
        logits, one_cache = model_lib.prefill(
            self.cfg, self.params, {"tokens": [list(req.prompt)]})
        first = int(self._sample(logits)[0])
        kvcache.write_slot(self.cache, one_cache, slot, self.axes)
        st = RequestState(req, slot, pos=len(req.prompt),
                          generated=[first],
                          prefill_s=time.perf_counter() - t0)
        self._next_tok[slot] = first
        self._pos[slot] = st.pos
        return st

    def _done(self, st: RequestState) -> bool:
        return len(st.generated) >= st.request.max_new_tokens or \
            (bool(st.generated) and
             st.generated[-1] == st.request.eos_id)

    def _release(self, st: RequestState) -> None:
        kvcache.clear_slot(self.cache, st.slot, self.axes)

    def _step_active(self) -> int:
        """ONE batched decode for all active lanes, each at its own
        position. Returns the number of tokens emitted."""
        logits, self.cache = model_lib.decode_step(
            self.cfg, self.params, self.cache, self._next_tok[:, None],
            self._pos)
        nxt = self._sample(logits)
        emitted = 0
        for slot, st in list(self.active.items()):
            st.generated.append(int(nxt[slot]))
            st.pos += 1
            self._next_tok[slot] = int(nxt[slot])
            self._pos[slot] = st.pos
            emitted += 1
            self._maybe_finish(st)
        return emitted
