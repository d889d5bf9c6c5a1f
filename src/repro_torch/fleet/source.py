"""Sensor-stream frontends: bounded request sources with backpressure.

Port of ``repro.fleet.source``. The paper's chips "process data
directly from sensors" — items arrive continuously at the TSV
interface, they are not pre-staged in host memory. This module models
that regime for the fleet router: a *source* turns a deterministic
``repro_torch.data`` pipeline (e.g.
:class:`repro_torch.data.SensorPipeline`, whose batches are pure
functions of ``(seed, step)``) into a stream of :class:`ItemRequest`s
through a bounded queue. Each batch becomes a host-side numpy request
as soon as it is made; the router stages it to the card. ``pump()``
produces only while the queue has room, so a slow consumer stalls
production (backpressure) instead of buffering the whole stream; a
checkpoint of the source is just the pipeline step already produced.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Deque, Optional

import numpy as np

from repro_torch.serving.engine import ItemRequest


class BoundedQueue:
    """A fixed-capacity FIFO: ``offer`` returns False when full (the
    producer's backpressure signal), ``poll`` returns None when empty."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("BoundedQueue needs capacity >= 1")
        self.capacity = capacity
        self._q: Deque[Any] = deque()

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self):
        return iter(self._q)

    @property
    def full(self) -> bool:
        return len(self._q) >= self.capacity

    @property
    def empty(self) -> bool:
        return not self._q

    def offer(self, item) -> bool:
        if self.full:
            return False
        self._q.append(item)
        return True

    def requeue(self, item) -> None:
        """Front-of-queue re-admission, ALWAYS accepted: the item was
        already admitted once (it is being put back, not produced), so
        refusing it on a full queue would drop it. The queue may
        transiently exceed ``capacity``; ``full`` then stays True, so
        the overage is paid by the PRODUCER stalling (``offer``
        refusing) — never charged against the admission budget twice."""
        self._q.appendleft(item)

    def peek(self):
        return self._q[0] if self._q else None

    def poll(self):
        return self._q.popleft() if self._q else None


class StreamSource:
    """Adapt a ``(seed, step)``-pure pipeline into a bounded request
    stream.

    ``pipeline`` needs one method, ``batch(step) -> (n, d) array``;
    each pipeline step becomes one request of ``n`` items (for
    :class:`repro_torch.data.SensorPipeline`, one sensor frame's windows —
    the granularity at which a frame grabber would hand data over).
    ``n_requests`` bounds the stream (None = endless); ``capacity``
    bounds the staging queue, and is the knob that trades frontend
    memory against the router's ability to backfill.

    ``start_step``/``step_stride`` deal the pipeline's step axis out:
    a source at ``(start_step=h, step_stride=H)`` produces steps
    h, h+H, h+2H, … — how a fleet of ``H`` hosts splits ONE logical
    sensor stream into disjoint per-host feeds (:meth:`for_host`).
    Because a batch is a pure function of ``(seed, step)``, any host —
    or a post-mortem — can replay any other host's exact feed from the
    two integers, which is what makes the distributed stream checkable
    against the single-chip stream without moving data between hosts.
    """

    def __init__(self, pipeline, *, n_requests: Optional[int] = 16,
                 capacity: int = 8, start_step: int = 0,
                 step_stride: int = 1, uid_base: int = 0):
        if step_stride < 1:
            raise ValueError("StreamSource: step_stride must be >= 1")
        self.pipeline = pipeline
        self.n_requests = n_requests
        self.queue = BoundedQueue(capacity)
        self.next_step = start_step
        self.step_stride = step_stride
        self.uid_base = uid_base
        self.produced = 0
        self.taken = 0
        self.stalls = 0                 # pump calls stopped by a full queue

    @classmethod
    def for_host(cls, pipeline, *, host: Optional[int] = None,
                 hosts: Optional[int] = None,
                 n_requests: Optional[int] = 16, capacity: int = 8,
                 uid_stride: int = 1_000_000) -> "StreamSource":
        """This host's share of one logical stream: host ``h`` of ``H``
        takes pipeline steps h, h+H, h+2H, … and uids starting at
        ``h × uid_stride`` (globally unique without coordination).
        ``host``/``hosts`` default to this process's ``torch.distributed``
        rank and world size when a process group is initialised, else
        to 0 and 1, so every rank constructing
        ``StreamSource.for_host(pipe)`` gets a disjoint, exactly
        replayable feed."""
        if host is None or hosts is None:
            import torch.distributed as dist
            grouped = dist.is_available() and dist.is_initialized()
            if host is None:
                host = dist.get_rank() if grouped else 0
            if hosts is None:
                hosts = dist.get_world_size() if grouped else 1
        if not 0 <= host < hosts:
            raise ValueError(f"StreamSource.for_host: host {host} not "
                             f"in [0, {hosts})")
        return cls(pipeline, n_requests=n_requests, capacity=capacity,
                   start_step=host, step_stride=hosts,
                   uid_base=host * uid_stride)

    # ---------------- producer side -------------------------------- #
    @property
    def dry(self) -> bool:
        """Production budget spent (queue may still hold requests)."""
        return self.n_requests is not None and \
            self.produced >= self.n_requests

    @property
    def exhausted(self) -> bool:
        return self.dry and self.queue.empty

    def pump(self) -> int:
        """Produce requests until the queue is full or the stream is
        dry. Returns how many were produced; a stop due to a full
        queue is counted as a stall (the backpressure event)."""
        made = 0
        while not self.dry:
            if self.queue.full:
                self.stalls += 1
                break
            items = np.asarray(self.pipeline.batch(self.next_step),
                               np.float32)
            self.queue.offer(ItemRequest(
                uid=self.uid_base + self.produced, items=items))
            self.next_step += self.step_stride
            self.produced += 1
            made += 1
        return made

    def requeue(self, requests) -> None:
        """Put already-produced requests back at the FRONT of the
        staging queue (first element ends up first): the failover path
        re-admitting a dead host's in-flight frames, or a consumer
        handing back work it could not place. Requeued requests do not
        touch ``produced``/``n_requests`` — the production budget was
        spent when they were first made (a takeover's replayed frames
        were the dead host's budget, not this source's) — and they
        may push the queue over ``capacity``: ``pump`` then stalls
        until the overage drains, so backpressure is preserved without
        double-charging admission."""
        for req in reversed(list(requests)):
            self.queue.requeue(req)

    # ---------------- consumer side -------------------------------- #
    def peek(self) -> Optional[ItemRequest]:
        return self.queue.peek()

    def take(self) -> Optional[ItemRequest]:
        req = self.queue.poll()
        if req is not None:
            self.taken += 1
        return req
