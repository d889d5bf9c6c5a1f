"""The device trace of a traced window, reduced to what the per-layer
metrics read.

``torch.profiler`` (CUPTI) records the card's kernels and copies and the
host's operations while the window runs inside the range
``portbench.window``. Its raw events are reduced once, here (ranges the
profiler mirrors onto the device's timeline are not device work): device time
and launches by operation name, the union of the card's busy intervals
within the window, and the longest idle gaps, each named by the
innermost host operation that was running at the gap's middle. The
readers in ``metrics/`` classify operation names themselves.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

WINDOW_SPAN = "portbench.window"
# the card's copies and fills, by the names CUPTI gives them
COPY_PREFIXES = ("Memcpy", "Memset")


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    ops: Dict[str, Tuple[int, float]]      # name → (launches, seconds)
    gaps: List[Tuple[str, float]]          # longest idle gaps, longest first

    def seconds(self, pick: Callable[[str], bool]) -> float:
        return sum(s for name, (_, s) in self.ops.items() if pick(name))

    def count(self, pick: Callable[[str], bool]) -> int:
        return sum(n for name, (n, _) in self.ops.items() if pick(name))


def is_copy(name: str) -> bool:
    return name.startswith(COPY_PREFIXES)


def summarize(device: Sequence[Tuple[str, int, int]],
              host: Sequence[Tuple[str, int, int]],
              n_gaps: int = 10) -> TraceSummary:
    """``device`` and ``host``: (name, start ns, end ns) events. The
    window is the host range named :data:`WINDOW_SPAN`; device events
    are clipped to it."""
    spans = [(s, e) for name, s, e in host if name == WINDOW_SPAN]
    if len(spans) != 1:
        raise ValueError(f"the trace holds {len(spans)} window ranges")
    w0, w1 = spans[0]
    ops: Dict[str, List[float]] = {}
    iv = []
    for name, s, e in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        rec = ops.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += (e - s) * 1e-9
        iv.append((s, e))
    iv.sort()
    busy_ns, gaps, cur = 0, [], w0
    for s, e in iv:
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy_ns += e - max(s, cur)
            cur = e
    if w1 > cur:
        gaps.append((cur, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    gaps = gaps[:n_gaps]
    named = []
    if gaps:
        inner = [(name, s, e) for name, s, e in host if name != WINDOW_SPAN]
        hs = np.array([s for _, s, _ in inner], dtype=np.int64)
        he = np.array([e for _, _, e in inner], dtype=np.int64)
        for g0, g1 in gaps:
            mid = (g0 + g1) // 2
            hit = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = "(no host operation)"
            if hit.size:
                name = inner[int(hit[np.argmax(hs[hit])])][0]
            named.append((name, (g1 - g0) * 1e-9))
    return TraceSummary((w1 - w0) * 1e-9, busy_ns * 1e-9,
                        {k: (int(v[0]), v[1]) for k, v in ops.items()},
                        named)


def capture(fn: Callable[[], object]):
    """Run ``fn`` under the profiler inside the window range; returns
    (its result, the :class:`TraceSummary`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            result = fn()
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        rec = (e.name(), s, s + e.duration_ns())
        if e.device_type() != DeviceType.CUDA:
            host.append(rec)
        elif not _annotation(e):
            device.append(rec)
    return result, summarize(device, host)


def _annotation(e) -> bool:
    """A host range mirrored onto the device's timeline: no device work."""
    ann = getattr(e, "is_user_annotation", None)
    return (ann is not None and ann()) or e.name() == WINDOW_SPAN
