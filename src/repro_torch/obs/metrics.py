"""Metrics registry: counters, gauges, bounded-reservoir histograms.

Port copy of ``repro.obs.metrics``: the same plain Python (it imports
no JAX, but ``repro``'s package does, so ``repro_torch`` keeps its
own copy).

The accounting layer under ``repro_torch.obs``: every serving component
(scheduler, router, chip, HA plane) records into ONE process-wide
registry (``repro_torch.obs.current().metrics``), and a registry
``snapshot()`` is a plain JSON-able dict — what the heartbeat board
publishes and what ``allgather_snapshots`` moves across hosts, so any
surviving rank can ``merge_snapshots`` the fleet-wide view.

Histograms are backed by a :class:`Reservoir`: exact count/sum/min/max
always, and the raw values kept EXACTLY up to ``cap`` samples — so
p50/p95/p99 over short runs are identical to percentiles of the raw
list — then deterministic Algorithm-R subsampling (a fixed seed, so a
seeded run reproduces bit-identically). The reservoir is also what
bounds :class:`repro_torch.fleet.RouterStats` latency memory and the
``allgather_latencies`` wire size over a long serve.

A registry constructed with ``enabled=False`` hands out a single
shared no-op instrument for every name — the disabled path is one
attribute check plus a dict hit, which is what lets the telemetry
hooks live permanently in the engine hot loop.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

DEFAULT_RESERVOIR = 4096
_RESERVOIR_SEED = 0x0B5E_C0DE     # fixed: snapshots are reproducible


class Reservoir:
    """Bounded sample of a value stream with exact low-order moments.

    ``count``/``total``/``vmin``/``vmax`` are exact over everything
    ever recorded; ``values`` holds every sample while ``count <=
    cap`` (percentiles are then exact) and a uniform Algorithm-R
    subsample after (deterministic: the replacement RNG is seeded at
    construction)."""

    __slots__ = ("cap", "count", "total", "vmin", "vmax", "_values",
                 "_rng")

    def __init__(self, cap: int = DEFAULT_RESERVOIR):
        if cap < 1:
            raise ValueError("Reservoir: cap must be >= 1")
        self.cap = int(cap)
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self._values: List[float] = []
        self._rng = np.random.default_rng(_RESERVOIR_SEED)

    def add(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if len(self._values) < self.cap:
            self._values.append(v)
        else:
            # Algorithm R: keep a uniform cap-sized sample of the stream
            j = int(self._rng.integers(0, self.count))
            if j < self.cap:
                self._values[j] = v

    @property
    def values(self) -> np.ndarray:
        """The retained samples (ALL samples while ``count <= cap``)."""
        return np.asarray(self._values, np.float64)

    @property
    def saturated(self) -> bool:
        return self.count > self.cap

    @property
    def mean(self) -> float:
        """Exact mean (from the full-stream count/total, not the
        sample)."""
        return self.total / self.count if self.count else 0.0

    def percentile(self, q) -> float:
        """Percentile over the retained samples — exact while the
        reservoir is not saturated."""
        if not self._values:
            return 0.0
        return float(np.percentile(self.values, q))

    def snapshot(self) -> dict:
        return {"count": self.count, "sum": self.total,
                "min": self.vmin if self.count else 0.0,
                "max": self.vmax if self.count else 0.0,
                "cap": self.cap, "values": list(self._values)}


def _labels_key(labels: dict) -> str:
    if not labels:
        return ""
    return "|" + ",".join(f"{k}={labels[k]}" for k in sorted(labels))


class Counter:
    """A running count. ``inc`` also takes a 0-d tensor on the card: the
    count then accumulates there, with no synchronise, and is read once,
    by :meth:`read` or a snapshot."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def read(self):
        v = self.value
        return v.item() if hasattr(v, "item") else v


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    __slots__ = ("reservoir",)

    def __init__(self, cap: int = DEFAULT_RESERVOIR):
        self.reservoir = Reservoir(cap)

    def record(self, v: float) -> None:
        self.reservoir.add(v)

    def percentile(self, q) -> float:
        return self.reservoir.percentile(q)

    @property
    def count(self) -> int:
        return self.reservoir.count


class _NullInstrument:
    """One shared object serves as the disabled counter, gauge AND
    histogram — every mutator is a no-op."""
    __slots__ = ()
    value = 0
    count = 0

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def record(self, v: float) -> None:
        pass

    def percentile(self, q) -> float:
        return 0.0


_NULL = _NullInstrument()


class MetricsRegistry:
    """Name → instrument map with JSON-able snapshots.

    Instruments are created on first use and looked up by
    ``name`` + sorted ``labels`` (rendered ``name|k=v,...``). With
    ``enabled=False`` every lookup returns the shared no-op
    instrument and ``snapshot()`` is empty."""

    def __init__(self, *, enabled: bool = True,
                 reservoir: int = DEFAULT_RESERVOIR):
        self.enabled = bool(enabled)
        self.reservoir_cap = int(reservoir)
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    # ---------------- instruments ---------------------------------- #
    def counter(self, name: str, **labels) -> Counter:
        if not self.enabled:
            return _NULL
        key = name + _labels_key(labels)
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter()
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        if not self.enabled:
            return _NULL
        key = name + _labels_key(labels)
        g = self._gauges.get(key)
        if g is None:
            g = self._gauges[key] = Gauge()
        return g

    def histogram(self, name: str, **labels) -> Histogram:
        if not self.enabled:
            return _NULL
        key = name + _labels_key(labels)
        h = self._histograms.get(key)
        if h is None:
            h = self._histograms[key] = Histogram(self.reservoir_cap)
        return h

    # ---------------- snapshots ------------------------------------ #
    def snapshot(self) -> dict:
        """Plain-dict view: counters/gauges by full key, histograms as
        reservoir snapshots with exact p50/p95/p99 attached."""
        hists = {}
        for key, h in sorted(self._histograms.items()):
            s = h.reservoir.snapshot()
            s["p50"], s["p95"], s["p99"] = (
                h.percentile(50), h.percentile(95), h.percentile(99))
            hists[key] = s
        return {
            "counters": {k: c.read()
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value
                       for k, g in sorted(self._gauges.items())},
            "histograms": hists,
        }


def _merge_reservoir_values(parts: Sequence[Sequence[float]],
                            cap: int) -> List[float]:
    merged: List[float] = []
    for part in parts:
        merged.extend(float(v) for v in part)
    if len(merged) <= cap:
        return merged
    # deterministic uniform thinning: evenly spaced indices over the
    # concatenation (order-stable, no RNG — hosts merging the same
    # snapshots get the same result)
    idx = np.linspace(0, len(merged) - 1, cap).round().astype(int)
    return [merged[i] for i in idx]


def merge_snapshots(snapshots: Iterable[Optional[dict]]) -> dict:
    """Fleet-wide roll-up of per-host registry snapshots: counters
    add, gauges take the max, histograms merge exactly on
    count/sum/min/max and concatenate (bounded) reservoir samples —
    the same spirit as :func:`repro_torch.fleet.router.assemble_stats`, for
    the whole registry at once."""
    snaps = [s for s in snapshots if s]
    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    for s in snaps:
        for k, v in s.get("counters", {}).items():
            out["counters"][k] = out["counters"].get(k, 0) + v
        for k, v in s.get("gauges", {}).items():
            out["gauges"][k] = max(out["gauges"].get(k, v), v)
    hist_keys = sorted({k for s in snaps
                        for k in s.get("histograms", {})})
    for k in hist_keys:
        parts = [s["histograms"][k] for s in snaps
                 if k in s.get("histograms", {})]
        cap = max(p.get("cap", DEFAULT_RESERVOIR) for p in parts)
        count = sum(p["count"] for p in parts)
        values = _merge_reservoir_values(
            [p.get("values", ()) for p in parts], cap)
        arr = np.asarray(values, np.float64)
        nonzero = [p for p in parts if p["count"]]
        merged = {
            "count": count,
            "sum": sum(p["sum"] for p in parts),
            "min": min(p["min"] for p in nonzero) if nonzero else 0.0,
            "max": max(p["max"] for p in nonzero) if nonzero else 0.0,
            "cap": cap, "values": values,
        }
        merged["p50"], merged["p95"], merged["p99"] = (
            (float(np.percentile(arr, q)) if arr.size else 0.0)
            for q in (50, 95, 99))
        out["histograms"][k] = merged
    return out
