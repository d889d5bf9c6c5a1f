"""The generator of closed-loop LM decode mixes.

``lanes`` conversations live on the program's member (the ``call``
that ``programs/lm_decode.py`` builds), each admitted and prefilled in
set-up through ``LMMember.on_admit`` with a prompt drawn from the seed:
a length uniform on ``prompt_len`` and ids uniform over the
configuration's vocabulary (its slice). The cache holds
``max_position_embeddings`` positions. One caller then makes calls back
to back, each one ``LMMember.stream_host`` step over every lane
(greedy), timed on the host clock from the call to its ids in
(page-locked) host memory. A lane whose next position would not fit
the cache is released and re-admitted with its prompt as a new
request, inside the step that finds it, so that step's time holds the
prefill.

Every token a lane is fed is recorded, so the reference can be
teacher-forced over each request's prompt and the tokens the program
chose. The logits of a uniform sample of ``max_keep`` decode rows
(lane, step) of the window, drawn from the seed (reservoir sampling),
are kept on the card in a buffer made in set-up, each with the experts
the program routed its request's tokens to up to the row (the member's
route log, read after the window). Without a window (the control) the
rows are drawn from the prompts' positions instead.

``enqueue_bursts`` (called by the harness only in the traced run)
runs ``trace_steps`` steps with ``repro_torch.obs`` configured, under
the profiler, and keeps on the traffic, for the window to carry, each
stage's device ms a step and the ``lm.expert_assignments`` a step; the
timed windows run with telemetry off. A stage's device ms are those of
the card's kernels and copies the host queued inside the stage's
``lm.*`` spans (:func:`stage_ms`): the host paces this step, so the
time between a span's two timing events holds the card's waits for the
launches, not the stage's work.
"""
from __future__ import annotations

import bisect
import dataclasses
import random
import time
import types
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from portbench import sensor

# purpose separators of the prompt and kept-row draws
_FOLD_PROMPTS = 0x1A9D
_FOLD_KEEP = 0x6B34
# the program's spans whose stages the bursts time (device ms a step)
SPANS = ("lm.mla", "lm.route", "lm.experts", "lm.shared")
COUNTER = "lm.expert_assignments"
# the readings beside the stages': every device event of the bursts and
# those the trace gave no launch for (ms a step); the spans' own timing
# events (``<span>.span_ms``)
DEVICE_TOTAL = "lm.device_ms"
UNLAUNCHED = "lm.unlaunched_ms"


@dataclasses.dataclass
class Window:
    calls: int
    items: int                      # tokens decoded: live lanes a step
    seconds: float
    latencies: List[float]          # seconds a step
    # ((request, pos), (logits, the request's routes up to pos))
    kept: List[Tuple[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]]]
    lanes: int
    mean_kv: float                  # cached positions a lane attends a step
    readings: Dict[str, float]      # the traced bursts' (stages, counter)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stage_ms(spans: Iterable[Tuple[str, int, int]],
             device: Iterable[Tuple[int, int, int]],
             launches: Dict[int, int]
             ) -> Tuple[Dict[str, float], float, float]:
    """The card's time in each stage. ``spans``: (name, start ns, end
    ns) host intervals on the profiler's clock, none inside another;
    ``device``: (correlation id, start ns, end ns) of the card's kernels
    and copies; ``launches``: correlation id → host ns of the runtime
    call that queued it. A device event counts to the span whose
    interval holds its launch, or, where the trace holds no launch for
    it, its own start. Returns ({name: ms}, ms of every device event,
    ms of those without a launch)."""
    spans = sorted(spans, key=lambda sp: sp[1])
    starts = [s0 for _, s0, _ in spans]
    out: Dict[str, int] = {}
    total = unlaunched = 0
    for corr, s0, s1 in device:
        ns = s1 - s0
        total += ns
        t = launches.get(corr)
        if t is None:
            unlaunched += ns
            t = s0
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][2]:
            name = spans[i][0]
            out[name] = out.get(name, 0) + ns
    return ({k: v * 1e-6 for k, v in out.items()}, total * 1e-6,
            unlaunched * 1e-6)


def _profiled(fn) -> Tuple[List[Tuple[int, int, int]], Dict[int, int]]:
    """Run ``fn`` under the profiler; returns the card's kernels and
    copies (correlation id, start ns, end ns) and the host's runtime
    and driver calls (correlation id → start ns), the calls that queue
    them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    device, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ann = getattr(e, "is_user_annotation", None)
            if not (ann is not None and ann()):
                device.append((e.correlation_id(), e.start_ns(),
                               e.start_ns() + e.duration_ns()))
        elif e.name().startswith("cu") and e.correlation_id():
            launches[e.correlation_id()] = e.start_ns()
    return device, launches


class Traffic:
    """One run's decode traffic for an LM configuration. ``batch``
    overrides the mix's lane count (the CPU tests)."""

    def __init__(self, mix: dict, seed: int, device, config: dict,
                 batch: Optional[int] = None):
        if (mix["loop"], mix["callers"]) != ("closed", 1):
            raise ValueError("the decode generator drives one caller in a "
                             "closed loop")
        self.device = torch.device(device)
        self.lanes = int(batch if batch is not None else mix["lanes"])
        self.batch = self.lanes
        self.cache_len = int(config["max_position_embeddings"])
        self.vocab = int(config["vocab_size"])
        self.max_keep = int(mix["max_keep"])
        self.warmup_calls = int(mix["warmup_calls"])
        self.trace_steps = int(mix["trace_steps"])
        self.seed = seed
        lo, hi = (int(v) for v in mix["prompt_len"])
        if not 1 <= lo <= hi < self.cache_len:
            raise ValueError(f"prompt lengths {lo}..{hi} do not fit a cache "
                             f"of {self.cache_len}")
        gen = torch.Generator().manual_seed(
            sensor.stream_seed(seed, _FOLD_PROMPTS))
        lens = torch.randint(lo, hi + 1, (self.lanes,), generator=gen)
        ids = torch.randint(0, self.vocab, (int(lens.sum()),), generator=gen)
        self.prompts = [tuple(p.tolist()) for p in
                        torch.split(ids, lens.tolist())]
        # every request's fed tokens (prompt first); lane → its request
        self.seqs: List[List[int]] = []
        self.lane_req: List[int] = [0] * self.lanes
        self.rows: List[Optional[Tuple[int, int]]] = [None] * self.max_keep
        self.readings: Dict[str, float] = {}
        self.keep_buf: Optional[torch.Tensor] = None
        # the route logs of requests whose lanes were re-admitted
        self.released: Dict[int, torch.Tensor] = {}
        self._placeholder = np.zeros((self.lanes, 1), np.float32)

    # ---------------- lanes ------------------------------------------ #
    def _admit(self, member, lane: int) -> None:
        prompt = self.prompts[lane]
        self.lane_req[lane] = len(self.seqs)
        self.seqs.append(list(prompt))
        req = types.SimpleNamespace(uid=len(self.seqs), prompt=prompt)
        member.on_admit(lane, types.SimpleNamespace(request=req, outputs=[]))

    def _step(self, member):
        """One timed step: (host seconds, each lane's request and the
        position its row wrote, the step's logits)."""
        pos = member._pos.copy()
        reqs = list(self.lane_req)
        t0 = time.perf_counter()
        fed = member.stream_host(self._placeholder)
        full = np.nonzero(member._pos >= self.cache_len)[0]
        for lane in full:
            self.released[self.lane_req[lane]] = member.routes[lane].clone()
            member.on_release(int(lane))
            self._admit(member, int(lane))
        dt = time.perf_counter() - t0
        for lane, req in enumerate(reqs):
            self.seqs[req].append(int(fed[lane, 0]))
        return dt, reqs, pos, member.logits

    def warm(self, call) -> None:
        member = call.serve(self.lanes, self.cache_len)
        self.keep_buf = torch.empty(
            (self.max_keep, member.clm.cfg.padded_vocab),
            dtype=torch.float32, device=self.device)
        for lane in range(self.lanes):
            self._admit(member, lane)
        for _ in range(self.warmup_calls):
            self._step(member)
        _sync(self.device)

    def enqueue_bursts(self, call) -> None:
        """The traced run's stage readings (kept for the window); returns
        None: this mix has no enqueue metric."""
        from repro_torch.obs import core as obs

        def bursts():
            _sync(self.device)
            for _ in range(self.trace_steps):
                self._step(call.member)
            _sync(self.device)

        tel = obs.configure(metrics=True, trace=True)
        try:
            device, launches = _profiled(bursts)
            tr = tel.tracer
            tr.resolve_device_times()
            spans, pairs = [], {}
            for ev in tr.trace_events():
                if ev["name"] not in SPANS or ev.get("ph") != "X":
                    continue
                spans.append((ev["name"], tr.unix_ns(ev["ts"]),
                              tr.unix_ns(ev["ts"] + ev["dur"])))
                ms = ev.get("args", {}).get("device_ms")
                if ms is not None:
                    pairs[ev["name"]] = pairs.get(ev["name"], 0.0) + ms
            n = self.trace_steps
            stages, total, unlaunched = stage_ms(spans, device, launches)
            self.readings = {name: v / n for name, v in stages.items()}
            self.readings.update({f"{name}.span_ms": v / n
                                  for name, v in pairs.items()})
            if device:
                self.readings[DEVICE_TOTAL] = total / n
                self.readings[UNLAUNCHED] = unlaunched / n
            count = tel.metrics.counter(COUNTER).read()
            if count:
                self.readings[COUNTER] = count / n
        finally:
            obs.disable()
        return None

    # ---------------- the window -------------------------------------- #
    def window(self, call, seconds: float) -> Window:
        rng = random.Random(sensor.stream_seed(self.seed, _FOLD_KEEP))
        k = self.max_keep
        member = call.member
        lat: List[float] = []
        i = calls = items = 0
        kv = 0.0
        _sync(self.device)
        t0 = time.perf_counter()
        while True:
            dt, reqs, pos, logits = self._step(member)
            lat.append(dt)
            calls += 1
            items += self.lanes
            kv += float(pos.sum()) + self.lanes
            hit: Dict[int, int] = {}
            for lane in range(self.lanes):
                j = i if i < k else rng.randrange(i + 1)
                if j < k:
                    hit[j] = lane
                    self.rows[j] = (reqs[lane], int(pos[lane]))
                i += 1
            if hit:
                slots = torch.tensor(list(hit), device=self.device)
                src = torch.tensor(list(hit.values()), device=self.device)
                self.keep_buf.index_copy_(0, slots,
                                          logits.index_select(0, src))
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(self.device)
        t1 = time.perf_counter()
        needed = {key[0] for key in self.rows if key is not None}
        logs = {r: t for r, t in self.released.items() if r in needed}
        for lane, req in enumerate(self.lane_req):
            if req in needed:
                logs[req] = member.routes[lane].clone()
        kept = [(key, (self.keep_buf[s], logs[key[0]][:key[1] + 1]))
                for s, key in enumerate(self.rows) if key is not None]
        return Window(calls, items, t1 - t0, lat, kept, self.lanes,
                      kv / max(items, 1), dict(self.readings))

    # ---------------- the check's inputs ------------------------------ #
    def reference_inputs(self) -> dict:
        """request → (its fed tokens on the device, the positions of its
        kept rows). Without a window: ``max_keep`` rows drawn from the
        seed over the prompts' positions, teacher-forced on the
        prompts."""
        rows = [key for key in self.rows if key is not None]
        seqs = self.seqs
        if not rows:
            rng = random.Random(sensor.stream_seed(self.seed, _FOLD_KEEP))
            seqs = [list(p) for p in self.prompts]
            rows = [(lane, rng.randrange(len(seqs[lane])))
                    for lane in (rng.randrange(self.lanes)
                                 for _ in range(self.max_keep))]
        out: Dict[int, Tuple[torch.Tensor, List[int]]] = {}
        for req, p in rows:
            if req not in out:
                out[req] = (torch.tensor(seqs[req], dtype=torch.int64,
                                         device=self.device), [])
            out[req][1].append(p)
        return out
