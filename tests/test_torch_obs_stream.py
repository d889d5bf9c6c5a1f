"""The spans inside ``CompiledChip.stream`` and the tracer under them.

With telemetry off the stream path touches no CUDA API; with it on,
each call is one ``chip.stream`` span with its stages nested under it
(``chip.handover``, ``chip.tile``, ``chip.combine``, ``chip.quantize``)
and outputs equal to the bit. The tracer's device times come from
pooled CUDA event pairs, resolved without a synchronise (here against a
stand-in card), and its clock anchor lays its spans on
``torch.profiler``'s clock.
"""
import pytest
import torch

from repro_torch import obs
from repro_torch.chip import compile_chip
from repro_torch.core.crossbar_layer import MLPSpec, mlp_init
from repro_torch.core.neural_core import CoreGeometry

torch.set_num_threads(1)

DIMS = (300, 40, 5)               # 1T1M on 128-row cores: 3, 1 row chunks
GEOMS = {"memristor": CoreGeometry(128, 64),
         "digital": CoreGeometry(256, 128)}


@pytest.fixture
def telemetry():
    tel = obs.configure()
    try:
        yield tel
    finally:
        obs.disable()


def _chip(system):
    spec = MLPSpec(DIMS)
    params = mlp_init(spec, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    return compile_chip(spec, params=params, system=system,
                        geom=GEOMS[system], device="cpu")


def _x(rows=6, seed=1):
    return torch.rand((rows, DIMS[0]),
                      generator=torch.Generator().manual_seed(seed))


def _no_cuda(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("the stream path touched the CUDA API")
    for name in ("synchronize", "Event", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)


def _by_name(events, name):
    return [e for e in events if e["name"] == name]


# ------------------------------------------------------------------ #
# the stream path
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("system", ["memristor", "digital"])
def test_stream_with_telemetry_off_touches_no_cuda_api(system,
                                                       monkeypatch):
    chip = _chip(system)
    want = chip.stream(_x())
    _no_cuda(monkeypatch)
    assert not obs.current().active
    assert torch.equal(chip.stream(_x()), want)
    assert torch.equal(chip.stream(_x().numpy()), want)


@pytest.mark.parametrize("system", ["memristor", "digital"])
def test_stream_spans_on_a_cpu_chip_carry_no_device_time(system,
                                                         monkeypatch,
                                                         telemetry):
    chip = _chip(system)
    _no_cuda(monkeypatch)
    chip.stream(_x())
    events = telemetry.tracer.trace_events()
    assert events and all("device_ms" not in e["args"] for e in events)


def test_memristor_stream_nests_tile_and_combine_under_each_call():
    chip = _chip("memristor")
    assert [layer.tiles.gp.shape[0] for layer in chip.plan] == [3, 1]
    x = _x()
    want = chip.stream(x)
    tel = obs.configure()
    try:
        outs = [chip.stream(x), chip.stream(x)]
        events = tel.tracer.trace_events()
    finally:
        obs.disable()
    assert all(torch.equal(y, want) for y in outs)
    calls = _by_name(events, "chip.stream")
    assert len(calls) == 2
    for call in calls:
        sid = call["args"]["span"]
        assert call["args"]["call"] == sid and "parent" not in call["args"]
        assert call["args"]["rows"] == 6 and \
            call["args"]["compile_delta"] == 0 and \
            call["args"]["system"] == "memristor"
        inner = [e for e in events if e["args"].get("parent") == sid]
        # one tile stage a layer; a combiner only where R > 1
        assert sorted(e["name"] for e in inner) == \
            ["chip.combine", "chip.tile", "chip.tile"]
        for e in inner:
            assert e["args"]["call"] == sid and e["cat"] == "chip"
            assert call["ts"] <= e["ts"] and \
                e["ts"] + e["dur"] <= call["ts"] + call["dur"] + 1e-3
    assert calls[0]["args"]["span"] != calls[1]["args"]["span"]


def test_digital_stream_brackets_each_layers_dac_codes():
    # on the 8-bit kernel path the kernel forms the codes, so there the
    # span covers the DAC together with the MAC: still one a layer
    chip = _chip("digital")
    x = _x()
    want = chip.stream(x)
    tel = obs.configure()
    try:
        got = chip.stream(x)
        events = tel.tracer.trace_events()
    finally:
        obs.disable()
    assert torch.equal(got, want)
    (call,) = _by_name(events, "chip.stream")
    quant = _by_name(events, "chip.quantize")
    assert len(quant) == len(chip.plan)
    assert all(e["args"]["parent"] == call["args"]["span"] ==
               e["args"]["call"] for e in quant)
    assert not _by_name(events, "chip.tile") and \
        not _by_name(events, "chip.combine")


@pytest.mark.parametrize("system", ["memristor", "digital"])
def test_handover_span_only_where_the_batch_is_not_resident(system,
                                                            telemetry):
    chip = _chip(system)
    x = _x()
    want = chip.stream(x)
    assert torch.equal(chip.stream(x.numpy()), want)
    events = telemetry.tracer.trace_events()
    first, second = _by_name(events, "chip.stream")
    handovers = _by_name(events, "chip.handover")
    assert [e["args"]["parent"] for e in handovers] == \
        [second["args"]["span"]]
    assert first["args"]["span"] != second["args"]["span"]


def test_stream_telemetry_keeps_the_counters_read():
    tel = obs.configure()
    try:
        chip = _chip("memristor")
        chip.stream(_x(rows=4))
        chip.stream(_x(rows=3)[None])
        snap = tel.metrics.snapshot()
    finally:
        obs.disable()
    assert snap["counters"]["chip.items_streamed"] == 7
    assert snap["counters"]["chip.compiles"] == 1
    assert set(snap["histograms"]) == {"chip.compile_s"}
    assert snap["gauges"] == {}


@pytest.mark.parametrize("system,bits,per_call", [("digital", 8, 2),
                                                  ("memristor", 8, 0),
                                                  ("digital", 12, 0)])
def test_dac_in_kernel_counts_the_layers_whose_codes_the_kernel_formed(
        system, bits, per_call):
    """One a layer on the 8-bit SRAM route; none where the codes are
    formed apart (12-bit byte planes) or there is no DAC (1T1M)."""
    spec = MLPSpec(DIMS)
    params = mlp_init(spec, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    chip = compile_chip(spec, params=params, system=system,
                        geom=GEOMS[system], weight_bits=bits, device="cpu")
    chip.stream(_x())
    tel = obs.configure()
    try:
        chip.stream(_x())
        chip.stream(_x(rows=3))
        snap = tel.metrics.snapshot()
    finally:
        obs.disable()
    assert snap["counters"].get("chip.dac_in_kernel", 0) == 2 * per_call
    assert snap["counters"]["chip.items_streamed"] == 9


def test_metrics_only_telemetry_streams_without_spans():
    tel = obs.configure(trace=False)
    try:
        chip = _chip("digital")
        y = chip.stream(_x())
        snap = tel.metrics.snapshot()
    finally:
        obs.disable()
    assert torch.equal(y, chip.stream(_x()))
    assert tel.tracer.trace_events() == []
    assert snap["counters"]["chip.items_streamed"] == 6


# ------------------------------------------------------------------ #
# the tracer's spans against a stand-in card
# ------------------------------------------------------------------ #
class _Card:
    """A stream whose work completes when the test says: an event
    recorded at position n is passed once ``done`` reaches n; a
    position is 1 ms of device time."""

    def __init__(self):
        self.queued = 0
        self.done = 0
        self.device_index = 0
        self.events = 0
        self.syncs = 0


def _install_card(monkeypatch):
    card = _Card()

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            card.events += 1
            self.at = None

        def record(self, stream=None):
            assert stream is card
            card.queued += 1
            self.at = card.queued

        def query(self):
            return self.at is not None and card.done >= self.at

        def elapsed_time(self, end):
            assert self.query() and end.query()
            return float(end.at - self.at)

    def sync(*args, **kw):
        card.syncs += 1
        raise AssertionError("a span waited for the card")

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: card)
    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    return card


CUDA = torch.device("cuda")


def _nested_call(tr, rec):
    with rec.span("outer"):
        with rec.span("inner"):
            pass
        with rec.span("inner"):
            pass


def test_span_device_times_resolve_lazily_without_a_synchronise(
        monkeypatch):
    card = _install_card(monkeypatch)
    tr = obs.Tracer()
    rec = obs.SpanRecorder(tr, CUDA, "chip")
    _nested_call(tr, rec)
    events = tr.trace_events()
    assert [e["name"] for e in events] == ["inner", "inner", "outer"]
    assert all("device_ms" not in e["args"] for e in events)   # queued
    card.done = 5                 # both inner pairs passed, not outer's end
    _nested_call(tr, rec)         # a root span's end polls
    first = tr.trace_events()[:3]
    assert [e["args"].get("device_ms") for e in first] == [1.0, 1.0, None]
    card.done = card.queued       # the caller's own synchronise
    assert tr.resolve_device_times() == 0
    events = tr.trace_events()
    assert [e["args"]["device_ms"] for e in events] == \
        [1.0, 1.0, 5.0, 1.0, 1.0, 5.0]
    assert card.syncs == 0
    # resolved pairs are reused: a steady stream creates no events
    made = card.events
    for _ in range(5):
        _nested_call(tr, rec)
        card.done = card.queued
    assert card.events == made and tr.resolve_device_times() == 0


def test_span_ids_parents_and_call_ids(monkeypatch):
    _install_card(monkeypatch)
    tr = obs.Tracer()
    rec = obs.SpanRecorder(tr, CUDA, "chip")
    _nested_call(tr, rec)
    _nested_call(tr, rec)
    events = tr.trace_events()
    outers = _by_name(events, "outer")
    for outer in outers:
        sid = outer["args"]["span"]
        assert outer["args"]["call"] == sid
        kids = [e for e in events if e["args"].get("parent") == sid]
        assert len(kids) == 2 and all(e["args"]["call"] == sid
                                      for e in kids)
    assert len({e["args"]["span"] for e in events}) == len(events)


def test_event_pairs_count_toward_max_events(monkeypatch):
    card = _install_card(monkeypatch)
    tr = obs.Tracer(max_events=4)
    rec = obs.SpanRecorder(tr, CUDA, "chip")
    for _ in range(3):
        with rec.span("s"):
            pass
    # two events and two pending pairs spend the budget of four
    assert len(tr.trace_events()) == 3
    assert tr.dropped == 0 and tr.dropped_device == 1
    card.done = card.queued
    assert tr.resolve_device_times() == 0
    for _ in range(3):
        with rec.span("s"):
            pass
    assert len(tr.trace_events()) == 4 and tr.dropped == 2
    other = tr.to_dict()["otherData"]
    assert other["dropped_events"] == 2
    assert other["dropped_device_times"] == tr.dropped_device


def test_disabled_tracer_spans_are_inert(monkeypatch):
    _no_cuda(monkeypatch)
    tr = obs.Tracer(enabled=False)
    with tr.span("s", device=CUDA) as span:
        span.set(rows=1)
    assert tr.trace_events() == [] and tr.resolve_device_times() == 0
    assert obs.Telemetry().spans(CUDA) is obs.NULL_RECORDER


# ------------------------------------------------------------------ #
# the clock anchor
# ------------------------------------------------------------------ #
def test_clock_anchor_lays_spans_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    tr = obs.Tracer()
    perf, unix, err = tr.clock
    assert 0 <= err < 50_000
    other = tr.to_dict()["otherData"]["clock"]
    assert other["epoch_unix_ns"] == tr.unix_ns(0.0)
    assert tr.unix_ns(1.5) - tr.unix_ns(0.0) == 1500
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):     # the profiler's first range
            pass
        for i in range(5):
            with tr.span(f"range{i}"):
                with record_function(f"range{i}"):
                    torch.ones(8).sum()
    starts = {e.name(): e.start_ns()
              for e in prof.profiler.kineto_results.events()}
    offsets = [starts[e["name"]] - tr.unix_ns(e["ts"])
               for e in tr.trace_events()]
    # the range opens just inside the span; a descheduled thread can
    # only make one late, so the closest shows the anchor's error
    assert len(offsets) == 5 and min(offsets) > -50_000
    assert min(abs(o) for o in offsets) <= 50_000


def test_written_trace_exports_the_anchor(tmp_path):
    import json

    tr = obs.Tracer()
    with tr.span("s"):
        pass
    with open(tr.write(str(tmp_path / "t.json"))) as f:
        doc = json.load(f)
    (ev,) = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    clock = doc["otherData"]["clock"]
    assert abs(clock["epoch_unix_ns"] + round(1000 * ev["ts"]) -
               tr.unix_ns(ev["ts"])) <= 1
    perf, unix = clock["perf_counter_ns"], clock["unix_ns"]
    assert (perf, unix, clock["error_ns"]) == tr.clock
    assert clock["epoch_unix_ns"] == unix + round(tr.t0 * 1e9) - perf
