"""The stream generator: its windows are the seed's, and every output
the window keeps belongs to the batch it is filed under, however many
calls the reservoir has seen."""
import pytest
import torch

from portbench import harness, sensor

torch.set_num_threads(1)

MIX = {"generator": "stream", "loop": "closed", "callers": 1, "batch": 16, "distinct_batches": 3,
       "max_keep": 4, "warmup_calls": 2,
       "source": {"kind": "sensor_windows", "window": 28, "stride": 18,
                  "height": 64, "width": 64}}


def _traffic(handover):
    gen = harness.load_module(harness.HERE / "generators" / "stream.py")
    return gen.Traffic(dict(MIX, handover=handover), 2 ** 31 + 3, "cpu",
                       {"dims": [784, 200, 10]})


@pytest.mark.parametrize("handover", ["device", "host"])
def test_kept_outputs_belong_to_their_batches(handover):
    t = _traffic(handover)

    def call(x):
        return x[:, :10] * 2.0 + 1.0

    t.warm(call)
    w = t.window(call, 0.05)
    assert w.calls > 10 * MIX["max_keep"] and w.items == w.calls * 16
    assert MIX["max_keep"] <= len(w.kept) <= MIX["max_keep"] + 1
    for idx, y in w.kept:
        assert torch.equal(y, call(t.inputs[idx]))
    if handover == "host":
        assert len(w.latencies) == w.calls
        assert t.enqueue_bursts(call) is None
    else:
        assert len(t.enqueue_bursts(call, bursts=2, calls=3)) == 2


def test_windows_are_a_pure_function_of_seed_and_index():
    a = sensor.Windows(5, MIX["source"], "cpu")
    b = sensor.Windows(5, MIX["source"], "cpu")
    x = a.items(0, 40)
    assert x.shape == (40, 784) and 0.0 <= float(x.min())
    assert float(x.max()) <= 1.0
    assert torch.equal(x[13:31], b.items(13, 18))
    assert not torch.equal(x, sensor.Windows(6, MIX["source"],
                                             "cpu").items(0, 40))


def test_windows_equal_the_ports_sensor_pipeline():
    from repro_torch.data.pipeline import SensorPipeline
    pipe = SensorPipeline(seed=2 ** 31 + 9, frames_per_step=4)
    w = sensor.Windows(2 ** 31 + 9, MIX["source"], "cpu")
    assert torch.equal(w.items(0, 36), pipe.batch(0))
    assert torch.equal(w.items(72, 36), pipe.batch(2))
