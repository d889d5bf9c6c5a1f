"""The roofline counts against the shapes, and the trace reduction and
its readers on a made-up trace."""
import math

import pytest
import torch

from portbench import devtrace, harness, roofline

torch.set_num_threads(1)

B = 65536


def _config(name):
    return harness.load_json(harness.HERE / "configs" / f"{name}.json")


def test_the_deep_net_needs_355600_operations_an_item():
    assert roofline.net_ops_per_item([784, 200, 100, 10]) == 355600


@pytest.mark.parametrize("name,in_b", [("deep-1t1m", 4), ("deep-sram", 1)])
def test_layer_work_counts_each_operand_once(name, in_b):
    work = roofline.layer_work(_config(name), B)
    assert [(w["d_in"], w["d_out"]) for w in work] == \
        [(784, 200), (200, 100), (100, 10)]
    assert work[0]["bytes"] == B * 784 * in_b + 784 * 200 + B * 200
    assert work[1]["bytes"] == B * 200 + 200 * 100 + B * 100
    assert work[2]["bytes"] == B * 100 + 100 * 10 + B * 10 * 4
    assert [w["ops"] for w in work] == [2 * B * 784 * 200,
                                        2 * B * 200 * 100,
                                        2 * B * 100 * 10]


def test_bound_names_the_larger_term():
    assert roofline.bound(494.7e12, 1.0, "tf32") == (1.0, "ops")
    assert roofline.bound(1.0, 3.35e12, "int8") == (1.0, "bytes")


def test_the_deep_nets_are_bound_by_their_bytes():
    t, which = roofline.stream_bound(_config("deep-1t1m"), B)
    assert which == ["bytes"] * 3
    nbytes = sum(w["bytes"] for w in
                 roofline.layer_work(_config("deep-1t1m"), B))
    assert math.isclose(t, nbytes / 3.35e12)
    assert 73e-6 < t < 75e-6
    t, which = roofline.stream_bound(_config("deep-sram"), B)
    assert which == ["bytes"] * 3 and 27e-6 < t < 29e-6


def _trace():
    ms = 1_000_000
    host = [(devtrace.WINDOW_SPAN, 0, 10 * ms),
            ("aten::copy_", 0, 2 * ms), ("cudaStreamSynchronize", 8 * ms,
                                         10 * ms)]
    device = [("Memcpy HtoD (Pinned -> Device)", 0, 3 * ms),
              ("void k::crossbar_mvm_kernel<false, 1>()", 3 * ms, 5 * ms),
              ("elementwise_kernel<add>", 4 * ms, 6 * ms),
              ("elementwise_kernel<add>", 11 * ms, 12 * ms)]
    return devtrace.summarize(device, host)


def test_summarize_unions_busy_time_and_names_idle_gaps():
    s = _trace()
    assert math.isclose(s.window_s, 0.010) and math.isclose(s.busy_s, 0.006)
    assert s.ops["elementwise_kernel<add>"][0] == 1
    assert s.gaps[0][0] == "cudaStreamSynchronize"
    assert math.isclose(s.gaps[0][1], 0.004)
    assert s.count(lambda n: not devtrace.is_copy(n)) == 2


def test_the_per_layer_readers_read_the_trace():
    cell = harness.load_cell("deep-1t1m.stream-host")

    class W:
        items, seconds, calls, latencies = 2 * B, 0.01, 2, []

    run = harness.Run(cell.config, B, W(), 1.0, _trace(), None)
    read = {m["name"]: harness.load_module(
        harness.HERE / "metrics" / f"{m['name']}.py").read(run)
        for m in cell.metrics(True)}
    assert math.isclose(read["h2d_ms"], 1.5)
    assert math.isclose(read["glue_ms.host"], 1.0)
    assert read["kernels_per_batch.host"] == 1.0
    assert math.isclose(read["device_idle.host"], 40.0)
    bound = roofline.stream_bound(cell.config, B)[0]
    assert math.isclose(read["k1_roofline.host"], 100 * bound / 0.001)
    assert math.isclose(read["stream_mfu.host"],
                        100 * 355600 * 2 * B / 0.010 / 494.7e12)
