"""The plain reference against the port on the CPU, at a small size:
its encoding equals the port's programmed state, the port's stream
passes the comparison, and the control fails it."""
import math

import pytest
import torch

from portbench import harness
from repro_torch.chip.compile import program_plan
from repro_torch.core.crossbar_layer import (MLPSpec, program_digital,
                                             program_layer, program_mlp)
from repro_torch.core.neural_core import CoreGeometry

torch.set_num_threads(1)

CONFIGS = ["deep-1t1m", "deep-sram"]
CELLS = {"deep-1t1m": "deep-1t1m.stream-dev",
         "deep-sram": "deep-sram.stream-dev"}


def _ref():
    return harness.load_module(harness.HERE / "references" / "chip_mlp.py")


def _judge():
    return harness.load_module(harness.HERE / "judges" / "rows.py")


def _cell(config):
    return harness.load_cell(CELLS[config])


def test_memristor_encoding_equals_the_ports():
    ref = _ref()
    cfg = _cell("deep-1t1m").config
    params = harness.make_params(cfg, 2 ** 31 + 7, "cpu")
    rows, cols = cfg["core_rows"], cfg["core_cols"]
    for p in params:
        gp, gn, scale = ref.program_tiles(p["w"], rows, cols)
        lp = program_layer(p["w"], geom=CoreGeometry(rows, cols))
        assert torch.equal(gp, lp.gp) and torch.equal(gn, lp.gn)
        assert torch.equal(scale, lp.scale)


def test_combiner_weights_equal_the_ports():
    ref = _ref()
    cfg = _cell("deep-1t1m").config
    params = harness.make_params(cfg, 11, "cpu")
    spec = MLPSpec(tuple(cfg["dims"]), cfg["activation"],
                   cfg["out_activation"])
    geom = CoreGeometry(cfg["core_rows"], cfg["core_cols"])
    plan = program_plan(program_mlp(params, spec, geom=geom))
    for lay, ref_lay in zip(plan, ref.program(cfg, params)):
        assert len(lay.combine) == len(ref_lay.levels)
        for w, (groups, fan_in), (wr, g, f) in zip(
                lay.combine, lay.levels, ref_lay.levels):
            assert (groups, fan_in) == (g, f)
            assert torch.equal(w, wr)


def test_digital_encoding_equals_the_ports():
    ref = _ref()
    cfg = _cell("deep-sram").config
    for p in harness.make_params(cfg, 3, "cpu"):
        codes, scale, offset, step = ref.program_digital(
            p["w"], cfg["weight_bits"])
        dp = program_digital(p["w"], bits=cfg["weight_bits"])
        assert torch.equal(codes, dp.wq) and step == dp.step
        assert torch.equal(scale, dp.scale)
        assert torch.equal(offset, dp.offset)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    ref = _ref()
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11,
                      1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -12, -3.0e-5,
                      0.0])
    y = ref.to_tf32(x)
    assert y.tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -9,
                          1.0, y[5].item(), 0.0]
    assert y[5].item() < 0
    bits = y.view(torch.int32) & 0x1FFF
    assert torch.all(bits == 0)


@pytest.mark.parametrize("config", CONFIGS)
def test_the_ports_stream_passes_and_the_control_fails(config):
    cell = _cell(config)
    limit = cell.config["check"]["out_gap_limit"]
    r = harness.run_cell(cell, 2 ** 31 + 99, 0.2, False, device="cpu",
                         batch=512)
    assert r["correct"], r["check"]
    assert r["check"]["out_gap"]["value"] <= limit
    assert r["info"]["undecided_share"] < 0.1
    v = harness.control_verdict(cell, 2 ** 31 + 99, device="cpu",
                                batch=512)
    assert not v["correct"] and v["check"]["out_gap"]["value"] > 10 * limit


def test_a_row_gap_is_the_widest_output_error_over_its_bound():
    ref = {"y": torch.tensor([[1.0, -2.0], [0.5, 0.5]], dtype=torch.float64),
           "bound": torch.tensor([[2.0, 4.0], [1.0, 1.0]],
                                 dtype=torch.float64),
           "margin": torch.tensor([1.0, 1e-9], dtype=torch.float64)}
    out = torch.tensor([[1.5, -2.0], [0.5, float("nan")]])
    judge = _judge()
    g = judge.row_gaps(out, ref)
    assert g[0].item() == 0.25 and math.isinf(g[1].item())
    v = judge.judge([(0, out)], {0: ref}, margin=1e-6, limit=0.1)
    assert v["out_gap"] == 0.25 and v["wrong_rows"] == 1
    assert v["undecided_share"] == 0.5
    v = judge.judge([(0, out[:1])], {0: ref}, margin=1e-6, limit=0.1)
    assert v["malformed"] == 1 and math.isinf(v["out_gap"])
    v = judge.verdict([(0, out[:1])], {0: ref},
                      {"margin": 1e-6, "out_gap_limit": 0.1})
    assert not v["correct"] and v["failed"] == 2
    assert v["check"]["out_gap"] == {"value": "inf", "limit": 0.1}
