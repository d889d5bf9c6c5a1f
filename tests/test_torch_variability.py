"""The port's variability slice against the reference, on the CPU.

``jax.random``'s threefry streams cannot be reproduced with a
``torch.Generator``, so parity is checked on the arithmetic: the
reference's own draws (from its per-(seed, layer, purpose, epoch)
keys) are fed to the port's apply steps, or the reference's perturbed
tiles and drift fields are handed across as numpy. The port's own
draws get distribution checks.

Bounds: perturbed conductances and streams rel ≤ 1e-6 (max |diff| /
max |ref|); stuck-cell overrides and drift fields exact; an ideal
``NoiseModel`` ``torch.equal`` to no model. Streams are compared on the
rows whose threshold units all sit outside the near-zero band
(|pre| > 1e-5·max|pre| at every hidden layer, R6 in ROADMAP Queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.chip import compile as jcompile
from repro.core import crossbar_layer as jcl
from repro.core import programming as jprog
from repro.core import quantization as jq
from repro.core.device import DEFAULT_DEVICE as JDEVICE
from repro.core.neural_core import CoreGeometry as JGeom
from repro.variability import NoiseModel as JNoise
from repro.variability import noise as jnoise

from repro_torch import obs as tobs
from repro_torch.chip import compile as tcompile
from repro_torch.chip import ChipRequest, compile_chip, reprogram_chip
from repro_torch.core import crossbar_layer as tcl
from repro_torch.core import programming as tprog
from repro_torch.core.device import DEFAULT_DEVICE as TDEVICE
from repro_torch.core.device import DeviceModel as TDeviceModel
from repro_torch.core.neural_core import CoreGeometry as TGeom
from repro_torch.variability import (AccuracyMonitor, NoiseModel,
                                     RecalPolicy, Recalibrator)
from repro_torch.variability import noise as tnoise

torch.set_num_threads(1)

SPEC_DIMS = (64, 48, 10)
TILE = (3, 3, 16, 8)   # the tile grid of a (40, 20) layer on 16×8 cores
BAND = 1e-5
FULL = dict(program_sigma=0.1, stuck_on_frac=0.01, stuck_off_frac=0.01,
            ir_drop_r_seg=1.0, drift_rate=2e-6, seed=3)


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


@dataclasses.dataclass(frozen=True)
class RefDrawsNoise(NoiseModel):
    """The port's NoiseModel with the reference's draws: every effect's
    draw comes from the reference's own key for (seed, layer, purpose
    [, epoch]), so the port's apply steps, program-time ordering and
    stream see exactly the reference's random numbers."""

    def _j(self) -> JNoise:
        return JNoise(**dataclasses.asdict(self))

    def write_draws(self, shape, *, layer=0, epoch=0):
        kp, kn = self._j()._program_keys(layer, epoch)
        return (_t(jax.random.normal(kp, tuple(shape))),
                _t(jax.random.normal(kn, tuple(shape))))

    def stuck_draws(self, shape, *, layer=0):
        sp, sn = self._j()._stuck_keys(layer)
        return (_t(jax.random.uniform(sp, tuple(shape))),
                _t(jax.random.uniform(sn, tuple(shape))))

    def drift_draws(self, shape, *, layer=0):
        k = jax.random.fold_in(self._j()._layer_key(layer),
                               jnoise._FOLD_DRIFT)
        s = self.drift_spread
        return _t(jax.random.uniform(k, tuple(shape), minval=1.0 - s,
                                     maxval=1.0 + s))


@pytest.fixture(scope="module")
def jparams():
    spec = jcl.MLPSpec(SPEC_DIMS, activation="threshold",
                       out_activation="linear")
    return jcl.mlp_init(jax.random.PRNGKey(0), spec)


@pytest.fixture(scope="module")
def tparams(jparams):
    return tcl.params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in jparams],
        device="cpu")


@pytest.fixture(scope="module")
def batch():
    return np.random.default_rng(1).uniform(0, 1, (48, 64)).astype(
        np.float32)


def _jspec():
    return jcl.MLPSpec(SPEC_DIMS, activation="threshold",
                       out_activation="linear")


def _tspec():
    return tcl.MLPSpec(SPEC_DIMS, activation="threshold",
                       out_activation="linear")


def _tiles(shape, seed=5):
    """An encoded tile grid of the reference's."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(-1, 1, shape).astype(np.float32)
    gp, gn = JDEVICE.pair_from_weight(jnp.asarray(w))
    return np.asarray(gp), np.asarray(gn)


# ------------------------- apply steps, reference draws --------------- #
@pytest.mark.parametrize("layer,epoch", [(0, 0), (2, 0), (1, 3)])
def test_write_noise_apply_matches_reference(layer, epoch):
    gp, gn = _tiles(TILE)
    jm = JNoise(program_sigma=0.25, seed=7)
    jp, jn = jm.perturb(jnp.asarray(gp), jnp.asarray(gn), JDEVICE,
                        layer=layer, epoch=epoch)
    kp, kn = jm._program_keys(layer, epoch)
    zp = _t(jax.random.normal(kp, gp.shape))
    zn = _t(jax.random.normal(kn, gn.shape))
    tp = tnoise.apply_write_noise(_t(gp), zp, 0.25, TDEVICE)
    tn = tnoise.apply_write_noise(_t(gn), zn, 0.25, TDEVICE)
    assert _rel(tp, jp) <= 1e-6 and _rel(tn, jn) <= 1e-6


@pytest.mark.parametrize("on,off", [(0.05, 0.0), (0.0, 0.07),
                                    (0.1, 0.2)])
def test_stuck_apply_matches_reference_exactly(on, off):
    gp, gn = _tiles(TILE, seed=6)
    jm = JNoise(stuck_on_frac=on, stuck_off_frac=off, seed=2)
    jp, jn = jm.perturb(jnp.asarray(gp), jnp.asarray(gn), JDEVICE, layer=1)
    sp, sn = jm._stuck_keys(1)
    tp = tnoise.apply_stuck(_t(gp), _t(jax.random.uniform(sp, gp.shape)),
                            on, off, TDEVICE)
    tn = tnoise.apply_stuck(_t(gn), _t(jax.random.uniform(sn, gn.shape)),
                            on, off, TDEVICE)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_perturb_with_reference_draws_matches_reference():
    """Write noise then stuck cells, in the reference's order."""
    gp, gn = _tiles(TILE, seed=8)
    kw = dict(program_sigma=0.3, stuck_on_frac=0.05, stuck_off_frac=0.05,
              seed=4)
    jp, jn = JNoise(**kw).perturb(jnp.asarray(gp), jnp.asarray(gn),
                                  JDEVICE, layer=1, epoch=2)
    tp, tn = RefDrawsNoise(**kw).perturb(_t(gp), _t(gn), TDEVICE, layer=1,
                                         epoch=2)
    assert _rel(tp, jp) <= 1e-6 and _rel(tn, jn) <= 1e-6


def test_drift_field_from_reference_draws_is_exact():
    jm = JNoise(drift_rate=3e-4, drift_spread=0.6, seed=5)
    want = np.asarray(jm.drift_field(TILE, layer=2))
    got = RefDrawsNoise(drift_rate=3e-4, drift_spread=0.6, seed=5
                        ).drift_field(TILE, layer=2)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_programming_noise_apply_matches_reference():
    cfg_j = jprog.ProgrammingConfig(tol_frac=1 / 128)
    cfg_t = tprog.ProgrammingConfig(tol_frac=1 / 128)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jprog.programming_noise(key, TILE, cfg_j))
    u = _t(jax.random.uniform(key, TILE, minval=-1.0, maxval=1.0))
    got = tprog.programming_noise_from(u, cfg_t)
    assert _rel(got, want) <= 1e-6
    # the port's own draws: within ±tol, both signs
    gen = torch.Generator().manual_seed(0)
    own = tprog.programming_noise(gen, (4096,), cfg_t)
    bound = cfg_t.tol_frac * TDEVICE.g_range
    assert float(own.abs().max()) <= bound
    assert float(own.min()) < 0 < float(own.max())


def test_program_layer_noise_order_matches_reference(monkeypatch):
    """encode → feedback-write residual (clipped) → NoiseModel perturb
    → IR-drop fold → r_seg fold → scale, with every draw the
    reference's: the programmed state agrees at rel ≤ 1e-6."""
    w = np.random.default_rng(2).standard_normal((40, 20)).astype(
        np.float32) / np.sqrt(40)
    kw = dict(program_sigma=0.1, stuck_on_frac=0.02, stuck_off_frac=0.03,
              ir_drop_r_seg=2.0, seed=6)
    geom_j = JGeom(16, 8)
    key = jax.random.PRNGKey(11)
    jp = jcl.program_layer(jnp.asarray(w), geom=geom_j, noise_key=key,
                           r_seg=1.5, noise=JNoise(**kw), noise_layer=1,
                           noise_epoch=2)
    kp, kn = jax.random.split(key)
    shape = tuple(jp.gp.shape)
    draws = iter([jax.random.uniform(k, shape, minval=-1.0, maxval=1.0)
                  for k in (kp, kn)])

    def ref_residual(generator, shp, cfg):
        assert tuple(shp) == shape
        return tprog.programming_noise_from(_t(next(draws)), cfg)

    monkeypatch.setattr(tprog, "programming_noise", ref_residual)
    tp = tcl.program_layer(torch.from_numpy(w), geom=TGeom(16, 8),
                           noise_key=torch.Generator(), r_seg=1.5,
                           noise=RefDrawsNoise(**kw), noise_layer=1,
                           noise_epoch=2)
    for f in ("gp", "gn", "scale"):
        assert _rel(getattr(tp, f), getattr(jp, f)) <= 1e-6, f


def test_program_mlp_noise_key_draws_layer_by_layer(tparams):
    """One generator threads through the layers (σ⁺ then σ⁻ each): the
    same seed gives the same chip, and each residual stays within
    ±tol of the noise-free encoding before the clip."""
    spec = _tspec()
    a = tcl.program_mlp(tparams, spec,
                        noise_key=torch.Generator().manual_seed(3))
    b = tcl.program_mlp(tparams, spec,
                        noise_key=torch.Generator().manual_seed(3))
    clean = tcl.program_mlp(tparams, spec)
    tol = (1 / 256) * TDEVICE.g_range
    for la, lb, lc in zip(a.layers, b.layers, clean.layers):
        assert torch.equal(la.gp, lb.gp) and torch.equal(la.gn, lb.gn)
        assert not torch.equal(la.gp, lc.gp)
        assert float((la.gp - lc.gp).abs().max()) <= tol * (1 + 1e-5)
    assert not torch.equal(a.layers[0].gp - clean.layers[0].gp,
                           a.layers[1].gp[:1, :1] - clean.layers[1].gp[:1,
                                                                       :1])


# ------------------------- σ = 0: the same code path ------------------ #
@pytest.mark.parametrize("system", ["memristor", "digital"])
def test_sigma0_bit_identical(system, tparams, batch):
    x = torch.from_numpy(batch)
    ideal = compile_chip(_tspec(), params=tparams, system=system,
                         device="cpu")
    nm = compile_chip(_tspec(), params=tparams, system=system,
                      noise=NoiseModel(), device="cpu")
    assert torch.equal(nm.stream(x), ideal.stream(x))
    assert torch.equal(nm.stream(x, use_kernel=False),
                       ideal.stream(x, use_kernel=False))
    assert not nm.has_drift
    assert all(layer.drift is None for layer in nm.plan)
    assert nm.items_streamed == 0           # the clock runs only w/ drift


def test_digital_ignores_the_noise_model(tparams, batch):
    x = torch.from_numpy(batch)
    ideal = compile_chip(_tspec(), params=tparams, system="digital",
                         device="cpu")
    noisy = compile_chip(_tspec(), params=tparams, system="digital",
                         noise=NoiseModel(**FULL), device="cpu")
    assert torch.equal(noisy.stream(x), ideal.stream(x))
    assert all(layer.drift is None for layer in noisy.plan)


# ------------------------- streams against the reference -------------- #
def _band_rows(plan, x, age=None):
    """Rows whose hidden threshold units all sit outside the band on
    the reference's plan (at ``age``, an item count)."""
    keep = np.ones(x.shape[0], bool)
    h = x
    agej = None if age is None else jnp.asarray(float(age), jnp.float32)
    for layer in plan[:-1]:
        lin = dataclasses.replace(layer, activation="linear")
        pre = np.asarray(jcompile._apply_stream_layer(lin, h, False, agej))
        keep &= ~np.any(np.abs(pre) <= BAND * np.max(np.abs(pre)), axis=1)
        h = jnp.asarray(np.where(pre >= 0, 1.0, -1.0).astype(np.float32))
    return keep


def _carried_chip(jc, noise):
    """The port's chip on the reference chip's perturbed tiles and drift
    fields, handed across as numpy."""
    layers, biases = [], []
    for jl in jc.plan:
        p = jl.tiles
        layers.append(tcl.crossbar_params_from_numpy(
            np.asarray(p.gp), np.asarray(p.gn), np.asarray(p.scale),
            d_in=p.d_in, d_out=p.d_out, geom_rows=p.geom_rows,
            geom_cols=p.geom_cols, device="cpu"))
        biases.append(torch.from_numpy(np.array(jl.bias)))
    prog = tcl.ProgrammedMLP(tuple(layers), tuple(biases),
                             tuple(jl.activation for jl in jc.plan),
                             "crossbar")
    tc = compile_chip(prog, system="memristor")
    plan = tuple(dataclasses.replace(tl, drift=torch.from_numpy(
        np.array(jl.drift))) for tl, jl in zip(tc.plan, jc.plan))
    return dataclasses.replace(tc, plan=plan, noise=noise)


@pytest.mark.parametrize("age", [0, 64, 100_000])
def test_noisy_drifting_stream_matches_reference(jparams, batch, age):
    jc = jcompile.compile_chip(_jspec(), params=jparams,
                               noise=JNoise(**FULL))
    tc = _carried_chip(jc, NoiseModel(**FULL))
    jc.advance_age(age)
    tc.advance_age(age)
    assert tc.items_streamed == jc.items_streamed == age
    want = np.asarray(jc.stream(jnp.asarray(batch), advance_age=False))
    x = torch.from_numpy(batch)
    keep = _band_rows(jc.plan, jnp.asarray(batch), age)
    assert keep.sum() >= 0.9 * keep.size
    for use_kernel in (True, False):
        got = tc.stream(x, use_kernel=use_kernel, advance_age=False).numpy()
        assert _rel(got[keep], want[keep]) <= 1e-6, use_kernel
    # layer by layer, on the reference's own activations, at this age
    agej = jnp.asarray(float(age), jnp.float32)
    aget = torch.full((), float(age))
    h = jnp.asarray(batch)
    for jl, tl in zip(jc.plan, tc.plan):
        jlin = dataclasses.replace(jl, activation="linear")
        tlin = dataclasses.replace(tl, activation="linear")
        pre = np.asarray(jcompile._apply_stream_layer(jlin, h, False, agej))
        for use_kernel in (True, False):
            out = tcompile._apply_stream_layer(
                tlin, torch.from_numpy(np.array(h)), use_kernel, aget)
            assert _rel(out, pre) <= 1e-6
        h = jq.make_activation(jl.activation)(jnp.asarray(pre))
    assert tc.items_streamed == age          # probes never age


def test_compile_with_reference_draws_gives_the_reference_chip(jparams,
                                                               tparams,
                                                               batch):
    """The whole compile — programming-time effects in the reference's
    order and the drift fields — on the reference's draws."""
    jc = jcompile.compile_chip(_jspec(), params=jparams,
                               noise=JNoise(**FULL))
    tc = compile_chip(_tspec(), params=tparams, noise=RefDrawsNoise(**FULL),
                      device="cpu")
    for jl, tl in zip(jc.plan, tc.plan):
        for f in ("gp", "gn", "scale"):
            assert _rel(getattr(tl.tiles, f), getattr(jl.tiles, f)) <= 1e-6
        np.testing.assert_array_equal(tl.drift.numpy(), np.asarray(jl.drift))
    keep = _band_rows(jc.plan, jnp.asarray(batch))
    for _ in range(3):                       # the same age trajectory
        want = np.asarray(jc.stream(jnp.asarray(batch)))
        got = tc.stream(torch.from_numpy(batch)).numpy()
        assert _rel(got[keep], want[keep]) <= 1e-6
    assert tc.items_streamed == jc.items_streamed == 3 * batch.shape[0]


def test_age_is_f32_like_the_reference(tparams, batch):
    """Past 2**24 items the f32 age stops resolving single items, as
    the reference's does: ages 2**24 and 2**24 + 1 stream the same."""
    chip = compile_chip(_tspec(), params=tparams,
                        noise=NoiseModel(drift_rate=1e-9), device="cpu")
    x = torch.from_numpy(batch)
    chip.advance_age(2 ** 24)
    a = chip.stream(x, advance_age=False)
    chip.advance_age(1)
    assert torch.equal(chip.stream(x, advance_age=False), a)
    chip.advance_age(3)
    assert not torch.equal(chip.stream(x, advance_age=False), a)


def test_replicas_share_one_age(jparams, tparams):
    """Replica fan-out folds the replicas into the batch: every replica
    sees the call's entry age, as the reference's vmapped replicas do."""
    noise_kw = dict(drift_rate=2e-3, seed=1)
    probe = compile_chip(_tspec(), params=tparams, device="cpu")
    rate = 3.5 * probe.mapping.items_per_second_capacity
    jc = jcompile.compile_chip(_jspec(), params=jparams,
                               items_per_second=rate,
                               noise=JNoise(**noise_kw))
    tc = compile_chip(_tspec(), params=tparams, items_per_second=rate,
                      noise=RefDrawsNoise(**noise_kw), device="cpu")
    assert tc.replication == jc.replication > 1
    x = np.random.default_rng(3).uniform(
        0, 1, (3 * tc.replication + 1, 64)).astype(np.float32)
    keep = _band_rows(jc.plan, jnp.asarray(x))
    for _ in range(2):
        want = np.asarray(jc.stream(jnp.asarray(x)))
        single = tc.stream(torch.from_numpy(x), fan_out=False,
                           advance_age=False).numpy()
        got = tc.stream(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, single, rtol=1e-6, atol=1e-6)
        assert _rel(got[keep], want[keep]) <= 1e-6
    assert tc.items_streamed == 2 * x.shape[0]


# ------------------------- drift clock, reprogram --------------------- #
def test_drift_ages_stream_and_probe_does_not_age(tparams, batch):
    x = torch.from_numpy(batch)
    chip = compile_chip(_tspec(), params=tparams,
                        noise=NoiseModel(drift_rate=2e-3), device="cpu")
    fresh = chip.stream(x, advance_age=False)
    assert chip.items_streamed == 0
    ideal = compile_chip(_tspec(), params=tparams, device="cpu").stream(x)
    assert torch.equal(fresh, ideal)          # age 0 == ideal, bitwise
    for _ in range(10):
        chip.stream(x)
    assert chip.items_streamed == 480
    assert not torch.equal(chip.stream(x, advance_age=False), fresh)
    chip.reset_age()
    assert torch.equal(chip.stream(x, advance_age=False), fresh)


def test_serving_ages_the_chip(tparams):
    chip = compile_chip(_tspec(), params=tparams,
                        noise=NoiseModel(drift_rate=2e-3), device="cpu")
    eng = chip.serve(slots=2)
    for uid in range(3):
        eng.submit(ChipRequest(uid=uid, items=np.full((2, 64), 0.5,
                                                      np.float32)))
    eng.run_until_drained()
    assert chip.items_streamed == 2 * eng.steps


def test_reprogram_resets_age_and_restores_exactly(tparams, batch):
    x = torch.from_numpy(batch)
    chip = compile_chip(_tspec(), params=tparams,
                        noise=NoiseModel(drift_rate=2e-3), device="cpu")
    fresh = chip.stream(x, advance_age=False)
    for _ in range(10):
        chip.stream(x)
    c0 = tcompile.compile_count()
    tel = tobs.configure()
    try:
        re = reprogram_chip(chip, tparams)
        snap = tel.metrics.snapshot()
        events = tel.tracer.trace_events()
    finally:
        tobs.disable()
    assert tcompile.compile_count() - c0 == 0
    assert re.items_streamed == 0 and chip.items_streamed == 480
    assert re.mapping is chip.mapping and re.route is chip.route
    assert re.noise == chip.noise and re.__dict__["_noise_epoch"] == 1
    assert torch.equal(re.stream(x, advance_age=False), fresh)
    assert snap["counters"]["chip.reprograms"] == 1
    assert any(e["name"] == "chip.reprogram" and e["args"]["epoch"] == 1
               for e in events)
    assert reprogram_chip(re, tparams).__dict__["_noise_epoch"] == 2
    assert reprogram_chip(re, tparams, noise=None).noise is None


def test_reprogram_rerolls_write_noise_and_keeps_stuck_cells(tparams,
                                                             batch):
    x = torch.from_numpy(batch)
    chip = compile_chip(_tspec(), params=tparams,
                        noise=NoiseModel(program_sigma=0.3), device="cpu")
    again = compile_chip(_tspec(), params=tparams,
                         noise=NoiseModel(program_sigma=0.3), device="cpu")
    assert torch.equal(again.stream(x), chip.stream(x))  # same epoch
    assert not torch.equal(reprogram_chip(chip, tparams).stream(x),
                           chip.stream(x))
    stuck = compile_chip(_tspec(), params=tparams,
                         noise=NoiseModel(stuck_on_frac=0.05,
                                          stuck_off_frac=0.05),
                         device="cpu")
    assert torch.equal(reprogram_chip(stuck, tparams).stream(x),
                       stuck.stream(x))
    ir = compile_chip(_tspec(), params=tparams,
                      noise=NoiseModel(ir_drop_r_seg=5.0), device="cpu")
    ideal = compile_chip(_tspec(), params=tparams, device="cpu")
    assert not torch.equal(ir.plan[0].tiles.gp, ideal.plan[0].tiles.gp)


def test_reprogram_refusals_match_the_reference(jparams, tparams):
    prog = tcl.program_mlp(tparams, _tspec())
    chip = compile_chip(prog, system="memristor")
    with pytest.raises(ValueError, match="pre-programmed MLP"):
        reprogram_chip(chip, tparams)
    jchip = jcompile.compile_chip(jcl.program_mlp(jparams, _jspec()),
                                  system="memristor")
    with pytest.raises(ValueError, match="pre-programmed MLP"):
        jcompile.reprogram_chip(jchip, jparams)
    # with the encoding given, it re-encodes
    re = reprogram_chip(chip, tparams, weight_bits=8,
                        device_model=TDEVICE, r_seg=0.0)
    assert re.program_kw is None and re.plan is not chip.plan
    with pytest.raises(ValueError, match="analytic-only"):
        reprogram_chip(compile_chip((1, (64, 10)), device="cpu"), tparams)
    good = compile_chip(_tspec(), params=tparams, device="cpu")
    with pytest.raises(ValueError, match="do not match the compiled"):
        reprogram_chip(good, tparams[:1])
    with pytest.raises(ValueError, match="do not match the compiled"):
        reprogram_chip(good, tparams, spec=tcl.MLPSpec((64, 10)))
    assert good.program_kw == dict(weight_bits=8, device_model=TDEVICE,
                                   r_seg=0.0)


# ------------------------- the port's own draws ----------------------- #
def test_stream_seeds_are_fixed_and_distinct():
    assert tnoise.stream_seed(0, 1, 2) == tnoise.stream_seed(0, 1, 2)
    seeds = {tnoise.stream_seed(s, layer, p, e)
             for s in range(3) for layer in range(3)
             for p in (tnoise._FOLD_PROGRAM, tnoise._FOLD_STUCK)
             for e in range(3)}
    assert len(seeds) == 54
    assert all(0 <= s < 2 ** 64 for s in seeds)


def test_lognormal_multiplier_has_mean_one():
    nm = NoiseModel(program_sigma=0.3)
    g = torch.full((64, 64, 16), 4e-6)
    dm = TDeviceModel(g_on=1.0, g_off=0.0)     # no clip in the way
    gp, _ = nm.perturb(g, g, dm)
    m = (gp / g).double()
    se = float(m.std()) / m.numel() ** 0.5
    assert abs(float(m.mean()) - 1.0) <= 3 * se
    # lognormal: log m ~ N(-σ²/2, σ²)
    lm = torch.log(m)
    assert abs(float(lm.std()) - 0.3) <= 0.01
    assert abs(float(lm.mean()) + 0.045) <= 3 * 0.3 / lm.numel() ** 0.5


@pytest.mark.parametrize("on,off", [(0.01, 0.01), (0.05, 0.2)])
def test_stuck_fractions_are_binomial(on, off):
    nm = NoiseModel(stuck_on_frac=on, stuck_off_frac=off, seed=9)
    g = torch.full((40, 32, 32), 3e-6)
    gp, gn = nm.perturb(g, g.clone(), TDEVICE, layer=2)
    n = g.numel()
    for x in (gp, gn):
        for frac, level in ((on, TDEVICE.g_on), (off, TDEVICE.g_off)):
            k = int((x == torch.tensor(level, dtype=torch.float32)).sum())
            sd = (n * frac * (1 - frac)) ** 0.5
            assert abs(k - n * frac) <= 4 * sd, (frac, k)


def test_drift_rates_lie_in_their_band_with_mean_r():
    r, s = 2e-4, 0.5
    field = NoiseModel(drift_rate=r, drift_spread=s, seed=1).drift_field(
        (50, 4, 32, 32), layer=1)
    assert field.dtype == torch.float32
    assert float(field.min()) >= r * (1 - s) * (1 - 1e-6)
    assert float(field.max()) <= r * (1 + s) * (1 + 1e-6)
    se = r * s / 3 ** 0.5 / field.numel() ** 0.5
    assert abs(float(field.double().mean()) - r) <= 3 * se


def test_write_noise_rerolls_per_epoch_defects_persist():
    nm = NoiseModel(program_sigma=0.2, stuck_on_frac=0.1,
                    drift_rate=1e-4, seed=4)
    shape = (2, 2, 16, 8)
    z0 = nm.write_draws(shape, layer=0, epoch=0)
    z1 = nm.write_draws(shape, layer=0, epoch=1)
    assert torch.equal(z0[0], nm.write_draws(shape, layer=0, epoch=0)[0])
    assert not torch.equal(z0[0], z1[0])
    assert not torch.equal(z0[0], z0[1])          # σ⁺ and σ⁻ differ
    assert not torch.equal(z0[0], nm.write_draws(shape, layer=1)[0])
    # stuck masks and drift rates carry no epoch: the same every time
    assert torch.equal(nm.stuck_draws(shape, layer=0)[0],
                       nm.stuck_draws(shape, layer=0)[0])
    assert torch.equal(nm.drift_field(shape, layer=0),
                       nm.drift_field(shape, layer=0))
    g = torch.full(shape, 2e-6)
    a = nm.perturb(g, g, TDEVICE, epoch=0)[0]
    b = nm.perturb(g, g, TDEVICE, epoch=1)[0]
    stuck = a == torch.tensor(TDEVICE.g_on, dtype=torch.float32)
    assert bool(stuck.any())
    assert torch.equal(stuck, b == torch.tensor(TDEVICE.g_on,
                                                dtype=torch.float32))
    assert not torch.equal(a[~stuck], b[~stuck])


# ------------------------- validation --------------------------------- #
@pytest.mark.parametrize("kw", [dict(program_sigma=-0.1),
                                dict(drift_rate=-1e-3),
                                dict(ir_drop_r_seg=-1.0),
                                dict(drift_spread=1.5),
                                dict(drift_spread=-0.1),
                                dict(stuck_on_frac=1.2),
                                dict(stuck_off_frac=-0.1),
                                dict(stuck_on_frac=0.7, stuck_off_frac=0.6)])
def test_noise_model_validation_matches_reference(kw):
    with pytest.raises(ValueError) as jerr:
        JNoise(**kw)
    with pytest.raises(ValueError) as terr:
        NoiseModel(**kw)
    assert str(terr.value) == str(jerr.value)


def test_noise_model_gates_match_reference():
    for kw in (dict(), dict(drift_rate=1e-3), dict(program_sigma=0.1),
               dict(ir_drop_r_seg=1.0), dict(stuck_off_frac=0.1),
               dict(seed=5)):
        j, t = JNoise(**kw), NoiseModel(**kw)
        assert (t.is_ideal, t.has_drift) == (j.is_ideal, j.has_drift)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


# ------------------------- feedback write ----------------------------- #
def _targets(seed, shape):
    gen = torch.Generator().manual_seed(seed)
    return TDEVICE.g_off + torch.rand(shape, generator=gen) * \
        TDEVICE.g_range


def test_feedback_write_converges_within_tolerance():
    cfg = tprog.ProgrammingConfig()
    res = tprog.feedback_write(_targets(0, (32, 16)),
                               torch.Generator().manual_seed(1), cfg)
    assert bool(res.converged.all())
    assert float(res.error.max()) <= cfg.tol_frac
    assert res.pulses.dtype == torch.int32


def test_variation_costs_pulses_not_accuracy():
    tgt = _targets(2, (16, 16))
    lo = tprog.feedback_write(tgt, torch.Generator().manual_seed(3),
                              tprog.ProgrammingConfig(
                                  device_model=TDeviceModel(
                                      write_sigma=0.02)))
    hi = tprog.feedback_write(tgt, torch.Generator().manual_seed(3),
                              tprog.ProgrammingConfig(
                                  device_model=TDeviceModel(
                                      write_sigma=0.5)))
    assert bool(lo.converged.all()) and bool(hi.converged.all())
    assert float(hi.error.max()) <= tprog.ProgrammingConfig().tol_frac
    assert int(hi.pulses.sum()) > int(lo.pulses.sum())


def test_feedback_write_stops_where_the_reference_loop_stops(monkeypatch):
    """Checking the loop condition on the host only every few pulses
    changes nothing: the masked iterations are no-ops."""
    tgt = _targets(4, (8, 8))
    runs = []
    for every in (1, 64):
        monkeypatch.setattr(tprog, "CHECK_EVERY", every)
        runs.append(tprog.feedback_write(tgt,
                                         torch.Generator().manual_seed(5)))
    assert torch.equal(runs[0].g, runs[1].g)
    assert torch.equal(runs[0].pulses, runs[1].pulses)


def test_program_pair_and_programming_time():
    gen = torch.Generator().manual_seed(4)
    w = torch.rand((8, 8), generator=gen) * 2 - 1
    from repro_torch.core.crossbar import pairs_from_weights
    gp_t, gn_t, scale = pairs_from_weights(w, quantize=False)
    rp, rn = tprog.program_pair(gp_t, gn_t, torch.Generator().manual_seed(5))
    w_prog = TDEVICE.weight_from_pair(rp.g, rn.g) * scale
    np.testing.assert_allclose(w_prog.numpy(), w.numpy(), atol=2.5 / 256)
    t = float(tprog.programming_time_s(rp.pulses))
    assert t == pytest.approx(int(rp.pulses.sum()) * (100e-9 + 1e-9))
    assert t > 10e-9


# ------------------------- monitor and closed loop -------------------- #
class StandInDeployment:
    """What the recalibrator drives: one app on one chip, reprogrammed
    in place through ``reprogram_chip``."""

    def __init__(self, chip, params):
        self.chip = chip
        self._params = params

    def params(self, app):
        return self._params

    def reprogram(self, app, params):
        self.chip = reprogram_chip(self.chip, params)


class Board:
    def __init__(self):
        self.events = []

    def publish_event(self, kind, payload):
        self.events.append(dict(kind=kind, **payload))


def test_monitor_and_closed_loop_recover_with_zero_compiles(tparams):
    chip = compile_chip(_tspec(), params=tparams,
                        noise=NoiseModel(drift_rate=5e-3), device="cpu")
    dep = StandInDeployment(chip, tparams)
    canary = np.random.default_rng(2).uniform(0, 1, (128, 64)).astype(
        np.float32)
    monitor = AccuracyMonitor(lambda: dep.chip, canary, every_steps=2)
    board = Board()
    recal = Recalibrator(dep, "app", monitor,
                         RecalPolicy(slo=0.99, cooldown_steps=4),
                         board=board)
    c0 = tcompile.compile_count()
    assert monitor.score().accuracy == 1.0      # attach-time baseline
    rng = np.random.default_rng(0)
    tel = tobs.configure()
    try:
        for _ in range(20):
            dep.chip.stream(torch.from_numpy(
                rng.random((64, 64), dtype=np.float32)))
            monitor.on_step(None)
            recal.on_step(None)
        snap = tel.metrics.snapshot()
    finally:
        tobs.disable()
    accs = [s.accuracy for s in monitor.samples]
    assert min(accs) < 0.99                     # drift breached the SLO
    assert recal.events                         # and the loop reacted
    assert tcompile.compile_count() - c0 == 0   # with zero compiles
    assert min(e.accuracy_after for e in recal.events) == 1.0
    assert all(e.compile_delta == 0 for e in recal.events)
    assert monitor.samples[-1].items_streamed < 20 * 64
    assert [e["kind"] for e in board.events] == \
        ["recalibration"] * len(recal.events)
    key = [k for k in snap["counters"] if k.startswith("variability.recals")]
    assert key and snap["counters"][key[0]] == len(recal.events)
    assert recal.summary()["recals"] == len(recal.events)
    assert monitor.summary()["series"]["accuracy"] == accs


def test_monitor_probes_never_age_the_chip(tparams):
    chip = compile_chip(_tspec(), params=tparams,
                        noise=NoiseModel(drift_rate=2e-3), device="cpu")
    canary = np.random.default_rng(3).uniform(0, 1, (64, 64)).astype(
        np.float32)
    monitor = AccuracyMonitor(lambda: chip, canary, name="probe")
    s0 = monitor.score()
    assert s0.accuracy == 1.0 and s0.items_streamed == 0
    assert chip.items_streamed == 0
    chip.stream(torch.from_numpy(canary))
    assert monitor.score().items_streamed == 64
    assert monitor.summary()["probes"] == 2
    with pytest.raises(ValueError, match="reference"):
        AccuracyMonitor(lambda: chip, canary, reference=[0, 1])
    with pytest.raises(ValueError, match="every_steps"):
        AccuracyMonitor(lambda: chip, canary, every_steps=0)


def test_monitor_series_matches_the_reference(jparams, tparams):
    """On the reference's drift fields the port's canary series is the
    reference's, probe for probe."""
    from repro.variability import AccuracyMonitor as JMonitor
    jc = jcompile.compile_chip(_jspec(), params=jparams,
                               noise=JNoise(drift_rate=5e-3))
    tc = compile_chip(_tspec(), params=tparams,
                      noise=RefDrawsNoise(drift_rate=5e-3), device="cpu")
    canary = np.random.default_rng(4).uniform(0, 1, (96, 64)).astype(
        np.float32)
    jm, tm = JMonitor(lambda: jc, canary), AccuracyMonitor(lambda: tc,
                                                           canary)
    np.testing.assert_array_equal(tm.reference, jm.reference)
    rng = np.random.default_rng(5)
    for _ in range(6):
        x = rng.random((128, 64), dtype=np.float32)
        jc.stream(jnp.asarray(x))
        tc.stream(torch.from_numpy(x))
        assert tm.score().accuracy == jm.score().accuracy
    assert tm.series() == jm.series()
    assert min(tm.series()["accuracy"]) < 1.0


def test_recal_policy_and_params_checks_match_reference(tparams):
    from repro.variability import RecalPolicy as JPolicy
    for kw in (dict(slo=0.0), dict(slo=1.5), dict(patience=0),
               dict(cooldown_steps=-1)):
        with pytest.raises(ValueError) as jerr:
            JPolicy(**kw)
        with pytest.raises(ValueError) as terr:
            RecalPolicy(**kw)
        assert str(terr.value) == str(jerr.value)
    chip = compile_chip(_tspec(), params=tparams, device="cpu")
    dep = StandInDeployment(chip, None)
    monitor = AccuracyMonitor(lambda: dep.chip, np.zeros((8, 64),
                                                         np.float32))
    with pytest.raises(ValueError, match="no stored"):
        Recalibrator(dep, "app", monitor).recalibrate()
    fn = Recalibrator(dep, "app", monitor, params_fn=lambda: tparams)
    assert fn.recalibrate().compile_delta == 0
    assert dep.chip is not chip
