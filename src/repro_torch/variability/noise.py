"""Non-ideal memristor devices: the noise model.

Port of ``repro.variability.noise``. The device model
(``repro_torch.core.device``) is *ideal* at system level: programming
lands exactly on the feedback-write target, conductances hold forever,
and every cell responds. Real 1T1M arrays do none of that.
:class:`NoiseModel` is the one container for those effects, consumed
at two points:

  PROGRAM time (``repro_torch.core.crossbar_layer.program_layer``)
    * ``program_sigma`` — mean-one lognormal multiplier on every
      programmed conductance, drawn afresh per programming *epoch*.
    * ``stuck_on_frac`` / ``stuck_off_frac`` — Bernoulli fraction of
      devices stuck at G_ON / G_OFF; the SAME cells stay stuck across
      epochs.
    * ``ir_drop_r_seg`` — per-segment wire resistance (Ω), folded as
      the wire-attenuation transform.

  STREAM time (``repro_torch.chip.compile.stream_pipeline``)
    * ``drift_rate`` — per-item conductance relaxation toward G_OFF:
      each weight's magnitude decays as ``exp(-rate_cell · age)``, with
      ``rate_cell = drift_rate × U[1-drift_spread, 1+drift_spread]``
      drawn once per device and ``age`` the items streamed since the
      last programming event.

The ideal model (all effects zero — the default) is a structural
no-op: every hook is gated on :attr:`is_ideal` / :attr:`has_drift`, so
it runs the same code path as no model at all.

Random streams. The reference derives one ``jax.random`` key per
(seed, layer, purpose[, epoch]) by ``fold_in``; threefry cannot be
reproduced with a ``torch.Generator``. Here the same tuple is mixed
into one 64-bit seed (:func:`stream_seed`, a fixed splitmix64 chain)
for an explicit CPU generator, so a noisy chip is the same chip on the
CPU and on the card (the draws are moved to the tiles' device). Each
effect is split into a *draw* (``*_draws``, ``drift_draws``) and an
*apply* (:func:`apply_write_noise`, :func:`apply_stuck`,
:func:`drift_from_uniform`), so the parity tests can feed the
reference's own draws to the port's arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

# purpose separators of the per-effect random streams (the reference's
# fold-in constants): write noise re-rolls per epoch, defects persist
_FOLD_PROGRAM = 0x9E37
_FOLD_STUCK = 0x5BD1
_FOLD_DRIFT = 0x85EB

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(*words: int) -> int:
    """A fixed 64-bit mix of integer words (seed, layer, purpose,
    epoch): distinct tuples give unrelated generator seeds."""
    h = 0
    for w in words:
        h = _splitmix64(h ^ (int(w) & _MASK64))
    return h


def _generator(*words: int) -> torch.Generator:
    return torch.Generator().manual_seed(stream_seed(*words))


# ---------------- the apply steps (the arithmetic under test) ---------- #
def apply_write_noise(g: torch.Tensor, z: torch.Tensor, sigma: float,
                      device_model) -> torch.Tensor:
    """Mean-one lognormal write error for standard-normal draws ``z``."""
    return device_model.clip(g * torch.exp(sigma * z - 0.5 * sigma * sigma))


def apply_stuck(g: torch.Tensor, u: torch.Tensor, on_frac: float,
                off_frac: float, device_model) -> torch.Tensor:
    """Stuck-cell overrides for uniform draws ``u`` in [0, 1): the
    first ``on_frac`` of the unit interval sticks at G_ON, the next
    ``off_frac`` at G_OFF."""
    g = torch.where(u < on_frac, torch.full_like(g, device_model.g_on), g)
    return torch.where((u >= on_frac) & (u < on_frac + off_frac),
                       torch.full_like(g, device_model.g_off), g)


def drift_from_uniform(u: torch.Tensor, drift_rate: float) -> torch.Tensor:
    """Per-cell relaxation rates for draws ``u`` in [1-s, 1+s)."""
    return (drift_rate * u).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class NoiseModel:
    """Non-ideal device effects for the memristor fabric (see module
    docstring). All-zero (the default) is exactly the ideal device.
    Digital (SRAM) fabrics ignore the model entirely."""
    program_sigma: float = 0.0      # lognormal σ on programmed g
    drift_rate: float = 0.0         # mean relaxation rate per item
    drift_spread: float = 1.0       # per-cell rate heterogeneity
    stuck_on_frac: float = 0.0      # fraction of cells stuck at G_ON
    stuck_off_frac: float = 0.0     # fraction stuck at G_OFF
    ir_drop_r_seg: float = 0.0      # wire segment resistance (Ω)
    seed: int = 0

    def __post_init__(self):
        for name in ("program_sigma", "drift_rate", "ir_drop_r_seg"):
            if getattr(self, name) < 0:
                raise ValueError(f"NoiseModel: {name} must be >= 0")
        if not 0.0 <= self.drift_spread <= 1.0:
            raise ValueError("NoiseModel: drift_spread must be in "
                             "[0, 1] (per-cell rates stay >= 0)")
        for name in ("stuck_on_frac", "stuck_off_frac"):
            if not 0.0 <= getattr(self, name) <= 1.0:
                raise ValueError(f"NoiseModel: {name} must be in [0, 1]")
        if self.stuck_on_frac + self.stuck_off_frac > 1.0:
            raise ValueError("NoiseModel: stuck_on_frac + "
                             "stuck_off_frac must be <= 1")

    # ---------------- gates --------------------------------------- #
    @property
    def is_ideal(self) -> bool:
        """True when every effect is off — the hooks then run the
        exact unperturbed code path."""
        return (self.program_sigma == 0.0 and self.drift_rate == 0.0
                and self.stuck_on_frac == 0.0
                and self.stuck_off_frac == 0.0
                and self.ir_drop_r_seg == 0.0)

    @property
    def has_drift(self) -> bool:
        return self.drift_rate > 0.0

    # ---------------- draws (CPU, f32) ---------------------------- #
    def write_draws(self, shape: Sequence[int], *, layer: int = 0,
                    epoch: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Standard normals for σ⁺ and σ⁻, fresh per programming
        event (write noise re-rolls)."""
        gen = _generator(self.seed, layer, _FOLD_PROGRAM, epoch)
        return (torch.randn(tuple(shape), generator=gen),
                torch.randn(tuple(shape), generator=gen))

    def stuck_draws(self, shape: Sequence[int], *, layer: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Uniforms for σ⁺ and σ⁻; epoch-INdependent: the same
        physical cells stay stuck."""
        gen = _generator(self.seed, layer, _FOLD_STUCK)
        return (torch.rand(tuple(shape), generator=gen),
                torch.rand(tuple(shape), generator=gen))

    def drift_draws(self, shape: Sequence[int], *,
                    layer: int = 0) -> torch.Tensor:
        """Uniforms in [1-drift_spread, 1+drift_spread)."""
        gen = _generator(self.seed, layer, _FOLD_DRIFT)
        u = torch.rand(tuple(shape), generator=gen)
        return u * (2.0 * self.drift_spread) + (1.0 - self.drift_spread)

    # ---------------- program-time effects ------------------------ #
    def perturb(self, gp: torch.Tensor, gn: torch.Tensor, device_model, *,
                layer: int = 0, epoch: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Apply the programming-time effects to an encoded tile grid:
        mean-one lognormal write error (fresh per ``epoch``), then the
        persistent stuck-cell overrides. Caller applies IR drop via
        the wire-attenuation fold (``ir_drop_r_seg``)."""
        if self.program_sigma > 0.0:
            zp, zn = self.write_draws(gp.shape, layer=layer, epoch=epoch)
            gp = apply_write_noise(gp, zp.to(gp.device), self.program_sigma,
                                   device_model)
            gn = apply_write_noise(gn, zn.to(gn.device), self.program_sigma,
                                   device_model)
        if self.stuck_on_frac > 0.0 or self.stuck_off_frac > 0.0:
            up, un = self.stuck_draws(gp.shape, layer=layer)
            gp = apply_stuck(gp, up.to(gp.device), self.stuck_on_frac,
                             self.stuck_off_frac, device_model)
            gn = apply_stuck(gn, un.to(gn.device), self.stuck_on_frac,
                             self.stuck_off_frac, device_model)
        return gp, gn

    # ---------------- stream-time drift --------------------------- #
    def drift_field(self, shape: Sequence[int], *, layer: int = 0,
                    device=None) -> torch.Tensor:
        """Per-cell relaxation rates for one layer's tile grid
        (epoch-independent — retention is a device property), f32 on
        ``device`` (default the CPU). The streamed decay is then
        ``exp(-field · age)``."""
        field = drift_from_uniform(self.drift_draws(shape, layer=layer),
                                   self.drift_rate)
        return field if device is None else field.to(device)
