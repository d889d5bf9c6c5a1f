"""Memristor device model (paper section IV.A).

Port of ``repro.core.device``: the conductance-domain view of the
two-terminal resistive switch of Lu et al. [22] (Yakopcic model [21]):

  R_on  = 125 kΩ         (minimum resistance, from [22])
  ratio = 1000           (R_off = 125 MΩ)
  precision              ~7 bits per device [20]; 2 devices/synapse → ~8b

Conductances are in [G_OFF, G_ON] = [8 nS, 8 µS]. A synapse is a
*differential pair* (σ⁺, σ⁻); its weight is σ⁺ − σ⁻ scaled by the pair
range, giving signed weights from strictly positive devices.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

# -- published device constants (Lu et al. [22] via Yakopcic model [21]) --
R_ON_OHM = 125e3
R_RATIO = 1000.0
R_OFF_OHM = R_ON_OHM * R_RATIO
G_ON = 1.0 / R_ON_OHM          # 8 µS
G_OFF = 1.0 / R_OFF_OHM        # 8 nS
SWITCH_TIME_S = 80e-9          # full-range switch
SWITCH_VOLT = 4.25
DEVICE_BITS = 7                # achievable per-device precision [20]

# Yakopcic model parameters used for Fig. 10 (recorded for provenance;
# the transfer characteristics above are what the system model consumes).
YAKOPCIC_PARAMS = dict(Vp=4.0, Vn=4.0, Ap=816000.0, An=816000.0,
                       xp=0.9897, xn=0.9897, ap=0.2, an=0.2)


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """Conductance-domain view of the memristor device."""
    g_on: float = G_ON
    g_off: float = G_OFF
    bits: int = DEVICE_BITS
    # lognormal sigma of the per-pulse response multiplier and the
    # ADC-referred read noise of feedback write; carried for parity with
    # the reference (the variability slice consumes them)
    write_sigma: float = 0.15
    read_sigma: float = 1.0 / 1024.0

    @property
    def g_range(self) -> float:
        return self.g_on - self.g_off

    @property
    def levels(self) -> int:
        return 2 ** self.bits

    def clip(self, g: torch.Tensor) -> torch.Tensor:
        return torch.clamp(g, self.g_off, self.g_on)

    # -- weight <-> differential conductance pair ----------------------- #
    def pair_from_weight(self, w: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Signed weight in [-1, 1] → (σ⁺, σ⁻), one device at G_OFF."""
        w = torch.clamp(w, -1.0, 1.0)
        mag = torch.abs(w) * self.g_range
        floor = torch.full_like(w, self.g_off)
        gp = torch.where(w >= 0, self.g_off + mag, floor)
        gn = torch.where(w >= 0, floor, self.g_off + mag)
        return gp, gn

    def weight_from_pair(self, gp: torch.Tensor,
                         gn: torch.Tensor) -> torch.Tensor:
        return (gp - gn) / self.g_range

    def quantize_g(self, g: torch.Tensor) -> torch.Tensor:
        """Snap conductance to the device's programmable levels
        (``torch.round`` rounds half to even, as ``jnp.round`` does)."""
        step = self.g_range / (self.levels - 1)
        return self.g_off + torch.round((g - self.g_off) / step) * step


DEFAULT_DEVICE = DeviceModel()
