"""Memristor crossbar functional model — Eq. 3 (paper §III.A/B).

Port of the parts of ``repro.core.crossbar`` that programming uses. A
column j of the crossbar with differential input pairs computes

            Σ_i x_i (σ⁺_ij − σ⁻_ij)
  DP_j  =  ─────────────────────────            (Eq. 3)
            Σ_i (σ⁺_ij + σ⁻_ij)

The column gain Σ(σ⁺+σ⁻) depends only on the programmed weights, so it
is computed once per tile and folded into downstream scales; wire
resistance attenuates devices far from the drivers (a first-order
series-resistance correction per (row, col) position).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.device import DEFAULT_DEVICE, DeviceModel

# Per-segment crossbar wire resistance (Ω) — 45 nm metal, one cell pitch.
WIRE_R_OHM = 2.5


def wire_attenuation(rows: int, cols: int, g_nominal: float,
                     r_seg: float = WIRE_R_OHM, *,
                     device: torch.device = torch.device("cpu")
                     ) -> torch.Tensor:
    """First-order attenuation factor per device position: a device
    at (i, j) sees ≈ r_seg·(i + (cols − 1 − j)) of series wire, so its
    effective conductance is G/(1 + G·R_path). (rows, cols) f32."""
    i = torch.arange(rows, dtype=torch.float32, device=device)[:, None]
    j = torch.arange(cols, dtype=torch.float32, device=device)[None, :]
    r_path = r_seg * (i + (cols - 1 - j))
    return 1.0 / (1.0 + g_nominal * r_path)


def column_gain(gp: torch.Tensor, gn: torch.Tensor) -> torch.Tensor:
    """The per-column divider loading Σ(σ⁺+σ⁻) — Eq. 3's denominator
    (summed over the second-to-last, row, axis)."""
    return torch.sum(gp + gn, dim=-2)


def pairs_from_weights(w: torch.Tensor,
                       device_model: DeviceModel = DEFAULT_DEVICE,
                       quantize: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Map float weight tiles (..., M, N) onto differential pairs.

    Each tile is normalized to its own max|w|, then encoded as
    (σ⁺, σ⁻) with the complementary device parked at G_OFF. Returns
    (gp, gn, amax) with amax of shape (..., 1, 1). The reference maps
    one tile and vmaps; here leading dimensions are tiles."""
    amax = torch.clamp(torch.amax(torch.abs(w), dim=(-2, -1),
                                  keepdim=True), min=1e-12)
    gp, gn = device_model.pair_from_weight(w / amax)
    if quantize:
        gp = device_model.quantize_g(gp)
        gn = device_model.quantize_g(gn)
    return gp, gn, amax
