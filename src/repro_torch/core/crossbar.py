"""Memristor crossbar functional model — Eq. 3 (paper §III.A/B).

Port of ``repro.core.crossbar``. A column j of the crossbar with
differential input pairs computes

            Σ_i x_i (σ⁺_ij − σ⁻_ij)
  DP_j  =  ─────────────────────────            (Eq. 3)
            Σ_i (σ⁺_ij + σ⁻_ij)

i.e. a resistive divider: the numerator is the signed analog dot
product, the denominator the total column loading. Consequences
modelled here, and folded into the kernels' program-time scales:

  * the column gain Σ(σ⁺+σ⁻) depends only on the programmed weights,
    so it is computed once per tile and folded into downstream scales;
  * a threshold activation (inverter pair) is gain-invariant (sign
    only), which is why the paper pairs Eq. 3 with thresholds;
  * wire resistance attenuates devices far from the row inputs (a
    first-order series-resistance correction per (row, col) position).

Inputs are analog voltages in [-1, 1]. Conductance tiles are
(..., M, N): leading dimensions are tiles (the reference maps one tile
and vmaps), and an input x (..., B, M) meets them as ``torch.matmul``
broadcasts; a 1-D x (M,) is one input vector.
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


def _attenuated(gp: torch.Tensor, gn: torch.Tensor, r_seg: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    if not r_seg:
        return gp, gn
    att = wire_attenuation(gp.shape[-2], gp.shape[-1],
                           float(DEFAULT_DEVICE.g_on), r_seg,
                           device=gp.device)
    return gp * att, gn * att


def _per_column(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-column (..., N) factor, set against x @ w's (..., B, N)."""
    return t.unsqueeze(-2) if x.dim() > 1 else t


def eq3_dot_product(x: torch.Tensor, gp: torch.Tensor, gn: torch.Tensor,
                    r_seg: float = 0.0) -> torch.Tensor:
    """Eq. 3 for batched inputs: x (..., B, M) or (M,) voltages in
    [-1, 1], gp/gn (..., M, N) conductance pairs → DP (..., B, N)
    voltages, |DP| ≤ max|x| (a divider). ``r_seg`` > 0 attenuates the
    devices first (``wire_attenuation`` at the default device's G_ON,
    as the reference does)."""
    gp, gn = _attenuated(gp, gn, r_seg)
    num = torch.matmul(x, gp - gn)
    den = torch.sum(gp + gn, dim=-2)          # input-independent loading
    return num / _per_column(den, x)


def column_gain(gp: torch.Tensor, gn: torch.Tensor) -> torch.Tensor:
    """The per-column divider loading Σ(σ⁺+σ⁻) — Eq. 3's denominator
    (summed over the second-to-last, row, axis)."""
    return torch.sum(gp + gn, dim=-2)


def effective_weights(gp: torch.Tensor, gn: torch.Tensor,
                      r_seg: float = 0.0) -> torch.Tensor:
    """The float weights Eq. 3 actually implements, tile by tile:
    W_eff[i, j] = (σ⁺−σ⁻)[i, j] / Σ_i(σ⁺+σ⁻)[j]."""
    gp, gn = _attenuated(gp, gn, r_seg)
    return (gp - gn) / torch.sum(gp + gn, dim=-2, keepdim=True)


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


def crossbar_forward(x: torch.Tensor, w: torch.Tensor, *,
                     device_model: DeviceModel = DEFAULT_DEVICE,
                     r_seg: float = 0.0, quantize: bool = True,
                     compensate_gain: bool = True) -> torch.Tensor:
    """End-to-end: float weight tiles (..., M, N) → pairs → Eq. 3 →
    (optionally) the de-gained dot product. The single-tile reference
    the kernels, the mapper and the app benchmarks share."""
    gp, gn, scale = pairs_from_weights(w, device_model, quantize)
    dp = eq3_dot_product(x, gp, gn, r_seg)
    if compensate_gain:
        den = _per_column(column_gain(gp, gn), x)
        dp = dp * den / device_model.g_range * _per_column(scale[..., 0, :],
                                                          x)
    return dp
