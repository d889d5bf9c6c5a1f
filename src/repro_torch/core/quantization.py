"""8-bit quantization and activations (paper §II.A, §V.A).

Port of the parts of ``repro.core.quantization`` that programming and
streaming use: symmetric int weight quantization for the SRAM digital
core, the memristor threshold (inverter pair) and the float-domain
activation table. ``torch.round`` rounds half to even, as
``jnp.round`` does, so the integer codes agree exactly.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch


def weight_scale(w: torch.Tensor, bits: int = 8, per_column: bool = False,
                 eps: float = 1e-12) -> torch.Tensor:
    """Symmetric quantization scale: max|w| maps to the top code."""
    qmax = 2.0 ** (bits - 1) - 1.0
    amax = torch.amax(torch.abs(w), dim=0, keepdim=True) if per_column \
        else torch.amax(torch.abs(w))
    return torch.clamp(amax, min=eps) / qmax


def quantize_weights(w: torch.Tensor, bits: int = 8,
                     per_column: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float weights → (int codes, scale). codes ∈ [-qmax, qmax]; int8
    up to 8 bits, int32 above."""
    qmax = 2.0 ** (bits - 1) - 1.0
    s = weight_scale(w, bits, per_column)
    q = torch.clamp(torch.round(w / s), -qmax, qmax)
    return q.to(torch.int8 if bits <= 8 else torch.int32), s


def threshold(x: torch.Tensor) -> torch.Tensor:
    """Memristor core activation: back-to-back inverter pair (Fig. 5),
    ±1 rails; an ideal comparator on DP_j."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def threshold_ste(x: torch.Tensor, slope: float = 4.0) -> torch.Tensor:
    """Trainable surrogate: hard threshold forward, steep-tanh
    backward. The forward value is exactly :func:`threshold`."""
    soft = torch.tanh(slope * x)
    return soft + (threshold(x) - soft).detach()


def make_activation(kind: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Float-domain activation: 'threshold' — memristor inverter pair;
    'sigmoid' — digital LUT target; 'tanh'; 'relu'; 'linear' — combiner
    neurons (Fig. 11 keeps sub-neuron sums linear)."""
    return {
        "threshold": threshold_ste,
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "relu": torch.relu,
        "linear": lambda x: x,
    }[kind]
