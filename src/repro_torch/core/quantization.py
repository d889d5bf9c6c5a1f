"""8-bit quantization: weights, activations, DAC/LUT (paper §II.A, §V.A).

Port of ``repro.core.quantization``. The SRAM digital core stores
8-bit synapses and streams 8-bit inputs; the memristor core receives
inputs through 8-bit DACs. Both are *ex-situ* trained: off-chip in
float or quantization-aware float, then programmed once.

  quantize_weights / dequantize  — symmetric per-tensor (or per-column)
                                   int weight quantization
  fake_quant                     — straight-through fake quantization
                                   for QAT (``repro_torch.optim.qat``)
  quantize_activations / dac     — the DAC transfer function
  fake_quant_act                 — straight-through activation fake
                                   quantization
  sigmoid_lut / apply_lut        — the digital core's activation LUT
  threshold / threshold_ste      — the memristor inverter pair

``torch.round`` rounds half to even, as ``jnp.round`` does, so the
integer codes agree exactly. The straight-through estimators are
``w + (wq - w).detach()`` with the scale computed on ``w.detach()``:
the reference's ``stop_gradient``.
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


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def fake_quant(w: torch.Tensor, bits: int = 8, per_column: bool = False
               ) -> torch.Tensor:
    """Straight-through fake quantization (QAT forward = quantized,
    backward = identity)."""
    qmax = 2.0 ** (bits - 1) - 1.0
    s = weight_scale(w.detach(), bits, per_column)
    wq = torch.clamp(torch.round(w / s), -qmax, qmax) * s
    return w + (wq - w).detach()


# --------------------------------------------------------------------- #
# activations (inputs): the DAC transfer function
# --------------------------------------------------------------------- #
def quantize_activations(x: torch.Tensor, bits: int = 8, lo: float = 0.0,
                         hi: float = 1.0
                         ) -> Tuple[torch.Tensor, float, float]:
    """Uniform input quantization to ``bits`` codes over [lo, hi] (the
    sensor interface's 8-bit samples, run through the first-layer
    cores' DACs, Fig. 8). Returns (codes, lo, step): uint8 codes up to
    8 bits, int32 above."""
    n = 2 ** bits - 1
    step = (hi - lo) / n
    q = torch.clamp(torch.round((x - lo) / step), 0, n)
    return q.to(torch.uint8 if bits <= 8 else torch.int32), lo, step


def dac(codes: torch.Tensor, lo: float, step: float) -> torch.Tensor:
    """codes → analog voltage (the DAC output applied to crossbar rows)."""
    return codes.to(torch.float32) * step + lo


def fake_quant_act(x: torch.Tensor, bits: int = 8, lo: float = -1.0,
                   hi: float = 1.0) -> torch.Tensor:
    """STE fake quantization of activations (QAT and the Fig. 12
    sweep)."""
    n = 2.0 ** bits - 1.0
    step = (hi - lo) / n
    xq = torch.clamp(torch.round((x - lo) / step), 0.0, n) * step + lo
    return x + (xq - x).detach()


# --------------------------------------------------------------------- #
# activation functions: LUT (digital core) & threshold (memristor core)
# --------------------------------------------------------------------- #
def threshold(x: torch.Tensor) -> torch.Tensor:
    """Memristor core activation: back-to-back inverter pair (Fig. 5),
    ±1 rails; an ideal comparator on DP_j."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def threshold_ste(x: torch.Tensor, slope: float = 4.0) -> torch.Tensor:
    """Trainable surrogate: hard threshold forward, steep-tanh
    backward. The forward value is exactly :func:`threshold`."""
    soft = torch.tanh(slope * x)
    return soft + (threshold(x) - soft).detach()


def sigmoid_lut(bits: int = 8, lo: float = -8.0, hi: float = 8.0
                ) -> torch.Tensor:
    """The digital core's activation LUT: 2^bits entries of σ(x) ∈ [0, 1]
    stored as ``bits``-bit codes (256 bytes for 8 bits, §V.A), int32."""
    n = 2 ** bits
    xs = torch.linspace(lo, hi, n, dtype=torch.float32)
    ys = torch.sigmoid(xs)
    return torch.round(ys * (n - 1)).to(torch.int32)


def apply_lut(acc: torch.Tensor, lut: torch.Tensor, in_lo: float = -8.0,
              in_hi: float = 8.0) -> torch.Tensor:
    """Digital-core activation: index the LUT with the (rescaled)
    accumulator; returns codes in [0, 2^bits − 1]."""
    n = lut.shape[0]
    idx = torch.clamp(torch.round((acc - in_lo) / (in_hi - in_lo) * (n - 1)),
                      0, n - 1).to(torch.long)
    return lut.to(acc.device)[idx]


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
