"""Plain PyTorch versions of the hand-written kernels.

Port of ``repro.kernels.ref``: the semantics each CUDA kernel in
``kernels/csrc`` must match up to float summation order — the tiled
differential-pair crossbar MVM (Eq. 3 per tile, with the divider folded
into a program-time ``scale``, Fig. 11 combining over row chunks, fused
bias/activation epilogue) and the SRAM digital core's int MAC array
with its fused requantize epilogue. ``kernels/ops.py`` runs these for
CPU tensors; on the card they are what the kernels are checked against.

Float math is IEEE f32 throughout. Where these run on the card, the
callers keep ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False (PyTorch's matmul default;
cuDNN is not used here), so no product drops to TF32.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantization import threshold

# The fused-epilogue activations, shared by every kernel wrapper so the
# kernels' activation codes and these plain versions cannot drift.
# "threshold" is the memristor inverter pair (±1 rails); "linear" is the
# identity used by Fig. 11 combiner neurons.
ACTIVATIONS = {
    "linear": lambda v: v,
    "threshold": threshold,
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
    "tanh": torch.tanh,
}


def crossbar_mvm_partials_ref(x: torch.Tensor, gp: torch.Tensor,
                              gn: torch.Tensor, scale: torch.Tensor
                              ) -> torch.Tensor:
    """Per-row-chunk scaled partials: x (B, R, rows); gp/gn
    (R, C, rows, cols); scale (R, C, cols) → (B, R, C·cols) f32 with
    ``out[b, r] = x[b, r] @ (gp[r] − gn[r]) · scale[r]`` per column
    tile. The reference computes this as one ``crossbar_mvm`` per row
    chunk (vmapped) so the partials reach the combiner stage apart.
    A bf16 ``x`` is upcast, and the combined tile stays f32."""
    w = (gp - gn).to(torch.float32)                          # (R,C,rows,cols)
    num = torch.einsum("brk,rckn->brcn", x.to(torch.float32), w)
    num = num * scale[None].to(torch.float32)
    return num.reshape(x.shape[0], x.shape[1], -1)


def crossbar_mvm_ref(x: torch.Tensor, gp: torch.Tensor, gn: torch.Tensor,
                     scale: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, *,
                     activation: str = "linear") -> torch.Tensor:
    """x (B, R, rows); gp/gn (R, C, rows, cols); scale (R, C, cols)
    → (B, C·cols) f32 = act(Σ_r (x_r @ (gp−gn))·scale + bias): each
    tile's partial is scaled before the sum over row chunks r."""
    out = torch.sum(crossbar_mvm_partials_ref(x, gp, gn, scale), dim=1)
    if bias is not None:
        out = out + bias.to(torch.float32)[None, :]
    return ACTIVATIONS[activation](out)


def int8_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, K) uint8/int8 codes; w (K, N) int8 → (B, N) int32.

    The products are summed in float64, which holds every partial sum
    of 8-bit codes exactly (|acc| ≤ 255·128·K < 2⁵³), so this equals
    an int32 accumulator. (PyTorch has no integer matmul on CUDA.)"""
    acc = x.to(torch.float64) @ w.to(torch.float64)
    return acc.to(torch.int32)


def int8_matmul_fused_ref(x: torch.Tensor, w: torch.Tensor,
                          scale: torch.Tensor,
                          offset: Optional[torch.Tensor] = None, *,
                          activation: str = "linear") -> torch.Tensor:
    """Fused digital-core epilogue: act(f32(acc)·scale + offset), f32."""
    acc = int8_matmul_ref(x, w).to(torch.float32)
    y = acc * scale.to(torch.float32)[None, :]
    if offset is not None:
        y = y + offset.to(torch.float32)[None, :]
    return ACTIVATIONS[activation](y)


def dac_codes(x: torch.Tensor, lo: float, step: float, bits: int
              ) -> torch.Tensor:
    """The SRAM core's input DAC: analog inputs → codes
    0..2^bits−1 (f32 holding integers)."""
    return torch.clamp(torch.round((x - lo) / step), 0, 2.0 ** bits - 1.0)


def int8_matmul_dac_ref(x: torch.Tensor, w: torch.Tensor,
                        scale: torch.Tensor,
                        offset: Optional[torch.Tensor], dac, *,
                        activation: str = "linear") -> torch.Tensor:
    """The fused epilogue on f32 analog inputs ``x``: their DAC codes
    (``dac`` = (lo, step, bits), bits ≤ 8) cast to uint8, then
    :func:`int8_matmul_fused_ref`."""
    codes = dac_codes(x, *dac).to(torch.uint8)
    return int8_matmul_fused_ref(codes, w, scale, offset,
                                 activation=activation)
