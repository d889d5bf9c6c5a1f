"""Hopper kernel wrapper: the SRAM digital core's int8 MAC array.

Port of ``repro.kernels.int8_matmul`` (the Pallas TPU kernels
``_kernel_fused`` and ``_kernel_raw``). Both are one CUDA kernel,
``csrc/int8_matmul.cu``, with the requantize epilogue switched on or
off; see its header for the design. This wrapper checks what it is
given, allocates the output, launches on PyTorch's current stream
without synchronising, and counts the launch (one counter per
epilogue mode). It takes CUDA tensors only: ``kernels.ops`` sends CPU
tensors to the plain versions in ``kernels.ref``.

The fused mode also takes f32 analog inputs with the input DAC's
constants (``dac``): the kernel then forms the codes in its load, and
counts under the same fused counter.

Codes wider than 8 bits are refused: they neither fit the kernel's
operand types nor are they wrapped into them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import (LaunchCounter, check_launch,
                                        check_operand, check_same_device)

fused_launches = LaunchCounter("int8_matmul_fused")
raw_launches = LaunchCounter("int8_matmul_raw")

# the largest K whose int32 accumulator cannot overflow with 8-bit codes
# (|x| ≤ 255, |w| ≤ 128)
MAX_K = (2 ** 31 - 1) // (255 * 128)


def check_dac(dac, x: torch.Tensor, scale) -> None:
    """Raise unless ``dac`` = (lo, step, bits) fits the kernel's 8-bit
    unsigned codes and comes with f32 x and the fused epilogue."""
    if scale is None:
        raise ValueError("int8_matmul: dac needs scale (the DAC runs in "
                         "the fused mode only)")
    if x.dtype != torch.float32:
        raise ValueError(f"int8_matmul: with dac, x must be float32 "
                         f"analog inputs, got {x.dtype}")
    lo, step, bits = dac
    if not 1 <= int(bits) <= 8 or not float(step) > 0.0:
        raise ValueError(f"int8_matmul: the DAC takes 1..8 bits and a "
                         f"positive step, got bits={bits}, step={step}")


def dac_constants(dac) -> Tuple[float, float, float]:
    """(shift, inv, top) for ``dac`` = (lo, step, bits), the f32
    constants of ``clamp(round((x − lo) / step), 0, 2^bits − 1)`` as
    PyTorch's CUDA ops run it with Python scalars lo and step: x + (−lo),
    then the product with 1/step taken in double and rounded once to
    f32 (exact for the DAC's steps 2/(2^bits − 1))."""
    lo, step, bits = dac
    return (float(np.float32(-lo)), float(np.float32(1.0 / step)),
            float(2 ** int(bits) - 1))


def int8_matmul(x: torch.Tensor, w: torch.Tensor,
                scale: Optional[torch.Tensor] = None,
                offset: Optional[torch.Tensor] = None, *,
                activation: str = "linear", dac=None) -> torch.Tensor:
    """x (B, K) uint8/int8; w (K, N) int8.

    scale is None → (B, N) int32 raw accumulator.
    scale (N,) f32 (offset (N,) f32 or None) → (B, N) f32
    = act(f32(acc)·scale + offset).
    dac = (lo, step, bits) with scale: x (B, K) f32 analog inputs, whose
    codes clamp(round((x − lo)/step), 0, 2^bits − 1) the kernel forms."""
    act = build.activation_code(activation)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"int8_matmul: expected x (B, K) and w (K, N), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    B, K = x.shape
    N = w.shape[1]
    if K > MAX_K:
        raise ValueError(f"int8_matmul: K={K} can overflow the int32 "
                         f"accumulator (at most {MAX_K})")
    name = "int8_matmul"
    if dac is not None:
        check_dac(dac, x, scale)
    check_operand(name, "x", x, (B, K),
                  (torch.uint8, torch.int8) if dac is None
                  else (torch.float32,))
    check_operand(name, "w", w, (K, N), (torch.int8,))
    fused = scale is not None
    if fused:
        check_operand(name, "scale", scale, (N,), (torch.float32,))
        if offset is not None:
            check_operand(name, "offset", offset, (N,), (torch.float32,))
    elif offset is not None or activation != "linear":
        raise ValueError("int8_matmul: offset/activation need scale (the "
                         "raw accumulator has no epilogue)")
    check_same_device(name, x, w, scale, offset)
    out = torch.empty((B, N), dtype=torch.float32 if fused else torch.int32,
                      device=x.device)
    if B == 0 or N == 0:
        return out
    off = None if offset is None else offset.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if dac is None:
            err = build.entry("int8_matmul")(
                x.data_ptr(), int(x.dtype == torch.int8), w.data_ptr(),
                scale.data_ptr() if fused else None, off, out.data_ptr(),
                B, K, N, act, int(fused), stream)
        else:
            err = build.entry("int8_matmul_dac")(
                x.data_ptr(), w.data_ptr(), scale.data_ptr(), off,
                out.data_ptr(), B, K, N, act, *dac_constants(dac), stream)
    check_launch("int8_matmul", err)
    (fused_launches if fused else raw_launches).add()
    return out
