"""Hopper kernel wrapper: tiled differential-pair crossbar MVM (Eq. 3).

Port of ``repro.kernels.crossbar_mvm`` (the Pallas TPU kernel). The
kernel itself is ``csrc/crossbar_mvm.cu``; see its header for the
design. This wrapper checks what it is given, allocates the output,
launches on PyTorch's current stream without synchronising, and counts
the launch. It takes CUDA tensors only: ``kernels.ops`` sends CPU
tensors to the plain version in ``kernels.ref``.

Two modes, one kernel:
  * reduce (``partials=False``): (B, C·cols) = act(Σ_r x_r·(gp−gn)·s + b),
    the dense ``crossbar_apply`` path;
  * partials (``partials=True``): (B, R, C·cols) with each row chunk's
    scaled partial kept apart — the chip's sub-neuron stage, one launch
    for all R chunks (the reference launches its kernel once per chunk).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import (LaunchCounter, check_launch,
                                        check_operand, check_same_device)

launches = LaunchCounter("crossbar_mvm")


def crossbar_mvm(x: torch.Tensor, gp: torch.Tensor, gn: torch.Tensor,
                 scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 *, activation: str = "linear",
                 partials: bool = False) -> torch.Tensor:
    """x (B, R, rows) f32/bf16; gp/gn (R, C, rows, cols) f32;
    scale (R, C, cols) f32; bias (C·cols,) f32 or None → f32
    (B, C·cols), or (B, R, C·cols) with ``partials`` (which takes no
    bias and only the linear activation)."""
    act = build.activation_code(activation)
    if partials and (bias is not None or activation != "linear"):
        raise ValueError("crossbar_mvm: partials mode has no epilogue "
                         "(bias/activation apply after the combiner)")
    if x.dim() != 3 or gp.dim() != 4:
        raise ValueError(f"crossbar_mvm: expected x (B, R, rows) and gp "
                         f"(R, C, rows, cols), got {tuple(x.shape)} and "
                         f"{tuple(gp.shape)}")
    B, R, rows = x.shape
    R_g, C, rows_g, cols = gp.shape
    if (R_g, rows_g) != (R, rows):
        raise ValueError(f"crossbar_mvm: x {tuple(x.shape)} does not "
                         f"match the tile grid {tuple(gp.shape)}")
    f32 = (torch.float32,)
    name = "crossbar_mvm"
    check_operand(name, "x", x, (B, R, rows),
                  (torch.float32, torch.bfloat16))
    check_operand(name, "gp", gp, (R, C, rows, cols), f32)
    check_operand(name, "gn", gn, (R, C, rows, cols), f32)
    check_operand(name, "scale", scale, (R, C, cols), f32)
    if bias is not None:
        check_operand(name, "bias", bias, (C * cols,), f32)
    check_same_device(name, x, gp, gn, scale, bias)
    shape = (B, R, C * cols) if partials else (B, C * cols)
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    fn = build.entry("crossbar_mvm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
                 gp.data_ptr(), gn.data_ptr(), scale.data_ptr(),
                 None if bias is None else bias.data_ptr(),
                 out.data_ptr(), B, R, C, rows, cols, act, int(partials),
                 stream)
    check_launch("crossbar_mvm", err)
    launches.add()
    return out
