"""Device dispatch for the kernels: the Hopper kernel for CUDA tensors,
the plain PyTorch version for CPU tensors.

Port of ``repro.kernels.ops``, where the CPU backend runs the Pallas
kernels in interpret mode. Here a CPU tensor takes the plain version in
``kernels.ref`` (there is no interpret mode for a CUDA kernel) and a
CUDA tensor launches the kernel — or raises: nothing falls back. Any
other device raises.

Program-once contract: every input-independent transform (Eq. 3's
divider, the per-tile weight descale, wire attenuation, requantization
constants) is folded into the operands at *program* time
(core/crossbar_layer.program_layer / program_digital); these are the
streaming-evaluate path and take the folded operands as they are.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import crossbar_mvm as _cb
from repro_torch.kernels import int8_matmul as _i8
from repro_torch.kernels import ref

COUNTERS = {c.name: c for c in (_cb.launches, _i8.fused_launches,
                                _i8.raw_launches)}


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: c.count for name, c in COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.reset()


def _on_cuda(name: str, x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: tensors on {x.device} are not supported "
                     f"(cuda runs the kernel, cpu the plain version)")


def crossbar_mvm(x: torch.Tensor, gp: torch.Tensor, gn: torch.Tensor,
                 scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 *, activation: str = "linear",
                 partials: bool = False) -> torch.Tensor:
    """Tiled differential crossbar MVM with fused epilogue.
    x (B, R, rows) f32/bf16; gp/gn (R, C, rows, cols); scale (R, C,
    cols) program-time folded divider + descale; bias (C·cols,) or None
    → (B, C·cols) = act(Σ_r x·(gp−gn)·scale + b). ``partials`` keeps
    the row chunks apart: (B, R, C·cols), no bias, linear."""
    if _on_cuda("crossbar_mvm", x):
        return _cb.crossbar_mvm(x, gp, gn, scale, bias,
                                activation=activation, partials=partials)
    if partials:
        if bias is not None or activation != "linear":
            raise ValueError("crossbar_mvm: partials mode has no "
                             "epilogue")
        return ref.crossbar_mvm_partials_ref(x, gp, gn, scale)
    return ref.crossbar_mvm_ref(x, gp, gn, scale, bias,
                                activation=activation)


def int8_matmul(x: torch.Tensor, w: torch.Tensor,
                scale: Optional[torch.Tensor] = None,
                offset: Optional[torch.Tensor] = None, *,
                activation: str = "linear", dac=None) -> torch.Tensor:
    """int8 MAC array (the SRAM digital core datapath): (B, K) uint8 or
    int8 × (K, N) int8 → int32. With ``scale`` (per-neuron requantize)
    the fused epilogue act(acc·scale + offset) runs in the kernel and
    the result is f32. With ``scale`` and ``dac`` = (lo, step, bits),
    bits ≤ 8, x is (B, K) f32 analog inputs and the kernel forms their
    DAC codes itself (the plain version: ``ref.dac_codes``, the uint8
    cast, then the fused epilogue)."""
    if _on_cuda("int8_matmul", x):
        return _i8.int8_matmul(x, w, scale, offset, activation=activation,
                               dac=dac)
    if dac is not None:
        _i8.check_dac(dac, x, scale)
    if (dac is None and x.dtype not in (torch.uint8, torch.int8)) or \
            w.dtype != torch.int8:
        raise ValueError(f"int8_matmul: takes uint8/int8 codes and int8 "
                         f"weights, got {x.dtype} and {w.dtype}")
    if dac is not None:
        return ref.int8_matmul_dac_ref(x, w, scale, offset, dac,
                                       activation=activation)
    if scale is None:
        return ref.int8_matmul_ref(x, w)
    return ref.int8_matmul_fused_ref(x, w, scale, offset,
                                     activation=activation)


def int8_matmul_planes(x_planes: torch.Tensor, w_planes: torch.Tensor
                       ) -> torch.Tensor:
    """Exact x @ w for codes wider than 8 bits, from byte planes:
    x_planes (Px, B, K) uint8 with x = Σ_i 256^i x_i, w_planes
    (Pw, K, N) int8 with w = Σ_j 256^j w_j → (B, N) int64
    = Σ_ij 256^(i+j) (x_i @ w_j). One raw int8 MAC (the int32
    accumulator, no epilogue) for each pair of planes; each plane
    product is 8-bit, so it keeps within :func:`int8_matmul`'s K guard
    and cannot overflow. The products are combined exactly in int64 by
    Horner's rule over i + j, from the top: one add a product, the
    first of each lower power also multiplying by 256."""
    px, pw = x_planes.shape[0], w_planes.shape[0]
    acc = None
    for d in reversed(range(px + pw - 1)):
        lo = max(0, d - pw + 1)
        for i in range(lo, min(d, px - 1) + 1):
            term = int8_matmul(x_planes[i], w_planes[d - i])
            if acc is None:
                acc = term.to(torch.int64)
            elif i == lo:
                acc = torch.add(term, acc, alpha=256)
            else:
                acc += term
    return acc
