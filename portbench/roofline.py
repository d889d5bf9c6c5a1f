"""The yardstick: the H100's published peaks and the work a layer needs.

Peaks are NVIDIA's H100 SXM data-sheet rates, dense, at the full 700 W
(a copy of ``repro_torch.launch.roofline``'s, kept here so that no
change to the program moves the yardstick). A layer's bound is the
larger of its operations over the route's peak and its bytes over the
HBM rate, and names which of the two it is.

The work is that of the layer as the configuration defines it, not of
any implementation: 2 · B · d_in · d_out operations; the layer input,
the programmed weights and the ``d_out`` outputs each moved once, each
at the narrowest width the configuration's arithmetic admits (the
``roofline`` widths of a configuration file: a memristor layer input in
f32, the SRAM DAC codes in one byte, threshold outputs in one byte,
8-bit synapses in one byte, linear outputs in f32). A kernel that fuses
more of the layer therefore cannot read above 100 %.
"""
from __future__ import annotations

from typing import List, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAKS = {
    "tf32": 494.7e12,     # TF32 dense tensor-core FLOP/s
    "bf16": 989.4e12,     # bf16 dense tensor-core FLOP/s
    "int8": 1979e12,      # int8 dense tensor-core OP/s
    "fp32": 67e12,        # IEEE f32 on the CUDA cores
}


def net_ops_per_item(dims) -> int:
    """Operations an item needs through the dense net: Σ 2 · d_in · d_out
    (355,600 for 784→200→100→10)."""
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def layer_work(config: dict, batch: int) -> List[dict]:
    """Each layer's ``ops`` and ``bytes`` for a batch of ``batch`` items."""
    dims = config["dims"]
    w = config["roofline"]
    n = len(dims) - 1
    out = []
    for i in range(n):
        d_in, d_out = dims[i], dims[i + 1]
        in_b = w["input_bytes"] if i == 0 else w["hidden_bytes"]
        out_b = w["output_bytes"] if i == n - 1 else w["hidden_bytes"]
        nbytes = (batch * d_in * in_b + d_in * d_out * w["weight_bytes"]
                  + batch * d_out * out_b)
        out.append({"d_in": d_in, "d_out": d_out,
                    "ops": 2 * batch * d_in * d_out, "bytes": nbytes})
    return out


def bound(ops: float, nbytes: float, peak: str) -> Tuple[float, str]:
    """(seconds, "ops" | "bytes"): the least time the card could take."""
    t_ops = ops / PEAKS[peak]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def stream_bound(config: dict, batch: int) -> Tuple[float, List[str]]:
    """The bounds of the net's layers summed, seconds a batch, and which
    term bounds each layer."""
    peak = config["roofline"]["peak"]
    total, which = 0.0, []
    for lay in layer_work(config, batch):
        t, w = bound(lay["ops"], lay["bytes"], peak)
        total += t
        which.append(w)
    return total, which
