"""Plain reference of an MLP mapped onto the paper's neural cores.

What the chip configurations (``configs/deep-*.json``) compute, worked
out again from the float weights the harness made, in plain PyTorch.
It imports nothing of ``repro_torch`` and takes nothing the program
made: the encoding is a frozen copy of the port's arithmetic, so the
same float weights give the same programmed state.

* ``memristor`` (1T1M crossbar cores, §III): each layer is cut into
  ``core_rows × core_cols`` tiles, each tile normalised to its max |w|
  and encoded as differential conductance pairs on the device's
  2⁷ levels between G_OFF and G_ON (Lu et al.'s 125 kΩ, ratio 1,000),
  with Eq. 3's divider and the descale folded into one scale a tile
  column. A layer wider than the core rows yields one partial a row
  chunk; the partials meet in Fig. 11's combiner neurons, whose
  all-ones weights are programmed the same way. Then bias and the
  activation (threshold: ±1 rails).
* ``digital`` (SRAM cores, §II.A): int synapses quantised per column
  at ``weight_bits``, inputs through a DAC on [-1, 1] at the same
  width, an exact integer MAC, then act(acc · scale + offset + bias).

:func:`forward` evaluates the encoded net in f64 (exact for the
digital integer MAC), and returns beside the outputs each output's
bound Σ|x·w| + |b| and each row's smallest hidden margin |pre| / bound:
where that margin is within rounding of zero, a threshold may fall
either way in any correct f32 implementation. ``arith="tf32"`` is the
control of the memristor route: every product's operands rounded to
TF32, sums in f32, as TF32 tensor cores compute.

The harness calls :func:`make_params` for the float weights both sides
get and :func:`outputs` for the reference's answers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch

# the memristor device (Lu et al. [22] via the Yakopcic model [21])
R_ON_OHM = 125e3
R_OFF_OHM = R_ON_OHM * 1000.0
G_ON = 1.0 / R_ON_OHM
G_OFF = 1.0 / R_OFF_OHM
G_RANGE = G_ON - G_OFF
DEVICE_LEVELS = 2 ** 7
# the digital core's input DAC range
DAC_LO, DAC_HI = -1.0, 1.0


# --------------------------------------------------------------------- #
# the float weights both sides get
# --------------------------------------------------------------------- #
def make_params(config: dict, gen: torch.Generator, device) -> list:
    """The configuration's float weights, drawn from ``gen`` on
    ``device``: N(0, s²/fan_in) weights and N(0, b_std²) biases, f32,
    one ``{"w": (d_in, d_out), "b": (d_out,)}`` a layer."""
    s = float(config["weights"]["w_std_times_sqrt_fan_in"])
    b_std = float(config["weights"]["b_std"])
    dims = config["dims"]
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((a, b), generator=gen, device=device) * \
            (s / math.sqrt(a))
        bias = torch.randn((b,), generator=gen, device=device) * b_std
        params.append({"w": w, "b": bias})
    return params


# --------------------------------------------------------------------- #
# programming (frozen copy of the port's encoding arithmetic)
# --------------------------------------------------------------------- #
def _quantize_g(g: torch.Tensor) -> torch.Tensor:
    step = G_RANGE / (DEVICE_LEVELS - 1)
    return G_OFF + torch.round((g - G_OFF) / step) * step


def _pairs(tiles: torch.Tensor):
    amax = torch.clamp(torch.amax(torch.abs(tiles), dim=(-2, -1),
                                  keepdim=True), min=1e-12)
    w = torch.clamp(tiles / amax, -1.0, 1.0)
    mag = torch.abs(w) * G_RANGE
    floor = torch.full_like(w, G_OFF)
    gp = torch.where(w >= 0, G_OFF + mag, floor)
    gn = torch.where(w >= 0, floor, G_OFF + mag)
    return _quantize_g(gp), _quantize_g(gn), amax


def program_tiles(w: torch.Tensor, rows: int, cols: int):
    """(d_in, d_out) f32 → (gp, gn, scale): (R, C, rows, cols) pairs and
    the (R, C, cols) folded scale amax · Σ(σ⁺+σ⁻) / (g_range · Σ(σ⁺+σ⁻))."""
    w = w.to(torch.float32)
    d_in, d_out = w.shape
    R, C = math.ceil(d_in / rows), math.ceil(d_out / cols)
    wp = torch.nn.functional.pad(w, (0, C * cols - d_out,
                                     0, R * rows - d_in))
    tiles = wp.reshape(R, rows, C, cols).permute(0, 2, 1, 3)
    gp, gn, amax = _pairs(tiles)
    descale = amax[..., 0] * torch.sum(gp + gn, dim=-2) / G_RANGE
    scale = descale / torch.sum(gp + gn, dim=2)
    return gp.contiguous(), gn.contiguous(), scale.contiguous()


def combiner(n_chunks: int, rows: int, cols: int, device
             ) -> List[Tuple[torch.Tensor, int, int]]:
    """Fig. 11's tree over ``n_chunks`` partials: (weights, groups,
    fan_in) a level, each level's all-ones column programmed as a
    crossbar column (so its weights are 1 up to the fold's rounding)."""
    levels = []
    k = n_chunks
    while k > 1:
        if k > rows:
            groups = math.ceil(k / rows)
            fan_in = math.ceil(k / groups)
        else:
            groups, fan_in = 1, k
        gp, gn, scale = program_tiles(
            torch.ones((fan_in, 1), dtype=torch.float32, device=device),
            rows, cols)
        wc = ((gp - gn) * scale[:, :, None, :])[0, 0, :fan_in, 0]
        levels.append((wc.to(torch.float32), groups, fan_in))
        k = groups
    return levels


def program_digital(w: torch.Tensor, bits: int):
    """(d_in, d_out) f32 → (codes int, scale, offset, step): per-column
    symmetric codes in [-qmax, qmax], the requantise constants
    scale = step · ws and offset = lo · Σ_k code · ws."""
    qmax = 2.0 ** (bits - 1) - 1.0
    w = w.to(torch.float32)
    ws = torch.clamp(torch.amax(torch.abs(w), dim=0, keepdim=True),
                     min=1e-12) / qmax
    codes = torch.clamp(torch.round(w / ws), -qmax, qmax)
    step = (DAC_HI - DAC_LO) / (2.0 ** bits - 1.0)
    ws = ws.reshape(-1).to(torch.float32)
    codes = codes.to(torch.int8 if bits <= 8 else torch.int32)
    scale = step * ws
    offset = DAC_LO * torch.sum(codes, dim=0).to(torch.float32) * ws
    return codes, scale, offset, step


def dac_codes(x: torch.Tensor, step: float, bits: int) -> torch.Tensor:
    """Analog inputs → DAC codes 0..2^bits − 1 (f32 holding integers)."""
    n = 2.0 ** bits - 1.0
    return torch.clamp(torch.round((x - DAC_LO) / step), 0, n)


@dataclasses.dataclass
class Layer:
    d_in: int
    d_out: int
    bias: torch.Tensor                 # (d_out,) f32
    activation: str
    # memristor
    gp: Optional[torch.Tensor] = None
    gn: Optional[torch.Tensor] = None
    scale: Optional[torch.Tensor] = None
    levels: Optional[list] = None
    # digital
    codes: Optional[torch.Tensor] = None
    offset: Optional[torch.Tensor] = None
    step: float = 0.0
    bits: int = 0


def program(config: dict, params, *, bits: Optional[int] = None
            ) -> List[Layer]:
    """Encode ``params`` (``[{"w": (d_in, d_out), "b": (d_out,)}]``) as
    the configuration's cores hold them. ``bits`` overrides the digital
    width (the int4 control)."""
    system = config["system"]
    rows, cols = int(config["core_rows"]), int(config["core_cols"])
    n = len(params)
    layers = []
    for i, p in enumerate(params):
        w = p["w"]
        act = config["activation"] if i < n - 1 else \
            config["out_activation"]
        lay = Layer(int(w.shape[0]), int(w.shape[1]),
                    p["b"].to(torch.float32), act)
        if system == "memristor":
            lay.gp, lay.gn, lay.scale = program_tiles(w, rows, cols)
            lay.levels = combiner(lay.gp.shape[0], rows, cols, w.device)
        elif system == "digital":
            b = int(config["weight_bits"]) if bits is None else bits
            lay.codes, lay.scale, lay.offset, lay.step = \
                program_digital(w, b)
            lay.bits = b
        else:
            raise ValueError(f"unknown core system {system!r}")
        layers.append(lay)
    return layers


# --------------------------------------------------------------------- #
# evaluation
# --------------------------------------------------------------------- #
def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 → the nearest TF32 value (10 stored mantissa bits, ties to
    even), as an f32 tensor."""
    u = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return u.to(torch.int32).view(torch.float32)


def _crossbar(lay: Layer, h: torch.Tensor, arith: str):
    """(pre, bound) of a memristor layer for inputs ``h`` (B, d_in)."""
    B = h.shape[0]
    R, C, rows, cols = lay.gp.shape
    xt = torch.nn.functional.pad(h, (0, R * rows - lay.d_in))
    xt = xt.reshape(B, R, rows)
    diff = lay.gp - lay.gn
    if arith == "exact":
        f = torch.float64
        x, wd, sc = xt.to(f), diff.to(f), lay.scale.to(f)
    else:
        f = torch.float32
        x, wd, sc = to_tf32(xt.to(f)), to_tf32(diff), lay.scale
    parts = torch.einsum("brk,rckn->brcn", x, wd) * sc[None]
    parts = parts.reshape(B, R, C * cols)[:, :, :lay.d_out]
    absparts = None
    if arith == "exact":
        absparts = torch.einsum("brk,rckn->brcn", x.abs(), wd.abs()) * \
            sc.abs()[None]
        absparts = absparts.reshape(B, R, C * cols)[:, :, :lay.d_out]
    for wc, groups, fan_in in lay.levels:
        pad = groups * fan_in - parts.shape[1]
        wc = wc.to(f) if arith == "exact" else to_tf32(wc)
        parts = torch.nn.functional.pad(parts, (0, 0, 0, pad))
        parts = torch.einsum("bgkd,k->bgd", parts.reshape(
            B, groups, fan_in, -1), wc)
        if absparts is not None:
            absparts = torch.nn.functional.pad(absparts, (0, 0, 0, pad))
            absparts = torch.einsum("bgkd,k->bgd", absparts.reshape(
                B, groups, fan_in, -1), wc.abs())
    pre = parts[:, 0, :] + lay.bias.to(f)[None, :]
    bound = None if absparts is None else \
        absparts[:, 0, :] + lay.bias.to(f).abs()[None, :]
    return pre, bound


def _digital(lay: Layer, h: torch.Tensor):
    xq = dac_codes(h.to(torch.float32), lay.step, lay.bits)
    f = torch.float64
    acc = xq.to(f) @ lay.codes.to(f)
    accabs = xq.to(f) @ lay.codes.to(f).abs()
    off = lay.offset.to(f) + lay.bias.to(f)
    pre = acc * lay.scale.to(f)[None, :] + off[None, :]
    bound = accabs * lay.scale.to(f).abs()[None, :] + off.abs()[None, :]
    return pre, bound


def _activate(kind: str, v: torch.Tensor) -> torch.Tensor:
    if kind == "threshold":
        return torch.where(v >= 0, 1.0, -1.0).to(v.dtype)
    if kind == "linear":
        return v
    raise ValueError(f"unsupported activation {kind!r}")


def forward(layers: List[Layer], x: torch.Tensor, *, arith: str = "exact"
            ) -> dict:
    """Evaluate the encoded net on ``x`` (B, d_in) f32.

    Returns ``y`` (B, d_out) and, with ``arith="exact"``, ``bound``
    (B, d_out): each output's Σ|x·w| + |b|, and ``margin`` (B,): the row's
    smallest hidden |pre| / bound. ``arith="tf32"`` (memristor only)
    computes every crossbar product from TF32 operands with f32 sums."""
    if arith not in ("exact", "tf32"):
        raise ValueError(f"unknown arithmetic {arith!r}")
    h = x
    margin = torch.full((x.shape[0],), math.inf, dtype=torch.float64,
                        device=x.device)
    bound = None
    for i, lay in enumerate(layers):
        if lay.codes is not None:
            pre, bound = _digital(lay, h)
        else:
            pre, bound = _crossbar(lay, h, arith)
        last = i == len(layers) - 1
        if not last and bound is not None:
            m = (pre.abs() / bound.clamp(min=1e-300)).amin(dim=1)
            margin = torch.minimum(margin, m.to(torch.float64))
        h = pre if last else _activate(lay.activation, pre)
    out = {"y": h}
    if arith == "exact":
        out["bound"] = bound
        out["margin"] = margin
    return out


def outputs(config: dict, params, inputs: dict, *, block: int,
            arith: str = "exact", bits: Optional[int] = None) -> dict:
    """:func:`forward` of every input batch (key → (B, d_in)), encoded
    once and evaluated in blocks of ``block`` rows. ``arith`` and
    ``bits`` select the configuration's control."""
    layers = program(config, params, bits=bits)
    out = {}
    for k, x in inputs.items():
        parts = [forward(layers, x[i:i + block], arith=arith)
                 for i in range(0, x.shape[0], block)]
        out[k] = {key: torch.cat([p[key] for p in parts])
                  for key in parts[0]}
    return out
