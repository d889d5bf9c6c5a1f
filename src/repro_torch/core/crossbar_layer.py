"""Program-once / stream-many execution of linear layers.

Port of ``repro.core.crossbar_layer``. The paper's split (§III.D:
train off-chip → program once → stream inference) is structural:

  PROGRAM (slow, once per deployment)
    program_layer     — tile a float (d_in × d_out) weight matrix into
                        crossbar-geometry tiles, differential-encode
                        each tile as (σ⁺, σ⁻) conductances (quantized,
                        optionally perturbed by programming noise and a
                        ``NoiseModel``, optionally wire-attenuated), and
                        fold *every*
                        input-independent factor — Eq. 3's divider
                        Σ(σ⁺+σ⁻), the per-tile weight descale and the
                        wire-attenuation correction — into ONE
                        per-tile-column ``scale``.
    program_digital   — the SRAM-core counterpart: int synapses plus
                        per-neuron requantize (scale, offset) constants.
    program_mlp       — program every layer of an MLP once.

  EVALUATE (fast, the streaming hot path)
    crossbar_apply    — x (..., d_in) → (..., d_out): the crossbar
                        kernel (``use_kernel=True``) or the reference's
                        batched einsum over the tile grid with
                        ``scale`` folded into the weights (the
                        default, as in the reference).
    digital_apply     — int MAC + fused requantize/bias/activation.

  TRAIN (ex-situ, the QAT trainer's forward)
    mlp_apply         — modes float | qat (plain ``h @ w + b``, as the
                        reference's, which has no kernel there either)
                        and the deployed crossbar | digital, which go
                        through ``programmed_mlp_apply`` (the kernels),
                        programming a param set once through a small
                        memo (``clear_program_cache`` drops it).

``crossbar_linear`` / ``digital_linear`` are the reference's deprecated
one-shot program-and-apply conveniences: they re-program on every call.

Programmed state lives in frozen dataclasses holding tensors on one
device; ``*_from_numpy`` carry weights and programmed state across
from numpy (the parity tests hand the reference's arrays over so).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import quantization as q
from repro_torch.core.crossbar import (column_gain, pairs_from_weights,
                                       wire_attenuation)
from repro_torch.core.device import DEFAULT_DEVICE, DeviceModel
from repro_torch.core.neural_core import CoreGeometry, MEMRISTOR_GEOM
from repro_torch.kernels import ref as kref
from repro_torch.obs.core import NULL_RECORDER
from repro_torch.obs.core import current as _obs_current
from repro_torch.runtime import DeviceLike, resolve_device


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return torch.nn.functional.pad(
        x, (0, cols - x.shape[1], 0, rows - x.shape[0]))


def _deprecated(name: str, instead: str) -> None:
    warnings.warn(
        f"{name} is deprecated; use {instead} (the unified chip API: "
        "compile once, stream many)", DeprecationWarning, stacklevel=3)


@dataclasses.dataclass(frozen=True)
class CrossbarParams:
    """Programmed chip state for one linear layer.

    ``scale`` is the program-time fold of everything Eq. 3 needs beyond
    the raw dot product: per tile-column j,

        scale = amax · Σ(σ⁺+σ⁻)_intended / (g_range · Σ(σ⁺+σ⁻)_actual)

    so evaluation is just Σ_r (x_r @ (σ⁺−σ⁻)) · scale."""
    gp: torch.Tensor       # (R, C, rows, cols) conductance tiles, f32
    gn: torch.Tensor
    scale: torch.Tensor    # (R, C, cols) — folded divider + descale
    d_in: int
    d_out: int
    geom_rows: int
    geom_cols: int


def program_layer(w: torch.Tensor, *, geom: CoreGeometry = MEMRISTOR_GEOM,
                  device_model: DeviceModel = DEFAULT_DEVICE,
                  quantize: bool = True,
                  noise_key: Optional[torch.Generator] = None,
                  noise_tol: float = 1.0 / 256.0, r_seg: float = 0.0,
                  noise=None, noise_layer: int = 0,
                  noise_epoch: int = 0) -> CrossbarParams:
    """Tile + differential-encode + (optionally) perturb like the
    feedback-write residual, then fold all input-independent scales.
    w: (d_in, d_out) float, on the device the state should live on.
    Wire resistance (``r_seg`` > 0) is a program-time transform of the
    conductances, so it is folded here.

    ``noise_key`` (a ``torch.Generator``) adds the feedback-write
    residual, uniform within ±``noise_tol``, σ⁺'s draws before σ⁻'s.
    ``noise`` (a ``repro_torch.variability.NoiseModel``, duck-typed)
    applies lognormal write error (re-rolled per ``noise_epoch``),
    persistent stuck cells and IR-drop attenuation; an ideal model is
    skipped entirely. Temporal drift is a stream-time effect
    (``repro_torch.chip.compile.stream_pipeline``)."""
    w = w.to(torch.float32)
    d_in, d_out = w.shape
    R = math.ceil(d_in / geom.rows)
    C = math.ceil(d_out / geom.cols)
    wp = _pad_to(w, R * geom.rows, C * geom.cols)
    tiles = wp.reshape(R, geom.rows, C, geom.cols).permute(0, 2, 1, 3)
    gp, gn, amax = pairs_from_weights(tiles, device_model, quantize)
    # descale from the *intended* state (the chip's downstream scales
    # are fixed at program time; the noise residual is the accuracy
    # cost the paper's tolerance bound accepts)
    descale = amax[..., 0] * column_gain(gp, gn) / device_model.g_range
    if noise_key is not None:
        from repro_torch.core.programming import (ProgrammingConfig,
                                                  programming_noise)
        cfg = ProgrammingConfig(tol_frac=noise_tol,
                                device_model=device_model)
        gp = device_model.clip(
            gp + programming_noise(noise_key, gp.shape, cfg).to(w.device))
        gn = device_model.clip(
            gn + programming_noise(noise_key, gn.shape, cfg).to(w.device))
    if noise is not None and not noise.is_ideal:
        gp, gn = noise.perturb(gp, gn, device_model, layer=noise_layer,
                               epoch=noise_epoch)
        if noise.ir_drop_r_seg:
            att = wire_attenuation(geom.rows, geom.cols,
                                   float(device_model.g_on),
                                   noise.ir_drop_r_seg, device=w.device)
            gp = gp * att
            gn = gn * att
    if r_seg:
        att = wire_attenuation(geom.rows, geom.cols,
                               float(device_model.g_on), r_seg,
                               device=w.device)
        gp = gp * att
        gn = gn * att
    # the divider the physical column actually realizes
    den_actual = torch.sum(gp + gn, dim=2)                 # (R, C, cols)
    scale = descale / den_actual
    return CrossbarParams(gp.contiguous(), gn.contiguous(),
                          scale.contiguous(), d_in, d_out,
                          geom.rows, geom.cols)


def tile_inputs(params: CrossbarParams, x: torch.Tensor) -> torch.Tensor:
    """(B, d_in) → (B, R, rows), zero-padded to the tile grid: the
    crossbar kernel's x operand."""
    R, rows = params.gp.shape[0], params.geom_rows
    xp = torch.nn.functional.pad(x, (0, R * rows - params.d_in))
    return xp.reshape(-1, R, rows).contiguous()


def folded_weights(params: CrossbarParams, dtype: torch.dtype
                   ) -> torch.Tensor:
    """The reference's einsum-path weights: (gp − gn) · scale per tile,
    (R, C, rows, cols) in ``dtype`` (bf16 for a bf16 stream)."""
    return ((params.gp - params.gn) *
            params.scale[:, :, None, :]).to(dtype)


def crossbar_apply(params: CrossbarParams, x: torch.Tensor, *,
                   bias: Optional[torch.Tensor] = None,
                   activation: str = "linear",
                   use_kernel: bool = False) -> torch.Tensor:
    """Streaming evaluate: x (..., d_in) → (..., d_out), in x's dtype.

    ``use_kernel`` runs the crossbar kernel (reduce mode, bias and
    activation in its epilogue); otherwise the reference's einsum over
    the whole tile grid with ``scale`` folded into the weights."""
    C, cols = params.gp.shape[1], params.geom_cols
    lead = x.shape[:-1]
    cdtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    xt = tile_inputs(params, x.reshape(-1, x.shape[-1]).to(cdtype))
    if use_kernel:
        from repro_torch.kernels import ops as kops
        bfull = None
        if bias is not None:
            bfull = torch.nn.functional.pad(
                bias.to(torch.float32).reshape(-1),
                (0, C * cols - params.d_out))
        out = kops.crossbar_mvm(xt, params.gp, params.gn, params.scale,
                                bfull, activation=activation)
        out = out[:, :params.d_out]
    else:
        # f32 products of (possibly bf16) operands: the reference's
        # preferred_element_type=f32 (bf16 products are exact in f32)
        out = torch.einsum("brk,rckn->bcn", xt.to(torch.float32),
                           folded_weights(params, cdtype).to(torch.float32))
        out = out.reshape(xt.shape[0], C * cols)[:, :params.d_out]
        if bias is not None:
            out = out + bias.to(torch.float32)[None, :]
        out = q.make_activation(activation)(out)
    return out.reshape(*lead, params.d_out).to(x.dtype)


def crossbar_linear(x: torch.Tensor, w: torch.Tensor, *,
                    geom: CoreGeometry = MEMRISTOR_GEOM,
                    device_model: DeviceModel = DEFAULT_DEVICE,
                    quantize: bool = True, r_seg: float = 0.0,
                    activation: str = "linear",
                    noise_key: Optional[torch.Generator] = None,
                    use_kernel: bool = False) -> torch.Tensor:
    """DEPRECATED one-shot program + apply: re-programs the crossbars
    on every call. Hold a CrossbarParams from program_layer, or compile
    the network with ``repro_torch.chip.compile_chip``."""
    _deprecated("crossbar_linear",
                "program_layer(...) + crossbar_apply, or "
                "repro_torch.chip.compile_chip(...).stream")
    params = program_layer(w, geom=geom, device_model=device_model,
                           quantize=quantize, noise_key=noise_key,
                           r_seg=r_seg)
    return crossbar_apply(params, x, activation=activation,
                          use_kernel=use_kernel)


# --------------------------------------------------------------------- #
# the digital (SRAM) core counterpart
# --------------------------------------------------------------------- #
# input DAC range for the digital datapath (§II.A): analog voltages in
# [-1, 1] quantized to 2^bits codes.
_DIG_LO, _DIG_HI = -1.0, 1.0


@dataclasses.dataclass(frozen=True)
class DigitalParams:
    """Programmed SRAM-core state: int synapses + the requantize
    constants fixed when the synapse memory is written.

    Evaluation is act(acc · scale + offset) with acc = xq @ wq the
    exact integer MAC-array output.

    Above 8 bits ``planes`` holds the codes as signed int8 byte planes,
    ``wq = Σ_j 256^j · planes[j]`` exactly, split once when the synapse
    memory is written: the int8 MAC kernel takes one plane at a time
    (:func:`digital_apply`). None at 8 bits and below."""
    wq: torch.Tensor       # (d_in, d_out) int8 (int32 above 8 bits)
    scale: torch.Tensor    # (d_out,) f32 — step · weight_scale
    offset: torch.Tensor   # (d_out,) f32 — lo · Σ_k wq · weight_scale
    step: float            # input quantization step
    bits: int
    d_in: int
    d_out: int
    planes: Optional[torch.Tensor] = None   # (P, d_in, d_out) int8 | None


# The widest codes the digital core takes. Above 16 bits an accumulator
# can pass 2⁵³, where the einsum path's f64 sum stops being exact, and
# the input codes (f32 integers) stop being exact above 24.
MAX_DIGITAL_BITS = 16


def _weight_planes(bits: int) -> int:
    """Signed byte planes that hold every code in [-qmax, qmax]: p
    signed digits span up to 127·(256^p − 1)/255."""
    qmax = 2 ** (bits - 1) - 1
    p = 1
    while 127 * (256 ** p - 1) // 255 < qmax:
        p += 1
    return p


def signed_byte_planes(wq: torch.Tensor, n: int) -> torch.Tensor:
    """Integer codes → (n, *wq.shape) int8 planes with
    ``wq = Σ_j 256^j · planes[j]``: each plane takes the low byte as a
    signed digit in [-128, 127] and carries the rest into the next."""
    rest = wq.to(torch.int64)
    planes = []
    for _ in range(n):
        digit = torch.remainder(rest + 128, 256) - 128
        planes.append(digit.to(torch.int8))
        rest = torch.div(rest - digit, 256, rounding_mode="floor")
    if bool(torch.any(rest != 0)):
        raise ValueError(f"signed_byte_planes: codes do not fit {n} "
                         f"signed byte plane(s)")
    return torch.stack(planes).contiguous()


def unsigned_byte_planes(codes: torch.Tensor, n: int) -> torch.Tensor:
    """Integer codes in [0, 2³¹) (any dtype holding them exactly) →
    (n, *codes.shape) uint8 planes with ``codes = Σ_i 256^i ·
    planes[i]``. The copy of an int32 into uint8 keeps its low byte."""
    c = codes.to(torch.int32)
    planes = torch.empty((n, *c.shape), dtype=torch.uint8,
                         device=c.device)
    for i in range(n):
        planes[i].copy_(c >> (8 * i) if i else c)
    return planes


def _digital_params(wq, scale, offset, step, bits, d_in, d_out
                    ) -> DigitalParams:
    planes = signed_byte_planes(wq, _weight_planes(bits)) \
        if bits > 8 else None
    return DigitalParams(wq, scale, offset, step, bits, d_in, d_out,
                         planes)


def program_digital(w: torch.Tensor, *, bits: int = 8) -> DigitalParams:
    """Quantize weights and precompute the per-neuron requantize
    epilogue constants (program-once for the SRAM core); above 8 bits
    also split the codes into the kernel's int8 byte planes. ``bits``
    runs from 2 to :data:`MAX_DIGITAL_BITS`."""
    if not 2 <= bits <= MAX_DIGITAL_BITS:
        raise ValueError(f"program_digital: bits must be in [2, "
                         f"{MAX_DIGITAL_BITS}], got {bits}")
    d_in, d_out = w.shape
    wq, ws = q.quantize_weights(w.to(torch.float32), bits=bits,
                                per_column=True)
    n = 2.0 ** bits - 1.0
    step = (_DIG_HI - _DIG_LO) / n
    ws = ws.reshape(-1).to(torch.float32)
    scale = step * ws
    offset = _DIG_LO * torch.sum(wq, dim=0).to(torch.float32) * ws
    return _digital_params(wq.contiguous(), scale, offset, step, bits,
                           d_in, d_out)


def dac_of(params: DigitalParams) -> Tuple[float, float, int]:
    """The input DAC's (lo, step, bits), as ``kernels.ops.int8_matmul``
    takes them."""
    return _DIG_LO, params.step, params.bits


def quantize_inputs(params: DigitalParams, x: torch.Tensor
                    ) -> torch.Tensor:
    """Analog inputs → DAC codes 0..2^bits−1 (f32 holding integers)."""
    return kref.dac_codes(x, *dac_of(params))


def digital_apply(params: DigitalParams, x: torch.Tensor, *,
                  bias: Optional[torch.Tensor] = None,
                  activation: str = "linear",
                  use_kernel: bool = False,
                  rec=NULL_RECORDER) -> torch.Tensor:
    """Streaming evaluate on the digital core: quantize inputs, int
    MAC, fused requantize + bias + activation epilogue.

    ``use_kernel`` runs the int8 MAC kernel: at 8 bits and below once,
    with the fused epilogue; above 8 bits once for each pair of byte
    planes of the input codes and the synapses (raw int32 products,
    combined exactly in int64), then the same epilogue in PyTorch. The
    reference's kernel path wraps wide codes into uint8 (R4) and its
    einsum path sums them in int32, which can overflow (R5); here both
    paths are exact, and equal to the bit. At 8 bits and below the
    kernel takes the f32 inputs and forms the DAC codes itself, in its
    load (counted by the ``obs`` counter ``chip.dac_in_kernel``, one a
    layer).

    ``rec`` (an ``obs`` span recorder) brackets the DAC codes
    (``chip.quantize``); on the 8-bit kernel path the codes are formed
    inside the one kernel launch, so there the span covers the DAC
    together with the MAC."""
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
    offset = params.offset
    if bias is not None:
        offset = offset + bias.to(torch.float32).reshape(-1)
    if use_kernel and params.planes is None:
        from repro_torch.kernels import ops as kops
        with rec.span("chip.quantize"):
            out = kops.int8_matmul(xf.contiguous(), params.wq,
                                   params.scale, offset,
                                   activation=activation,
                                   dac=dac_of(params))
        _obs_current().metrics.counter("chip.dac_in_kernel").inc()
        return out.reshape(*lead, params.d_out).to(x.dtype)
    with rec.span("chip.quantize"):
        xq = quantize_inputs(params, xf)
    if use_kernel:
        from repro_torch.kernels import ops as kops
        acc = kops.int8_matmul_planes(
            unsigned_byte_planes(xq, math.ceil(params.bits / 8)),
            params.planes)
    else:
        # integer products summed exactly in f64 (PyTorch has no
        # integer matmul on CUDA)
        acc = xq.to(torch.float64) @ params.wq.to(torch.float64)
    # the exact integer rounded once to f32, as an int32 accumulator is
    # where it does not overflow
    out = acc.to(torch.float32) * params.scale[None, :] + offset[None, :]
    out = q.make_activation(activation)(out)
    return out.reshape(*lead, params.d_out).to(x.dtype)


def digital_linear(x: torch.Tensor, w: torch.Tensor, *, bits: int = 8,
                   activation: str = "linear",
                   use_kernel: bool = False) -> torch.Tensor:
    """DEPRECATED one-shot SRAM-core execution (§II.A datapath):
    re-quantizes the weights on every call. Hold a DigitalParams from
    program_digital, or compile with ``repro_torch.chip.compile_chip``."""
    _deprecated("digital_linear",
                "program_digital(...) + digital_apply, or "
                "repro_torch.chip.compile_chip(..., system='digital')"
                ".stream")
    params = program_digital(w, bits=bits)
    return digital_apply(params, x, activation=activation,
                         use_kernel=use_kernel)


# --------------------------------------------------------------------- #
# the paper's app networks
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class MLPSpec:
    dims: Tuple[int, ...]
    activation: str = "threshold"    # hidden activation (memristor)
    out_activation: str = "linear"


def mlp_init(spec: MLPSpec, *, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None):
    """Random weights ``N(0, 1/fan_in)`` and zero biases, as
    ``[{"w": (d_in, d_out), "b": (d_out,)}]`` f32 tensors on ``device``
    (default ``cuda``). Drawn from ``generator`` on its own device, then
    moved. A ``torch.Generator`` does not reproduce the reference's
    ``jax.random`` draws: to compare the two, carry the reference's
    weights across with :func:`params_from_numpy`."""
    dev = resolve_device(device)
    gen_dev = generator.device if generator is not None else "cpu"
    params = []
    for i in range(len(spec.dims) - 1):
        fan = spec.dims[i]
        w = torch.randn((spec.dims[i], spec.dims[i + 1]),
                        generator=generator, dtype=torch.float32,
                        device=gen_dev) / math.sqrt(fan)
        params.append({"w": w.to(dev),
                       "b": torch.zeros(spec.dims[i + 1],
                                        dtype=torch.float32, device=dev)})
    return params


def params_from_numpy(params: Sequence[dict], *,
                      device: DeviceLike = None):
    """The reference's ``[{"w", "b"}]`` (numpy arrays) → the port's
    params, f32 tensors on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return [{k: torch.tensor(np.asarray(p[k], np.float32), device=dev)
             for k in ("w", "b")} for p in params]


def crossbar_params_from_numpy(gp, gn, scale, *, d_in: int, d_out: int,
                               geom_rows: int, geom_cols: int,
                               device: DeviceLike = None
                               ) -> CrossbarParams:
    """Programmed crossbar state carried across from numpy."""
    dev = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return CrossbarParams(t(gp), t(gn), t(scale), int(d_in), int(d_out),
                          int(geom_rows), int(geom_cols))


def digital_params_from_numpy(wq, scale, offset, *, step: float, bits: int,
                              d_in: int, d_out: int,
                              device: DeviceLike = None) -> DigitalParams:
    """Programmed SRAM-core state carried across from numpy."""
    dev = resolve_device(device)
    wq_np = np.asarray(wq)
    wq_t = torch.tensor(
        wq_np.astype(np.int8 if bits <= 8 else np.int32), device=dev)
    return _digital_params(
        wq_t, torch.tensor(np.asarray(scale, np.float32), device=dev),
        torch.tensor(np.asarray(offset, np.float32), device=dev),
        float(step), int(bits), int(d_in), int(d_out))


@dataclasses.dataclass(frozen=True)
class ProgrammedMLP:
    """A fully programmed MLP: per-layer chip state + biases + the
    fused activation schedule. Build once with program_mlp, stream
    through programmed_mlp_apply — no per-call re-encoding."""
    layers: Tuple       # CrossbarParams | DigitalParams per layer
    biases: Tuple       # (d_out,) f32 per layer
    activations: Tuple[str, ...]  # fused act per layer
    mode: str                     # "crossbar" | "digital"


def program_mlp(params, spec: MLPSpec, *, mode: str = "crossbar",
                geom: CoreGeometry = MEMRISTOR_GEOM,
                device_model: DeviceModel = DEFAULT_DEVICE,
                weight_bits: int = 8,
                noise_key: Optional[torch.Generator] = None,
                r_seg: float = 0.0,
                noise=None, noise_epoch: int = 0) -> ProgrammedMLP:
    """Program every layer of the MLP once (crossbar or SRAM mode), on
    the device the params live on. ``noise_key``/``noise``/
    ``noise_epoch`` thread the variability model into each crossbar
    layer's programming, layer by layer from the one generator; digital
    mode ignores them (SRAM writes are noise-free in this model)."""
    if mode not in ("crossbar", "digital"):
        raise ValueError(f"program_mlp: unknown mode {mode!r}")
    n = len(params)
    layers, biases, acts = [], [], []
    for i, p in enumerate(params):
        if mode == "crossbar":
            layers.append(program_layer(p["w"], geom=geom,
                                        device_model=device_model,
                                        noise_key=noise_key, r_seg=r_seg,
                                        noise=noise, noise_layer=i,
                                        noise_epoch=noise_epoch))
        else:
            layers.append(program_digital(p["w"], bits=weight_bits))
        biases.append(p["b"].to(torch.float32))
        acts.append(spec.activation if i < n - 1 else spec.out_activation)
    return ProgrammedMLP(tuple(layers), tuple(biases), tuple(acts), mode)


def programmed_mlp_apply(prog: ProgrammedMLP, x: torch.Tensor, *,
                         use_kernel: bool = False) -> torch.Tensor:
    """The dense streaming path over already-programmed state: one
    crossbar (or int8) kernel launch per layer with ``use_kernel``."""
    apply_fn = crossbar_apply if prog.mode == "crossbar" else digital_apply
    h = x
    for lp, b, act in zip(prog.layers, prog.biases, prog.activations):
        h = apply_fn(lp, h, bias=b, activation=act, use_kernel=use_kernel)
    return h


# Small FIFO memo so mlp_apply(mode="crossbar"|"digital") programs each
# param set once even when the caller holds no ProgrammedMLP. The key
# is the *identity* of the weight tensors; entries keep strong refs to
# their anchors so a live key can never alias a recycled id().
_MLP_PROGRAM_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_MLP_PROGRAM_CACHE_MAX = 8


def clear_program_cache() -> None:
    """Drop all memoized ProgrammedMLPs (and the strong refs they hold
    to their source param tensors). Long-lived processes that cycle
    through many models should call this — or hold ProgrammedMLPs
    explicitly via program_mlp and skip the memo."""
    _MLP_PROGRAM_CACHE.clear()


def _cached_program_mlp(params, spec: MLPSpec, mode: str,
                        weight_bits: int) -> ProgrammedMLP:
    anchors = tuple(p["w"] for p in params) + tuple(p["b"] for p in params)
    key = (mode, weight_bits, spec, tuple(id(a) for a in anchors))
    hit = _MLP_PROGRAM_CACHE.get(key)
    if hit is not None and all(a is b for a, b in zip(hit[0], anchors)):
        _MLP_PROGRAM_CACHE.move_to_end(key)
        return hit[1]
    with torch.no_grad():
        prog = program_mlp(params, spec, mode=mode, weight_bits=weight_bits)
    _MLP_PROGRAM_CACHE[key] = (anchors, prog)
    while len(_MLP_PROGRAM_CACHE) > _MLP_PROGRAM_CACHE_MAX:
        _MLP_PROGRAM_CACHE.popitem(last=False)
    return prog


def mlp_apply(params, x: torch.Tensor, spec: MLPSpec, *,
              weight_bits: int = 8, act_bits: int = 8,
              mode: str = "float",
              programmed: Optional[ProgrammedMLP] = None,
              use_kernel: bool = True) -> torch.Tensor:
    """mode: float | qat | crossbar | digital — the Fig. 12 sweep axes.

    float/qat are the ex-situ TRAINING forward (the QAT trainer's
    path), plain ``h @ w + b`` with straight-through fake quantization
    in qat. The deployed modes are DEPRECATED here, as in the
    reference: deployment belongs to ``repro_torch.chip.compile_chip(
    spec, params=...).stream(x)``. Pass ``programmed`` (from
    program_mlp), or let the memo program this param set on first use.
    They stream through the kernels (``use_kernel``, the port's
    default; the reference's is its einsum path)."""
    if mode in ("crossbar", "digital"):
        if programmed is None:
            _deprecated(f"mlp_apply(mode={mode!r})",
                        "repro_torch.chip.compile_chip(spec, params=...)"
                        ".stream(x)")
            programmed = _cached_program_mlp(params, spec, mode,
                                             weight_bits)
        return programmed_mlp_apply(programmed, x, use_kernel=use_kernel)
    if mode not in ("float", "qat"):
        raise ValueError(f"mlp_apply: unknown mode {mode!r}")

    h = x
    n = len(params)
    for i, p in enumerate(params):
        act = spec.activation if i < n - 1 else spec.out_activation
        if mode == "qat":
            w = q.fake_quant(p["w"], bits=weight_bits, per_column=True)
            h = h @ w + p["b"]
            h = q.make_activation(act)(h)
            if i < n - 1:
                h = q.fake_quant_act(h, bits=act_bits)
        else:
            h = h @ p["w"] + p["b"]
            h = q.make_activation(act)(h)
    return h
