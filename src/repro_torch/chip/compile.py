"""compile_chip: the unified compile → program → stream entry point.

Port of ``repro.chip.compile``. Network topologies are compiled onto
fixed-geometry cores (§IV.C), the resulting flows are statically
routed over the 2-D mesh (§II.B), every mapped core is programmed once
(§III.D), and the programmed chip then streams items. ``compile_chip``
runs that whole pipeline and returns a :class:`CompiledChip`:

  chip.stream(x)   — execute the *mapped* dataflow: per-row-chunk
                     sub-neuron partials (one crossbar-kernel launch per
                     layer, in partials mode), programmed combiner
                     neurons (Fig. 11), replica fan-out; or one int8
                     MAC-kernel launch per layer on the digital system.
  chip.serve(...)  — a slot-scheduled streaming engine over the chip.

``chip.report()`` (the Tables II–VI accounting) comes with the
cost-model slice of the port; the variability hooks (``noise=``,
``noise_key=``) with the variability slice.

The chip's programmed state (tiles, fold scales, combiner neurons,
biases) is tensors on one device; its mapping and route are plain
attributes. Streaming never re-programs tile state.

Functional tile layout vs the packer's row balancing: both split a
layer with ``fan_in > geom.rows`` into ``ceil(fan_in / geom.rows)`` row
chunks (the Fig. 11 sub-neuron level). The packer balances rows across
chunks so link streaming time equalizes (7 chunks of 112 for 784
inputs); the functional image uses uniform ``geom.rows`` chunks so the
programmed tiles are identical to ``program_layer``'s — the same chunk
*count* into the same cores, so placement and routing are unchanged.
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import quantization as q
from repro_torch.core import routing as routing_lib
from repro_torch.core.crossbar_layer import (CrossbarParams, DigitalParams,
                                             MLPSpec, ProgrammedMLP,
                                             digital_apply, folded_weights,
                                             program_layer, program_mlp,
                                             tile_inputs)
from repro_torch.core.device import DEFAULT_DEVICE, DeviceModel
from repro_torch.core.mapping import Mapping, Net, map_networks
from repro_torch.core.neural_core import (DIGITAL_GEOM, MEMRISTOR_GEOM,
                                          CoreGeometry)
from repro_torch.core.systems import normalize_system, system_mode
from repro_torch.obs.core import current as _obs_current
from repro_torch.runtime import DeviceLike, resolve_device

# full compile passes (map → route → program) this process has run: a
# stream must never re-run the program pass, and the telemetry span of
# every stream records this count's delta to show it
_COMPILE_COUNT = 0


def compile_count() -> int:
    """Monotone count of :func:`compile_chip` passes in this process."""
    return _COMPILE_COUNT


# --------------------------------------------------------------------- #
# the streamable execution plan
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class StreamLayer:
    """One network layer of the mapped dataflow.

    ``tiles`` is the programmed chip state (CrossbarParams tile grid or
    DigitalParams SRAM image). ``combine`` holds one programmed
    all-ones weight vector per Fig. 11 combiner level — the combining
    neurons are *real programmed neurons* (encoded through the same
    differential-pair + fold pipeline as any weight). ``levels`` gives
    each combine level's (groups, fan_in) shape; empty when the layer
    fits the core rows."""
    tiles: Union[CrossbarParams, DigitalParams]
    combine: Tuple[torch.Tensor, ...]        # (fan_in,) f32 per level
    bias: torch.Tensor                       # (d_out,) f32
    activation: str
    levels: Tuple[Tuple[int, int], ...]


def _combiner_levels(n_chunks: int, geom: CoreGeometry,
                     device_model: DeviceModel, device: torch.device
                     ) -> Tuple[Tuple[torch.Tensor, ...],
                                Tuple[Tuple[int, int], ...]]:
    """Fig. 11 combiner tree for ``n_chunks`` sub-neuron partials.

    While the partial count exceeds the core rows, an intermediate
    sub-neuron level sums balanced groups; the final level is the
    combining neuron proper. Every level's all-ones weight column is
    programmed through ``program_layer``."""
    vecs: List[torch.Tensor] = []
    levels: List[Tuple[int, int]] = []
    k = n_chunks
    while k > 1:
        if k > geom.rows:
            groups = math.ceil(k / geom.rows)
            fan_in = math.ceil(k / groups)
        else:
            groups, fan_in = 1, k
        ones = program_layer(torch.ones((fan_in, 1), dtype=torch.float32,
                                        device=device),
                             geom=geom, device_model=device_model)
        w = ((ones.gp - ones.gn) *
             ones.scale[:, :, None, :])[0, 0, :fan_in, 0]
        vecs.append(w.to(torch.float32))
        levels.append((groups, fan_in))
        k = groups
    return tuple(vecs), tuple(levels)


def _layer_plan(lp, bias: torch.Tensor, activation: str,
                device_model: DeviceModel) -> StreamLayer:
    bias = bias.to(torch.float32)
    if isinstance(lp, CrossbarParams):
        R = lp.gp.shape[0]
        geom = CoreGeometry(lp.geom_rows, lp.geom_cols)
        combine, levels = _combiner_levels(
            R, geom, device_model, lp.gp.device) if R > 1 else ((), ())
        return StreamLayer(lp, combine, bias, activation, levels)
    return StreamLayer(lp, (), bias, activation, ())


def _crossbar_partials(p: CrossbarParams, x: torch.Tensor,
                       use_kernel: bool) -> torch.Tensor:
    """Sub-neuron stage: per-row-chunk partial dot products.

    x (B, d_in) → (B, R, d_out). The same tile arithmetic as
    ``crossbar_apply``, but the Fig. 11 reduction over row chunks is
    NOT folded into the contraction — the partials feed the programmed
    combiner stage, which is the mapped dataflow. ``use_kernel`` runs
    the crossbar kernel once, in partials mode, for all R chunks; else
    the reference's einsum with ``scale`` folded into the weights."""
    R = p.gp.shape[0]
    cdtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    xt = tile_inputs(p, x.to(cdtype))
    if use_kernel:
        from repro_torch.kernels import ops as kops
        parts = kops.crossbar_mvm(xt, p.gp, p.gn, p.scale, partials=True)
    else:
        parts = torch.einsum("brk,rckn->brcn", xt.to(torch.float32),
                             folded_weights(p, cdtype).to(torch.float32))
        parts = parts.reshape(xt.shape[0], R, -1)
    return parts[:, :, :p.d_out]


def _apply_stream_layer(layer: StreamLayer, x: torch.Tensor,
                        use_kernel: bool) -> torch.Tensor:
    if isinstance(layer.tiles, DigitalParams):
        return digital_apply(layer.tiles, x, bias=layer.bias,
                             activation=layer.activation,
                             use_kernel=use_kernel)
    parts = _crossbar_partials(layer.tiles, x, use_kernel)     # (B, R, d)
    for w, (groups, fan_in) in zip(layer.combine, layer.levels):
        B, K, d = parts.shape
        pad = groups * fan_in - K
        if pad:
            parts = torch.nn.functional.pad(parts, (0, 0, 0, pad))
        parts = torch.einsum("bgkd,k->bgd",
                             parts.reshape(B, groups, fan_in, d),
                             w.to(parts.dtype))
    out = parts[:, 0, :]
    out = out + layer.bias[None, :]
    return q.make_activation(layer.activation)(out)


def stream_pipeline(plan: Tuple[StreamLayer, ...], x: torch.Tensor,
                    use_kernel: bool = True,
                    replication: int = 1) -> torch.Tensor:
    """Stage-ordered evaluation of the whole mapped pipeline, with
    replica fan-out: the batch is dealt across the ``replication``
    identical pipeline copies (§V.C), each streaming its shard through
    the same programmed image. The reference vmaps over the replica
    axis; here that axis is written out and folded into the batch, so
    all replicas' shards go through one kernel launch per layer."""
    def replica(xb):
        h = xb
        for layer in plan:
            h = _apply_stream_layer(layer, h, use_kernel)
        return h

    B = x.shape[0]
    if replication <= 1 or B < replication:
        return replica(x)
    # (replication, per) shards, padded as the reference's vmap needs
    # them, laid out row-major: the flat batch is the replica axis
    # folded into the batch axis
    per = math.ceil(B / replication)
    xp = torch.nn.functional.pad(x, (0, 0, 0, replication * per - B))
    return replica(xp)[:B]


# --------------------------------------------------------------------- #
# the compiled chip object
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class CompiledChip:
    """A fully compiled + programmed chip (see module docstring).

    ``plan`` holds the programmed tensors (None for an analytic-only
    compile); ``mapping`` and ``route`` are the compile's plain-Python
    reports; ``device`` is where the plan lives and streams run."""
    system: str                         # memristor | digital
    geom: CoreGeometry
    mapping: Mapping
    route: routing_lib.RouteReport
    items_per_second: float             # target rate (0 → best effort)
    plan: Optional[Tuple[StreamLayer, ...]]   # None → analytic-only
    device: torch.device
    dims: Optional[Tuple[int, ...]] = None

    @property
    def replication(self) -> int:
        return self.mapping.replication

    @property
    def total_cores(self) -> int:
        return self.mapping.total_cores

    def stream(self, x, *, use_kernel: bool = True,
               fan_out: bool = True) -> torch.Tensor:
        """Stream a batch through the mapped, programmed pipeline.

        x: (..., d_in) tensor or array → (..., d_out) on the chip's
        device. ``use_kernel`` (the default) runs the hand-written
        kernels on a CUDA chip and their plain versions on a CPU chip;
        ``use_kernel=False`` runs the reference's einsum path.
        ``fan_out=False`` pins the whole batch onto one replica."""
        if self.plan is None:
            raise ValueError(
                "this chip was compiled from bare network shapes "
                "(no weights), so it is analytic-only: stream() and "
                "serve() need programmed state. Re-compile with "
                "compile_chip(spec, params=...) or from a ProgrammedMLP.")
        x = torch.as_tensor(x, device=self.device)
        lead = x.shape[:-1]
        xf = x.reshape(-1, x.shape[-1])
        rep = self.mapping.replication if fan_out else 1
        tel = _obs_current()
        if not tel.active:
            out = stream_pipeline(self.plan, xf, use_kernel=use_kernel,
                                  replication=rep)
        else:
            # program-vs-stream economics, measured: the stream span
            # carries the compile_count delta (a stream must never
            # re-run the program pass) next to the per-batch wall time
            t0 = time.perf_counter()
            c0 = _COMPILE_COUNT
            out = stream_pipeline(self.plan, xf, use_kernel=use_kernel,
                                  replication=rep)
            if out.device.type == "cuda":
                torch.cuda.synchronize(out.device)
            dur = time.perf_counter() - t0
            tel.tracer.complete(
                "chip.stream", t0, dur, tid=0, cat="chip",
                args={"rows": int(xf.shape[0]), "system": self.system,
                      "compile_delta": _COMPILE_COUNT - c0})
            tel.metrics.counter("chip.items_streamed").inc(
                int(xf.shape[0]))
            tel.metrics.histogram("chip.stream_s").record(dur)
        return out.reshape(*lead, out.shape[-1]).to(x.dtype)

    def __call__(self, x, **kw) -> torch.Tensor:
        return self.stream(x, **kw)

    def report(self):
        """Tables II–VI accounting: not ported yet."""
        raise NotImplementedError("cost-model slice")

    def serve(self, *, slots: int = 4, **kw):
        """A :class:`repro_torch.chip.ChipEngine` over this chip."""
        from repro_torch.chip.serving import ChipEngine
        return ChipEngine(self, slots=slots, **kw)


# --------------------------------------------------------------------- #
# compile_chip
# --------------------------------------------------------------------- #
NetworksLike = Union[MLPSpec, ProgrammedMLP, Net, Sequence[Net]]


class ChipRateWarning(UserWarning):
    """The requested items_per_second exceeds what the routed fabric's
    TDM link schedule can sustain."""


def _validate_rate(items_per_second: float, replicas: int,
                   route: routing_lib.RouteReport) -> None:
    """items_per_second sizes the replica fan-out against COMPUTE
    capacity (§V.C), but each replica's mesh is also a static TDM
    network whose busiest link forwards LINK_BITS per cycle. Warn
    (:class:`ChipRateWarning`) when the per-replica rate exceeds what
    the routed schedule can carry."""
    if not items_per_second:
        return
    per_replica = items_per_second / replicas
    limit = route.max_items_per_second
    if per_replica <= limit * (1.0 + 1e-9):
        return
    # stacklevel: here → compile_chip → its caller
    warnings.warn(
        f"compile_chip: items_per_second={items_per_second:g} is "
        f"infeasible on the routed fabric: each of the {replicas} "
        f"replica(s) must stream {per_replica:g} items/s, but the "
        f"busiest mesh link's TDM frame is {route.schedule_cycles} "
        f"cycles/item, capping a replica at {limit:g} items/s. Use a "
        f"larger core geometry (fewer row chunks -> less mesh traffic) "
        f"or lower the target rate.", ChipRateWarning, stacklevel=3)


def _spec_dims(prog: ProgrammedMLP) -> Tuple[int, ...]:
    dims = [prog.layers[0].d_in]
    for lp in prog.layers:
        dims.append(lp.d_out)
    return tuple(dims)


def _default_geom(system: str) -> CoreGeometry:
    return MEMRISTOR_GEOM if system == "memristor" else DIGITAL_GEOM


def _plan_device(prog: ProgrammedMLP) -> torch.device:
    lp = prog.layers[0]
    return (lp.gp if isinstance(lp, CrossbarParams) else lp.wq).device


def compile_chip(networks: NetworksLike, *,
                 params=None,
                 system: str = "memristor",
                 geom: Optional[CoreGeometry] = None,
                 items_per_second: float = 0.0,
                 weight_bits: int = 8,
                 device_model: DeviceModel = DEFAULT_DEVICE,
                 r_seg: float = 0.0,
                 noise=None,
                 noise_key=None,
                 sensor_flags: Optional[Sequence[bool]] = None,
                 deps: Optional[Sequence[Sequence[int]]] = None,
                 device: DeviceLike = None) -> CompiledChip:
    """Compile networks onto a chip: split → pack → place → route, then
    program every mapped layer's tile state on ``device`` (default
    ``cuda``; ``"cpu"`` must be asked for).

    ``networks`` is one of
      * an :class:`MLPSpec` — pass ``params`` (``mlp_init`` or
        ``params_from_numpy``) for a streamable chip, omit it for an
        analytic-only compile;
      * a :class:`ProgrammedMLP` — re-uses its programmed tile state
        (no re-encoding) on the device it lives on;
      * a ``(instances, dims)`` net tuple or a sequence of them —
        analytic-only.

    ``system`` is ``"memristor"`` (1T1M crossbar cores) or
    ``"digital"`` (SRAM cores); ``items_per_second`` sizes the replica
    fan-out (§V.C) and is validated against the routed TDM link
    capacity (a :class:`ChipRateWarning` when it cannot be carried)."""
    if noise is not None or noise_key is not None:
        raise NotImplementedError("variability slice")
    system = normalize_system(system, context="compile_chip")
    mode = system_mode(system)
    global _COMPILE_COUNT
    _COMPILE_COUNT += 1
    t_compile0 = time.perf_counter()

    prog: Optional[ProgrammedMLP] = None
    dims: Optional[Tuple[int, ...]] = None
    if isinstance(networks, ProgrammedMLP):
        prog = networks
        if (prog.mode == "crossbar") != (system == "memristor"):
            raise ValueError(
                f"compile_chip: ProgrammedMLP mode {prog.mode!r} does "
                f"not match system {system!r}")
        dev = _plan_device(prog)
        if device is not None and resolve_device(device) != dev:
            raise ValueError(f"compile_chip: the ProgrammedMLP lives on "
                             f"{dev}, not {device}")
        dims = _spec_dims(prog)
        if geom is None and prog.mode == "crossbar":
            lp0 = prog.layers[0]
            geom = CoreGeometry(lp0.geom_rows, lp0.geom_cols)
        nets: Tuple[Net, ...] = ((1, dims),)
    elif isinstance(networks, MLPSpec):
        dev = resolve_device(device)
        dims = tuple(networks.dims)
        nets = ((1, dims),)
        if params is not None:
            params = [{k: p[k].to(dev) for k in ("w", "b")}
                      for p in params]
            prog = program_mlp(params, networks, mode=mode,
                               geom=geom or _default_geom(system),
                               device_model=device_model,
                               weight_bits=weight_bits, r_seg=r_seg)
    else:
        dev = resolve_device(device)
        if params is not None:
            raise ValueError(
                "compile_chip: params are only meaningful with an "
                "MLPSpec (one weighted network); bare net tuples "
                "compile analytic-only chips")
        seq = list(networks)
        if seq and isinstance(seq[0], int):       # a single bare Net
            seq = [tuple(networks)]
        nets = tuple((int(i), tuple(d)) for i, d in seq)

    mapping = map_networks(nets, system=system, geom=geom,
                           items_per_second=items_per_second,
                           sensor_flags=sensor_flags, deps=deps)
    route = routing_lib.route(mapping)
    _validate_rate(items_per_second, mapping.replication, route)

    plan: Optional[Tuple[StreamLayer, ...]] = None
    if prog is not None:
        plan = program_plan(prog, device_model=device_model)
    chip = CompiledChip(system, mapping.geom, mapping, route,
                        items_per_second, plan, dev, dims)
    tel = _obs_current()
    if tel.active:
        dur = time.perf_counter() - t_compile0
        tel.tracer.complete("chip.compile", t_compile0, dur, tid=0,
                            cat="chip",
                            args={"system": system,
                                  "dims": list(dims) if dims else None,
                                  "streamable": plan is not None})
        tel.metrics.counter("chip.compiles").inc()
        tel.metrics.gauge("chip.compile_count").set(_COMPILE_COUNT)
        tel.metrics.histogram("chip.compile_s").record(dur)
    return chip


def program_plan(prog: ProgrammedMLP, *,
                 device_model: DeviceModel = DEFAULT_DEVICE
                 ) -> Tuple[StreamLayer, ...]:
    """The programming half of a compile, alone: turn an already
    programmed MLP into the streamable per-layer plan (tiles + Fig. 11
    combiner neurons)."""
    return tuple(_layer_plan(lp, b, act, device_model)
                 for lp, b, act in zip(prog.layers, prog.biases,
                                       prog.activations))
