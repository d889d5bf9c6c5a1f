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
  chip.report()    — the Tables II–VI area/power/throughput accounting.
  chip.serve(...)  — a slot-scheduled streaming engine over the chip.

``reprogram_chip`` swaps a chip's weights without re-mapping or
re-routing; ``compile_app`` compiles one of the paper's apps at its
real-time load (an analytic chip whose report is its table row).

The chip's programmed state (tiles, fold scales, combiner neurons,
biases, drift rates) is tensors on one device; its mapping and route
are plain attributes, and the drift clock (items streamed since the
last programming event) is a host-side integer. Streaming never
re-programs tile state.

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
from typing import Any, List, Optional, Sequence, Tuple, Union

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
from repro_torch.obs.core import NULL_RECORDER
from repro_torch.obs.core import current as _obs_current
from repro_torch.runtime import DeviceLike, resolve_device

# full compile passes (map → route → program) this process has run: a
# stream must never re-run the program pass, and the telemetry span of
# every stream records this count's delta to show it
_COMPILE_COUNT = 0


def compile_count() -> int:
    """Monotone count of :func:`compile_chip` passes in this process."""
    return _COMPILE_COUNT


# legacy serving-assembly entry points warn ONCE per process when used
# directly; keyed so tests can reset and assert the exactly-once contract
_DEPRECATION_WARNED: set = set()


def warn_once_deprecated(key: str, message: str, *,
                         stacklevel: int = 3) -> None:
    if key in _DEPRECATION_WARNED:
        return
    _DEPRECATION_WARNED.add(key)
    warnings.warn(message, DeprecationWarning, stacklevel=stacklevel)


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
    fits the core rows.

    ``drift`` (crossbar layers under a drifting NoiseModel only) holds
    the per-cell conductance relaxation rates, shaped like the tiles;
    streaming applies ``exp(-drift · age)`` to the tile grid. None
    everywhere else — the plan is then exactly the ideal one.

    ``groups`` > 1 (crossbar only): the grid holds that many
    independent sub-layers of equal shape (an attention head's matrix
    each), stacked along the row chunks: group g's input (its slice
    of the layer input, padded to its row chunks) meets only its own
    chunks, the combiner sums within a group, and the output is the
    groups' outputs side by side."""
    tiles: Union[CrossbarParams, DigitalParams]
    combine: Tuple[torch.Tensor, ...]        # (fan_in,) f32 per level
    bias: torch.Tensor                       # (d_out,) f32
    activation: str
    levels: Tuple[Tuple[int, int], ...]
    drift: Optional[torch.Tensor] = None     # per-cell rates | None
    groups: int = 1


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
                device_model: DeviceModel, *, noise=None,
                layer: int = 0, groups: int = 1) -> StreamLayer:
    bias = bias.to(torch.float32)
    if isinstance(lp, CrossbarParams):
        R = lp.gp.shape[0] // groups
        geom = CoreGeometry(lp.geom_rows, lp.geom_cols)
        combine, levels = _combiner_levels(
            R, geom, device_model, lp.gp.device) if R > 1 else ((), ())
        drift = None
        if noise is not None and noise.has_drift:
            # per-cell relaxation rates (epoch-independent: retention is
            # a device property). Combiner neurons are left ideal: their
            # all-ones encodings drift uniformly, a common positive
            # factor the activations ignore.
            drift = noise.drift_field(tuple(lp.gp.shape), layer=layer,
                                      device=lp.gp.device)
        return StreamLayer(lp, combine, bias, activation, levels, drift,
                           groups)
    return StreamLayer(lp, (), bias, activation, ())


def program_grouped(ws: torch.Tensor, *, geom: CoreGeometry,
                    device_model: DeviceModel = DEFAULT_DEVICE
                    ) -> CrossbarParams:
    """G independent (d_in, d_out) matrices ``ws`` (G, d_in, d_out) on
    one grid, exact encoding: each programmed alone
    (``program_layer``) and the tile grids stacked along the row
    chunks; ``d_in`` counts the padded rows of all the groups (a
    grouped :class:`StreamLayer`'s input pads to them)."""
    lps = [program_layer(w, geom=geom, device_model=device_model,
                         quantize=False) for w in ws]
    R = lps[0].gp.shape[0]
    return CrossbarParams(torch.cat([lp.gp for lp in lps]).contiguous(),
                          torch.cat([lp.gn for lp in lps]).contiguous(),
                          torch.cat([lp.scale for lp in lps]).contiguous(),
                          len(lps) * R * geom.rows, lps[0].d_out,
                          geom.rows, geom.cols)


def _crossbar_partials(p: CrossbarParams, x: torch.Tensor,
                       use_kernel: bool,
                       decay: Optional[torch.Tensor] = None,
                       rec=NULL_RECORDER) -> torch.Tensor:
    """Sub-neuron stage: per-row-chunk partial dot products.

    x (B, d_in) → (B, R, d_out). The same tile arithmetic as
    ``crossbar_apply``, but the Fig. 11 reduction over row chunks is
    NOT folded into the contraction — the partials feed the programmed
    combiner stage, which is the mapped dataflow. ``use_kernel`` runs
    the crossbar kernel once, in partials mode, for all R chunks; else
    the reference's einsum with ``scale`` folded into the weights.

    ``decay`` (temporal drift) relaxes both pair devices with the cell's
    own factor before either path; the program-time fold ``scale`` is
    frozen physical state, so the decay is an uncorrected error — the
    accuracy loss closed-loop recalibration exists to repair.

    ``rec`` brackets the pad to the tile grid (``chip.tile``)."""
    if decay is not None:
        p = dataclasses.replace(p, gp=p.gp * decay, gn=p.gn * decay)
    R = p.gp.shape[0]
    cdtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    with rec.span("chip.tile"):
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
                        use_kernel: bool,
                        age: Optional[torch.Tensor] = None,
                        rec=NULL_RECORDER) -> torch.Tensor:
    """One layer of the mapped dataflow; ``rec`` brackets its stages
    (``chip.tile``, ``chip.combine``, ``chip.quantize``)."""
    if isinstance(layer.tiles, DigitalParams):
        return digital_apply(layer.tiles, x, bias=layer.bias,
                             activation=layer.activation,
                             use_kernel=use_kernel, rec=rec)
    decay = None
    if layer.drift is not None and age is not None:
        decay = torch.exp(-layer.drift * age)
    G = layer.groups
    if G > 1:
        B = x.shape[0]
        xg = x.reshape(B, G, -1)
        x = torch.nn.functional.pad(
            xg, (0, layer.tiles.d_in // G - xg.shape[2])).reshape(B, -1)
    parts = _crossbar_partials(layer.tiles, x, use_kernel,
                               decay, rec)                     # (B, R, d)
    if G > 1:
        parts = parts.reshape(-1, parts.shape[1] // G, parts.shape[2])
    if layer.combine:
        with rec.span("chip.combine"):
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
    out = q.make_activation(layer.activation)(out)
    return out.reshape(-1, G * out.shape[1]) if G > 1 else out


def stream_pipeline(plan: Tuple[StreamLayer, ...], x: torch.Tensor,
                    use_kernel: bool = True,
                    replication: int = 1,
                    age: Optional[torch.Tensor] = None,
                    rec=NULL_RECORDER) -> torch.Tensor:
    """Stage-ordered evaluation of the whole mapped pipeline, with
    replica fan-out: the batch is dealt across the ``replication``
    identical pipeline copies (§V.C), each streaming its shard through
    the same programmed image. The reference vmaps over the replica
    axis; here that axis is written out and folded into the batch, so
    all replicas' shards go through one kernel launch per layer.

    ``age`` (an f32 scalar tensor on the plan's device: items streamed
    since programming) activates the per-cell drift decay on layers
    that carry a ``drift`` field. Every item of the call, on every
    replica, sees the batch's entry age. ``rec`` (an ``obs`` span
    recorder) brackets each layer's stages."""
    def replica(xb):
        h = xb
        for layer in plan:
            h = _apply_stream_layer(layer, h, use_kernel, age, rec)
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


def _resident(x, device: torch.device) -> bool:
    """``x`` is a tensor on ``device`` already (``cuda`` without an
    index: the current card), so streaming it needs no handover."""
    if not isinstance(x, torch.Tensor):
        return False
    if x.device == device:
        return True
    return device.type == "cuda" and device.index is None and \
        x.device.type == "cuda" and \
        x.device.index == torch.cuda.current_device()


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
    tsv_bits_per_item: Optional[float]
    plan: Optional[Tuple[StreamLayer, ...]]   # None → analytic-only
    device: torch.device
    dims: Optional[Tuple[int, ...]] = None
    # how the plan was encoded (weight_bits/device_model/r_seg) — what
    # reprogram_chip must reuse for a weights-ONLY swap to hold
    program_kw: Optional[dict] = None
    # the variability model the chip was compiled under (None = ideal
    # devices); the drift clock lives in __dict__, host-side
    noise: Optional[Any] = None
    # did THIS compile validate items_per_second against the routed TDM
    # schedule?
    rate_validated: bool = False

    @property
    def replication(self) -> int:
        return self.mapping.replication

    @property
    def total_cores(self) -> int:
        return self.mapping.total_cores

    # -------- drift age (host-side mutable state) ---------------- #
    @property
    def items_streamed(self) -> int:
        """Items streamed since the last programming event — the drift
        clock. Always 0 for chips without a drifting noise model."""
        return self.__dict__.get("_items_streamed", 0)

    @property
    def has_drift(self) -> bool:
        return self.noise is not None and self.noise.has_drift

    def reset_age(self) -> None:
        """Reset the drift clock, as a (re)programming event does."""
        self.__dict__["_items_streamed"] = 0

    def advance_age(self, items: int) -> None:
        """Advance the drift clock by ``items`` streamed elsewhere."""
        if self.has_drift:
            self.__dict__["_items_streamed"] = \
                self.items_streamed + int(items)

    def stream(self, x, *, use_kernel: bool = True,
               fan_out: bool = True,
               advance_age: bool = True) -> torch.Tensor:
        """Stream a batch through the mapped, programmed pipeline.

        x: (..., d_in) tensor or array → (..., d_out) on the chip's
        device. ``use_kernel`` (the default) runs the hand-written
        kernels on a CUDA chip and their plain versions on a CPU chip;
        ``use_kernel=False`` runs the reference's einsum path.
        ``fan_out=False`` pins the whole batch onto one replica. Under
        a drifting noise model the call evaluates at the chip's current
        age and then advances the drift clock by the batch size;
        ``advance_age=False`` makes it a pure probe.

        With ``repro_torch.obs`` telemetry on, the call is a
        ``chip.stream`` span (its rows and the compile_count delta: a
        stream must never re-run the program pass) over the handover
        (``chip.handover``) and each layer's stages, each timed on the
        card by CUDA events, resolved later: the call never waits for
        the card."""
        if self.plan is None:
            raise ValueError(
                "this chip was compiled from bare network shapes "
                "(no weights), so it is analytic-only: report() works, "
                "but stream() and serve() need programmed state. "
                "Re-compile with compile_chip(spec, params=...) or "
                "from a ProgrammedMLP.")
        tel = _obs_current()
        if not tel.active:
            return self._stream(x, use_kernel, fan_out, advance_age,
                                NULL_RECORDER)
        rec = tel.spans(self.device, cat="chip")
        c0 = _COMPILE_COUNT
        with rec.span("chip.stream", system=self.system) as span:
            out = self._stream(x, use_kernel, fan_out, advance_age, rec)
            rows = math.prod(out.shape[:-1])
            span.set(rows=rows, compile_delta=_COMPILE_COUNT - c0)
        tel.metrics.counter("chip.items_streamed").inc(rows)
        return out

    def _stream(self, x, use_kernel: bool, fan_out: bool,
                advance_age: bool, rec) -> torch.Tensor:
        if not _resident(x, self.device):
            with rec.span("chip.handover"):
                x = torch.as_tensor(x, device=self.device)
        lead = x.shape[:-1]
        xf = x.reshape(-1, x.shape[-1])
        rep = self.mapping.replication if fan_out else 1
        age = None
        if self.has_drift:
            # the reference's f32 age (it rounds past 2**24 items),
            # filled on the device: no host-to-device copy
            age = torch.full((), float(self.items_streamed),
                             dtype=torch.float32, device=self.device)
        out = stream_pipeline(self.plan, xf, use_kernel=use_kernel,
                              replication=rep, age=age, rec=rec)
        if age is not None and advance_age:
            self.advance_age(xf.shape[0])
        return out.reshape(*lead, out.shape[-1]).to(x.dtype)

    def __call__(self, x, **kw) -> torch.Tensor:
        return self.stream(x, **kw)

    def report(self):
        """Unified area/power/throughput accounting (Tables II–VI)."""
        from repro_torch.chip.report import chip_report
        return chip_report(self)

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


def validate_stream_rate(items_per_second: float, replicas: int,
                         route: routing_lib.RouteReport,
                         strict: bool, *,
                         context: str = "compile_chip",
                         fabric: str = "replica(s)",
                         remedy: str = ("Use a larger core geometry "
                                        "(fewer row chunks -> less mesh "
                                        "traffic), lower the target "
                                        "rate, or split the load across "
                                        "chips (repro_torch.fleet)."),
                         stacklevel: int = 3,
                         chip_replicas: Optional[int] = None) -> None:
    """items_per_second sizes the replica fan-out against COMPUTE
    capacity (§V.C), but each replica's mesh is also a static TDM
    network whose busiest link forwards LINK_BITS per cycle — a rate a
    replica's cores could hit may still be un-routable. Warn
    (:class:`ChipRateWarning`), or raise ``ValueError`` when
    ``strict``, when the per-replica rate exceeds what the routed
    schedule can carry.

    ``replicas`` is however many identical copies of the routed fabric
    share the load: ``mapping.replication`` at compile time, and
    ``replication × n_chips`` when ``repro_torch.fleet.shard_chip`` fans
    the same compiled plan out over a fleet. ``chip_replicas`` (the
    per-chip replication, when ``replicas`` is already the fleet total)
    folds both capacity levels into the one diagnostic."""
    if not items_per_second:
        return
    per_replica = items_per_second / replicas
    limit = route.max_items_per_second
    if per_replica <= limit * (1.0 + 1e-9):
        return
    capacities = ""
    if chip_replicas is not None:
        capacities = (f" Capacity: {chip_replicas * limit:g} items/s "
                      f"per chip, {replicas * limit:g} items/s "
                      f"fleet-wide.")
    msg = (f"{context}: items_per_second={items_per_second:g} is "
           f"infeasible on the routed fabric: each of the "
           f"{replicas} {fabric} must stream "
           f"{per_replica:g} items/s, but the busiest mesh link's TDM "
           f"frame is {route.schedule_cycles} cycles/item, capping a "
           f"replica at {limit:g} items/s.{capacities} {remedy}")
    if strict:
        raise ValueError(msg)
    warnings.warn(msg, ChipRateWarning, stacklevel=stacklevel)


def _validate_rate(items_per_second: float, replicas: int,
                   route: routing_lib.RouteReport, strict: bool) -> None:
    # point the warning at compile_chip's caller: stacklevel counts
    # validate_stream_rate(1) → here(2) → compile_chip(3) → user(4)
    validate_stream_rate(items_per_second, replicas, route, strict,
                         stacklevel=4)


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
                 noise_key: Optional[torch.Generator] = None,
                 r_seg: float = 0.0,
                 noise=None,
                 sensor_flags: Optional[Sequence[bool]] = None,
                 deps: Optional[Sequence[Sequence[int]]] = None,
                 tsv_bits_per_item: Optional[float] = None,
                 strict_rate: bool = False,
                 validate_rate: bool = True,
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
        analytic-only (report and sizing, no stream).

    ``system`` is ``"memristor"`` (1T1M crossbar cores) or
    ``"digital"`` (SRAM cores); ``items_per_second`` sizes the replica
    fan-out (§V.C) and is validated against the routed TDM link
    capacity: an un-routable rate warns (:class:`ChipRateWarning`) or,
    with ``strict_rate=True``, raises; ``validate_rate=False`` skips
    the check (recorded in ``rate_validated``). ``tsv_bits_per_item``
    overrides the report's mapping-derived sensor traffic.

    ``noise`` (a :class:`repro_torch.variability.NoiseModel`) compiles
    the chip onto non-ideal devices: programming-time effects perturb
    the encoding when this compile runs the encoder (MLPSpec +
    params), and temporal drift attaches per-cell relaxation rates the
    stream evaluates against the chip's age. An ideal model runs the
    same code path as ``noise=None``. ``noise_key`` (a
    ``torch.Generator``) adds the feedback-write residual. Digital
    (SRAM) systems ignore both."""
    system = normalize_system(system, context="compile_chip")
    mode = system_mode(system)
    global _COMPILE_COUNT
    _COMPILE_COUNT += 1
    t_compile0 = time.perf_counter()

    prog: Optional[ProgrammedMLP] = None
    dims: Optional[Tuple[int, ...]] = None
    encoded_here = False                # did THIS compile run the encoder?
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
            prog = program_mlp(_params_on(params, dev), networks,
                               mode=mode,
                               geom=geom or _default_geom(system),
                               device_model=device_model,
                               weight_bits=weight_bits,
                               noise_key=noise_key, r_seg=r_seg,
                               noise=noise, noise_epoch=0)
            encoded_here = True
    else:
        dev = resolve_device(device)
        if params is not None:
            raise ValueError(
                "compile_chip: params are only meaningful with an "
                "MLPSpec (one weighted network); bare net tuples "
                "compile analytic-only chips")
        if hasattr(networks, "family") and hasattr(networks, "num_layers"):
            raise NotImplementedError(
                f"compile_chip maps MLPs only; "
                f"{getattr(networks, 'family', '?')!r} model configs "
                f"(transformer blocks, KV caches) are compiled by "
                f"repro_torch.lm.compile_lm")
        seq = list(networks)
        if seq and isinstance(seq[0], int):       # a single bare Net
            seq = [tuple(networks)]
        nets = tuple((int(i), tuple(d)) for i, d in seq)

    mapping = map_networks(nets, system=system, geom=geom,
                           items_per_second=items_per_second,
                           sensor_flags=sensor_flags, deps=deps)
    route = routing_lib.route(mapping)
    if validate_rate:
        _validate_rate(items_per_second, mapping.replication, route,
                       strict_rate)

    plan: Optional[Tuple[StreamLayer, ...]] = None
    if prog is not None:
        plan = program_plan(prog, device_model=device_model, noise=noise)
    # encoding knobs recorded only when this compile ran the encoder —
    # for a caller-programmed MLP they describe nothing (reprogram_chip
    # then demands them explicitly instead of guessing)
    program_kw = dict(weight_bits=weight_bits, device_model=device_model,
                      r_seg=r_seg) if encoded_here else None
    chip = CompiledChip(system, mapping.geom, mapping, route,
                        items_per_second, tsv_bits_per_item, plan, dev,
                        dims, program_kw, noise,
                        rate_validated=bool(validate_rate))
    tel = _obs_current()
    if tel.active:
        dur = time.perf_counter() - t_compile0
        tel.tracer.complete("chip.compile", t_compile0, dur, tid=0,
                            cat="chip",
                            args={"system": system,
                                  "dims": list(dims) if dims else None,
                                  "streamable": plan is not None})
        tel.metrics.counter("chip.compiles").inc()
        tel.metrics.histogram("chip.compile_s").record(dur)
    return chip


def _params_on(params, dev: torch.device):
    return [{k: p[k].to(dev) for k in ("w", "b")} for p in params]


def program_plan(prog: ProgrammedMLP, *,
                 device_model: DeviceModel = DEFAULT_DEVICE,
                 noise=None) -> Tuple[StreamLayer, ...]:
    """The programming half of a compile, alone: turn an already
    programmed MLP into the streamable per-layer plan (tiles + Fig. 11
    combiner neurons). ``compile_chip`` calls this after map+route;
    :func:`reprogram_chip` calls it INSTEAD of them. ``noise`` attaches
    per-cell drift rates to crossbar layers when the model drifts
    (programming-time effects belong to ``program_mlp``)."""
    return tuple(_layer_plan(lp, b, act, device_model, noise=noise,
                             layer=i)
                 for i, (lp, b, act) in
                 enumerate(zip(prog.layers, prog.biases,
                               prog.activations)))


_KEEP_NOISE = object()     # sentinel: "reuse the chip's own model"


def reprogram_chip(chip: CompiledChip, params, *,
                   spec: Optional[MLPSpec] = None,
                   weight_bits: Optional[int] = None,
                   device_model: Optional[DeviceModel] = None,
                   noise_key: Optional[torch.Generator] = None,
                   r_seg: Optional[float] = None,
                   noise=_KEEP_NOISE) -> CompiledChip:
    """Swap a compiled chip's weights WITHOUT recompiling the fabric.

    The mapping, placement and routed TDM schedule are functions of the
    network *shape* only, so new weights for the same topology need
    only re-encoding into tile state (``program_mlp`` +
    :func:`program_plan`) — map_networks/route never run, asserted by
    :func:`compile_count` staying put.

    The returned chip shares the original's mapping/route objects and
    device; only ``plan`` is new. ``spec`` defaults to the chip's own
    dims and per-layer activations, and ``weight_bits``/
    ``device_model``/``r_seg`` to the values the chip was COMPILED with
    (``noise_key`` is per-programming-event, so it never defaults to
    the old one).

    The chip's variability model carries over by default (pass
    ``noise=`` to change it, including ``None`` to go ideal). A
    reprogram is a new programming *epoch*: write noise re-rolls,
    stuck cells persist, and the drift clock resets to age 0."""
    if chip.plan is None:
        raise ValueError(
            "reprogram_chip: this chip is analytic-only (compiled "
            "without weights) — there is no programmed state to swap; "
            "compile_chip(spec, params=...) first")
    if chip.program_kw is None and \
            (weight_bits is None or device_model is None or r_seg is None):
        # the chip was compiled from an externally-programmed MLP, so
        # how its tiles were encoded is unknown — guessing defaults
        # would silently change the tenant's quantization
        raise ValueError(
            "reprogram_chip: this chip was compiled from a "
            "pre-programmed MLP, so its original encoding parameters "
            "are not recorded — pass weight_bits, device_model and "
            "r_seg explicitly to guarantee the swap re-encodes the same "
            "way")
    compiled_kw = chip.program_kw or {}
    if weight_bits is None:
        weight_bits = compiled_kw["weight_bits"]
    if device_model is None:
        device_model = compiled_kw["device_model"]
    if r_seg is None:
        r_seg = compiled_kw["r_seg"]
    explicit_spec = spec
    if spec is None:
        spec = MLPSpec(chip.dims,
                       activation=chip.plan[0].activation,
                       out_activation=chip.plan[-1].activation)
    if tuple(spec.dims) != tuple(chip.dims):
        raise ValueError(
            f"reprogram_chip: new network dims {tuple(spec.dims)} do "
            f"not match the compiled fabric {tuple(chip.dims)} — a "
            f"different topology re-maps and re-routes; use "
            f"compile_chip")
    if len(params) != len(chip.dims) - 1:
        raise ValueError(
            f"reprogram_chip: {len(params)} weight layer(s) do not "
            f"match the compiled fabric's {len(chip.dims) - 1}")
    for i, p in enumerate(params):
        want = (chip.dims[i], chip.dims[i + 1])
        if tuple(p["w"].shape) != want:
            raise ValueError(
                f"reprogram_chip: layer {i} weights {tuple(p['w'].shape)}"
                f" do not match the compiled fabric {want}")
    if noise is _KEEP_NOISE:
        noise = chip.noise
    epoch = chip.__dict__.get("_noise_epoch", 0) + 1
    prog = program_mlp(_params_on(params, chip.device), spec,
                       mode=system_mode(chip.system), geom=chip.geom,
                       device_model=device_model, weight_bits=weight_bits,
                       noise_key=noise_key, r_seg=r_seg, noise=noise,
                       noise_epoch=epoch)
    if explicit_spec is None:
        # tile programming is activation-independent, but the plan
        # records one activation PER layer — keep the compiled chip's
        # own schedule rather than the MLPSpec reconstruction
        prog = dataclasses.replace(
            prog, activations=tuple(lay.activation for lay in chip.plan))
    new = dataclasses.replace(chip,
                              plan=program_plan(prog,
                                                device_model=device_model,
                                                noise=noise),
                              noise=noise)
    # fresh object → fresh __dict__: the drift clock starts at age 0;
    # remember the epoch so the NEXT reprogram re-rolls write noise
    new.__dict__["_noise_epoch"] = epoch
    tel = _obs_current()
    if tel.active:
        tel.tracer.instant(
            "chip.reprogram", cat="chip",
            args={"system": chip.system, "epoch": epoch,
                  "compile_count": _COMPILE_COUNT})
        tel.metrics.counter("chip.reprograms").inc()
    return new


def compile_app(app, system: str, *,
                geom: Optional[CoreGeometry] = None,
                device: DeviceLike = None) -> CompiledChip:
    """Compile one of the paper's applications (a
    ``repro_torch.configs.paper_apps.AppConfig``, duck-typed) at its
    real-time load: the analytic chip whose ``report()`` is the app's
    Tables II–VI row for ``system``."""
    system = normalize_system(system, context="compile_app")
    nets = app.memristor_nets if system == "memristor" else app.sram_nets
    return compile_chip(nets, system=system, geom=geom,
                        items_per_second=app.items_per_second,
                        sensor_flags=app.sensor_flags(system),
                        deps=app.net_deps(system),
                        tsv_bits_per_item=app.tsv_bits_per_item,
                        device=device)
