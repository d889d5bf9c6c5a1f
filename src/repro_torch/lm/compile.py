"""compile_lm: transformer blocks on the crossbar fabric.

Port of ``repro.lm.compile``. Every matmul of a dense transformer block
— the seven per-layer linears wq/wk/wv/wo (attention) and w1/w3/w2
(the gated FFN: SwiGLU, or GeGLU for gemma2) — is programmed onto tile grids through the SAME
``program_layer`` → ``StreamLayer`` pipeline that maps the sensor MLPs,
while everything a crossbar cannot express (rms-norm, rotary embedding,
softmax attention, residuals, KV-cache surgery, the tied LM head) stays
plain tensor glue from ``models/transformer.py`` via its
``project``/``mlp_fn`` hooks. With ``use_kernel=True`` (the port's
default) each linear is one crossbar-kernel launch in partials mode
(``csrc/crossbar_mvm.cu``), then the programmed Fig. 11 combiner: a
forward launches the kernel 7 × ``num_layers`` times.

Exactness discipline
--------------------
LM linears are programmed in EXACT mode (``quantize=False``): the
differential-pair encoding with the per-tile-column fold scale is
value-preserving — ``(gp - gn) · scale`` recovers the weight up to
float rounding — and the combiner neurons' all-ones encodings decode
to exactly 1.0. One functional image therefore serves BOTH systems:
memristor and digital differ in tile geometry (128×64 and 256×128 by
default, so tiling, combiner depth and the whole cost model differ) but
share the exact encoding, which is what lets
``CompiledLM.prefill``/``decode`` match the dense forward at rel ≤
1e-6 on the CPU. The int8 digital path (the MAC kernels) is not on this
path. Host glue is forced to float32 compute for the same reason.

Latent attention and held experts
---------------------------------
A ``family="moe"`` config with ``attention="mla"`` (DeepSeek-V3's
block: Moonlight-16B-A3B) maps every static-weight product of both
block kinds onto its own grid, through the same ``program_layer`` →
``StreamLayer`` → ``_apply_stream_layer`` path:

  attention  "wq_a" (q_proj and kv_a_proj side by side: one input),
             "wkb" (each head's W_kbᵀ, nope → r) and "wvb" (each
             head's W_vb, r → v) as GROUPED grids (``StreamLayer.groups``
             = heads: the heads' matrices stacked along the row chunks,
             one launch for all heads), "wo";
  dense FFN  "w13" (w1 and w3 side by side), "w2";
  MoE        "router", "shared_w13", "shared_w2", and each held
             expert's "w13.e", "w2.e".

The absorbed form (``models.attention``) keeps only the latent and
the RoPE key in the cache and never expands K or V; the glue (norms,
RoPE, the attention over the latent cache, routing and the grouping by
expert) is ``models.transformer.LatentMoEStack``'s own code, handed
these grids through its hooks. A decode writes the latent cache in
place.

Cost accounting, built lazily
-----------------------------
The per-layer linears double as ``(1, (d_in, d_out))`` net tuples for
an analytic :class:`repro_torch.chip.CompiledChip` (map → route), so an
LM tenant prices through ``deployment_report`` like a sensor app.
``CompiledLM.chip`` builds that chip on first access and keeps it; the
reference builds it inside ``compile_lm``. The values are the same. The
reason is the reference's fault R8 (ROADMAP Queue 3): the routing pass
pairs every net's stage-0 producers with every net's stage-1 consumers
(``core/routing.py`` ``build_flows``), so the flows grow with the
square of the net count — 8,256 flows for one (1024, 1024) net at
128×64 tiles, 524,800 for eight — and the 168 linears of the
full-width qwen1.5-0.5B cannot be routed in any reasonable time, while
its programmed tile plans (the part that computes) take seconds. So
``compile_lm`` programs and never routes; ``deploy()`` touches
``.chip`` to validate the tenant's rate and price it, as the reference
does, at the widths where that finishes.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.chip.compile import (CompiledChip, StreamLayer,
                                      _apply_stream_layer, _default_geom,
                                      _layer_plan, compile_chip,
                                      program_grouped)
from repro_torch.core.crossbar_layer import program_layer
from repro_torch.core.device import DEFAULT_DEVICE, DeviceModel
from repro_torch.core.neural_core import CoreGeometry
from repro_torch.core.systems import normalize_system
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as tf
from repro_torch.models.layers import act_fn, rms_norm
from repro_torch.obs.core import current as _obs_current
from repro_torch.runtime import DeviceLike, resolve_device

# the crossbar-mappable linears of one dense block, in dataflow order
LM_LINEARS: Tuple[str, ...] = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")
# a latent decode reads the cache's first slots in multiples of this
KV_LEN_STEP = 128


@dataclasses.dataclass(frozen=True)
class TransformerParams:
    """A model config plus its dense parameter tree (tensors, the
    layout of :func:`repro_torch.models.model.init_params`) — what a
    trainer or a checkpoint loader hands :func:`compile_lm` instead of
    a fresh seeded init."""
    cfg: Any
    params: Any


def _block_linears(cfg, p_l) -> Dict[str, torch.Tensor]:
    """The seven (d_in, d_out) weight matrices of one block, flattened
    out of the attention head layout. QKV biases are NOT folded in —
    ``attn_apply`` adds them in the glue, so the programmed tiles stay
    pure matmuls (a crossbar bias row would re-quantize them)."""
    a = p_l["attn"]
    d, H = cfg.d_model, cfg.num_heads
    KH, dh = cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": a["wq"].reshape(d, H * dh),
        "wk": a["wk"].reshape(d, KH * dh),
        "wv": a["wv"].reshape(d, KH * dh),
        "wo": a["wo"].reshape(H * dh, d),
        "w1": p_l["mlp"]["w1"],
        "w3": p_l["mlp"]["w3"],
        "w2": p_l["mlp"]["w2"],
    }


# --------------------------------------------------------------------- #
# the mapped forward (glue + tile-grid projections)
# --------------------------------------------------------------------- #
def _latent_linears(cfg, p_l, moe: bool) -> Dict[str, torch.Tensor]:
    """A latent (MLA) block's static-weight products (see the module
    docstring): (d_in, d_out) matrices, and (heads, d_in, d_out) stacks
    for the grouped "wkb" and "wvb"."""
    a = p_l["attn"]
    d, H, nope = cfg.d_model, cfg.num_heads, cfg.qk_nope_head_dim
    wb = a["wkv_b"]                                  # (r, H, nope + v)
    lin = {"wq_a": torch.cat([a["wq"].reshape(d, -1), a["wkv_a"]], dim=1),
           "wkb": wb[..., :nope].permute(1, 2, 0),   # (H, nope, r)
           "wvb": wb[..., nope:].permute(1, 0, 2),   # (H, r, v)
           "wo": a["wo"].reshape(-1, d)}
    m = p_l["mlp"]
    if not moe:
        lin["w13"] = torch.cat([m["w1"], m["w3"]], dim=1)
        lin["w2"] = m["w2"]
        return lin
    lin["router"] = m["router"]
    if cfg.num_shared_experts:
        sh = m["shared"]
        lin["shared_w13"] = torch.cat([sh["w1"], sh["w3"]], dim=1)
        lin["shared_w2"] = sh["w2"]
    for e in range(cfg.local_experts):
        lin[f"w13.{e}"] = torch.cat([m["w1"][e], m["w3"][e]], dim=1)
        lin[f"w2.{e}"] = m["w2"][e]
    return lin


def _projector(layer_plans: Dict[str, StreamLayer], use_kernel: bool):
    """``project(name, x)``: x (..., d_in) through the layer's grid
    ``name``."""
    def project(name: str, x: torch.Tensor) -> torch.Tensor:
        out = _apply_stream_layer(layer_plans[name],
                                  x.reshape(-1, x.shape[-1]), use_kernel)
        return out.reshape(*x.shape[:-1], -1)
    return project


def _mlp_fn(layer_plans: Dict[str, StreamLayer], cfg, use_kernel: bool):
    def mlp(p_mlp, x: torch.Tensor) -> torch.Tensor:
        B, S, d = x.shape
        x2 = x.reshape(B * S, d)
        h = _apply_stream_layer(layer_plans["w1"], x2, use_kernel)
        g = _apply_stream_layer(layer_plans["w3"], x2, use_kernel)
        h = act_fn(cfg.act)(h) * g
        out = _apply_stream_layer(layer_plans["w2"], h, use_kernel)
        return out.reshape(B, S, -1)
    return mlp


def _latent_forward(clm: "CompiledLM", batch, mode: str, cache,
                    use_kernel: bool, kv_len: Optional[int] = None,
                    routes=None):
    """``LatentMoEStack.apply`` with every layer's products on its
    grids; spans ``lm.*`` on the LM's device when tracing; ``routes``
    as the stack's."""
    cfg, params = clm.cfg, clm.params
    h = model_lib._embed_in(cfg, params, batch, torch.float32)
    B, S = h.shape[0], h.shape[1]
    positions = model_lib.positions_for(cfg, batch, B, S, mode, h.device)

    def hooks(layer):
        project = _projector(clm.plans[layer], use_kernel)
        return project, project

    h, cache, _ = tf.LatentMoEStack.apply(
        params["stack"], cfg, h, positions=positions, mode=mode,
        cache=cache, hooks=hooks, kv_len=kv_len,
        rec=_obs_current().spans(clm.device), routes=routes)
    return rms_norm(h, params["final_norm"], cfg.norm_eps), cache


def _lm_forward(clm: "CompiledLM", batch, mode: str, cache,
                use_kernel: bool):
    """``model.forward`` with each layer's seven matmuls routed through
    ``_apply_stream_layer`` (each layer owns a distinct programmed tile
    image). Positions, cache layout and everything else mirror the
    dense path exactly — the stacked cache is the dense engine's, which
    is what lets ``serving.kvcache`` slot surgery work unchanged."""
    cfg, params = clm.cfg, clm.params
    h = model_lib._embed_in(cfg, params, batch, torch.float32)
    B, S = h.shape[0], h.shape[1]
    positions = model_lib.positions_for(cfg, batch, B, S, mode, h.device)
    windows = tf._layer_windows(cfg)
    caches = []
    for layer in range(cfg.num_layers):
        h, c_new, _ = tf._block_apply(
            tf.layer_slice(params["stack"], layer), cfg, h,
            positions=positions, mode=mode,
            cache=None if cache is None else tf.layer_slice(cache, layer),
            window=windows[layer],
            project=_projector(clm.plans[layer], use_kernel),
            mlp_fn=_mlp_fn(clm.plans[layer], cfg, use_kernel))
        caches.append(c_new)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h, tf.stack_caches(caches)


# --------------------------------------------------------------------- #
# the compiled LM object
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class CompiledLM:
    """A transformer mapped onto the fabric (see module docstring).

    ``params`` is the dense parameter tree (glue: embeddings, norms,
    biases, the tied LM head) and ``plans`` the per-layer programmed
    tile plans, all on ``device``. ``prefill``/``decode`` mirror
    ``models.model.prefill``/``decode_step`` exactly — same signatures,
    same cache — with the block matmuls running the mapped tile-grid
    path. ``decode_per_slot`` is always on (a CompiledLM exists to
    serve; lockstep callers pass per-lane positions). ``nets`` are the
    per-linear net tuples :attr:`chip` maps and routes on first access."""
    params: Any
    plans: Tuple[Dict[str, StreamLayer], ...]
    cfg: Any
    system: str
    geom: CoreGeometry
    tokens_per_second: float
    nets: Tuple[Tuple[int, Tuple[int, int]], ...]
    device: torch.device

    @functools.cached_property
    def chip(self) -> CompiledChip:
        """The analytic cost compile (map → route over the per-layer
        linears) — what ``deployment_report`` prices the tenant by.
        Built on first access (see the module docstring: R8)."""
        return compile_chip(self.nets, system=self.system, geom=self.geom,
                            items_per_second=self.tokens_per_second,
                            validate_rate=False, device=self.device)

    @property
    def d_model(self) -> int:
        return self.cfg.d_model

    @property
    def latent(self) -> bool:
        """An MLA/MoE model (``LatentMoEStack``)."""
        return tf.get_stack(self.cfg) is tf.LatentMoEStack

    def init_cache(self, batch: int, cache_len: int,
                   dtype: torch.dtype = torch.bfloat16):
        """The serving cache (``dtype``: its float type; bf16 rounds
        what the exact f32 path computes)."""
        return model_lib.init_cache(self.cfg, batch, cache_len, dtype,
                                    device=self.device)

    def prefill(self, tokens, *, use_kernel: bool = True, routes=None):
        """tokens (B, S) int → (last-token logits (B, padded_vocab),
        cache). ``routes`` (a latent model's): a list that gets each MoE
        layer's chosen expert ids (B·S, top_k) appended."""
        toks = torch.as_tensor(tokens, device=self.device).long()
        if toks.dim() == 1:
            toks = toks[None, :]
        batch = {"tokens": toks}
        if self.latent:
            h, cache = _latent_forward(self, batch, "prefill", None,
                                       use_kernel, routes=routes)
        else:
            h, cache = _lm_forward(self, batch, "prefill", None, use_kernel)
        logits = model_lib._head(self.cfg, self.params,
                                 h[:, -1:, :])[:, 0, :]
        return logits, cache

    def decode(self, cache, tokens, pos, *, use_kernel: bool = True,
               routes=None):
        """tokens (B, 1) int, pos (B,) per-slot positions →
        (logits (B, padded_vocab), new_cache); ``cache`` is left as it
        was, except a latent (MLA) cache, which is written in place
        and returned. Positions held on the host (numpy, a list, a CPU
        tensor) bound the latent slots read to the highest. ``routes``
        as :meth:`prefill`'s."""
        batch = {"tokens": tokens, "pos": pos}
        if self.latent:
            kv_len = None
            if not torch.is_tensor(pos) or pos.device.type == "cpu":
                kv_len = int(np.max(np.asarray(pos))) + 1
                kv_len = -(-kv_len // KV_LEN_STEP) * KV_LEN_STEP
            h, new_cache = _latent_forward(self, batch, "decode", cache,
                                           use_kernel, kv_len, routes)
        else:
            h, new_cache = _lm_forward(self, batch, "decode", cache,
                                       use_kernel)
        logits = model_lib._head(self.cfg, self.params, h)[:, 0, :]
        return logits, new_cache

    def report(self):
        return self.chip.report()


# --------------------------------------------------------------------- #
# the compile
# --------------------------------------------------------------------- #
def _params_on(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _params_on(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def compile_lm(model, *, system: str = "memristor", geometry=None,
               tokens_per_second: float = 0.0, seed: int = 0,
               device_model: DeviceModel = DEFAULT_DEVICE,
               device: DeviceLike = None) -> CompiledLM:
    """Map a dense transformer onto the fabric, on ``device`` (default
    ``cuda``; ``"cpu"`` must be asked for).

    ``model`` is a :class:`repro_torch.configs.ModelConfig` (parameters
    are seeded deterministically from ``seed``:
    :func:`repro_torch.models.model.init_params`) or a
    :class:`TransformerParams` carrying trained weights. ``geometry``
    pins the tile geometry as a ``(rows, cols)`` pair or
    :class:`CoreGeometry` (None → the system's paper optimum);
    ``tokens_per_second`` is the tenant SLO the analytic cost chip is
    replica-sized against (validated at deploy scope, like every other
    tenant's rate). ``device_model`` is the memristor device the
    encoding uses (the reference's ``device=``).

    The config's compute dtype is forced to float32 and
    ``decode_per_slot`` to True — the serving contract (see
    :class:`CompiledLM`). Dense blocks and latent-attention MoE blocks
    (``attention="mla"``, sigmoid-routed held experts: the module
    docstring) are mapped; other families raise: softmax-routed
    capacity MoE, the hybrid's and xLSTM's state scans.
    """
    if isinstance(model, TransformerParams):
        cfg, params = model.cfg, model.params
    elif hasattr(model, "family") and hasattr(model, "num_layers"):
        cfg, params = model, None
    else:
        raise TypeError(
            f"compile_lm takes a ModelConfig or TransformerParams "
            f"(got {type(model).__name__}); MLPs/net tuples belong to "
            f"repro_torch.chip.compile_chip")
    latent = cfg.family == "moe" and cfg.attention == "mla"
    if cfg.family != "dense" and not latent:
        raise NotImplementedError(
            f"compile_lm maps dense transformer blocks and latent-"
            f"attention (MLA) MoE blocks only; family {cfg.family!r} "
            f"(softmax capacity routing and the ssm/hybrid state scans "
            f"have no mapping here)")
    if latent:
        tf.LatentMoEStack.check(cfg)
    system = normalize_system(system, context="compile_lm")
    dev = resolve_device(device)
    cfg = cfg.replace(compute_dtype="float32", decode_per_slot=True)
    if params is None:
        params = model_lib.init_params(cfg, seed, device=dev)
    else:
        params = _params_on(params, dev)
    if geometry is None:
        geom = _default_geom(system)
    elif isinstance(geometry, CoreGeometry):
        geom = geometry
    else:
        geom = CoreGeometry(*geometry)

    plans = []
    nets = []
    for layer in range(cfg.num_layers):
        if latent:
            linears = _latent_linears(
                cfg, *tf.LatentMoEStack.layer(params["stack"], cfg, layer))
        else:
            linears = _block_linears(
                cfg, tf.layer_slice(params["stack"], layer))
        layer_plans = {}
        for name, w in linears.items():
            w = w.to(torch.float32)
            groups = 1 if w.dim() == 2 else w.shape[0]
            if groups > 1:
                lp = program_grouped(w, geom=geom, device_model=device_model)
            else:
                lp = program_layer(w, geom=geom, device_model=device_model,
                                   quantize=False)
            layer_plans[name] = _layer_plan(
                lp, torch.zeros((w.shape[-1],), dtype=torch.float32,
                                device=dev), "linear", device_model,
                groups=groups)
            nets.extend([(1, (int(w.shape[-2]), int(w.shape[-1])))] *
                        groups)
        plans.append(layer_plans)

    clm = CompiledLM(params=params, plans=tuple(plans), cfg=cfg,
                     system=system, geom=geom,
                     tokens_per_second=float(tokens_per_second),
                     nets=tuple(nets), device=dev)
    tel = _obs_current()
    if tel.active:
        tel.metrics.counter("lm.compiles").inc()
    return clm
