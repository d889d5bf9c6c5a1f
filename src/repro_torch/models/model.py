"""Public model API: init / forward / prefill / decode_step / loss.

Port of ``repro.models.model``. The same batch-dict conventions
(global shapes):

  train:   {"tokens": (B, S) int, "labels": (B, S) int} or
           {"embeds": (B, S, d), "labels": (B, S)}
  prefill: {"tokens": (B, S) int} or {"embeds": (B, S, d)} → cache
  decode:  {"tokens": (B, 1) int, "pos": () or (B,) int, cache}

and the same parameter and cache layouts: a stacked leading layer axis,
wq (L, d, H, dh), wo (L, H, dh, d), cache (L, B, T, KH, dh); the hybrid
and xLSTM stacks' group axes (``transformer``). Every function here
runs on the device its parameters live on.

Weights: :func:`init_params` draws each leaf from a ``torch.Generator``
of the target device, seeded by the splitmix64 mix of (seed, leaf,
layer) — deterministic for a seed and a device type (a CPU and a CUDA
init of one seed differ). On the ``meta`` device it gives every leaf's
shape and dtype and allocates nothing (``launch.specs``, the analogue
of ``jax.eval_shape``). The reference's threefry draws cannot be
replayed; :func:`params_from_numpy` carries its parameter tree across
instead.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.models import transformer as tf
from repro_torch.models.layers import (cdtype, cross_entropy, dense_init,
                                       embed_init, embed_tokens, lm_logits,
                                       pdtype, rms_norm)
from repro_torch.models.xlstm import slstm_ff_width
from repro_torch.runtime import DeviceLike, resolve_device
from repro_torch.sharding import shard
from repro_torch.variability.noise import stream_seed

Params = Dict[str, Any]

# generator purposes: the embedding table, the block stack, the head
_EMBED, _STACK, _HEAD = 0, 1, 2


def _device_of(params: Params) -> torch.device:
    return params["final_norm"].device


# --------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------- #
def _target(device: DeviceLike) -> torch.device:
    """``resolve_device``, or ``meta`` for shapes without storage."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def init_params(cfg, seed: int = 0, *, device: DeviceLike = None) -> Params:
    """Seeded parameters on ``device`` (default ``cuda``)."""
    dev = _target(device)
    gen_dev = "cpu" if dev.type == "meta" else dev

    def gen(*words) -> torch.Generator:
        return torch.Generator(device=gen_dev).manual_seed(
            stream_seed(seed, *words))

    dt = pdtype(cfg)
    stack = tf.get_stack(cfg)
    p: Params = {
        "embed": {"table": embed_init(gen(_EMBED), (cfg.padded_vocab,
                                                    cfg.d_model), dt,
                                      device=dev)},
        "stack": stack.init(lambda layer, leaf: gen(_STACK, layer, leaf),
                            cfg, dev),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": dense_init(gen(_HEAD), (cfg.d_model,
                                                     cfg.padded_vocab), dt,
                                        device=dev)}
    return p


def param_specs(cfg) -> Params:
    """Each parameter leaf's logical axis names, in the parameters'
    structure (``repro_torch.sharding`` maps them onto a mesh)."""
    stack = tf.get_stack(cfg)
    s: Params = {
        "embed": {"table": ("vocab", "embed")},
        "stack": _with_stack_lead(cfg, stack.specs(cfg)),
        "final_norm": (None,),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = {"w": ("embed", "vocab")}
    return s


def _with_stack_lead(cfg, specs):
    """Stack specs get a leading (layer) axis of None; hybrid/xlstm
    specs already encode their own leading axes except the group axis
    (and the hybrid's shared block, which is not stacked)."""
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        return tf.lead_specs(specs)
    if cfg.family == "hybrid":
        return {"groups": tf.lead_specs(specs["groups"]),
                "shared": specs["shared"]}
    if cfg.family == "ssm":
        return {"groups": tf.lead_specs(specs["groups"])}
    raise ValueError(cfg.family)


def params_from_numpy(cfg, tree, *, device: DeviceLike = None) -> Params:
    """The reference's parameter tree, of any family (numpy arrays, or
    anything ``np.asarray`` takes, under the same keys) → the port's, in
    ``cfg.param_dtype`` on ``device`` (default ``cuda``). The layouts are
    the same, so this is the identity on shapes; the parity tests use it,
    the serving path does not."""
    dev = resolve_device(device)
    dt = pdtype(cfg)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        a = np.asarray(x, np.float32)
        return torch.tensor(a, device=dev).to(dt)

    out = conv(dict(tree))
    missing = {"embed", "stack", "final_norm"} - set(out)
    if missing:
        raise ValueError(f"params_from_numpy: not a transformer parameter "
                         f"tree (missing {sorted(missing)})")
    return out


# --------------------------------------------------------------------- #
# forward paths
# --------------------------------------------------------------------- #
def _tokens(tokens, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=device).long()


def _embed_in(cfg, params, batch, dtype: torch.dtype) -> torch.Tensor:
    dev = _device_of(params)
    if "embeds" in batch:
        h = torch.as_tensor(batch["embeds"], device=dev).to(dtype)
    else:
        h = embed_tokens(params["embed"]["table"],
                         _tokens(batch["tokens"], dev), dtype)
    if cfg.scale_embed:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype)
    return shard(h, "batch", "seq", None)


def _head(cfg, params, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = params["embed"]["table"].T
    else:
        w = params["lm_head"]["w"]
    return lm_logits(h, w, cfg.final_softcap)


def positions_for(cfg, batch, B: int, S: int, mode: str,
                  device: torch.device) -> torch.Tensor:
    """(B, S) int32 token positions: per-lane (``decode_per_slot``) or
    one shared position for a decode, 0..S-1 otherwise."""
    if mode == "decode":
        pos = torch.as_tensor(batch["pos"], device=device).to(torch.int32)
        if cfg.decode_per_slot:
            return pos.reshape(B, 1)
        return pos.reshape(1, 1).expand(B, S)
    return torch.arange(S, dtype=torch.int32, device=device)[None, :] \
        .expand(B, S)


def forward(cfg, params, batch, mode: str = "train",
            cache=None) -> Tuple[torch.Tensor, Any, Dict]:
    """Returns (hidden, cache, aux). Hidden is post-norm."""
    dtype = cdtype(cfg)
    h = _embed_in(cfg, params, batch, dtype)
    B, S = h.shape[0], h.shape[1]
    positions = positions_for(cfg, batch, B, S, mode, h.device)
    stack = tf.get_stack(cfg)
    h, new_cache, aux = stack.apply(params["stack"], cfg, h,
                                    positions=positions, mode=mode,
                                    cache=cache)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h, new_cache, aux


def loss_fn(cfg, params, batch) -> Tuple[torch.Tensor, Dict]:
    """Training loss: cross-entropy of the head's logits against
    ``batch["labels"]`` (labels < 0 masked out), plus
    ``router_aux_weight`` × the router's auxiliary loss where the stack
    reports one (MoE: ``moe_aux`` and ``moe_drop`` in the metrics, both
    summed over the layers). Returns (loss, metrics)."""
    h, _, aux = forward(cfg, params, batch, mode="train")
    logits = _head(cfg, params, h)
    loss, acc = cross_entropy(logits, torch.as_tensor(batch["labels"]),
                              cfg.vocab_size)
    metrics = {"loss": loss, "accuracy": acc}
    if aux and "aux_loss" in aux:
        metrics["moe_aux"] = aux["aux_loss"]
        metrics["moe_drop"] = aux.get("drop_frac",
                                      torch.zeros((), device=loss.device))
        loss = loss + cfg.router_aux_weight * aux["aux_loss"]
    metrics["total_loss"] = loss
    return loss, metrics


def prefill(cfg, params, batch) -> Tuple[torch.Tensor, Any]:
    """Returns (last-token logits (B, padded_vocab) f32, cache)."""
    h, cache, _ = forward(cfg, params, batch, mode="prefill")
    logits = _head(cfg, params, h[:, -1:, :])[:, 0, :]
    return logits, cache


def decode_step(cfg, params, cache, tokens, pos) -> Tuple[torch.Tensor, Any]:
    """tokens: (B, 1); pos: scalar (position being written), or (B,)
    per-slot positions when cfg.decode_per_slot is set. The given cache
    is left as it was; the updated one is returned."""
    batch = {"tokens": tokens, "pos": pos}
    h, new_cache, _ = forward(cfg, params, batch, mode="decode", cache=cache)
    logits = _head(cfg, params, h)[:, 0, :]
    return logits, new_cache


def init_cache(cfg, batch: int, cache_len: int,
               dtype: torch.dtype = torch.bfloat16, *,
               device: DeviceLike = None):
    return tf.get_stack(cfg).init_cache(cfg, batch, cache_len, dtype,
                                        _target(device))


def cache_specs(cfg):
    return tf.get_stack(cfg).cache_specs(cfg)


def cache_axes(cfg):
    """Each cache leaf's (lane axis, ring axis or None), for the serving
    engine's lane surgery (``serving.kvcache``)."""
    return tf.get_stack(cfg).cache_axes(cfg)


# --------------------------------------------------------------------- #
# parameter counting (analytic)
# --------------------------------------------------------------------- #
def _block_params(cfg) -> int:
    """One attention + MLP (or MoE) block's parameters."""
    d, H, KH, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    block = d * H * dh + 2 * d * KH * dh + H * dh * d + 2 * d
    if cfg.family == "moe":
        E, f = cfg.num_experts, cfg.d_ff
        block += d * E + 3 * E * d * f
        block += 3 * d * f * cfg.num_shared_experts
    else:
        block += 3 * d * cfg.d_ff
    if cfg.qkv_bias:
        block += H * dh + 2 * KH * dh
    if cfg.post_block_norm:
        block += 2 * d
    return block


def _latent_params(cfg, active_only: bool) -> int:
    """The latent MoE stack's layers: MLA in each, then the dense FFN or
    the router, its bias, the held experts (the ``top_k`` a token visits
    with ``active_only``) and the shared experts."""
    d, H = cfg.d_model, cfg.num_heads
    r, rope = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    nope, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    att = (d * H * (nope + rope) + d * (r + rope) + r + r * H * (nope + dv)
           + H * dv * d + 2 * d)
    nd = cfg.first_k_dense
    experts = cfg.top_k if active_only else cfg.local_experts
    moe = (d * cfg.num_experts + cfg.num_experts
           + 3 * d * cfg.d_ff * (experts + cfg.num_shared_experts))
    return (cfg.num_layers * att + nd * 3 * d * cfg.dense_d_ff
            + (cfg.num_layers - nd) * moe)


def params_from_layers(cfg, ref: Dict, *,
                       device: DeviceLike = None) -> Params:
    """A latent MoE model's parameters in the published per-layer layout
    (what ``reference_moonlight.make_params`` draws: ``embed`` (V, d),
    ``lm_head`` (d, V), ``final_norm``, and a list ``layers`` of
    ``input_norm``, ``post_norm``, ``q_proj`` (d, H·(nope + rope)),
    ``kv_a_proj`` (d, r + rope), ``kv_norm``, ``kv_b_proj`` (r,
    H·(nope + v)), ``o_proj`` (H·v, d) and ``mlp`` {w1, w3, w2} or
    ``moe`` {gate, gate_bias, w1, w3, w2 (held, ...), shared}) → this
    package's tree (:class:`transformer.LatentMoEStack`), copied onto
    ``device`` in ``cfg.param_dtype``."""
    dev = resolve_device(device)
    dt = pdtype(cfg)
    d, H = cfg.d_model, cfg.num_heads
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim

    def t(x):
        return torch.as_tensor(x).to(device=dev, dtype=dt)

    def block(lay):
        p = {"attn": {"wq": t(lay["q_proj"]).reshape(d, H, nope + rope),
                      "wkv_a": t(lay["kv_a_proj"]),
                      "kv_norm": t(lay["kv_norm"]),
                      "wkv_b": t(lay["kv_b_proj"]).reshape(
                          cfg.kv_lora_rank, H, -1),
                      "wo": t(lay["o_proj"]).reshape(H, cfg.v_head_dim, d)},
             "attn_norm": t(lay["input_norm"]),
             "mlp_norm": t(lay["post_norm"])}
        if "moe" in lay:
            m = lay["moe"]
            p["mlp"] = {"router": t(m["gate"]),
                        "router_bias": t(m["gate_bias"]),
                        "w1": t(m["w1"]), "w3": t(m["w3"]), "w2": t(m["w2"]),
                        "shared": {k: t(v) for k, v in m["shared"].items()}}
        else:
            p["mlp"] = {k: t(v) for k, v in lay["mlp"].items()}
        return p

    layers = [block(lay) for lay in ref["layers"]]
    nd = cfg.first_k_dense
    kinds = [("moe" in lay) for lay in ref["layers"]]
    if len(layers) != cfg.num_layers or kinds != [
            i >= nd for i in range(len(kinds))]:
        raise ValueError(f"params_from_layers: {len(layers)} layers do not "
                         f"match {cfg.num_layers} with {nd} dense first")
    stack = {}
    if nd:
        stack["dense"] = tf._stack_trees(layers[:nd])
    if cfg.num_layers > nd:
        stack["moe"] = tf._stack_trees(layers[nd:])
    return {"embed": {"table": t(ref["embed"])}, "stack": stack,
            "final_norm": t(ref["final_norm"]),
            "lm_head": {"w": t(ref["lm_head"])}}


def _mamba_params(cfg) -> int:
    """One Mamba2 block's parameters and its pre-norm."""
    d, d_in, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    gn, W = cfg.ssm_ngroups * cfg.ssm_state, cfg.conv_width
    return (2 * d * d_in + 2 * d * gn + d * H + (W + 1) * (d_in + 2 * gn)
            + 3 * H + d_in + d_in * d + d)


def _xlstm_group_params(cfg) -> int:
    """One xLSTM group's parameters: its mLSTMs and its sLSTM."""
    d, W = cfg.d_model, cfg.conv_width
    dm, Hl = int(cfg.mlstm_proj_factor * d), cfg.num_lstm_heads
    mlstm = (d + 2 * d * dm + (W + 1) * dm + 3 * dm * dm + 2 * (dm * Hl + Hl)
             + 2 * dm + dm * d)
    f, dh = slstm_ff_width(cfg), d // Hl
    slstm = d + 4 * d * d + 4 * Hl * dh * dh + 4 * d + 2 * d + 2 * d * f
    return (cfg.slstm_period - 1) * mlstm + slstm


def count_params(cfg, active_only: bool = False) -> int:
    """The leaves :func:`init_params` would make, counted from the
    config for every family (the reference counts an ``eval_shape`` of
    its init; the totals are equal). ``active_only`` counts, of each MoE
    layer's experts, only the ``top_k`` a token visits (the shared
    experts and the router stay counted), as the reference does."""
    stack = tf.get_stack(cfg)
    d = cfg.d_model
    if stack is tf.HybridStack:
        trunk = cfg.num_layers * _mamba_params(cfg) + _block_params(cfg)
    elif stack is tf.XLSTMStack:
        trunk = cfg.num_layers // cfg.slstm_period * _xlstm_group_params(cfg)
    elif stack is tf.LatentMoEStack:
        trunk = _latent_params(cfg, active_only)
    else:
        trunk = cfg.num_layers * _block_params(cfg)
    total = cfg.padded_vocab * d + trunk + d
    if not cfg.tie_embeddings:
        total += d * cfg.padded_vocab
    if active_only and cfg.num_experts and stack is not tf.LatentMoEStack:
        per_expert = 3 * cfg.d_model * cfg.d_ff
        total -= cfg.num_layers * (cfg.num_experts - cfg.top_k) * per_expert
    return int(total)


def count_nonembedding_params(cfg, active_only: bool = False) -> int:
    n = count_params(cfg, active_only)
    n -= cfg.padded_vocab * cfg.d_model  # input table (lookup, not matmul)
    return int(n)
