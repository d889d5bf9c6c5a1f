"""Logical-axis -> mesh-axis rule tables, per (config, mesh, mode).

Port of ``repro.launch.rules``, line for line: pure Python over the
config and the mesh's axis sizes. This is the single place where the
parallelism strategy is decided:

  DP    batch        -> (pod, data)
  FSDP  embed        -> data            (weight d_model dims)
  TP    heads/ff/vocab/exp -> model
  SP    seq          -> model           (activations at block boundaries)
  EP    exp          -> model
  decode: KV-cache sequence dim -> model (cache too big for head-parallel)

Rules degrade gracefully: a dim not divisible by its axis degree is
left unsharded (None), except ``"ff"``, ``"lstm_dh"`` and ``"cap"``,
which the reference shards without a check (a DTensor shards such a
dim unevenly, the last shards shorter; the reduced configs' widths
divide by 2 and 4).
``mesh`` is anything :func:`repro_torch.launch.mesh.mesh_axis_sizes`
reads: a ``DeviceMesh`` or a ``MeshShape`` stand-in.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

from repro_torch.launch import mesh as mesh_lib


def kv_repeat_for(cfg, tp: int) -> int:
    """Smallest replication r with (KH*r) % tp == 0, capped at q_per_kv."""
    if cfg.num_kv_heads == 0:
        return 1
    r = tp // math.gcd(cfg.num_kv_heads, tp)
    if r > cfg.q_per_kv or cfg.num_heads % tp != 0:
        r = 1 if cfg.num_kv_heads % tp == 0 else cfg.q_per_kv
    return max(r, 1)


def effective_dp(cfg, mesh) -> int:
    """DP degree including the model axis when TP is off."""
    dp = mesh_lib.dp_degree(mesh)
    if not cfg.tp_shard:
        dp *= mesh_lib.tp_degree(mesh)
    return dp


def make_rules(cfg, mesh, mode: str, *, global_batch: int) -> Dict:
    sizes = mesh_lib.mesh_axis_sizes(mesh)
    tp = sizes.get("model", 1)
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    if not cfg.tp_shard and "model" in sizes:
        # TP off -> the model axis joins data parallelism; otherwise the
        # dense compute would be replicated tp-fold
        dp_axes = dp_axes + ("model",)
    dp = 1
    for a in dp_axes:
        dp *= sizes.get(a, 1)
    KH_eff = cfg.num_kv_heads * cfg.kv_repeat

    def div(n, axis="model"):
        return n > 0 and n % sizes.get(axis, 1) == 0

    tp_on = cfg.tp_shard
    rules: Dict[str, Optional[object]] = {
        "batch": (dp_axes if len(dp_axes) > 1 else dp_axes[0])
        if global_batch % max(dp, 1) == 0 and global_batch >= dp else None,
        "embed": "data" if div(cfg.d_model, "data") else None,
        "heads": "model" if tp_on and div(cfg.num_heads) else None,
        "kv_heads": "model" if tp_on and div(cfg.num_kv_heads) else None,
        "ff": "model" if tp_on else None,
        "vocab": "model" if (tp_on and div(cfg.padded_vocab)) else None,
        "exp": "model" if tp_on and div(cfg.num_experts) else None,
        "cap": "data",
        "ssm_heads": "model" if tp_on and div(cfg.ssm_heads) else None,
        "lstm_dh": "model" if tp_on else None,
        "cchunk": None,  # chunk axis of chunked recurrences (opt-in)
    }
    if mode in ("train", "prefill"):
        rules["seq"] = "model" if (cfg.seq_shard and tp_on) else None
        rules["act_kv"] = "model" if (tp_on and div(KH_eff)) else None
        rules["act_kvseq"] = None
    else:  # decode
        rules["seq"] = None
        rules["act_kv"] = None
        rules["act_kvseq"] = "model"
        # decode keeps weights resident when they fit: FSDP would
        # re-gather the full weight set every emitted token. Models
        # whose TP-sharded weights exceed the memory budget stay
        # FSDP-sharded and pay the gather.
        p_bytes_tp = 2.0 * cfg.param_count(active_only=False) / max(tp, 1)
        if p_bytes_tp < 12e9:
            rules["embed"] = None
    return rules
