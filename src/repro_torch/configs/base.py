"""Model / run configuration dataclasses.

Port of ``repro.configs.base``: the same fields, defaults and derived
properties. Every ported architecture gets one module in this package
exposing ``CONFIG`` (the exact published geometry) and ``reduced()`` (a
tiny same-family config for CPU tests); the registry in ``__init__``
maps ``--arch <id>`` strings to them. ``ModelConfig.param_count`` is
analytic (the reference counts an ``eval_shape`` of its init).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    # trunk geometry
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    attn_softcap: float = 0.0          # gemma2 attention-logit softcap
    final_softcap: float = 0.0         # gemma2 final-logit softcap
    sliding_window: int = 0            # 0 = full attention
    local_global: bool = False         # gemma2 alternating local/global layers
    post_block_norm: bool = False      # gemma2 post-norms
    attn_scale: float = 0.0            # 0 -> 1/sqrt(head_dim)
    # KV heads replicated to this factor so KH*kv_repeat divides the TP
    # degree (MaxText-style). Set by the launcher per mesh; 1 on CPU.
    kv_repeat: int = 1
    # MoE
    num_experts: int = 0
    top_k: int = 0
    # local-dispatch groups (GShard's G axis): tokens are routed within
    # groups that align with the DP shards, so dispatch gather + combine
    # scatter never cross devices (Perf cell B). 0 = single global group.
    moe_groups: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # SSM (Mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    conv_width: int = 4
    # hybrid (zamba-style): shared transformer block applied every N ssm blocks
    shared_attn_every: int = 0
    # xLSTM: one sLSTM block per `slstm_period` blocks, rest mLSTM
    slstm_period: int = 0
    mlstm_proj_factor: float = 2.0
    slstm_ff_factor: float = 4.0 / 3.0
    num_lstm_heads: int = 4
    # decode: per-slot positions (continuous-batching serving). Off for
    # the lockstep dry-run/benchmark decode path.
    decode_per_slot: bool = False
    # sequence-parallel activations at block boundaries (train/prefill).
    # For small d_model the per-layer seq re-gathers cost more ICI than
    # TP all-reduces save - Perf cell A measures this.
    seq_shard: bool = True
    # tensor-parallel sharding of dense/attention/expert weights. For
    # sub-1B models TP=16 trades cheap FLOPs for expensive per-layer
    # activation all-reduces; False leaves weights DP-replicated
    # (vocab/embedding sharding is separate and stays on).
    tp_shard: bool = True
    # KV-cache dtype for serving: bfloat16 | int8 (quantize-on-write,
    # Perf cell C: the paper's 8-bit ex-situ theme applied to decode)
    kv_cache_dtype: str = "bfloat16"
    # misc
    act: str = "silu"                  # silu | gelu
    scale_embed: bool = False          # gemma-style sqrt(d_model) embed scale
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    frontend: str = "none"             # none | vision | audio  (stubbed per spec)
    # numerics / distribution knobs (per-arch defaults; overridable)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"                # full | dots | none
    grad_accum: int = 1                # microbatches per train step
    scan_layers: bool = True

    # ------------------------------------------------------------------ #
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up for even TP sharding (MaxText-style)."""
        return _round_up(self.vocab_size, 512) if self.vocab_size else 0

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def local_experts(self) -> int:
        """The routed experts this device holds and computes."""
        return self.held_experts or self.num_experts

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (for MODEL_FLOPS = 6·N·D roofline term) ----- #
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count of the trunk (embeddings included).

        ``active_only`` counts only the experts a token actually visits
        (top_k + shared) — the N in MoE MODEL_FLOPS.
        """
        from repro_torch.models import model as _model  # lazy; no cycle
        return _model.count_params(self, active_only=active_only)


@dataclass(frozen=True)
class LatentMoEConfig(ModelConfig):
    """A DeepSeek-V3 style model (Moonlight-16B-A3B): latent attention,
    leading dense layers, sigmoid-routed experts of which this device
    may hold a share. The reference package has no such config."""
    # the router's scoring: "softmax" (top-k of a softmax, capacity
    # dispatch with drops) or "sigmoid_bias" (DeepSeek-V3's noaux_tc:
    # top-k of sigmoid scores plus a correction bias that counts in the
    # choice only; the chosen scores normalised and times
    # ``routed_scaling``; no drops)
    router: str = "softmax"
    routed_scaling: float = 1.0
    # expert parallelism: this device holds ``held_experts`` of the
    # ``num_experts`` routed experts (0 = all), those of rank
    # ``expert_rank`` (experts rank·held … rank·held + held − 1)
    held_experts: int = 0
    expert_rank: int = 0
    # leading dense layers of an MoE stack (DeepSeek's
    # first_k_dense_replace) and their FFN width
    first_k_dense: int = 0
    dense_d_ff: int = 0
    # attention kind: "gqa", or "mla" (DeepSeek's latent attention:
    # K and V through a kv_lora_rank latent, a shared RoPE key of
    # qk_rope_head_dim; q projected whole, q_lora_rank null)
    attention: str = "gqa"
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0


# Every config reads what LatentMoEConfig adds at its defaults, which
# change nothing: class attributes of the base, not fields (the base's
# fields stay the reference package's).
for _f in dataclasses.fields(LatentMoEConfig):
    if _f.name not in ModelConfig.__dataclass_fields__:
        setattr(ModelConfig, _f.name, _f.default)
del _f


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Is this (arch, shape) cell lowered, or a documented skip?"""
    if shape.name == "long_500k":
        subquadratic = cfg.family in ("ssm", "hybrid")
        if not subquadratic:
            return False, (
                "long_500k skipped: full-attention architecture; 512k decode "
                "requires sub-quadratic attention (see DESIGN.md §4)"
            )
    return True, ""
