"""Roofline terms of one step, and the collectives it issues.

Port of ``repro.launch.roofline``. The terms, per device:

  T_compute    = FLOPs_per_device / PEAK_FLOPS
  T_memory     = bytes_per_device / HBM_BW
  T_collective = wire_bytes_per_device / LINK_BW

The hardware constants are an NVIDIA H100 SXM5's spec-sheet figures
(dense, no sparsity), not measurements; the reference's are a TPU
v5e's. ``PEAK_F32``, ``PEAK_TF32`` and ``PEAK_INT8`` are the rates
``chip_smoke.py`` bounds its kernels with.

The reference parses the collectives out of XLA's optimized HLO text.
The port has no HLO: :class:`CollectiveCounter` is a dispatch mode that
sees every collective a step issues on this rank — the functional
collectives DTensor issues (``_c10d_functional.all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_reduce``, ``all_to_all_single``) and
the process group's own (``c10d.allreduce_``, ``broadcast_``,
``allgather_``, ``send``) — and charges each by the reference's ring
model, ``g`` being the op's group size:

  all-gather          out * (g-1)/g
  reduce-scatter      out * (g-1)          (operand = out * g)
  all-reduce          2 * size * (g-1)/g
  all-to-all          size * (g-1)/g
  collective-permute  size                 (a point-to-point send)
  broadcast           size * (g-1)/g       (no reference op: the
                                            reference's pipeline sums a
                                            one-hot all-reduce instead)

A receive is not charged: its bytes are the sender's. The counter sees
each rank's own tensors (a DTensor's local shards), so its sums are per
device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

PEAK_FLOPS = 989.4e12    # bf16 dense tensor-core FLOP/s (H100 SXM5 sheet)
HBM_BW = 3.35e12         # HBM3 B/s (sheet)
LINK_BW = 450e9          # NVLink 4 B/s, per direction (sheet)
PEAK_TF32 = 494.7e12     # TF32 dense tensor-core FLOP/s (sheet)
PEAK_INT8 = 1979e12      # int8 dense tensor-core OP/s (sheet)
PEAK_F32 = 67e12         # IEEE f32 on the CUDA cores (sheet)

# torch op name → (the reference's op name, how its size is read)
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_to_all_single": "all-to-all",
}
_C10D = {
    "allreduce_": "all-reduce",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_allgather_base_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast",
    "send": "collective-permute",
}


@dataclass
class CollectiveStats:
    wire_bytes: float = 0.0
    raw_bytes: float = 0.0
    by_op: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    def add(self, opname: str, size: float, g: int) -> None:
        """Charge one collective whose result is ``size`` bytes on a
        group of ``g`` ranks."""
        if opname == "all-gather":
            wire = size * (g - 1) / max(g, 1)
        elif opname == "reduce-scatter":
            wire = size * (g - 1)
        elif opname == "all-reduce":
            wire = 2.0 * size * (g - 1) / max(g, 1)
        elif opname in ("all-to-all", "broadcast"):
            wire = size * (g - 1) / max(g, 1)
        else:  # collective-permute
            wire = float(size)
        self.wire_bytes += wire
        self.raw_bytes += size
        self.by_op[opname] = self.by_op.get(opname, 0.0) + wire
        self.counts[opname] = self.counts.get(opname, 0) + 1


def _nbytes(x) -> int:
    import torch

    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _group_size(args) -> int:
    import torch
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, torch.ScriptObject):
            return torch.distributed.ProcessGroup.unbox(a).size()
    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


def _mode_class():
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Counter(TorchDispatchMode):
        def __init__(self, stats: CollectiveStats):
            super().__init__()
            self.stats = stats

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented   # count its local collectives
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            ns = func.namespace
            name = func._overloadpacket.__name__
            table = {"_c10d_functional": _FUNCTIONAL, "c10d": _C10D}.get(ns)
            if table and name in table:
                op = table[name]
                # the result's bytes (the reference reads the result
                # shape); the in-place ops' results are their inputs
                size = _nbytes(out if ns == "_c10d_functional"
                               else args[0])
                if op == "reduce-scatter" and ns == "c10d":
                    size = _nbytes(args[0])
                self.stats.add(op, size, _group_size(args))
            return out

    return _Counter


class CollectiveCounter:
    """``with CollectiveCounter() as c: ...`` → ``c.stats``, the
    :class:`CollectiveStats` of every collective this rank issued in
    the block (per device; works under ``FakeTensorMode`` and the
    ``"fake"`` process group, where nothing is sent)."""

    def __init__(self):
        self.stats = CollectiveStats()
        self._mode = None

    def __enter__(self):
        self._mode = _mode_class()(self.stats)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        mode, self._mode = self._mode, None
        return mode.__exit__(*exc)


def device_flop_counter():
    """A ``torch.utils.flop_counter.FlopCounterMode`` that counts each
    rank's own work: an op on DTensors is left to DTensor, and the
    products it runs on the local shards are the ones counted (the
    stock mode counts a DTensor op at its global shape). An op without
    a FLOP formula runs as it is, where the stock mode decomposes it to
    look for products inside (on ``meta`` tensors some decompositions
    view strided inputs they cannot); the products a step runs (``mm``,
    ``bmm``, ``addmm``, ``baddbmm``) have formulas."""
    from torch.distributed.tensor import DTensor
    from torch.utils import flop_counter as fc
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Mode(TorchDispatchMode):
        def __init__(self, counter):
            super().__init__()
            self.counter = counter

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            return self.counter._count_flops(func._overloadpacket, out,
                                             args, kwargs)

    class DeviceFlopCounter(fc.FlopCounterMode):
        def __enter__(self):
            self.flop_counts.clear()
            self.mod_tracker.__enter__()
            self.mode = _Mode(self)
            self.mode.__enter__()
            return self

    return DeviceFlopCounter(display=False)


def terms(flops_per_dev: float, bytes_per_dev: float,
          wire_bytes_per_dev: float) -> Dict[str, float]:
    t = {
        "t_compute_s": flops_per_dev / PEAK_FLOPS,
        "t_memory_s": bytes_per_dev / HBM_BW,
        "t_collective_s": wire_bytes_per_dev / LINK_BW,
    }
    dom = max(("compute", "memory", "collective"),
              key=lambda k: t[f"t_{k}_s"])
    t["dominant"] = dom
    t["bound_s"] = max(t["t_compute_s"], t["t_memory_s"],
                       t["t_collective_s"])
    return t


def analytic_memory_bytes(cfg, shape_cfg, *, n_devices: int,
                          dp: int, tp: int, accum: int = 1) -> float:
    """First-principles per-device HBM traffic for one step, the
    reference's model unchanged:

      train:   params: grad write + AdamW m/v read+write + param
               read+write (f32)  → 24 B/param (+2 B bf16 cast read)
               activations: with full remat only layer-boundary
               checkpoints cross HBM → 3 × tokens·d_model·2B per layer
               logits: tokens × padded_vocab × 2B × (write + read)
      prefill: params read (2 B) + checkpoints write + logits last-step
      decode:  params read + KV-cache read (whole cache) + write (one
               slot) + small activations

    Everything is divided across the mesh the way the rule table shards
    it: params over dp (FSDP) × tp (TP), tokens over dp, cache over tp.
    MoE charges the active experts only.
    """
    P = cfg.param_count(active_only=True)
    P_total = cfg.param_count(active_only=False)
    L = max(cfg.num_layers, 1)
    tokens = shape_cfg.global_batch * (1 if shape_cfg.kind == "decode"
                                       else shape_cfg.seq_len)
    tokens_dev = tokens / max(dp, 1)
    d = max(cfg.d_model, 1)
    vocab = max(cfg.padded_vocab, 1)

    if shape_cfg.kind == "train":
        p_dev = P_total / n_devices
        param_bytes = p_dev * (4 + 4      # param read + write (f32)
                               + 8 + 8    # m, v read + write
                               + 4        # grad (f32) write+read amortized
                               + 2)       # bf16 compute-cast read
        ckpt = 3.0 * tokens_dev * d * 2 * L
        logits = 2.0 * tokens_dev * (vocab / tp) * 2 * 2
        # weights stream from HBM once per microbatch fwd + twice bwd
        weight_stream = 3.0 * accum * (P / n_devices) * 2
        return param_bytes + ckpt + logits + weight_stream
    if shape_cfg.kind == "prefill":
        p_dev = P / n_devices
        ckpt = 1.0 * tokens_dev * d * 2 * L
        logits = 2.0 * (shape_cfg.global_batch / dp) * (vocab / tp) * 2
        return p_dev * 2 + ckpt + logits
    # decode: one token per sequence; params + cache dominate
    p_dev = P / max(tp, 1)          # weights TP-sharded, read every step
    kh = max(cfg.num_kv_heads * cfg.kv_repeat, 1)
    # bf16 cache: 2 B/elem; int8 cache: 1 B + f32 scale per dh row
    kv_b = 2.0 if cfg.kv_cache_dtype != "int8" else \
        1.0 + 4.0 / max(cfg.head_dim, 1)
    cache = (shape_cfg.global_batch / max(dp, 1)) * \
        (shape_cfg.seq_len / max(tp, 1)) * kh * max(cfg.head_dim, 1) \
        * kv_b * 2 * L
    if cfg.family in ("ssm", "hybrid"):
        # recurrent state instead of (most of) the KV cache
        state = (shape_cfg.global_batch / max(dp, 1)) * cfg.d_inner * \
            max(cfg.ssm_state, 1) * 4 * 2 * L
        cache = state if cfg.family == "ssm" else state + cache / max(
            cfg.shared_attn_every, 1)
    logits = (shape_cfg.global_batch / dp) * (vocab / tp) * 2 * 2
    return p_dev * 2 + cache + logits


def model_flops(cfg, shape_cfg) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (fwd-only steps)."""
    from repro_torch.models.model import count_nonembedding_params
    n = count_nonembedding_params(cfg, active_only=True)
    if shape_cfg.kind == "train":
        d = shape_cfg.global_batch * shape_cfg.seq_len
        return 6.0 * n * d
    if shape_cfg.kind == "prefill":
        d = shape_cfg.global_batch * shape_cfg.seq_len
        return 2.0 * n * d
    d = shape_cfg.global_batch * 1  # decode: one token per sequence
    return 2.0 * n * d
