"""Quantization-aware training — the paper's ex-situ training pipeline.

Port of ``repro.optim.qat``. The deployed chip holds 8-bit
differential-pair weights and 8-bit (DAC) or 1-bit (threshold)
activations; ex-situ training therefore trains *through* those
constraints with straight-through estimators, so the programmed
network matches the trained one (§III.D, Fig. 12):

  qat_params   — fake-quantize every matrix leaf of a param tree
  qat_loss_fn  — wrap any loss so its forward sees quantized weights
  mlp_loss     — the trainer's softmax cross-entropy
  train_mlp    — the small-MLP QAT trainer of the Fig. 12 sweep and the
                 examples, with variation-aware training (``noise=``)
  accuracy     — classification accuracy in any Fig. 12 mode, or on a
                 compiled chip

The reference's docstring names a ``precision_sweep`` that it does not
define (the sweep lives in ``benchmarks/fig12_bitwidth.py``); none is
ported. The trainer's forward is plain PyTorch, differentiated by
autograd, as the reference differentiates its plain ``jnp`` forward:
the kernels serve the deployed chip, not training.

Random streams: the initial weights and the variation-aware lognormal
draws come from CPU ``torch.Generator``s seeded through the port's
splitmix64 mix (``stream_seed``), moved to the training device, so a
run is the same on the CPU and on the card. The reference's
``jax.random`` draws cannot be replayed; a parity test hands the
reference's initial weights across with ``params=``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.core import quantization as q
from repro_torch.pytree import flatten_with_path, tree_map
from repro_torch.runtime import DeviceLike, resolve_device
from repro_torch.variability.noise import stream_seed

# purpose separators of the trainer's draws in the stream mix
_FOLD_INIT = 0x9A71
_FOLD_NOISE = 0x9A72


def qat_params(params, bits: int = 8) -> Any:
    """Fake-quantize every >=2-D leaf (matrices/embeddings); biases and
    norms stay float — they fold into the DAC/LUT scales on chip."""
    def fq(p):
        return q.fake_quant(p, bits=bits, per_column=True) \
            if p.dim() >= 2 else p
    return tree_map(fq, params)


def qat_loss_fn(loss_fn: Callable, bits: int = 8) -> Callable:
    def wrapped(params, *args, **kw):
        return loss_fn(qat_params(params, bits), *args, **kw)
    return wrapped


def mlp_loss(params, xb: torch.Tensor, yb: torch.Tensor, spec,
             weight_bits: int, act_bits: int, mode: str) -> torch.Tensor:
    """The trainer's loss: mean softmax cross-entropy of
    ``mlp_apply(mode=)`` logits against integer labels (the reference's
    closure inside ``train_mlp``, in its arithmetic order)."""
    from repro_torch.core.crossbar_layer import mlp_apply

    logits = mlp_apply(params, xb, spec, weight_bits=weight_bits,
                       act_bits=act_bits, mode=mode)
    onehot = torch.nn.functional.one_hot(yb.to(torch.int64),
                                         spec.dims[-1]).to(logits.dtype)
    return torch.mean(torch.sum(torch.log_softmax(logits, dim=-1) * -onehot,
                                dim=-1))


def _lognormal_perturb(params, sigma: float, noise_seed: int, step: int):
    """Each >=2-D leaf times a fresh mean-one lognormal multiplier of
    ``sigma`` (straight-through in the leaf: the draw is a constant),
    drawn for (noise_seed, step, leaf index in tree order)."""
    flat = flatten_with_path(params)
    out = []
    for i, (_, p) in enumerate(flat):
        if p.dim() >= 2:
            gen = torch.Generator().manual_seed(
                stream_seed(noise_seed, _FOLD_NOISE, step, i))
            z = torch.randn(p.shape, generator=gen).to(p.device)
            p = p * torch.exp(sigma * z - 0.5 * sigma * sigma)
        out.append(p)
    it = iter(out)
    return tree_map(lambda _: next(it), params)


def _initial_params(spec, seed: int, params, dev: torch.device):
    from repro_torch.core.crossbar_layer import mlp_init

    if params is None:
        gen = torch.Generator().manual_seed(stream_seed(seed, _FOLD_INIT))
        return mlp_init(spec, generator=gen, device=dev)
    return [{k: (p[k] if isinstance(p[k], torch.Tensor) else
                 torch.from_numpy(np.array(p[k], np.float32)))
             .detach().to(device=dev, dtype=torch.float32).clone()
             for k in ("w", "b")} for p in params]


def train_mlp(x, y, dims, *, activation: str, weight_bits: int,
              act_bits: int, steps: int = 300, lr: float = 0.05,
              seed: int = 0, noise=None, noise_seed: int = 0,
              params=None, device: DeviceLike = None) -> Dict[str, Any]:
    """Small-MLP QAT trainer (plain SGD on the softmax cross-entropy,
    batches of ``min(128, n)`` walked through the data as the
    reference's). Float path when ``weight_bits >= 32``.

    ``params`` (``[{"w", "b"}]``, tensors or arrays) starts from given
    weights instead of the seeded ``mlp_init`` draw; ``device`` is where
    training runs (default ``cuda``; ``"cpu"`` must be asked for).

    ``noise`` (a ``repro_torch.variability.NoiseModel``) enables
    variation-aware training (Hasan & Taha arXiv:1603.07400): each
    step's forward sees the weights through a fresh mean-one lognormal
    multiplier of the model's ``program_sigma`` (straight-through, like
    fake-quant), drawn from ``noise_seed``. A None or σ = 0 model leaves
    the computation byte for byte as without one: the perturbation is
    skipped in the structure, not multiplied by one."""
    from repro_torch.core.crossbar_layer import MLPSpec

    dev = resolve_device(device)
    spec = MLPSpec(tuple(dims), activation=activation,
                   out_activation="linear")
    params = _initial_params(spec, seed, params, dev)
    mode = "float" if weight_bits >= 32 else "qat"
    sigma = 0.0 if noise is None else float(noise.program_sigma)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    y = torch.as_tensor(y).to(device=dev, dtype=torch.int64)

    n = x.shape[0]
    bs = min(128, n)
    for i in range(steps):
        lo = (i * bs) % max(n - bs, 1)
        leaves = [p[k].requires_grad_(True) for p in params
                  for k in ("w", "b")]
        seen = _lognormal_perturb(params, sigma, noise_seed, i) \
            if sigma > 0.0 else params
        grads = torch.autograd.grad(
            mlp_loss(seen, x[lo:lo + bs], y[lo:lo + bs], spec, weight_bits,
                     act_bits, mode), leaves)
        with torch.no_grad():
            it = iter(grads)
            params = [{k: p[k].detach() - lr * next(it) for k in ("w", "b")}
                      for p in params]
    return {"params": params, "spec": spec}


@torch.no_grad()
def accuracy(params, spec, x, y, *, mode: str, weight_bits: int = 8,
             act_bits: int = 8, programmed=None, chip=None) -> float:
    """Classification accuracy in any Fig. 12 mode, on the device the
    weights (or the chip) live on.

    For the deployed modes ("crossbar"/"digital") pass ``chip`` (a
    ``repro_torch.chip.CompiledChip`` from compile_chip — the unified
    API) or ``programmed`` (a bare ProgrammedMLP) to evaluate
    already-programmed state; with neither, the network is programmed
    once through the memo so repeated accuracy() calls never re-encode
    the weights."""
    if chip is not None:
        dev = chip.device
        logits = chip.stream(torch.as_tensor(x, dtype=torch.float32)
                             .to(dev))
    else:
        from repro_torch.core.crossbar_layer import mlp_apply
        dev = params[0]["w"].device
        logits = mlp_apply(params,
                           torch.as_tensor(x, dtype=torch.float32).to(dev),
                           spec, weight_bits=weight_bits,
                           act_bits=act_bits, mode=mode,
                           programmed=programmed)
    y = torch.as_tensor(y).to(logits.device)
    return float(torch.mean((torch.argmax(logits, -1) == y)
                            .to(torch.float32)))
