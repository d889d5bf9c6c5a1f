"""Ex-situ programming: feedback write of the 1T1M crossbar (paper §III.D).

Port of ``repro.core.programming``. Off-chip training produces target
conductances; programming then sets each device by a *feedback write*
loop, because device-to-device variation means identical pulses do not
produce identical ΔR:

  repeat:  read device (1T1M isolates it — Fig. 9, no sneak paths)
           if |g − g*| ≤ tol: done
           apply a write pulse toward g*; the realized Δg is the nominal
           step × a lognormal device response factor

A single shared ADC per core serializes device programming (§III.D);
the model therefore also reports *programming time* per core =
Σ pulses × (t_read + t_pulse) — the deploy-once cost the paper accepts.

The reference runs the loop as a ``jax.lax.while_loop`` over the whole
tile. Here it is a plain loop over tensors on the target's device: each
iteration computes the loop condition on the device and masks its own
update with it, and the host reads the condition back only every
``CHECK_EVERY`` iterations, so the result is the reference's loop's
(up to the random streams) without one host sync per pulse.

Random draws come from a ``torch.Generator``: a ``jax.random`` key's
threefry streams cannot be reproduced, so parity with the reference is
checked on the arithmetic (``programming_noise_from``) with the
reference's own draws handed across.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.core.device import DEFAULT_DEVICE, DeviceModel

T_READ_S = 100e-9       # 1T1M read through the shared ADC (§III.D)
T_PULSE_S = 1e-9        # one programming pulse
CHECK_EVERY = 16        # pulses between host reads of the loop condition


@dataclasses.dataclass(frozen=True)
class ProgrammingConfig:
    tol_frac: float = 1.0 / 256.0   # target: within half an 8-bit LSB
    pulses_per_range: int = 512     # nominal full-range pulse count
    max_pulses: int = 4096          # per-device feedback-write budget
    device_model: DeviceModel = DEFAULT_DEVICE


class ProgrammingResult(NamedTuple):
    g: torch.Tensor            # programmed conductances
    pulses: torch.Tensor       # per-device pulse counts (int32)
    error: torch.Tensor        # |g - target| / g_range
    converged: torch.Tensor    # per-device bool


def _normal(generator: torch.Generator, shape: Sequence[int],
            device: torch.device) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator,
                       device=generator.device).to(device)


def feedback_write(target: torch.Tensor, generator: torch.Generator,
                   cfg: ProgrammingConfig = ProgrammingConfig()
                   ) -> ProgrammingResult:
    """Program a tile of devices to ``target`` conductances."""
    dev = cfg.device_model
    tol = cfg.tol_frac * dev.g_range
    step = dev.g_range / cfg.pulses_per_range
    derate = math.exp(-2.0 * dev.write_sigma)
    g = torch.full_like(target, dev.g_off)        # devices start erased
    pulses = torch.zeros(target.shape, dtype=torch.int32,
                         device=target.device)
    for n in range(cfg.max_pulses):
        # the reference's loop condition, as a device tensor
        running = torch.any(torch.abs(g - target) > tol)
        if n % CHECK_EVERY == 0 and not bool(running):
            break
        # read with ADC-referred noise; pulse while outside *half* the
        # tolerance so read noise cannot park a device just outside the
        # convergence band (standard feedback-write deadband)
        read = g + dev.read_sigma * dev.g_range * \
            _normal(generator, g.shape, g.device)
        err = target - read
        need = (torch.abs(err) > 0.5 * tol) & running
        # mean-normalized lognormal response: identical pulses,
        # different ΔR (§III.D)
        resp = torch.exp(dev.write_sigma *
                         _normal(generator, g.shape, g.device)
                         - 0.5 * dev.write_sigma ** 2)
        # error-proportional, variance-derated pulse amplitude (Alibart
        # et al. [20]): variation costs *pulses*, never convergence
        amp = torch.clamp(torch.abs(err), step / 8.0, step) * derate
        g = torch.where(need, dev.clip(g + torch.sign(err) * amp * resp),
                        g)
        pulses += need.to(torch.int32)
    err = torch.abs(g - target) / dev.g_range
    return ProgrammingResult(g, pulses, err, err <= cfg.tol_frac)


def program_pair(gp_target: torch.Tensor, gn_target: torch.Tensor,
                 generator: torch.Generator,
                 cfg: ProgrammingConfig = ProgrammingConfig()
                 ) -> Tuple[ProgrammingResult, ProgrammingResult]:
    """Both devices of each differential pair, σ⁺ first, from one
    generator."""
    return feedback_write(gp_target, generator, cfg), \
        feedback_write(gn_target, generator, cfg)


def programming_time_s(pulses: torch.Tensor) -> torch.Tensor:
    """Serialized by the single shared per-core ADC (§III.D)."""
    return torch.sum(pulses) * (T_READ_S + T_PULSE_S)


def programming_noise_from(u: torch.Tensor,
                           cfg: ProgrammingConfig = ProgrammingConfig()
                           ) -> torch.Tensor:
    """The residual for uniform draws ``u`` in [-1, 1): ±tol."""
    return u * cfg.tol_frac * cfg.device_model.g_range


def programming_noise(generator: torch.Generator, shape: Tuple[int, ...],
                      cfg: ProgrammingConfig = ProgrammingConfig()
                      ) -> torch.Tensor:
    """Cheap surrogate for studies that only need the *residual* error:
    uniform within ±tol (the feedback loop guarantees the bound). Drawn
    on the generator's device."""
    u = torch.rand(tuple(shape), generator=generator,
                   device=generator.device) * 2.0 - 1.0
    return programming_noise_from(u, cfg)
