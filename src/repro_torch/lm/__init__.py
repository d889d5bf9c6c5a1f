"""repro_torch.lm — language-model tenants on the crossbar fabric (port
of ``repro.lm``).

:func:`compile_lm` maps a dense transformer's per-layer linears, or a
latent-attention MoE model's (Moonlight-16B-A3B:
``configs.moonlight_16b_a3b``), onto programmed tile grids (the same
program pipeline as the sensor apps; attention, rotary, routing and
cache glue stay plain tensor code), and
:class:`LMMember` serves the result as an ordinary ``deploy()`` tenant —
one decode step per lane through the same keyed scheduler, per-app
stats and Tables II–VI cost rows composing like any sensor app:

  from repro_torch.configs import qwen1p5_0p5b
  from repro_torch.deploy import AppSpec, deploy

  d = deploy(AppSpec("lm", qwen1p5_0p5b.reduced_serving(),
                     cache_len=64, lanes_per_chip=2))
  d.submit_tokens("lm", prompt, max_new_tokens=16)
  d.run_until_drained()
  print(d.generated_tokens("lm"))      # == the dense serving.Engine's

Runs on the card (``device="cpu"`` must be asked for); every block
linear goes through the crossbar kernel there.

Self-check:  PYTHONPATH=src python -m repro_torch.lm --selftest
(``--device cpu``, ``--chips N``).

Submodule imports are lazy (PEP 562), as in the reference.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "CompiledLM": "repro_torch.lm.compile",
    "LM_LINEARS": "repro_torch.lm.compile",
    "TransformerParams": "repro_torch.lm.compile",
    "compile_lm": "repro_torch.lm.compile",
    "DEFAULT_CACHE_LEN": "repro_torch.lm.serving",
    "LMMember": "repro_torch.lm.serving",
    "LMRequest": "repro_torch.lm.serving",
    "lm_request": "repro_torch.lm.serving",
    "tokens_from_state": "repro_torch.lm.serving",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
