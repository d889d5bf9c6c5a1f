"""repro_torch.deploy — declarative multi-app deployment over one fabric
(port of ``repro.deploy``).

The paper's processor serves five sensor applications from one
core/fabric design (Tables II–VI); this package is that multi-tenancy
as an API. Declare WHAT runs — apps, systems, SLOs, lane budgets, one
fabric topology — and ``deploy`` wires compile → fleet → router:

  from repro_torch.deploy import AppSpec, DeploymentSpec, deploy

  d = deploy(DeploymentSpec(
      apps=(AppSpec("deep", "deep", system="1t1m"),
            AppSpec("ocr", "ocr", system="1t1m", lanes_per_chip=2)),
      n_chips=4))
  y = d.stream("deep", x)              # == the shard_chip path, bit for bit
  d.submit("ocr", items); d.run_until_drained()
  d.serve({"deep": src_a, "ocr": src_b})   # sensor-fed closed loop
  print(d.stats())                     # per-app rows + exact fleet roll-up
  print(d.report())                    # multi-app Tables II–VI composition
  d.reprogram("deep", new_params)      # live weight swap, NO recompile
  d.close()

Runs on the card (``device="cpu"`` must be asked for) and streams
through the kernels by default (``use_kernel=True``).

Self-check:  PYTHONPATH=src python -m repro_torch.deploy --selftest
(``--device cpu``, ``--chips N``).

Submodule imports are lazy (PEP 562), as in the reference.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "AppSpec": "repro_torch.deploy.spec",
    "DeploymentSpec": "repro_torch.deploy.spec",
    "single_app": "repro_torch.deploy.spec",
    "Deployment": "repro_torch.deploy.deployment",
    "deploy": "repro_torch.deploy.deployment",
    "MultiAppRouter": "repro_torch.deploy.router",
    "DistributedMultiAppRouter": "repro_torch.deploy.router",
    "DeploymentStats": "repro_torch.deploy.router",
    "DeploymentReport": "repro_torch.deploy.report",
    "deployment_report": "repro_torch.deploy.report",
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
