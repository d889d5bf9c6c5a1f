"""The system under test for the chip configurations.

``repro_torch.chip.compile_chip`` maps, routes and programs the net onto
the configuration's cores (ideal devices, ``weight_bits``-bit weights,
one replica) on the card, once; the call each batch takes is
``CompiledChip.stream``: the handover, the mapped stream pipeline, the
kernel wrappers and K1 (memristor) or K2 (digital).
"""
from __future__ import annotations


def build(config: dict, params, device):
    """The programmed chip's stream call for ``params``
    (``[{"w", "b"}]`` f32 tensors on ``device``)."""
    from repro_torch.chip import compile_chip
    from repro_torch.core.crossbar_layer import MLPSpec
    from repro_torch.core.neural_core import CoreGeometry

    spec = MLPSpec(tuple(config["dims"]), activation=config["activation"],
                   out_activation=config["out_activation"])
    chip = compile_chip(spec, params=params, system=config["system"],
                        geom=CoreGeometry(int(config["core_rows"]),
                                          int(config["core_cols"])),
                        weight_bits=int(config["weight_bits"]),
                        device=device)
    return chip.stream
