"""The paper's primary contribution, ported: memristor/SRAM cores — the
device and crossbar models, program/evaluate of crossbar and SRAM
layers, the §IV.C mapping compiler and the static mesh router.

Import the modules directly (``repro_torch.core.crossbar_layer``,
``repro_torch.core.mapping``, ...)."""
