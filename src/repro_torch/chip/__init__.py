"""The unified chip API, ported: compile → program → stream as one
object, on the card.

  chip = compile_chip(spec, params=..., system="memristor")
  y = chip.stream(x)          # the mapped dataflow, programmed once
  rep = chip.report()         # area / power / throughput (Tables II–VI)
  eng = chip.serve(slots=4)   # slot-scheduled streaming engine
  chip = reprogram_chip(chip, new_params)   # weights only, no compile

See :mod:`repro_torch.chip.compile` for the design notes.
Self-check:  PYTHONPATH=src python -m repro_torch.chip --selftest
"""
from repro_torch.chip.compile import (ChipRateWarning, CompiledChip,
                                      StreamLayer, compile_app,
                                      compile_chip, compile_count,
                                      program_plan, reprogram_chip,
                                      stream_pipeline, validate_stream_rate)
from repro_torch.chip.report import ChipReport, chip_report
from repro_torch.chip.serving import (ChipEngine, ChipRequest,
                                      ChipRequestState)

__all__ = ["ChipRateWarning", "ChipReport", "CompiledChip", "StreamLayer",
           "chip_report", "compile_app", "compile_chip", "compile_count",
           "program_plan", "reprogram_chip", "stream_pipeline",
           "validate_stream_rate",
           "ChipEngine", "ChipRequest", "ChipRequestState"]
