"""chip.serve(): slot-scheduled streaming over a compiled chip.

Port of ``repro.chip.serving``. A fixed pool of lanes, each active lane
feeding the chip ONE item per engine step (the paper's fixed-rate
streaming discipline, §V.C), all lanes evaluated in a single
``chip.stream`` batch on the chip's device. The batching/backfill/
latency logic lives in
:class:`repro_torch.serving.engine.ItemStreamScheduler`; this module
only binds it to one ``CompiledChip``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.serving.engine import (ItemRequest, ItemRequestState,
                                        ItemStreamScheduler)

# historic names, re-exported through repro_torch.chip
ChipRequest = ItemRequest
ChipRequestState = ItemRequestState


class ChipEngine(ItemStreamScheduler):
    """StreamingEngine over a :class:`repro_torch.chip.CompiledChip`.

    Streams through the chip's kernels by default (``use_kernel``), on
    the device the chip was compiled for."""

    def __init__(self, chip, *, slots: int = 4, use_kernel: bool = True,
                 queue_limit=None):
        if chip.plan is None:
            raise ValueError("chip.serve() needs a streamable chip "
                             "(compiled with weights); this one is "
                             "analytic-only")
        super().__init__(chip.dims[0], slots=slots,
                         queue_limit=queue_limit)
        self.chip = chip
        self.use_kernel = use_kernel

    def _stream_batch(self, batch: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(batch).to(self.chip.device)
        out = self.chip.stream(x, use_kernel=self.use_kernel)
        return out.cpu().numpy()
