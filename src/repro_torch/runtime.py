"""Where the port's tensors live.

Every entry point resolves its ``device`` argument here: ``None``
means the card (``cuda``), ``"cpu"`` must be asked for, and a request
for ``cuda`` on a machine without one raises rather than falling back.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; ``"cpu"``/``"cuda[:i]"`` as given. Raises
    if CUDA is asked for (or defaulted to) and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on cuda or cpu, not "
                         f"{dev.type!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is visible; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU")
    return dev
