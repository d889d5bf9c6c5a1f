"""What every kernel wrapper does around a launch: check its operands,
check the launch's CUDA error, and count the launch.

A wrapper adds one to its :class:`LaunchCounter` where it launches its
CUDA kernel, and nowhere else (the plain versions that CPU tensors take
are not counted), so a run can show that it went through the kernels.
``kernels.ops`` collects the counters.
"""
from __future__ import annotations

from typing import Sequence

import torch


class LaunchCounter:
    """A plain integer count of one kernel's launches."""
    __slots__ = ("name", "count")

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def add(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


def check_operand(kernel: str, name: str, t: torch.Tensor, shape,
                  dtypes: Sequence[torch.dtype]) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``shape`` and
    one of ``dtypes``."""
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: {name} must be a CUDA tensor, got "
                         f"{t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{kernel}: {name} has dtype {t.dtype}, expected "
                         f"one of {tuple(dtypes)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def check_same_device(kernel: str, *tensors) -> None:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: operands on several devices "
                         f"{sorted(map(str, devices))}")


def check_launch(kernel: str, err: int) -> None:
    """Raise if a launch returned a CUDA error (cudaError_t ≠ 0): a
    refused launch never runs, and a later synchronize would not say."""
    if err != 0:
        raise RuntimeError(f"repro_torch: {kernel} kernel launch failed "
                           f"with cudaError_t {err}")
