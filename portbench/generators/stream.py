"""The general generator of closed-loop stream mixes.

One caller hands ``batch`` sensor windows (``sensor.Windows``) a call
to the system under test, back to back, each call as soon as the last
returned. The inputs are ``distinct_batches`` consecutive batches of the
seed's window stream, made in set-up and cycled:

* ``handover: "device"`` — a pool resident on the card. Calls are
  dispatched ahead and the outputs stay on the card; the window ends in
  ``torch.cuda.synchronize()``.
* ``handover: "host"`` — a ring of page-locked host buffers, as a DMA
  frame grabber fills them. Each call's outputs are brought to host
  memory before the next call; each batch is timed on the host clock
  from the call that hands it over to its outputs in host memory.

The outputs of a uniform sample of ``max_keep`` calls, drawn from the
seed, and of the last call are kept for the correctness check, copied
into buffers made in set-up (page-locked for the host handover, as are
the buffers the other outputs land in), so the window allocates nothing
more than the program does.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import List, Optional, Tuple

import torch

from portbench import sensor

# purpose separator of the kept-output draw in the stream mix
_FOLD_KEEP = 0x6B33


@dataclasses.dataclass
class Window:
    calls: int
    items: int
    seconds: float
    latencies: List[float]          # host handover: seconds a batch
    kept: List[Tuple[int, torch.Tensor]]   # (batch index, output)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Traffic:
    """One run's stream traffic for a net of ``config["dims"]``: the
    inputs, warm-up, the timed window. ``batch`` overrides the mix's
    batch size (the CPU tests)."""

    def __init__(self, mix: dict, seed: int, device, config: dict,
                 batch: Optional[int] = None):
        d_in, d_out = int(config["dims"][0]), int(config["dims"][-1])
        self.device = torch.device(device)
        self.batch = int(batch if batch is not None else mix["batch"])
        self.n = int(mix["distinct_batches"])
        self.handover = mix["handover"]
        if self.handover not in ("device", "host"):
            raise ValueError(f"unknown handover {self.handover!r}")
        if (mix["loop"], mix["callers"]) != ("closed", 1):
            raise ValueError("the stream generator drives one caller in a "
                             "closed loop")
        self.max_keep = int(mix["max_keep"])
        self.warmup_calls = int(mix["warmup_calls"])
        self.d_out = d_out
        self.seed = seed
        wins = sensor.Windows(seed, mix["source"], self.device)
        if wins.d_item != d_in:
            raise ValueError(f"mix items have {wins.d_item} features, the "
                             f"configuration takes {d_in}")
        made = [wins.items(k * self.batch, self.batch)
                for k in range(self.n)]
        pin = self.device.type == "cuda"
        out_shape = (self.max_keep + 1, self.batch, d_out)
        if self.handover == "device":
            self.inputs = made
            self.keep_buf = torch.empty(out_shape, dtype=torch.float32,
                                        device=self.device)
        else:
            self.inputs = [torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=pin).copy_(t)
                           for t in made]
            self.outputs = torch.empty((self.n, self.batch, d_out),
                                       dtype=torch.float32, pin_memory=pin)
            self.keep_buf = torch.empty(out_shape, dtype=torch.float32,
                                        pin_memory=pin)
        _sync(self.device)

    def reference_inputs(self) -> dict:
        """Batch index → the same input on the device, for the check."""
        return {k: x.to(self.device) for k, x in enumerate(self.inputs)}

    def _handover(self, y, dst):
        """The outputs in host memory: copied into ``dst``, page-locked,
        or as they are if they are not the outputs asked for."""
        if tuple(y.shape) == tuple(dst.shape) and y.dtype == dst.dtype:
            return dst.copy_(y)
        return y.cpu()

    def warm(self, call) -> None:
        for i in range(self.warmup_calls):
            y = call(self.inputs[i % self.n])
            if self.handover == "host":
                self._handover(y, self.outputs[i % self.n])
        _sync(self.device)

    def enqueue_bursts(self, call, bursts: int = 5, calls: int = 16
                       ) -> Optional[List[float]]:
        """Host seconds a call while the card drains what is queued:
        ``bursts`` runs of ``calls`` calls from a drained card, each
        timed whole. None for the host handover, whose calls are not
        dispatched ahead."""
        if self.handover != "device":
            return None
        out = []
        for _ in range(bursts):
            _sync(self.device)
            t0 = time.perf_counter()
            for i in range(calls):
                call(self.inputs[i % self.n])
            out.append((time.perf_counter() - t0) / calls)
        _sync(self.device)
        return out

    def window(self, call, seconds: float) -> Window:
        """The timed window. The outputs of ``max_keep`` calls, a
        uniform sample of the window's calls drawn from the seed
        (reservoir sampling), and of the last call are kept; outputs of
        the wrong shape or type are kept as they came."""
        rng = random.Random(sensor.stream_seed(self.seed, _FOLD_KEEP))
        k = self.max_keep
        host = self.handover == "host"
        buf = self.keep_buf
        slot_of: List[Optional[int]] = [None] * k   # batch index a slot holds
        odd: List[Tuple[int, torch.Tensor]] = []
        lat: List[float] = []
        inputs, n = self.inputs, self.n
        _sync(self.device)
        t0 = time.perf_counter()
        i = 0
        while True:
            idx = i % n
            j = i if i < k else rng.randrange(i + 1)
            slot = buf[j] if j < k else None
            if host:
                ts = time.perf_counter()
                y = self._handover(call(inputs[idx]), self.outputs[idx]
                                   if slot is None else slot)
                now = time.perf_counter()
                lat.append(now - ts)
            else:
                y = call(inputs[idx])
                now = time.perf_counter()
                if slot is not None:
                    y = self._keep_on_card(y, slot)
            if slot is not None:
                slot_of[j] = idx if y is slot else None
                if y is not slot and len(odd) < k:
                    odd.append((idx, y))
            i += 1
            if now - t0 >= seconds:
                break
        if j >= k:
            if not host:
                y = self._keep_on_card(y, buf[k])
            odd.append((idx, y))
        _sync(self.device)
        t1 = time.perf_counter()
        kept = [(b, buf[s]) for s, b in enumerate(slot_of) if b is not None]
        return Window(i, i * self.batch, t1 - t0, lat, kept + odd)

    @staticmethod
    def _keep_on_card(y, slot):
        if tuple(y.shape) == tuple(slot.shape) and y.dtype == slot.dtype:
            return slot.copy_(y)
        return y
