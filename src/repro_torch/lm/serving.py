"""Decode-as-streaming: the LM tenant as an ordinary router member.

Port of ``repro.lm.serving``. One decode step IS one streamed item. An
:class:`LMRequest` rides the SAME
:class:`repro_torch.serving.KeyedItemStreamScheduler` lane block that
serves sensor frames — its ``items`` placeholder is
``(max_new_tokens, 1)``, so the scheduler's per-item accounting
(items/requests/rejections, latency reservoirs, per-app stats rows that
sum exactly to the fleet roll-up) counts TOKENS with no new
bookkeeping. The router's member hooks bind the lane lifecycle to the
KV cache:

  admit   → B = 1 prefill of the prompt, ``kvcache.write_slot`` into the
            lane, first greedy token staged
  step    → emit the staged token, then ONE batched ``CompiledLM.decode``
            over every lane at its own position (inactive lanes decode
            junk that ring-position masking ignores and the next admit
            overwrites — the same discipline as ``serving.Engine``)
  release → ``kvcache.clear_slot``

Re-admission after an eviction (elastic resize / requeue) re-prefills
prompt + already-emitted tokens: greedy decoding is deterministic, so
the continuation picks up exactly where the evicted lane stopped, and
nothing is re-emitted (the scheduler's ``pos`` survives the trip).

Token telemetry rides the ``repro_torch.obs`` registry: ``lm.tokens``
(counter, one per live lane per step), ``lm.prefill_tokens`` and a
per-token ``lm.decode_latency_s`` histogram.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs.core import current as _obs_current
from repro_torch.serving import kvcache
from repro_torch.serving.engine import ItemRequest

DEFAULT_CACHE_LEN = 128


@dataclasses.dataclass
class LMRequest(ItemRequest):
    """An :class:`ItemRequest` that carries a token prompt. ``items``
    is a ``(max_new_tokens, 1)`` placeholder — row count = tokens to
    generate; the streamed "outputs" are the generated token ids."""
    prompt: Tuple[int, ...] = ()


def lm_request(prompt, max_new_tokens: int = 16, *, uid: int = 0,
               key=None) -> LMRequest:
    """Build an LM decode request (the router stamps ``uid``/``key``
    on submission paths that own them)."""
    prompt = tuple(int(t) for t in prompt)
    if not prompt:
        raise ValueError("lm_request: empty prompt")
    if max_new_tokens < 1:
        raise ValueError("lm_request: max_new_tokens must be >= 1")
    return LMRequest(uid=uid,
                     items=np.zeros((int(max_new_tokens), 1), np.float32),
                     key=key, prompt=prompt)


def tokens_from_state(st) -> List[int]:
    """Generated token ids of a (finished or in-flight) lane state."""
    return [int(round(float(o[0]))) for o in st.outputs]


class LMMember:
    """One LM tenant on the shared multi-app router.

    Quacks like a fleet member (``d_in``/``stream_host``/``n_chips``)
    plus the admit/release hooks :class:`repro_torch.deploy.MultiAppRouter`
    drives; deliberately does NOT expose ``.chip`` — the analytic cost
    compile lives on ``clm.chip`` (built lazily), and the router's
    "analytic-only tenants cannot stream" check must not mistake this
    member for one. Decode is one batched call over all lanes on the
    ``CompiledLM``'s device, its linears through the crossbar kernel
    when ``use_kernel`` (the router's default). ``mesh`` is the chip
    mesh the tenant is counted on (no state depends on it).
    ``cache_dtype`` is the cache's float type (bf16 by default; an
    exact f32 model states f32). After a step, ``logits`` holds its
    (lanes, padded_vocab) logits on the device; the step's ids reach
    the host in a page-locked buffer. ``route_log`` (a latent MoE
    model) keeps, on the device, each lane's chosen experts for every
    position it holds: ``routes`` (lanes, cache_len, MoE layers,
    top_k) int16, written by the prefill and by each step, for a
    checker that compares the routing itself.
    """

    d_in = 1                    # one token id per streamed item
    is_lm = True
    is_distributed = False

    def __init__(self, clm, *, lanes: int,
                 cache_len: int = DEFAULT_CACHE_LEN, n_chips: int = 1,
                 mesh=None, cache_dtype: torch.dtype = torch.bfloat16,
                 route_log: bool = False):
        if lanes < 1:
            raise ValueError("LMMember: needs lanes >= 1")
        if cache_len < 2:
            raise ValueError("LMMember: cache_len must be >= 2")
        self.clm = clm
        self.cfg = clm.cfg
        self.cache_len = int(cache_len)
        self.lanes = int(lanes)
        self.n_chips = int(n_chips)
        self.n_local_chips = int(n_chips)
        self.mesh = mesh
        self.cache_dtype = cache_dtype
        if route_log and not getattr(clm, "latent", False):
            raise ValueError("LMMember: route_log needs a latent MoE model")
        self.route_log = route_log
        self.prefill_tokens = 0
        self.decode_steps = 0
        self.logits: Optional[torch.Tensor] = None
        self._alloc(self.lanes)

    def _alloc(self, lanes: int) -> None:
        self.cache = self.clm.init_cache(lanes, self.cache_len,
                                         self.cache_dtype)
        self._next_tok = np.zeros((lanes,), np.int32)
        self._pos = np.zeros((lanes,), np.int32)
        self._live: set = set()
        self._ids = torch.empty((lanes,), dtype=torch.int64,
                                pin_memory=self.clm.device.type == "cuda")
        self.routes = None
        if self.route_log:
            cfg = self.cfg
            self.routes = torch.zeros(
                (lanes, self.cache_len, cfg.num_layers - cfg.first_k_dense,
                 cfg.top_k), dtype=torch.int16, device=self.clm.device)

    # ---------------- lane lifecycle hooks -------------------------- #
    def on_admit(self, lane: int, st) -> None:
        """Fresh admission AND re-admission after eviction: prefill
        prompt + already-emitted tokens, write the lane's KV slot,
        stage the next greedy token."""
        req = st.request
        prompt = tuple(getattr(req, "prompt", ()) or ())
        if not prompt:
            raise ValueError(
                f"request {req.uid}: an LM lane needs a token prompt — "
                "build requests with repro_torch.lm.lm_request (or "
                "Deployment.submit_tokens)")
        context = list(prompt) + tokens_from_state(st)
        if len(context) > self.cache_len:
            # ring-cache resume: only the last cache_len tokens fit the
            # lane; positions restart, so this is the documented lossy
            # fallback (deployments size cache_len >= prompt +
            # max_new_tokens)
            context = context[-self.cache_len:]
        routes = [] if self.route_log else None
        logits, one_cache = self.clm.prefill([context], routes=routes)
        kvcache.write_slot(self.cache, one_cache, lane)
        if routes:
            self.routes[lane, :len(context)] = torch.stack(routes, 1)
        self._next_tok[lane] = int(torch.argmax(logits[0]))
        self._pos[lane] = len(context)
        self._live.add(lane)
        self.prefill_tokens += len(context)
        tel = _obs_current()
        if tel.active:
            tel.metrics.counter("lm.prefill_tokens").inc(len(context))

    def on_release(self, lane: int) -> None:
        kvcache.clear_slot(self.cache, lane)
        self._live.discard(lane)

    # ---------------- one batched decode step ----------------------- #
    def stream_host(self, batch: np.ndarray, *,
                    use_kernel: bool = True) -> np.ndarray:
        """(lanes, 1) placeholder in → (lanes, 1) token ids out: emit
        each lane's staged token, then one batched decode (every lane
        at its own position) stages the next."""
        out = self._next_tok.astype(np.float32)[:, None]
        t0 = time.perf_counter()
        routes = [] if self.route_log else None
        logits, self.cache = self.clm.decode(
            self.cache, self._next_tok[:, None], self._pos,
            use_kernel=use_kernel, routes=routes)
        self.logits = logits
        if routes:
            slot = torch.as_tensor(self._pos % self.cache_len,
                                   device=logits.device).long()
            self.routes[torch.arange(len(slot), device=logits.device),
                        slot] = torch.stack(routes, 1)
        nxt = self._ids.copy_(torch.argmax(logits, dim=-1)).numpy().astype(
            np.int32)
        dt = time.perf_counter() - t0
        for lane in self._live:
            self._next_tok[lane] = nxt[lane]
            self._pos[lane] += 1
        self.decode_steps += 1
        live = len(self._live)
        tel = _obs_current()
        if tel.active and live:
            m = tel.metrics
            m.counter("lm.tokens").inc(live)
            m.histogram("lm.decode_latency_s").record(dt / live)
        return out

    # ---------------- elastic resize -------------------------------- #
    def resize(self, n_chips: Optional[int] = None, *, mesh=None,
               lanes: Optional[int] = None) -> None:
        """``lanes``: rebuild the lane-batched KV cache for a new lane
        budget — call BEFORE the router requeues evicted lanes: their
        states re-admit through :meth:`on_admit`, which re-prefills
        into the fresh cache (greedy determinism preserves the
        continuations). ``n_chips``/``mesh`` (what the router's own
        ``resize`` passes every member) only recount the tenant's
        chips."""
        if mesh is not None:
            self.mesh = mesh
            n_chips = mesh.size
        if n_chips is not None:
            self.n_chips = self.n_local_chips = int(n_chips)
        if lanes is not None:
            if lanes < 1:
                raise ValueError("LMMember.resize: needs lanes >= 1")
            self.lanes = int(lanes)
            self._alloc(self.lanes)
