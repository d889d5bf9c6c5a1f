"""The port's dense greedy decode ``Engine`` (``repro_torch.serving``)
against the reference's ``repro.serving.Engine``, on the CPU.

Weights are handed across as numpy (``params_from_numpy``). Both
engines run the serving configuration (``reduced_serving()``: f32
compute, the bf16 KV cache ``init_cache`` defaults to), so their greedy
token streams must be equal, request by request, under continuous
admission, eos and lane reuse.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen1p5_0p5b as jqwen
from repro.models import model as jmodel
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest

from repro_torch.configs import qwen1p5_0p5b as tqwen
from repro_torch.models import model as tmodel
from repro_torch.serving import Engine, Request

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    jcfg = jqwen.reduced_serving()
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tqwen.reduced_serving()
    tp = tmodel.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    return jcfg, jp, tcfg, tp


def _drain(engine_cls, request_cls, cfg, params, requests, *, slots,
           cache_len=64):
    eng = engine_cls(cfg, params, slots=slots, cache_len=cache_len)
    for uid, (prompt, n, eos) in enumerate(requests):
        eng.submit(request_cls(uid=uid, prompt=list(prompt),
                               max_new_tokens=n, eos_id=eos))
    done = eng.run_until_drained()
    return eng, {st.request.uid: st.generated for st in done}


def test_engine_tokens_equal_the_reference(setup):
    """More requests than lanes, mixed lengths: lanes are reused, each
    admission prefills into a lane that held another request."""
    jcfg, jp, tcfg, tp = setup
    rng = np.random.default_rng(0)
    requests = [(rng.integers(0, tcfg.vocab_size, size=n), 3 + n % 5, -1)
                for n in (4, 9, 2, 6, 5, 7, 3)]
    _, want = _drain(JEngine, JRequest, jcfg, jp, requests, slots=3)
    eng, got = _drain(Engine, Request, tcfg, tp, requests, slots=3)
    assert got == want
    assert len(eng.finished) == len(requests)
    assert all(len(t) == n for (_, n, _), t in
               zip(requests, (got[i] for i in range(len(requests)))))
    assert eng.cache["k"].dtype == torch.bfloat16


def test_eos_stops_a_lane_as_the_reference(setup):
    """eos = the token the reference emits third: that request stops
    there (after three tokens), the others run on."""
    jcfg, jp, tcfg, tp = setup
    prompts = [[5, 6, 7], [8, 9]]
    _, free = _drain(JEngine, JRequest, jcfg, jp,
                     [(p, 8, -1) for p in prompts], slots=2)
    eos = free[0][2]
    requests = [(prompts[0], 8, eos), (prompts[1], 8, -1)]
    _, want = _drain(JEngine, JRequest, jcfg, jp, requests, slots=2)
    _, got = _drain(Engine, Request, tcfg, tp, requests, slots=2)
    assert got == want
    assert got[0] == free[0][:free[0].index(eos) + 1]


def test_continuous_admission_interleaves(setup):
    """A long request must not block short ones: shorts finish while
    the long one still runs."""
    _, _, tcfg, tp = setup
    eng = Engine(tcfg, tp, slots=2, cache_len=64)
    eng.submit(Request(uid=0, prompt=[5, 6], max_new_tokens=30))
    eng.submit(Request(uid=1, prompt=[7], max_new_tokens=2))
    eng.submit(Request(uid=2, prompt=[8], max_new_tokens=2))
    steps = 0
    while len(eng.finished) < 2 and steps < 100:
        eng.step()
        steps += 1
    assert {st.request.uid for st in eng.finished} == {1, 2}
    assert 0 in {st.request.uid for st in eng.active.values()}
    eng.run_until_drained()
    assert len(eng.finished) == 3


def test_engine_matches_lockstep_decode(setup):
    """One request through the engine == direct greedy decode with the
    lockstep model path on its own prefill cache (which evicts
    position 0 at the first decode: the reference's arithmetic)."""
    _, _, tcfg, tp = setup
    cfg = tcfg.replace(decode_per_slot=False)
    prompt, n_new = [3, 1, 4, 1, 5], 6
    logits, cache = tmodel.prefill(cfg, tp, {"tokens": [prompt]})
    ref = [int(torch.argmax(logits[0]))]
    pos = len(prompt)
    for _ in range(n_new - 1):
        logits, cache = tmodel.decode_step(cfg, tp, cache, [[ref[-1]]], pos)
        ref.append(int(torch.argmax(logits[0])))
        pos += 1
    jcfg = jqwen.reduced_serving()
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    jl, jc = jmodel.prefill(jcfg, jp, {"tokens": jnp.asarray([prompt])})
    jref = [int(jnp.argmax(jl[0]))]
    for i in range(n_new - 1):
        jl, jc = jmodel.decode_step(jcfg, jp, jc,
                                    jnp.asarray([[jref[-1]]]),
                                    jnp.int32(len(prompt) + i))
        jref.append(int(jnp.argmax(jl[0])))
    assert ref == jref
    # the engine's lanes sit in a 64-slot ring: nothing is evicted
    eng = Engine(tcfg, tp, slots=2, cache_len=64)
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=n_new))
    done = eng.run_until_drained()
    assert done[0].generated[0] == ref[0] and len(done[0].generated) == n_new


def test_custom_sampler_and_eos(setup):
    _, _, tcfg, tp = setup
    eng = Engine(tcfg, tp, slots=1, cache_len=64,
                 sampler=lambda logits, gen: torch.full(
                     (logits.shape[0],), 9, dtype=torch.int64))
    eng.submit(Request(uid=0, prompt=[1, 2], max_new_tokens=50, eos_id=9))
    done = eng.run_until_drained()
    assert len(done) == 1 and done[0].generated == [9]
