"""The port's procedural data (``repro_torch.data``) against
``repro.data``.

The reference draws with ``jax.random``; the parity tests hand its
draws across (the stream's velocity, a stand-in dataset's labels,
jitters and noise field, the token pipeline's uniforms and Markov
mask) and hold the port's output to the reference's:

  * sensor frames and windows at atol 1e-6 (``sin``/``exp`` may differ
    in the last ulp between XLA and PyTorch), the roll offsets exact;
  * stand-in images at atol 1e-5: XLA's f32 ``cos`` is not correctly
    rounded (about 1 % of arguments are an ulp off the f64 value,
    measured here), and the grating's argument 2π·freq·(x·cos θ +
    y·sin θ)/w amplifies an ulp of cos θ some 50×; both packages'
    images differ from an f64 evaluation by up to 3.5e-6;
  * tokens exactly, the draws whose Zipf rank overflows int32 included.

The port's own draws get range, shape, class-count and purity checks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import images as jimages
from repro.data.images import sensor_stream as jsensor_stream
from repro.data.pipeline import PipelineState as JState
from repro.data.pipeline import SensorPipeline as JPipe
from repro.data.pipeline import TokenPipeline as JTokens
from repro.fleet import StreamSource as JSource

from repro_torch.data import (PipelineState, SensorPipeline, TokenPipeline,
                              chars_like, cifar_like, embeds_batch, images,
                              mnist_like, sensor_frames, sensor_stream,
                              sensor_velocity)
from repro_torch.fleet import StreamSource

torch.set_num_threads(1)

ATOL = 1e-6


def _ref_velocity(seed):
    """The reference's draw inside ``sensor_stream``."""
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (2,),
                                         minval=1.0, maxval=3.0))


@pytest.mark.parametrize("seed,frames,h,w,start",
                         [(0, 5, 64, 64, 0), (3, 4, 64, 64, 1000),
                          (7, 3, 32, 48, 37)])
def test_frames_match_reference_with_its_velocity(seed, frames, h, w, start):
    vel = _ref_velocity(seed)
    ref = np.asarray(jsensor_stream(seed, frames, h, w, start=start))
    out = sensor_frames(torch.from_numpy(vel.copy()), frames, h, w,
                        start=start)
    assert out.dtype == torch.float32 and out.shape == (frames, h, w)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
    # the roll offsets exactly: int32(f32(i) · vel), as the reference
    i = jnp.arange(start, start + frames)
    want = np.stack([np.asarray((i * vel[0]).astype(jnp.int32)),
                     np.asarray((i * vel[1]).astype(jnp.int32))], axis=1)
    got = images.frame_offsets(torch.from_numpy(vel.copy()), frames, start)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [dict(), dict(window=8, stride=8, height=16,
                                             width=16),
                                dict(window=28, stride=18, frames_per_step=3,
                                     seed=5)])
def test_windows_match_reference_with_its_velocity(kw, monkeypatch):
    """Frame-major windows, d_item, windows_per_frame and items_per_step
    as the reference's, with the reference's velocity handed in."""
    ref_pipe, pipe = JPipe(**kw), SensorPipeline(**kw)
    vel = _ref_velocity(pipe.seed)
    monkeypatch.setattr(images, "sensor_velocity",
                        lambda seed: torch.from_numpy(vel.copy()))
    assert (pipe.d_item, pipe.windows_per_frame, pipe.items_per_step) == \
        (ref_pipe.d_item, ref_pipe.windows_per_frame,
         ref_pipe.items_per_step)
    for step in (0, 2):
        np.testing.assert_allclose(pipe.batch(step).numpy(),
                                   np.asarray(ref_pipe.batch(step)),
                                   rtol=0, atol=ATOL)


def test_pipeline_state_round_trips_as_the_reference():
    st = SensorPipeline(seed=4).state(9)
    assert st == PipelineState(4, 9)
    assert st.as_dict() == JState(4, 9).as_dict()
    assert PipelineState.from_dict(st.as_dict()) == st


def test_velocities_lie_in_one_to_three_and_differ_by_seed():
    vels = torch.stack([sensor_velocity(s) for s in range(200)])
    assert vels.dtype == torch.float32
    assert bool((vels >= 1.0).all()) and bool((vels < 3.0).all())
    assert len({tuple(v.tolist()) for v in vels}) == 200
    # both halves of the range are reached
    assert float(vels.min()) < 1.5 and float(vels.max()) > 2.5
    assert torch.equal(sensor_velocity(3), sensor_velocity(3))


def test_a_batch_is_a_slice_of_a_longer_stream():
    """Purity: frames are pure functions of (seed, absolute index), so a
    batch equals the windows of the matching frames of one long stream,
    and a 3-frame step is the concatenation of three 1-frame steps."""
    one = SensorPipeline(window=8, stride=8, height=16, width=16, seed=2)
    three = SensorPipeline(window=8, stride=8, height=16, width=16, seed=2,
                           frames_per_step=3)
    long = sensor_stream(2, 12, 16, 16)
    for step in (0, 5, 11):
        frame = long[step]
        wins = [frame[r:r + 8, c:c + 8].reshape(-1)
                for r in (0, 8) for c in (0, 8)]
        assert torch.equal(one.batch(step), torch.stack(wins))
    assert torch.equal(three.batch(1),
                       torch.cat([one.batch(s) for s in (3, 4, 5)]))
    assert torch.equal(sensor_stream(2, 4, 16, 16, start=7), long[7:11])
    assert not torch.equal(one.batch(0), one.batch(1))
    b = one.batch(0)
    assert b.shape == (4, 64) and float(b.min()) >= 0.0 and \
        float(b.max()) <= 1.0


def test_sensor_pipeline_rejects_bad_geometry():
    with pytest.raises(ValueError, match="window"):
        SensorPipeline(window=96, height=64, width=64)
    with pytest.raises(ValueError, match="stride"):
        SensorPipeline(window=8, height=16, width=16, stride=0)
    with pytest.raises(ValueError, match="frames_per_step"):
        SensorPipeline(frames_per_step=0)


def test_for_host_partitions_the_stream_as_the_reference():
    """Host h of H takes steps h, h+H, …, with uids from h × 10⁶: the
    port's feeds take the reference's steps and uids, and each request
    is its own pipeline's batch at that step."""
    kw = dict(window=8, stride=8, height=16, width=16)
    pipe, ref_pipe = SensorPipeline(**kw), JPipe(**kw)
    hosts = 3
    for h in range(hosts):
        src = StreamSource.for_host(pipe, host=h, hosts=hosts,
                                    n_requests=4, capacity=8)
        ref = JSource.for_host(ref_pipe, host=h, hosts=hosts,
                               n_requests=4, capacity=8)
        src.pump()
        ref.pump()
        got = [src.take() for _ in range(4)]
        want = [ref.take() for _ in range(4)]
        assert [r.uid for r in got] == [r.uid for r in want] == \
            [h * 1_000_000 + i for i in range(4)]
        for i, r in enumerate(got):
            assert isinstance(r.items, np.ndarray)
            np.testing.assert_array_equal(
                r.items, pipe.batch(h + i * hosts).numpy())
        assert (src.next_step, src.produced) == (ref.next_step, ref.produced)
    with pytest.raises(ValueError, match="host"):
        StreamSource.for_host(pipe, host=3, hosts=3)
    with pytest.raises(ValueError, match="step_stride"):
        StreamSource(pipe, step_stride=0)


def test_for_host_defaults_to_one_host_without_a_process_group():
    pipe = SensorPipeline(window=8, stride=8, height=16, width=16)
    src = StreamSource.for_host(pipe, n_requests=2)
    assert (src.next_step, src.step_stride, src.uid_base) == (0, 1, 0)


# ---------------- the stand-in image datasets ------------------------- #
STAND_INS = {"mnist_like": (28, 28, 1, 10, 0.10),
             "cifar_like": (32, 32, 3, 10, 0.15),
             "chars_like": (50, 50, 1, 26, 0.08)}
IMAGE_ATOL = 1e-5


def _ref_draws(seed, n, h, w, channels, n_classes):
    """The draws inside the reference's ``_dataset``/``_class_image``:
    labels, the two jitters and the noise field."""
    k_lab, k_img = jax.random.split(jax.random.PRNGKey(seed))
    labels = jax.random.randint(k_lab, (n,), 0, n_classes, jnp.int32)
    keys = jax.random.split(k_img, n * channels).reshape(n, channels, 2)

    def one(k):
        k1, k2, k3 = jax.random.split(k, 3)
        return (jax.random.normal(k1, ()), jax.random.normal(k2, ()),
                jax.random.normal(k3, (h, w)))

    jt, jf, z = jax.vmap(jax.vmap(one))(keys)
    return [torch.from_numpy(np.array(a)) for a in (labels, jt, jf, z)]


@pytest.mark.parametrize("name", sorted(STAND_INS))
@pytest.mark.parametrize("seed", [0, 3])
def test_stand_in_images_match_reference_on_its_draws(name, seed):
    h, w, c, classes, noise = STAND_INS[name]
    n = 48
    xs, ys = getattr(jimages, name)(seed, n)
    x, y = images._dataset(*_ref_draws(seed, n, h, w, c, classes), h, w,
                           classes, noise)
    assert x.dtype == torch.float32 and x.shape == (n, c * h * w)
    np.testing.assert_array_equal(y.numpy(), np.asarray(ys))
    np.testing.assert_allclose(x.numpy(), np.asarray(xs), rtol=0,
                               atol=IMAGE_ATOL)


@pytest.mark.parametrize("fn,dim,classes", [(mnist_like, 784, 10),
                                            (cifar_like, 3072, 10),
                                            (chars_like, 2500, 26)])
def test_stand_ins_have_the_originals_shapes_and_are_pure(fn, dim,
                                                          classes):
    x, y = fn(seed=5, n=300)
    assert x.shape == (300, dim) and x.dtype == torch.float32
    assert y.shape == (300,) and y.dtype == torch.int64
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    assert set(y.tolist()) == set(range(classes))
    x2, y2 = fn(seed=5, n=300)
    assert torch.equal(x, x2) and torch.equal(y, y2)
    x3, _ = fn(seed=6, n=300)
    assert not torch.equal(x, x3)
    # class-conditional: a class's mean image differs from another's
    means = torch.stack([x[y == k].mean(0) for k in range(2)])
    assert float((means[0] - means[1]).abs().max()) > 0.1


# ---------------- the token pipeline ---------------------------------- #
def _ref_token_draws(seed, step, B, S):
    """The uniforms and the Markov mask inside the reference's
    ``TokenPipeline.batch``."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    k1, k2, _ = jax.random.split(key, 3)
    u = jax.random.uniform(k1, (B, S + 1), minval=1e-6, maxval=1.0)
    mask = jax.random.uniform(k2, (B, S + 1)) < 0.7
    return k1, np.asarray(u), np.asarray(mask)


@pytest.mark.parametrize("vocab,seed,step", [(151_936, 0, 0),
                                             (152_064, 3, 5), (512, 1, 2),
                                             (64, 9, 11)])
def test_token_pipeline_matches_reference_on_its_draws(vocab, seed, step):
    """The Zipf transform on the reference's uniforms — the ones whose
    rank passes 2³¹ included, which XLA saturates to vocab−1 and a
    plain int32 cast on the CPU would wrap to token 0 — and the Markov
    chain on its mask give the reference's tokens exactly."""
    B, S = 8, 128
    ref = JTokens(vocab_size=vocab, seq_len=S, global_batch=B, seed=seed)
    pipe = TokenPipeline(vocab_size=vocab, seq_len=S, global_batch=B,
                         seed=seed)
    k1, u, mask = _ref_token_draws(seed, step, B, S)
    overflow = u < 0.0135                 # u^-5 ≥ 2³¹ − 1 at a = 1.2
    assert overflow.sum() > 0
    zipf = pipe.zipf_tokens(torch.from_numpy(u.copy()))
    np.testing.assert_array_equal(zipf.numpy(),
                                  np.asarray(ref._zipf_sample(k1, (B, S + 1))))
    assert bool((zipf.numpy()[overflow] == vocab - 1).all())
    toks = pipe.markov_chain(zipf, torch.from_numpy(mask.copy()))
    want = ref.batch(step)
    np.testing.assert_array_equal(toks[:, :S].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(toks[:, 1:].numpy(),
                                  np.asarray(want["labels"]))


def test_token_pipeline_batches_are_pure_sliceable_and_checkpointable():
    pipe = TokenPipeline(vocab_size=1000, seq_len=32, global_batch=8,
                         seed=4)
    b = pipe.batch(3)
    assert set(b) == {"tokens", "labels"}
    for v in b.values():
        assert v.dtype == torch.int32 and v.shape == (8, 32)
        assert int(v.min()) >= 0 and int(v.max()) < 1000
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    again = pipe.batch(3)
    assert all(torch.equal(b[k], again[k]) for k in b)
    assert not torch.equal(b["tokens"], pipe.batch(4)["tokens"])
    u, mask = pipe.draws(3)
    assert u.dtype == torch.float32 and float(u.min()) >= 1e-6 and \
        float(u.max()) < 1.0
    assert 0.6 < float(mask.float().mean()) < 0.8
    # host_shard: the reference's slicing of the one global batch
    ref = JTokens(vocab_size=1000, seq_len=32, global_batch=8, seed=4)
    for count in (1, 2, 4):
        parts = [pipe.host_shard(b, i, count) for i in range(count)]
        ref_parts = [ref.host_shard({k: jnp.asarray(v.numpy())
                                     for k, v in b.items()}, i, count)
                     for i in range(count)]
        for got, want in zip(parts, ref_parts):
            for k in b:
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
        assert torch.equal(torch.cat([p["tokens"] for p in parts]),
                           b["tokens"])
    with pytest.raises(ValueError, match="split"):
        pipe.host_shard(b, 0, 3)
    st = pipe.state(7)
    assert st == PipelineState(4, 7) and st.as_dict() == \
        ref.state(7).as_dict()


def test_embeds_batch_shapes_and_purity():
    b = embeds_batch(3, 2, 5, 16, 100)
    assert b["embeds"].dtype == torch.bfloat16 and \
        b["embeds"].shape == (2, 5, 16)
    assert b["labels"].dtype == torch.int32 and b["labels"].shape == (2, 5)
    assert int(b["labels"].max()) < 100 and int(b["labels"].min()) >= 0
    again = embeds_batch(3, 2, 5, 16, 100)
    assert torch.equal(b["embeds"], again["embeds"])
