"""The port's sensor data (``repro_torch.data``) against ``repro.data``.

The reference draws the stream's velocity with ``jax.random``; the
parity tests hand that velocity across and hold the port's frames and
windows to the reference's at atol 1e-6 (``sin``/``exp`` may differ in
the last ulp between XLA and PyTorch), with the roll offsets exact. The
port's own velocity draw gets range and purity checks instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.images import sensor_stream as jsensor_stream
from repro.data.pipeline import PipelineState as JState
from repro.data.pipeline import SensorPipeline as JPipe
from repro.fleet import StreamSource as JSource

from repro_torch.data import (PipelineState, SensorPipeline, images,
                              sensor_frames, sensor_stream, sensor_velocity)
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
