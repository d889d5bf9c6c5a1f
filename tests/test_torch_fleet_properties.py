"""Scheduler/router invariants under random ragged traffic, on the
port's router.

The toy-fleet invariants of ``tests/test_fleet_properties.py`` (no item
dropped or duplicated; backfill never exceeds ``lanes_per_chip ×
n_chips``; bounded-queue admission returns False exactly when the queue
is full; per-request latencies monotone; the same across mid-serve
``resize`` membership changes; shrink and grow preserving progress;
``merge_stats`` consistent with its parts), run on
:class:`repro_torch.fleet.FleetRouter` with the reference's seeds as
parametrised cases. The payload is a row-pure toy fleet (``y = 2x +
1``): the router is payload-agnostic.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.fleet import FleetRouter, merge_stats
from repro_torch.serving.engine import ItemRequest

# ---------------------------------------------------------------------- #
# toy payload + schedule driver
# ---------------------------------------------------------------------- #
D_IN = 3


class ToyFleet:
    """Row-pure payload: y = 2x + 1 (so outputs identify their input
    row exactly — duplication or loss is detectable per item)."""
    d_in = D_IN

    def __init__(self, n_chips=1):
        self.n_chips = n_chips

    def stream(self, x, use_kernel=False):
        return np.asarray(x, np.float32) * 2.0 + 1.0


@dataclasses.dataclass
class DriveLog:
    accepted: list                  # uids the router admitted-queue took
    rejected: list                  # uids submit() refused
    submit_expect: list             # (returned, expected-from-queue-state)
    step_emitted: list              # items emitted per engine step


def drive(schedule, *, lanes_per_chip=2, n_chips=2,
          queue_limit=None) -> tuple:
    """Run one ragged schedule through a FleetRouter.

    ``schedule`` is a list of waves; each wave is
    ``(lengths, steps_after)``: submit one request per length, then run
    that many engine steps — arrivals land mid-flight, which is what
    exercises backfill. Returns (router, DriveLog) after a full drain.
    """
    fleet = ToyFleet(n_chips)
    router = FleetRouter(fleet, lanes_per_chip=lanes_per_chip,
                         queue_limit=queue_limit)
    rng = np.random.default_rng(0)
    log = DriveLog([], [], [], [])
    uid = 0
    for lengths, steps_after in schedule:
        for n in lengths:
            items = rng.uniform(-1, 1, (n, D_IN)).astype(np.float32)
            expected = queue_limit is None or \
                len(router.queue) < queue_limit
            got = router.submit(ItemRequest(uid=uid, items=items))
            log.submit_expect.append((got, expected))
            (log.accepted if got else log.rejected).append(uid)
            uid += 1
        for _ in range(steps_after):
            log.step_emitted.append(router.step())
    while router.queue or router.active:
        log.step_emitted.append(router.step())
    return router, log


# ---------------------------------------------------------------------- #
# the invariants
# ---------------------------------------------------------------------- #
def check_no_drop_no_dup(router, log):
    """Every admitted request finishes exactly once, with exactly its
    items, each transformed exactly once (y = 2x + 1 row-for-row)."""
    done_uids = [st.request.uid for st in router.finished]
    assert sorted(done_uids) == sorted(log.accepted)
    assert len(set(done_uids)) == len(done_uids)
    total_items = 0
    for st in router.finished:
        items = np.asarray(st.request.items, np.float32)
        assert st.result.shape == items.shape[:1] + (D_IN,)
        np.testing.assert_allclose(st.result, items * 2.0 + 1.0,
                                   rtol=1e-6)
        total_items += items.shape[0]
    assert router.items_emitted == total_items == sum(log.step_emitted)


def check_backfill_bound(router, log):
    """No engine step ever streams more than lanes_per_chip × n_chips
    items — lanes are the only concurrency there is."""
    lanes = router.lanes_per_chip * router.n_chips
    assert router.slots == lanes
    assert all(0 <= e <= lanes for e in log.step_emitted)
    if router.steps:
        assert 0 < router.stats().occupancy <= 1.0


def check_admission_exact(router, log, queue_limit):
    """submit() returned False exactly when the admission queue stood
    at queue_limit — never early, never late — and the rejected
    counter agrees."""
    for got, expected in log.submit_expect:
        assert got == expected
    assert router.rejected == len(log.rejected)
    if queue_limit is None:
        assert not log.rejected


def check_latency_monotone(router):
    for st in router.finished:
        assert st.request.t_submit <= st.t_admit <= st.t_first \
            <= st.t_done
        assert st.admit_step <= st.done_step
        assert st.wait_s >= 0 and st.latency_s >= st.wait_s


def check_all(schedule, *, lanes_per_chip, n_chips, queue_limit):
    router, log = drive(schedule, lanes_per_chip=lanes_per_chip,
                        n_chips=n_chips, queue_limit=queue_limit)
    check_no_drop_no_dup(router, log)
    check_backfill_bound(router, log)
    check_admission_exact(router, log, queue_limit)
    check_latency_monotone(router)
    return router


def drive_with_resize(schedule, chip_counts, *, lanes_per_chip=2,
                      queue_limit=None) -> tuple:
    """Like :func:`drive`, but the fleet CHANGES SIZE mid-serve: after
    wave ``i`` the router is resized to ``chip_counts[i]`` chips (the
    first entry is the starting size), with whatever is mid-flight
    evicted and front-requeued by the scheduler rebuild. Returns
    (router, log, lane_caps) where ``lane_caps[k]`` is the lane budget
    in force at engine step ``k``."""
    fleet = ToyFleet(chip_counts[0])
    router = FleetRouter(fleet, lanes_per_chip=lanes_per_chip,
                         queue_limit=queue_limit)
    rng = np.random.default_rng(0)
    log = DriveLog([], [], [], [])
    lane_caps = []
    uid = 0
    for (lengths, steps_after), n_next in zip(schedule, chip_counts):
        for n in lengths:
            items = rng.uniform(-1, 1, (n, D_IN)).astype(np.float32)
            expected = queue_limit is None or \
                len(router.queue) < queue_limit
            got = router.submit(ItemRequest(uid=uid, items=items))
            log.submit_expect.append((got, expected))
            (log.accepted if got else log.rejected).append(uid)
            uid += 1
        for _ in range(steps_after):
            lane_caps.append(router.slots)
            log.step_emitted.append(router.step())
        router.resize(n_next)           # the membership change
    while router.queue or router.active:
        lane_caps.append(router.slots)
        log.step_emitted.append(router.step())
    return router, log, lane_caps


def check_backfill_bound_elastic(router, log, lane_caps,
                                 lanes_per_chip, chip_counts):
    """The elastic form of the backfill bound: each step's emission is
    capped by the lane budget IN FORCE at that step, and the final
    slot count matches the last resize."""
    assert router.slots == lanes_per_chip * chip_counts[-1]
    assert router.n_chips == chip_counts[-1]
    assert len(lane_caps) == len(log.step_emitted)
    assert all(0 <= e <= cap
               for e, cap in zip(log.step_emitted, lane_caps))


def check_all_elastic(schedule, chip_counts, *, lanes_per_chip,
                      queue_limit):
    router, log, lane_caps = drive_with_resize(
        schedule, chip_counts, lanes_per_chip=lanes_per_chip,
        queue_limit=queue_limit)
    check_no_drop_no_dup(router, log)
    check_backfill_bound_elastic(router, log, lane_caps,
                                 lanes_per_chip, chip_counts)
    check_admission_exact(router, log, queue_limit)
    check_latency_monotone(router)
    return router


# ---------------------------------------------------------------------- #
# seeded schedules (the reference's seeds)
# ---------------------------------------------------------------------- #
def _random_schedule(rng):
    return [
        (list(rng.integers(1, 7, size=rng.integers(0, 6))),
         int(rng.integers(0, 5)))
        for _ in range(rng.integers(1, 7))
    ]


@pytest.mark.parametrize("seed", range(12))
def test_invariants_random_schedules(seed):
    rng = np.random.default_rng(seed)
    check_all(_random_schedule(rng),
              lanes_per_chip=int(rng.integers(1, 4)),
              n_chips=int(rng.integers(1, 4)),
              queue_limit=None)


@pytest.mark.parametrize("seed", range(12))
def test_invariants_random_schedules_bounded_queue(seed):
    rng = np.random.default_rng(100 + seed)
    check_all(_random_schedule(rng),
              lanes_per_chip=int(rng.integers(1, 3)),
              n_chips=int(rng.integers(1, 3)),
              queue_limit=int(rng.integers(1, 4)))


@pytest.mark.parametrize("seed", range(12))
def test_invariants_across_membership_changes(seed):
    rng = np.random.default_rng(200 + seed)
    schedule = _random_schedule(rng)
    chip_counts = [int(rng.integers(1, 5)) for _ in schedule]
    check_all_elastic(schedule, chip_counts,
                      lanes_per_chip=int(rng.integers(1, 4)),
                      queue_limit=None)


@pytest.mark.parametrize("seed", range(8))
def test_invariants_across_membership_changes_bounded(seed):
    rng = np.random.default_rng(300 + seed)
    schedule = _random_schedule(rng)
    chip_counts = [int(rng.integers(1, 4)) for _ in schedule]
    check_all_elastic(schedule, chip_counts,
                      lanes_per_chip=int(rng.integers(1, 3)),
                      queue_limit=int(rng.integers(1, 4)))


def test_shrink_grow_preserves_streamed_progress():
    """A deterministic worst case: fill every lane with long requests,
    shrink to one lane-block mid-flight, then grow back — every item
    must come out exactly once, never re-streamed (items_emitted ==
    total items == per-step sum), with outputs exact."""
    fleet = ToyFleet(4)
    router = FleetRouter(fleet, lanes_per_chip=2)
    rng = np.random.default_rng(1)
    reqs = [ItemRequest(uid=i,
                        items=rng.uniform(-1, 1, (10, D_IN))
                        .astype(np.float32))
            for i in range(8)]
    for r in reqs:
        assert router.submit(r)
    emitted = [router.step() for _ in range(3)]     # lanes mid-request
    router.resize(1)                                # shrink 4 → 1 chip
    assert router.slots == 2
    emitted += [router.step() for _ in range(3)]
    router.resize(4)                                # grow back
    assert router.slots == 8
    while router.queue or router.active:
        emitted.append(router.step())
    assert sorted(st.request.uid for st in router.finished) == \
        list(range(8))
    assert router.items_emitted == 80 == sum(emitted)
    for st in router.finished:
        np.testing.assert_allclose(
            st.result, np.asarray(st.request.items) * 2.0 + 1.0,
            rtol=1e-6)


def test_merge_stats_is_consistent_with_parts():
    rng = np.random.default_rng(7)
    parts = []
    for seed in range(3):
        router = check_all(_random_schedule(rng), lanes_per_chip=2,
                           n_chips=1, queue_limit=None)
        parts.append(router.stats())
    m = merge_stats(parts)
    assert m.requests == sum(p.requests for p in parts)
    assert m.items == sum(p.items for p in parts)
    assert m.lanes == sum(p.lanes for p in parts)
    assert m.rejected == sum(p.rejected for p in parts)
    assert m.steps == max(p.steps for p in parts)
    assert m.wall_s == max(p.wall_s for p in parts)
    assert m.latency_s_p50 == max(p.latency_s_p50 for p in parts)
    assert m.occupancy <= 1.0 + 1e-9
