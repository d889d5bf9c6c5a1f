"""Closed-loop, accuracy-SLO recalibration: the paper's operational
mode on real devices.

Port of ``repro.variability.recal``. Memristor deployments counter
conductance drift by periodically reprogramming the arrays (Hasan &
Taha arXiv:1603.07400). The :class:`repro_torch.variability.monitor.
AccuracyMonitor` supplies canary accuracy, and on a sustained SLO
breach the :class:`Recalibrator` re-encodes the app's weights through
the deployment's ``reprogram`` — a weights-only swap, so
``compile_count()`` must not move (asserted per event, not assumed) —
resetting the drift clock and re-rolling programming noise while stuck
cells persist. Each event is published on an optional board (anything
with ``publish_event(kind, payload)``).

The deployment is duck-typed: ``reprogram(app, params)`` and
``params(app)`` (the stored weights, or None). Weights come from
``params_fn`` when given, else from ``deployment.params(app)`` (a plain
re-flash of the same weights, which is all pure drift needs).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional


@dataclasses.dataclass(frozen=True)
class RecalPolicy:
    """When to pull the reprogram trigger.

    ``slo`` is the canary-accuracy floor. ``patience`` consecutive
    breaching probes arm the trigger (1 = react to the first breach);
    ``cooldown_steps`` engine steps must pass after a recalibration
    before the next one (reprogramming costs device write time —
    §III.C feedback writes — so flapping is real money); ``max_recals``
    bounds total events (None = unbounded)."""
    slo: float = 0.99
    patience: int = 1
    cooldown_steps: int = 0
    max_recals: Optional[int] = None

    def __post_init__(self):
        if not 0.0 < self.slo <= 1.0:
            raise ValueError("RecalPolicy: slo must be in (0, 1]")
        if self.patience < 1:
            raise ValueError("RecalPolicy: patience must be >= 1")
        if self.cooldown_steps < 0:
            raise ValueError("RecalPolicy: cooldown_steps must be >= 0")


@dataclasses.dataclass(frozen=True)
class RecalEvent:
    """One completed closed-loop recalibration."""
    app: str
    step: int                   # engine step of the triggering probe
    items_streamed: int         # drift age at the trigger
    accuracy_before: float
    accuracy_after: float
    compile_delta: int          # pinned 0: reprogram is not a compile


class Recalibrator:
    """Accuracy-SLO watchdog + actuator over one deployed app.

    Call the monitor's and then this object's ``on_step`` after each
    engine step: the recalibrator consumes any new canary samples,
    tracks consecutive SLO breaches, and reprograms the app live when
    the policy says so.
    """

    def __init__(self, deployment, app: str, monitor,
                 policy: Optional[RecalPolicy] = None, *,
                 params_fn: Optional[Callable[[], list]] = None,
                 board=None, rank: int = 0):
        self.deployment = deployment
        self.app = str(app)
        self.monitor = monitor
        self.policy = policy or RecalPolicy()
        self.params_fn = params_fn
        self.board = board          # has publish_event, or None
        self.rank = int(rank)
        self.events: List[RecalEvent] = []
        self._breaches = 0
        self._steps_seen = 0
        self._cooldown_until = 0
        self._consumed = 0

    # ------------------------------------------------------------ #
    def _fresh_params(self):
        if self.params_fn is not None:
            return self.params_fn()
        params = self.deployment.params(self.app)
        if params is None:
            raise ValueError(
                f"Recalibrator: app {self.app!r} has no stored "
                "parameters and no params_fn was given — nothing to "
                "reprogram with")
        return params

    def recalibrate(self,
                    trigger: Optional[object] = None) -> RecalEvent:
        """Reprogram the app's fabric now (normally driven by
        ``on_step``; callable directly for a manual refresh). Asserts
        the zero-recompile contract and re-scores the canary so the
        event records the accuracy the swap restored."""
        from repro_torch.chip.compile import compile_count
        before = trigger if trigger is not None else self.monitor.latest
        c0 = compile_count()
        self.deployment.reprogram(self.app, self._fresh_params())
        delta = compile_count() - c0
        if delta != 0:
            raise AssertionError(
                f"Recalibrator: reprogram of {self.app!r} ran {delta} "
                "full compile pass(es); the zero-recompile contract "
                "is broken")
        after = self.monitor.score(step=self._steps_seen)
        event = RecalEvent(
            app=self.app,
            step=int(getattr(before, "step", self._steps_seen)),
            items_streamed=int(getattr(before, "items_streamed", 0)),
            accuracy_before=float(getattr(before, "accuracy",
                                          float("nan"))),
            accuracy_after=after.accuracy,
            compile_delta=delta)
        self.events.append(event)
        self._cooldown_until = self._steps_seen + \
            self.policy.cooldown_steps
        self._breaches = 0
        if self.board is not None:
            self.board.publish_event(
                "recalibration",
                dict(rank=self.rank, **dataclasses.asdict(event)))
        from repro_torch.obs import current
        tel = current()
        if tel.active:
            # the recalibration shows up on the serving timeline, next
            # to the engine steps and any HA membership changes
            tel.tracer.instant("variability.recalibration",
                               cat="variability",
                               args=dataclasses.asdict(event))
            tel.metrics.counter("variability.recals",
                                app=self.app).inc()
        return event

    def on_step(self, router) -> None:
        self._steps_seen += 1
        new = self.monitor.samples[self._consumed:]
        self._consumed = len(self.monitor.samples)
        for sample in new:
            if sample.accuracy >= self.policy.slo:
                self._breaches = 0
                continue
            self._breaches += 1
            if self._breaches < self.policy.patience:
                continue
            if self._steps_seen < self._cooldown_until:
                continue
            if self.policy.max_recals is not None and \
                    len(self.events) >= self.policy.max_recals:
                continue
            self.recalibrate(trigger=sample)

    # ------------------------------------------------------------ #
    def summary(self) -> dict:
        return {
            "app": self.app,
            "policy": dataclasses.asdict(self.policy),
            "recals": len(self.events),
            "events": [dataclasses.asdict(e) for e in self.events],
        }
