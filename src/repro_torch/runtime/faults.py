"""Failure taxonomy the trainer consumes (counterpart of the part of
``repro.runtime.faults`` the trainer needs).

Only :class:`DeviceLossError` is ported: a *persistent* failure the trainer
re-raises at once instead of retrying.  The injectable fault specs,
``FaultPlan`` and ``FaultInjector`` come with the elastic runtime
(ROADMAP A12); until then ``Trainer.train(fail_injector=)`` takes any
callable of the step.
"""
from __future__ import annotations


class DeviceLossError(RuntimeError):
    """A persistent topology change: ``failed_ids`` devices are gone.

    Retrying the step cannot succeed -- the trainer propagates this
    immediately so an elastic runtime can re-mesh and resume."""

    def __init__(self, failed_ids, *, step: int = -1):
        self.failed_ids = frozenset(int(i) for i in failed_ids)
        self.step = step
        ids = sorted(self.failed_ids)
        super().__init__(f"device(s) {ids} lost at step {step}")
