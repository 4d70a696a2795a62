"""Typed observability events: the vocabulary of the bus.

Counterpart of ``repro.obs.events``, with the same sixteen classes (the
base ``Event`` and the fifteen kinds of ``EVENT_KINDS``) and the same
records: ``to_record()`` gives the reference's keys in the reference's
order, so either package's ``report`` reads the other's streams.  Every
event is a small frozen dataclass with a class-level ``kind`` tag and a
wall-clock timestamp:

  * ``PlanEvent``            -- one ``plan_for`` resolution: plan-cache
                                hit/miss plus where the layout decision
                                came from (analytic / override / profile).
                                The port plans at every launch (it is
                                eager; the reference plans at trace time),
                                so a model run streams one a launch.
  * ``SpmdFallbackEvent``    -- a declared sharding degraded to
                                replication on an SPMD launch, with the
                                reasons.
  * ``SpmdOverrideShadowEvent`` -- plan overrides keyed at a global shape
                                under an SPMD launch: inert cells.
  * ``ValidationEvent``      -- one measured-vs-predicted record: HBM bytes
                                or comm wire bytes against the plan's
                                model.
  * ``TrainStepEvent``       -- one trainer step's metrics.
  * ``CheckpointEvent``      -- a checkpoint save/restore.
  * ``AdmissionEvent``       -- the batcher admitted a request to a slot.
  * ``BatcherTickEvent``     -- one decode tick's occupancy/packing state.
  * ``PagePoolEvent``        -- the paged KV cache's pool occupancy after
                                a tick (paged batcher only).
  * ``PreemptionEvent``      -- the batcher evicted a slot to reclaim its
                                pages (the request is requeued for replay).
  * ``RequestAbandonedEvent`` -- ``run()`` hit its tick budget with this
                                request still queued or in flight.
  * ``ProfileDriftEvent``    -- a swept profile cell no longer reproduces
                                its recorded geometry (planner drift).
  * ``MeshChangeEvent``      -- an elastic runtime rebuilt the mesh after
                                a topology change (device loss / gain).
  * ``ResumeEvent``          -- an elastic runtime restored a checkpoint
                                onto the (new) mesh and resumed training.
  * ``DegradedEvent``        -- the system kept running in a degraded
                                mode: a straggling step, a transient-step
                                retry, retired surplus devices, or a
                                serving page-pool shrink.

The validation, drift, mesh-change and resume kinds have no producer in
the port yet (ROADMAP A7.2-A7.5, A12); the report reads them already.
Producers build events only when the bus is enabled
(``repro_torch.obs.bus.enabled``), so the taxonomy costs nothing when no
sink is listening.
"""
from __future__ import annotations

import dataclasses
import time
from typing import ClassVar

__all__ = [
    "Event",
    "PlanEvent",
    "SpmdFallbackEvent",
    "SpmdOverrideShadowEvent",
    "ValidationEvent",
    "TrainStepEvent",
    "CheckpointEvent",
    "AdmissionEvent",
    "BatcherTickEvent",
    "PagePoolEvent",
    "PreemptionEvent",
    "RequestAbandonedEvent",
    "ProfileDriftEvent",
    "MeshChangeEvent",
    "ResumeEvent",
    "DegradedEvent",
    "EVENT_KINDS",
]


def _jsonable(v):
    """Tuples -> lists (recursively) so records round-trip through JSON."""
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return v


@dataclasses.dataclass(frozen=True)
class Event:
    """Base event: a ``kind`` tag plus the emission wall-clock time."""

    kind: ClassVar[str] = "event"

    ts: float = dataclasses.field(default_factory=time.time, kw_only=True)

    def to_record(self) -> dict:
        """Flat JSON-safe dict: ``{"kind": ..., "ts": ..., <fields>}``."""
        rec = {"kind": self.kind, "ts": self.ts}
        for f in dataclasses.fields(self):
            if f.name == "ts":
                continue
            rec[f.name] = _jsonable(getattr(self, f.name))
        return rec


@dataclasses.dataclass(frozen=True)
class PlanEvent(Event):
    """One ``api.plan_for`` resolution, with provenance.

    ``cache`` is "hit"/"miss" for planner-derived plans and "override"
    when a ``plan_overrides`` pin short-circuited the planner; ``source``
    is the plan's provenance ("analytic", "profile:<path>", ...).
    """

    kind: ClassVar[str] = "plan"

    kernel: str
    shape: tuple
    dtype: str
    cache: str
    source: str = "analytic"
    local: bool = False
    mesh: tuple = ()


@dataclasses.dataclass(frozen=True)
class SpmdFallbackEvent(Event):
    """A declared sharding fell back to replication on this launch."""

    kind: ClassVar[str] = "spmd_fallback"

    kernel: str
    mesh: tuple
    reasons: tuple


@dataclasses.dataclass(frozen=True)
class SpmdOverrideShadowEvent(Event):
    """Plan-override cells keyed at the global shape of an SPMD launch --
    they can never match the per-shard local shapes, so the pin is inert."""

    kind: ClassVar[str] = "spmd_override_shadow"

    kernel: str
    mesh: tuple
    global_shape: tuple
    cells: tuple


@dataclasses.dataclass(frozen=True)
class ValidationEvent(Event):
    """One measured-vs-predicted record (``repro_torch.measure.validate``).

    ``check`` is "hbm" (the body's CUDA-event time at the card's data-sheet
    memory rate, ms x bytes/s, vs predicted_hbm_bytes: a timed check, not a
    byte census), "comm" (the wire bytes of the collectives a rank issued
    vs predicted_comm_bytes) or "exposed_comm" (the bytes left on the
    critical path vs predicted_exposed_comm_bytes).
    """

    kind: ClassVar[str] = "validation"

    kernel: str
    family: str
    check: str
    predicted_bytes: float
    measured_bytes: float
    ratio: float
    status: str
    mesh: tuple = ()


@dataclasses.dataclass(frozen=True)
class TrainStepEvent(Event):
    """One optimizer step's metrics (the structured form of the trainer's
    legacy ``metrics`` list-of-dicts)."""

    kind: ClassVar[str] = "train_step"

    step: int
    loss: float
    grad_norm: float
    step_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class CheckpointEvent(Event):
    """A checkpoint transition: ``action`` is "save" or "restore"."""

    kind: ClassVar[str] = "checkpoint"

    step: int
    action: str


@dataclasses.dataclass(frozen=True)
class AdmissionEvent(Event):
    """The continuous batcher admitted a request into a decode slot."""

    kind: ClassVar[str] = "admission"

    rid: int
    slot: int
    queue_depth: int


@dataclasses.dataclass(frozen=True)
class BatcherTickEvent(Event):
    """One serve tick's slot occupancy and packing state.

    ``pad_slots`` is the tile-padding overhead the planner chose
    (physical minus requested slots); ``free_slots`` is requested slots
    with no tenant.  Together they are the tick's packing waste: rows the
    decode batch computes that serve no request.
    """

    kind: ClassVar[str] = "batcher_tick"

    tick: int
    n_prefill: int
    n_decode: int
    slots: int
    padded_slots: int
    free_slots: int
    pad_slots: int
    queue_depth: int


@dataclasses.dataclass(frozen=True)
class PagePoolEvent(Event):
    """Paged-KV pool occupancy after one tick (paged batcher only).

    ``live_pages`` excludes the reserved null page; utilization is
    ``used_pages / live_pages``.  A pool pinned at full is the
    backpressure/preemption regime; a pool near empty means the page
    budget (``n_pages``) is oversized for the offered load.
    """

    kind: ClassVar[str] = "page_pool"

    tick: int
    used_pages: int
    free_pages: int
    live_pages: int
    page_len: int


@dataclasses.dataclass(frozen=True)
class PreemptionEvent(Event):
    """The batcher evicted a slot's request to reclaim its pages.

    ``reason`` is "decode_pressure" (a decoding slot needed a page) or
    "prefill_pressure" (an older prefill displaced a newer one).  The
    request is requeued at the head of the queue and replays from scratch
    on re-admission (greedy decode makes the replay token-identical).
    """

    kind: ClassVar[str] = "preemption"

    rid: int
    slot: int
    reason: str
    pages_freed: int
    queue_depth: int


@dataclasses.dataclass(frozen=True)
class RequestAbandonedEvent(Event):
    """``run()`` exhausted ``max_ticks`` with this request unfinished.

    ``stage`` is "queued", "prefill", or "decode"; ``fed``/``generated``
    record how far it got.  Paired with ``serving.scheduler.TruncatedRun``
    so truncation is never silent.
    """

    kind: ClassVar[str] = "request_abandoned"

    rid: int
    stage: str
    fed: int
    generated: int


@dataclasses.dataclass(frozen=True)
class ProfileDriftEvent(Event):
    """A swept profile cell no longer reproduces its recorded geometry."""

    kind: ClassVar[str] = "profile_drift"

    path: str
    cell: str
    detail: str


@dataclasses.dataclass(frozen=True)
class MeshChangeEvent(Event):
    """The elastic runtime rebuilt the mesh after a topology change.

    ``old_mesh``/``new_mesh`` are ``(axis, size)`` pairs; ``failed_ids``
    are the devices reported lost, ``retired_ids`` the *surviving*
    devices the new mesh could not use (surplus after preserving the TP
    axis -- a partial TP group, or a remainder that does not divide).
    ``step`` is the training step at which the change was observed."""

    kind: ClassVar[str] = "mesh_change"

    old_mesh: tuple
    new_mesh: tuple
    failed_ids: tuple = ()
    retired_ids: tuple = ()
    reason: str = "device_loss"
    step: int = -1


@dataclasses.dataclass(frozen=True)
class ResumeEvent(Event):
    """The elastic runtime resumed training on a (re-built) mesh.

    ``step`` is the checkpoint step training resumes from (0 on a cold
    start with no checkpoint); ``batch_chunks`` the per-DP-group batch
    sizes after ``rebalance_batch``; ``invalidated_plans`` how many
    plan-cache cells keyed to the old mesh were dropped;
    ``spec_fallbacks`` the ``rules.spec_report`` reasons for any batch
    dimension that fell back to replication on the new mesh."""

    kind: ClassVar[str] = "resume"

    step: int
    mesh: tuple
    batch_chunks: tuple = ()
    invalidated_plans: int = 0
    restored: bool = True
    spec_fallbacks: tuple = ()


@dataclasses.dataclass(frozen=True)
class DegradedEvent(Event):
    """The system kept running in a degraded mode instead of failing.

    ``reason`` is one of "straggler" (a step exceeded the straggler
    threshold over the step-time EMA), "transient_retry" (a step raised a
    transient error and was retried with backoff), "surplus_devices"
    (``surviving_mesh`` retired alive devices it could not place), or
    "pool_shrink" (the serving page pool lost capacity and tenants were
    re-admitted via preemption-by-replay)."""

    kind: ClassVar[str] = "degraded"

    reason: str
    detail: str = ""
    step: int = -1


EVENT_KINDS: dict[str, type[Event]] = {
    cls.kind: cls
    for cls in (
        PlanEvent,
        SpmdFallbackEvent,
        SpmdOverrideShadowEvent,
        ValidationEvent,
        TrainStepEvent,
        CheckpointEvent,
        AdmissionEvent,
        BatcherTickEvent,
        PagePoolEvent,
        PreemptionEvent,
        RequestAbandonedEvent,
        ProfileDriftEvent,
        MeshChangeEvent,
        ResumeEvent,
        DegradedEvent,
    )
}
