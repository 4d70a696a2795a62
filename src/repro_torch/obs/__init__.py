"""Observability bus: streaming planner provenance, SPMD comm health, and
trainer/serving metrics.

Counterpart of ``repro.obs``:

    from repro_torch import obs

    with obs.session(obs.JsonlSink("run.jsonl")):
        trainer.train(...)      # plan-cache, fallback, step events stream

    python -m repro_torch.obs.report run.jsonl

Typed events (``obs.events``) are emitted at the seams of the launch path
(``api.dispatch``, ``api.spmd``), the trainer and the batcher, and
delivered to pluggable sinks (``obs.sinks``) through an ambient nestable
session (``obs.bus``) that mirrors ``api.plan_context``.  The default
sink is a ``NullSink`` and producers gate on ``obs.enabled()``, so an
uninstrumented process pays nothing.  On a mesh of ranks only rank 0
streams (``obs.bus``).  The records are the reference's, so
``repro.obs.report`` and ``repro_torch.obs.report`` read each other's
streams.
"""
from repro_torch.obs.bus import (
    current_sinks,
    emit,
    enabled,
    reset_default_sinks,
    session,
    set_default_sinks,
)
from repro_torch.obs.events import (
    EVENT_KINDS,
    AdmissionEvent,
    BatcherTickEvent,
    CheckpointEvent,
    DegradedEvent,
    Event,
    MeshChangeEvent,
    PagePoolEvent,
    PlanEvent,
    PreemptionEvent,
    ProfileDriftEvent,
    RequestAbandonedEvent,
    ResumeEvent,
    SpmdFallbackEvent,
    SpmdOverrideShadowEvent,
    TrainStepEvent,
    ValidationEvent,
)
from repro_torch.obs.sinks import (
    JsonlSink,
    LoggingSink,
    NullSink,
    RingBufferSink,
    Sink,
)

__all__ = [
    "session", "emit", "enabled", "current_sinks",
    "set_default_sinks", "reset_default_sinks",
    "Sink", "NullSink", "RingBufferSink", "JsonlSink", "LoggingSink",
    "Event", "PlanEvent", "SpmdFallbackEvent", "SpmdOverrideShadowEvent",
    "ValidationEvent", "TrainStepEvent", "CheckpointEvent",
    "AdmissionEvent", "BatcherTickEvent", "PagePoolEvent",
    "PreemptionEvent", "RequestAbandonedEvent", "ProfileDriftEvent",
    "MeshChangeEvent", "ResumeEvent", "DegradedEvent",
    "EVENT_KINDS",
]
