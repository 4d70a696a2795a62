"""The event bus: an ambient, nestable sink scope mirroring PlanContext.

Counterpart of ``repro.obs.bus``.  Instrumented code (the launch path, the
trainer, the batcher) never holds a sink; it asks the *ambient* bus:

    from repro_torch.obs import bus, events

    if bus.enabled():
        bus.emit(events.PlanEvent(...))

and callers decide where events go by entering a session:

    with obs.session(obs.JsonlSink("run.jsonl")):
        trainer.train(...)        # every event inside streams to the file

Sessions nest exactly like ``api.plan_context``: an inner session
*inherits* the enclosing scope's sinks and adds its own (an inner ring
buffer observes without detaching the outer JSONL stream); pass
``inherit=False`` to isolate a scope, and ``session(NullSink(),
inherit=False)`` silences one explicitly.  The stack is thread-local --
concurrent serving threads can stream to different sinks -- and a
process-wide default (``set_default_sinks``) serves launchers that
configure the stream once at startup.

The default is a single ``NullSink``: ``enabled()`` is False, so every
instrumentation site skips event construction entirely.  That guard is
the subsystem's zero-overhead contract -- tests count sink calls under
the default and assert zero (tests/test_torch_obs.py).

On a mesh of ranks every rank is a process of its own
(``launch.mesh.spawn``), with its own bus: a session entered in the
parent does not reach the ranks.  The launchers open a sink on rank 0
only (``launch.train --obs-jsonl``); every other rank keeps the NullSink
default and pays nothing.  All ranks run one host schedule, so rank 0's
batcher and trainer events are the run's.
"""
from __future__ import annotations

import contextlib
import logging
import threading

from repro_torch.obs.sinks import NullSink, Sink

__all__ = [
    "enabled",
    "emit",
    "session",
    "current_sinks",
    "set_default_sinks",
    "reset_default_sinks",
]

_log = logging.getLogger("repro_torch.obs")

_NULL = NullSink()
_DEFAULT_LOCK = threading.Lock()
_default_sinks: tuple[Sink, ...] = (_NULL,)
_tls = threading.local()


def _stack() -> list[tuple[Sink, ...]]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_sinks() -> tuple[Sink, ...]:
    """The sinks an ``emit`` in this thread would deliver to right now."""
    st = _stack()
    return st[-1] if st else _default_sinks


def enabled() -> bool:
    """True when any active sink actually listens (is not a NullSink).

    Producers gate on this before *building* an event, so the default
    (NullSink-only) configuration costs one tuple scan and nothing else.
    """
    return any(not isinstance(s, NullSink) for s in current_sinks())


def emit(event) -> None:
    """Deliver ``event`` to every active sink.

    A failing sink is logged and skipped -- observability must never take
    down the training step or the serving tick it observes.
    """
    for sink in current_sinks():
        try:
            sink.emit(event)
        except Exception:  # noqa: BLE001 -- a sink must not kill the host
            _log.exception("obs sink %r failed; event dropped",
                           type(sink).__name__)


def set_default_sinks(*sinks: Sink) -> None:
    """Install the process-wide default sinks (what threads with no active
    session emit to).  Launchers call this once at startup; no sinks
    restores the built-in NullSink default."""
    global _default_sinks
    for s in sinks:
        if not hasattr(s, "emit"):
            raise TypeError(f"not a sink (no emit): {type(s).__name__}")
    with _DEFAULT_LOCK:
        _default_sinks = tuple(sinks) if sinks else (_NULL,)


def reset_default_sinks() -> None:
    """Restore the built-in NullSink default (tests)."""
    set_default_sinks()


@contextlib.contextmanager
def session(*sinks: Sink, inherit: bool = True):
    """Enter an observability scope delivering to ``sinks``.

    With ``inherit=True`` (default) the scope *adds* its sinks to the
    enclosing scope's -- nesting a ring buffer inside a JSONL session
    delivers every event to both, mirroring ``plan_context``'s
    field-inheritance semantics.  ``inherit=False`` makes ``sinks`` the
    whole scope.  Yields the active sink tuple.
    """
    for s in sinks:
        if not hasattr(s, "emit"):
            raise TypeError(f"not a sink (no emit): {type(s).__name__}")
    base = current_sinks() if inherit else ()
    # Inherited NullSinks are dropped: they carry no behavior, and keeping
    # them would make an enabled() scan linger over dead entries.
    active = tuple(s for s in base if not isinstance(s, NullSink)) + sinks
    if not active:
        active = (_NULL,)
    st = _stack()
    st.append(active)
    try:
        yield active
    finally:
        st.pop()
