"""Pluggable event sinks: where the observability bus delivers events.

Counterpart of ``repro.obs.sinks``.  A sink is anything with
``emit(event)`` (and optionally ``close()``).  Shipped sinks:

  * ``NullSink``       -- drops everything; the process default.  The bus
                          treats a scope whose sinks are all NullSinks as
                          *disabled*, so instrumentation sites skip event
                          construction entirely (zero-cost default).
  * ``RingBufferSink`` -- last-N events in memory, with per-kind counts;
                          what tests and in-process health probes read.
  * ``JsonlSink``      -- one JSON record per line (``Event.to_record``),
                          the stream ``python -m repro_torch.obs.report``
                          aggregates.
  * ``LoggingSink``    -- renders each event onto a stdlib logger.

Sinks must never raise into the instrumented hot path: the bus catches
and logs a failing sink (``repro_torch.obs.bus``), but a sink that can
fail routinely (disk full) should handle its own errors too.
"""
from __future__ import annotations

import collections
import json
import logging
import threading
from typing import IO

__all__ = ["Sink", "NullSink", "RingBufferSink", "JsonlSink", "LoggingSink"]


class Sink:
    """Base sink: subclass and override :meth:`emit`."""

    def emit(self, event) -> None:
        raise NotImplementedError

    def close(self) -> None:
        """Release resources; further emits are undefined."""

    def __enter__(self) -> "Sink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NullSink(Sink):
    """Drops every event.  Scopes whose sinks are all NullSinks count as
    disabled (``bus.enabled()`` is False), so producers never even build
    the event -- the zero-cost default the launch path relies on."""

    def emit(self, event) -> None:
        pass


class RingBufferSink(Sink):
    """Keeps the last ``capacity`` events in memory.

    Thread-safe; ``events()`` snapshots the buffer and ``counts()``
    returns ``{kind: n}`` over everything ever emitted (not just what is
    still buffered), so hit-rate style assertions survive wraparound.
    """

    def __init__(self, capacity: int = 4096):
        self._buf: collections.deque = collections.deque(maxlen=int(capacity))
        self._counts: collections.Counter = collections.Counter()
        self._lock = threading.Lock()

    def emit(self, event) -> None:
        with self._lock:
            self._buf.append(event)
            self._counts[event.kind] += 1

    def events(self, kind: str | None = None) -> list:
        with self._lock:
            evs = list(self._buf)
        return evs if kind is None else [e for e in evs if e.kind == kind]

    def counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def __len__(self) -> int:
        return len(self._buf)


class JsonlSink(Sink):
    """Appends one JSON record per event to ``path`` (or a file object).

    The format is one ``Event.to_record()`` dict per line -- exactly what
    ``python -m repro_torch.obs.report`` consumes.  The file opens lazily
    on the first emit (constructing the sink never touches the filesystem)
    and flushes per record so a crashed run still leaves a usable stream.
    """

    def __init__(self, path_or_file, *, append: bool = False):
        if hasattr(path_or_file, "write"):
            self._file: IO | None = path_or_file
            self._owns = False
            self._path = None
        else:
            self._file = None
            self._owns = True
            self._path = str(path_or_file)
        self._append = append
        self._lock = threading.Lock()
        self.emitted = 0

    def _open(self) -> IO:
        if self._file is None:
            self._file = open(self._path, "a" if self._append else "w")
        return self._file

    def emit(self, event) -> None:
        line = json.dumps(event.to_record())
        with self._lock:
            f = self._open()
            f.write(line + "\n")
            f.flush()
            self.emitted += 1

    def close(self) -> None:
        with self._lock:
            if self._file is not None and self._owns:
                self._file.close()
                self._file = None


class LoggingSink(Sink):
    """Renders each event onto a stdlib logger (default
    ``repro_torch.obs.events`` at INFO)."""

    def __init__(self, logger: logging.Logger | str | None = None,
                 level: int = logging.INFO):
        if logger is None:
            logger = logging.getLogger("repro_torch.obs.events")
        elif isinstance(logger, str):
            logger = logging.getLogger(logger)
        self._log = logger
        self._level = level

    def emit(self, event) -> None:
        rec = event.to_record()
        kind = rec.pop("kind")
        rec.pop("ts", None)
        self._log.log(self._level, "%s %s", kind,
                      " ".join(f"{k}={v}" for k, v in rec.items()))
