"""Checkpointing: atomic step directories and an async writer.

Counterpart of ``repro.checkpoint.manager`` (one process).  Layout:
``<dir>/step_<N>/shard_0.npz`` + ``meta.json``, written into a ``.tmp0``
directory and renamed on completion, so a crash mid-write never corrupts
the latest checkpoint; restore picks the newest complete step.  A state
tree (nested dicts of tensors) flattens to ``"/"``-joined key paths, the
names the reference's ``_flatten`` gives (``"params/embed"``,
``"opt/m/..."``, ``"opt/step"``), so a checkpoint the JAX package wrote
restores into the port.  bf16 leaves are stored widened to fp32 (exact) and
cast back to the template's dtype on restore.

The device-to-host copy happens on the caller's thread; the file write on
a writer thread whose failure is re-raised from the next ``wait()``,
``save()`` or ``restore_latest()``.

A checkpoint is always in the single-device layout.  On a mesh of ranks the
trainer gathers the shards and one rank writes (``runtime.trainer``); a
restore hands ``cut`` each global array to slice it to the restoring rank's
block, so a checkpoint moves between a mesh and one device either way.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.models.params import leaves

PROCESS = 0   # the shard index of this single-process port


def _key(path: tuple[str, ...]) -> str:
    return "/".join(str(k) for k in path)


def _flatten(tree) -> dict[str, np.ndarray]:
    out = {}
    for path, leaf in leaves(tree):
        t = leaf.detach().to("cpu")
        if t.dtype == torch.bfloat16:   # no numpy bf16: widen, exactly
            t = t.to(torch.float32)
        out[_key(path)] = t.numpy()
    return out


def _unflatten_into(tree, flat: dict[str, np.ndarray], path=(), cut=None):
    """A tree shaped like ``tree`` holding the arrays of ``flat``, each
    cut by ``cut(path, array)`` when given, cast to its template leaf's
    dtype and shape and put on its device.  A leaf the checkpoint lacks
    raises ``KeyError``."""
    out = {}
    for k, v in tree.items():
        p = path + (k,)
        if isinstance(v, dict):
            out[k] = _unflatten_into(v, flat, p, cut)
            continue
        arr = flat[_key(p)]
        if cut is not None:
            arr = cut(p, arr)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        out[k] = t.to(v.dtype).reshape(v.shape).to(v.device)
    return out


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: threading.Thread | None = None
        # A failure on the async writer thread is kept here and re-raised
        # from the next wait()/save() on the caller's thread.
        self._error: BaseException | None = None
        # Called inside _write after the tmp dir is populated and before the
        # atomic rename, so a raising hook leaves exactly the torn state a
        # mid-write crash would.
        self.fault_hook = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, *, meta: dict | None = None) -> None:
        flat = _flatten(state)  # the device-to-host copy, on this thread
        if self.async_write:
            self.wait()  # raises if the previous async write failed
            self._thread = threading.Thread(
                target=self._write_async, args=(step, flat, meta or {}),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, meta or {})

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"async checkpoint write failed: {err!r} (the step was "
                f"never completed; its torn tmp dir is invisible to "
                f"restore)") from err

    def _write_async(self, step: int, flat: dict, meta: dict) -> None:
        try:
            self._write(step, flat, meta)
        except BaseException as e:  # noqa: BLE001 -- re-raised from wait()
            self._error = e

    def _write(self, step: int, flat: dict, meta: dict) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + f".tmp{PROCESS}"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"shard_{PROCESS}.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, **meta}, f)
        if self.fault_hook is not None:
            self.fault_hook(step, tmp)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, *, cut=None) -> Any:
        """Restore into the structure, dtypes, shapes and devices of
        ``like``, each saved array first cut by ``cut(path, array)`` when
        given (a rank's block of the single-device layout)."""
        self.wait()
        path = os.path.join(self.dir, f"step_{step:08d}",
                            f"shard_{PROCESS}.npz")
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        return _unflatten_into(like, flat, cut=cut)

    def restore_latest(self, like: Any, *, cut=None
                       ) -> tuple[int, Any] | None:
        # Settle an in-flight async save first: a save() scheduled before
        # this call must be selectable (the trainer's failure path restores
        # right after saves).
        self.wait()
        step = self.latest_step()
        if step is None:
            return None
        return step, self.restore(step, like, cut=cut)
