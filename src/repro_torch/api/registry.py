"""Declarative kernel registry: one place where every kernel family lives.

Counterpart of ``repro.api.registry``.  Each family registers itself with

    @register_kernel("stream.triad",
                     signature=StreamSignature(n_read=2, n_write=1),
                     ref=sref.triad, plan_args=plan_args_1d)
    def _stream_triad(plan, b, c, *, s): ...

declaring, in one spot, what the launch path needs: the stream
``signature`` (pushed into ``core.planner.FAMILIES``, so the planner and the
kernel cannot drift), the plain ``ref`` oracle with ``launch``'s calling
convention, ``plan_args`` (the logical planning shape and dtype of a call)
and the launch body, which takes the resolved ``KernelPlan`` first.

A kernel also declares how it partitions over a mesh
(``partitioning``, an ``api.spmd.Partitioning``) and, when its shards must
talk, the shard body that does it (``spmd_body``, which takes an
``api.spmd.ShardContext`` first).

Entries resolve lazily: ``resolve("jacobi")`` imports
``repro_torch.kernels.jacobi.ops`` on first use.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

from repro_torch.api.spmd import Partitioning
from repro_torch.core import planner as planner_lib
from repro_torch.core.autotune import StreamSignature

# family prefix of a registered name -> module whose import registers it
FAMILY_MODULES: dict[str, str] = {
    "stream": "repro_torch.kernels.stream.ops",
    "triad": "repro_torch.kernels.triad.ops",
    "jacobi": "repro_torch.kernels.jacobi.ops",
    "lbm": "repro_torch.kernels.lbm.ops",
    "rmsnorm": "repro_torch.kernels.rmsnorm.ops",
    "xent": "repro_torch.kernels.xent.ops",
}


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """One registered kernel: analysis + oracle + launch body."""

    name: str
    signature: StreamSignature
    ref: Callable
    plan_args: Callable      # (*arrays, **scalars) -> (shape, dtype)
    body: Callable           # (plan, *arrays, **scalars) -> result
    partitioning: Partitioning | None = None
    spmd_body: Callable | None = None   # (ShardContext, *arrays, **scalars)


_REGISTRY: dict[str, KernelEntry] = {}


def register_kernel(
    name: str,
    *,
    signature: StreamSignature,
    ref: Callable,
    plan_args: Callable,
    partitioning: Partitioning | None = None,
    cta_buffers: int | None = None,
    col_tiled: bool = False,
    spmd_body: Callable | None = None,
):
    """Decorator: declare a kernel family's streams and launch body.

    ``cta_buffers`` and ``col_tiled`` feed the planner's block geometry
    (``core.planner.register_family``).  ``partitioning`` is the SPMD
    placement rule (omitted: replicated under a mesh); ``spmd_body`` the
    kernel-owned shard body for partitionings that communicate, which needs
    a ``partitioning`` to shard anything in the first place.  A name
    registered again by another function raises instead of replacing the
    kernel.
    """

    def deco(body: Callable) -> Callable:
        prev = _REGISTRY.get(name)
        # Same module + qualname = an idempotent re-import; anything else
        # (including a same-named function from another module) is a shadow.
        if prev is not None and (
                prev.body.__module__ != body.__module__
                or prev.body.__qualname__ != body.__qualname__):
            raise ValueError(
                f"kernel {name!r} already registered by "
                f"{prev.body.__module__}.{prev.body.__qualname__}; "
                f"refusing shadow registration"
            )
        if partitioning is not None and not isinstance(partitioning,
                                                       Partitioning):
            raise TypeError(
                f"kernel {name!r}: partitioning must be a Partitioning, "
                f"got {type(partitioning).__name__}"
            )
        if spmd_body is not None and partitioning is None:
            raise TypeError(
                f"kernel {name!r}: spmd_body without a partitioning is "
                f"unreachable -- declare which axes shard first"
            )
        planner_lib.register_family(name, signature, cta_buffers=cta_buffers,
                                    col_tiled=col_tiled)
        _REGISTRY[name] = KernelEntry(
            name=name,
            signature=signature,
            ref=ref,
            plan_args=plan_args,
            body=body,
            partitioning=partitioning,
            spmd_body=spmd_body,
        )
        return body

    return deco


def resolve(name: str) -> KernelEntry:
    """Entry for ``name``, importing its family module on first use."""
    entry = _REGISTRY.get(name)
    if entry is not None:
        return entry
    module = FAMILY_MODULES.get(name.split(".")[0])
    if module is not None:
        importlib.import_module(module)
        entry = _REGISTRY.get(name)
        if entry is not None:
            return entry
    raise KeyError(
        f"no kernel registered as {name!r}; known: {sorted(_REGISTRY)}"
        f" (families: {sorted(FAMILY_MODULES)})"
    )


def list_kernels() -> list[str]:
    """Sorted names of every registered kernel, after importing every
    family module."""
    for module in FAMILY_MODULES.values():
        importlib.import_module(module)
    return sorted(_REGISTRY)
