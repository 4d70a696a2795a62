"""PlanContext: the ambient layout policy every kernel launch plans under.

Counterpart of ``repro.api.context``.  The paper's lesson (SS2.3) is that
layout parameters must be global: one address->resource analysis governs
every loop kernel.  ``plan_context`` sets that policy for a scope:

    with plan_context(smem_budget=96 * 1024):
        api.launch("triad", b, c, d)

    with plan_context(mesh=mesh):     # a launch.mesh.Mesh of ranks
        trainer.train()               # every launch routes over the mesh

Contexts nest; inner contexts inherit every field they do not override
(``plan_overrides`` merge, inner wins).  The context is thread-local, and a
process-wide default serves the outermost level.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Mapping

from repro_torch.core.planner import KernelPlan

_UNSET = object()


@dataclasses.dataclass(frozen=True)
class PlanContext:
    """Everything the planner needs beyond (kernel, shape, dtype).

    smem_budget:
        per-CTA shared-memory bytes the block chooser may assume; ``None``
        reads the current CUDA device (the H100 data sheet without one).
    sm_count:
        SMs the grid must fill; ``None`` reads the device likewise.
    model:
        the conflict model (``InterleavedMemoryModel``) scoring skews;
        ``None`` uses the planner default.
    plan_overrides:
        pinned plans, keyed by bare kernel name or by ``(kernel, shape,
        dtype)`` cell (the cell key wins).  A pin applies only at its
        plan's exact logical shape and dtype; other launches of the same
        kernel fall through to the planner.
    mesh:
        a ``launch.mesh.Mesh`` of ranks, an ``{axis: size}`` mapping, or
        ``(axis, size)`` pairs.  It keys the plan cache and widens the
        minor-dim padding of global plans over the model axis; only a
        ``Mesh`` of more than one rank routes launches through the SPMD
        path (``api.spmd``).  ``None`` plans for one device.
    spmd:
        whether ``launch`` may route over such a mesh;
        ``plan_context(spmd=False)`` keeps the mesh for planning and forces
        every launch in the scope to stay on the rank's own data.
    """

    smem_budget: int | None = None
    sm_count: int | None = None
    model: Any = None
    plan_overrides: Mapping[Any, KernelPlan] = dataclasses.field(
        default_factory=dict
    )
    mesh: Any = None
    spmd: bool = True

    def evolve(self, **changes) -> "PlanContext":
        """Derived context: fields passed as ``_UNSET`` keep this context's
        value; ``plan_overrides`` merge with the new mapping winning, and an
        explicit ``plan_overrides=None`` clears every inherited pin."""
        unknown = set(changes) - {f.name for f in dataclasses.fields(self)}
        if unknown:
            raise TypeError(f"unknown PlanContext fields: {sorted(unknown)}")
        kw = {}
        for f in dataclasses.fields(self):
            v = changes.get(f.name, _UNSET)
            if v is _UNSET:
                kw[f.name] = getattr(self, f.name)
            elif f.name == "plan_overrides":
                kw[f.name] = {} if v is None else {**self.plan_overrides,
                                                   **dict(v)}
            else:
                kw[f.name] = v
        return PlanContext(**kw)


_default = PlanContext()
_tls = threading.local()


def _stack() -> list[PlanContext]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_context() -> PlanContext:
    """The innermost active ``plan_context``, else the process default."""
    st = _stack()
    return st[-1] if st else _default


@contextlib.contextmanager
def use_context(ctx: PlanContext):
    """Enter ``ctx`` itself (a context captured on another thread, as an
    autograd backward re-enters its forward's)."""
    st = _stack()
    st.append(ctx)
    try:
        yield ctx
    finally:
        st.pop()


@contextlib.contextmanager
def plan_context(mesh=_UNSET, *, smem_budget=_UNSET, sm_count=_UNSET,
                 model=_UNSET, plan_overrides=_UNSET, spmd=_UNSET):
    """Enter a derived ``PlanContext``; unspecified fields inherit from the
    enclosing context (or the process default at the outermost level)."""
    ctx = current_context().evolve(
        mesh=mesh, smem_budget=smem_budget, sm_count=sm_count, model=model,
        plan_overrides=plan_overrides, spmd=spmd)
    st = _stack()
    st.append(ctx)
    try:
        yield ctx
    finally:
        st.pop()
