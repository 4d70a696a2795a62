"""The kernel-launch path: ``launch(kernel, *tensors, **scalars)``.

Counterpart of ``repro.api.dispatch``.

    from repro_torch import api
    a = api.launch("stream.triad", b, c, s=3.0)

``launch`` resolves the registered entry (lazily importing its family),
derives the logical planning shape from the tensors, asks the analytic
planner for the memoized ``KernelPlan`` under the ambient ``PlanContext``,
checks that the plan agrees with the tensors, and hands both to the
registered body.  Every family therefore plans through one policy.

When the ambient mesh is a ``launch.mesh.Mesh`` of more than one rank,
``launch`` routes through the SPMD path instead (``api.spmd``): the tensors
are this rank's shards, the kernel's ``Partitioning`` says how they were cut,
and each rank plans its own local shape.  Single-rank programs, and scopes
under ``plan_context(spmd=False)``, keep the direct path.

Under an ``obs`` session ``plan_for`` emits a ``PlanEvent`` a resolution
(hit, miss or override) and a shadowed override an
``SpmdOverrideShadowEvent`` each time; the port is eager, so every launch
resolves its plan and streams one ``PlanEvent`` (the reference plans at
trace time).
"""
from __future__ import annotations

import warnings

import torch

from repro_torch.api import context as context_lib
from repro_torch.api import registry as registry_lib
from repro_torch.api import spmd as spmd_lib
from repro_torch.core.planner import (
    KernelPlan,
    dtype_name,
    plan_cache_info,
    plan_kernel,
)
from repro_torch.obs import bus as obs_bus
from repro_torch.obs import events as obs_events

__all__ = ["launch", "plan_for", "plan_tile", "explain", "ref"]


def plan_for(kernel: str, shape, dtype, *, ctx=None,
             local: bool = False) -> KernelPlan:
    """The plan ``launch`` would use for ``kernel`` on (shape, dtype) under
    the ambient (or given) ``PlanContext``.  Unknown kernels fail here.

    ``local=True`` plans one rank's launch on the SPMD path: the shape is
    the rank's shard, so the minor dim is not widened again for the mesh's
    model axis; the mesh still keys the memo entry."""
    entry = registry_lib.resolve(kernel)
    ctx = ctx or context_lib.current_context()
    # A (kernel, shape, dtype) cell key wins over a bare kernel-name pin.
    cell = (entry.name, tuple(int(s) for s in shape), dtype_name(dtype))
    override = ctx.plan_overrides.get(cell)
    if override is None:
        override = ctx.plan_overrides.get(entry.name)
    if override is not None and _matches(entry, override, shape, dtype):
        if obs_bus.enabled():
            obs_bus.emit(obs_events.PlanEvent(
                kernel=entry.name, shape=tuple(override.logical_shape),
                dtype=override.dtype, cache="override",
                source=override.provenance, local=bool(local),
                mesh=tuple(override.mesh)))
        return override
    # An observed plan was a miss when the memo's miss counter moved
    # across the call (the cache is process-global: telemetry, not
    # accounting, if threads plan at once).
    track = obs_bus.enabled()
    misses_before = plan_cache_info()["misses"] if track else 0
    plan = plan_kernel(
        entry.name, shape, dtype,
        mesh=ctx.mesh,
        model=ctx.model,
        smem_budget=ctx.smem_budget,
        sm_count=ctx.sm_count,
        local=local,
    )
    if track:
        cache = ("miss" if plan_cache_info()["misses"] > misses_before
                 else "hit")
        obs_bus.emit(obs_events.PlanEvent(
            kernel=entry.name, shape=tuple(plan.logical_shape),
            dtype=plan.dtype, cache=cache, source=plan.provenance,
            local=bool(local), mesh=tuple(plan.mesh)))
    return plan


def plan_tile(kernel: str, shape, dtype, *, smem_budget: int | None = None,
              ctx=None) -> KernelPlan:
    """Tile-size plan query: the plan of ``kernel`` over ``shape`` with an
    explicit per-tile ``smem_budget`` layered onto the ambient (or given)
    context.  The serving paged KV cache sizes its pages from the returned
    plan's ``block_rows`` (``serving.paged_cache.plan_page_geometry``), so
    cache pages and kernel blocks follow one layout policy.

    A tile is sized by its budget, not by a grid: the query plans for one
    SM, so the planner's fill rule (``layout.CTAS_PER_SM`` CTAs on every SM)
    does not cut the tile down to a row.  The reference's TPU planner has
    no fill rule either (its grid runs in order on one core), and there the
    same query takes ``vmem_budget``."""
    ctx = ctx or context_lib.current_context()
    ctx = ctx.evolve(sm_count=1)
    if smem_budget is not None:
        ctx = ctx.evolve(smem_budget=int(smem_budget))
    return plan_for(kernel, shape, dtype, ctx=ctx)


def _matches(entry, plan: KernelPlan, shape, dtype) -> bool:
    return (plan.kernel == entry.name
            and tuple(plan.logical_shape) == tuple(int(s) for s in shape)
            and plan.dtype == dtype_name(dtype))


def _validate(entry, plan: KernelPlan, shape, dtype) -> None:
    """Plan <-> tensor agreement: a stale or hand-built plan must never
    silently drop tail elements or run a kernel at the wrong dtype."""
    if plan.kernel != entry.name:
        raise ValueError(
            f"plan is for kernel {plan.kernel!r}, launched {entry.name!r}"
        )
    if tuple(plan.logical_shape) != tuple(int(s) for s in shape):
        raise ValueError(
            f"plan {plan.kernel} is for shape {plan.logical_shape}, "
            f"got tensors of logical shape {tuple(shape)}"
        )
    if plan.dtype != dtype_name(dtype):
        raise ValueError(
            f"plan {plan.kernel} is for dtype {plan.dtype}, "
            f"got {dtype_name(dtype)}"
        )


def launch(kernel: str, *tensors, plan: KernelPlan | None = None,
           global_shapes=None, **scalars):
    """Run a registered kernel on ``tensors`` under the ambient PlanContext.

    Under an ambient mesh of ranks (and no pinned ``plan``) the tensors are
    this rank's shards and the launch partitions over the mesh by the
    kernel's ``Partitioning`` (``api.spmd.spmd_launch``); ``global_shapes``
    gives the global extents the shards were cut from where the rank
    cannot infer them (one tuple an operand, ``None`` for an extent to
    infer).  Otherwise ``plan`` pins an explicit ``KernelPlan`` (still
    validated), else the context's ``plan_overrides`` and then the memoized
    planner decide.  Scalars pass through as keywords to the registered
    body."""
    entry = registry_lib.resolve(kernel)
    if plan is None:
        mesh = spmd_lib.spmd_mesh()
        if mesh is not None:
            _warn_spmd_shadowed_overrides(entry, mesh, tensors, scalars,
                                          global_shapes)
            return spmd_lib.spmd_launch(entry, mesh, tensors, scalars,
                                        global_shapes)
    shape, dtype = entry.plan_args(*tensors, **scalars)
    if plan is None:
        plan = plan_for(kernel, shape, dtype)
    _validate(entry, plan, shape, dtype)
    return entry.body(plan, *tensors, **scalars)


_SPMD_OVERRIDE_WARNED: set[tuple] = set()


def _warn_spmd_shadowed_overrides(entry, mesh, tensors, scalars,
                                  global_shapes=None) -> None:
    """Under the SPMD route plans resolve against each rank's *local*
    shape, so a pin keyed at the global shape never matches.  Say so once
    per (kernel, mesh), naming the offending cells; pins keyed at any other
    shape are taken for per-shard cells and do not warn.  The global shape
    comes from the shards as ``spmd_launch`` derives it."""
    ctx = context_lib.current_context()
    keys = [k for k in ctx.plan_overrides
            if k == entry.name
            or (isinstance(k, tuple) and k and k[0] == entry.name)]
    if not keys:
        return
    part = spmd_lib.partitioning_for(entry, len(tensors))
    *_, shapes = spmd_lib.shard_specs(mesh, part.in_axes, tensors,
                                      global_shapes)
    gshape = tuple(int(s) for s in entry.plan_args(
        *(torch.empty(s, dtype=t.dtype, device="meta")
          for t, s in zip(tensors, shapes)), **scalars)[0])
    offending = sorted(
        str(k) for k in keys
        if (tuple(ctx.plan_overrides[k].logical_shape) == gshape
            if k == entry.name else tuple(k[1]) == gshape))
    if not offending:
        return
    if obs_bus.enabled():
        # every occurrence emits; only the warning below fires once
        obs_bus.emit(obs_events.SpmdOverrideShadowEvent(
            kernel=entry.name,
            mesh=tuple(zip(tuple(mesh.axis_names), tuple(mesh.shape))),
            global_shape=gshape, cells=tuple(offending)))
    mesh_key = (entry.name, tuple(mesh.axis_names), tuple(mesh.shape))
    if mesh_key in _SPMD_OVERRIDE_WARNED:
        return
    _SPMD_OVERRIDE_WARNED.add(mesh_key)
    warnings.warn(
        f"plan override(s) for {entry.name!r} under SPMD mesh "
        f"{mesh.axis_sizes}: overrides are matched against each rank's "
        f"local shapes, and these cell key(s) are keyed at the launch's "
        f"global shape {gshape} -- they stay inert unless a shard's local "
        f"shape coincides with it (offending cell key(s): "
        f"{', '.join(offending)}).  Pin plans at the per-shard shapes on "
        f"SPMD runs", RuntimeWarning, stacklevel=3)


def ref(kernel: str, *tensors, **scalars):
    """The registered plain oracle, same calling convention as launch."""
    return registry_lib.resolve(kernel).ref(*tensors, **scalars)


def explain(kernel: str, shape, dtype) -> str:
    """Human-readable plan report for any registered kernel under the
    ambient context."""
    return plan_for(kernel, shape, dtype).explain()
