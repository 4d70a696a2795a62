"""The kernel-launch path: ``launch(kernel, *tensors, **scalars)``.

Counterpart of ``repro.api.dispatch`` (single-device path).

    from repro_torch import api
    a = api.launch("stream.triad", b, c, s=3.0)

``launch`` resolves the registered entry (lazily importing its family),
derives the logical planning shape from the tensors, asks the analytic
planner for the memoized ``KernelPlan`` under the ambient ``PlanContext``,
checks that the plan agrees with the tensors, and hands both to the
registered body.  Every family therefore plans through one policy.
"""
from __future__ import annotations

from repro_torch.api import context as context_lib
from repro_torch.api import registry as registry_lib
from repro_torch.core.planner import KernelPlan, dtype_name, plan_kernel

__all__ = ["launch", "plan_for", "plan_tile", "explain", "ref"]


def plan_for(kernel: str, shape, dtype, *, ctx=None) -> KernelPlan:
    """The plan ``launch`` would use for ``kernel`` on (shape, dtype) under
    the ambient (or given) ``PlanContext``.  Unknown kernels fail here."""
    entry = registry_lib.resolve(kernel)
    ctx = ctx or context_lib.current_context()
    # A (kernel, shape, dtype) cell key wins over a bare kernel-name pin.
    cell = (entry.name, tuple(int(s) for s in shape), dtype_name(dtype))
    override = ctx.plan_overrides.get(cell)
    if override is None:
        override = ctx.plan_overrides.get(entry.name)
    if override is not None and _matches(entry, override, shape, dtype):
        return override
    return plan_kernel(
        entry.name, shape, dtype,
        model=ctx.model,
        smem_budget=ctx.smem_budget,
        sm_count=ctx.sm_count,
    )


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


def launch(kernel: str, *tensors, plan: KernelPlan | None = None, **scalars):
    """Run a registered kernel on ``tensors`` under the ambient PlanContext.

    ``plan`` pins an explicit ``KernelPlan`` (still validated); otherwise
    the context's ``plan_overrides`` and then the memoized planner decide.
    Scalars pass through as keywords to the registered body."""
    entry = registry_lib.resolve(kernel)
    shape, dtype = entry.plan_args(*tensors, **scalars)
    if plan is None:
        plan = plan_for(kernel, shape, dtype)
    _validate(entry, plan, shape, dtype)
    return entry.body(plan, *tensors, **scalars)


def ref(kernel: str, *tensors, **scalars):
    """The registered plain oracle, same calling convention as launch."""
    return registry_lib.resolve(kernel).ref(*tensors, **scalars)


def explain(kernel: str, shape, dtype) -> str:
    """Human-readable plan report for any registered kernel under the
    ambient context."""
    return plan_for(kernel, shape, dtype).explain()
