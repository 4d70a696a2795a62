"""Kernel-launch API: registry + PlanContext + one launch path.

    from repro_torch import api

    with api.plan_context(smem_budget=96 * 1024):
        a = api.launch("triad", b, c, d)
        print(api.explain("jacobi", (16382, 16384), "float32"))
"""
from repro_torch.api.context import (
    PlanContext,
    current_context,
    plan_context,
)
from repro_torch.api.spmd import SCALAR, Partitioning, ShardContext, spmd_mesh
from repro_torch.api.dispatch import explain, launch, plan_for, plan_tile, ref
from repro_torch.api.registry import (
    FAMILY_MODULES,
    KernelEntry,
    list_kernels,
    register_kernel,
    resolve,
)

__all__ = [
    "PlanContext", "plan_context", "current_context",
    "launch", "plan_for", "plan_tile", "explain", "ref",
    "register_kernel", "resolve", "list_kernels",
    "KernelEntry", "FAMILY_MODULES", "Partitioning", "SCALAR",
    "ShardContext", "spmd_mesh",
]
