"""Core: the paper's analytic data-layout optimization on a Hopper machine
model.  Counterpart of ``repro.core`` (the planner, with its mesh-aware and
shard-local plans, and the segmented container)."""
from repro_torch.core.aliasing import InterleavedMemoryModel, Stream, analytic_skews
from repro_torch.core.autotune import LayoutPlan, StreamSignature, plan_streams
from repro_torch.core.layout import (
    LayoutPolicy,
    PaddedDim,
    hopper_limits,
    round_up,
    vector_unit,
)
from repro_torch.core.planner import (
    KernelPlan,
    clear_plan_cache,
    explain,
    invalidate_mesh_plans,
    plan_cache_info,
    plan_kernel,
    register_family,
)
from repro_torch.core.segmented import (
    PageGeometry,
    SegmentedArray,
    seg_map,
    seg_triad,
    split_lengths,
)

__all__ = [
    "InterleavedMemoryModel", "Stream", "analytic_skews",
    "LayoutPlan", "StreamSignature", "plan_streams",
    "LayoutPolicy", "PaddedDim", "hopper_limits", "round_up", "vector_unit",
    "KernelPlan", "plan_kernel", "plan_cache_info", "clear_plan_cache",
    "explain", "register_family", "invalidate_mesh_plans",
    "SegmentedArray", "PageGeometry", "seg_map", "seg_triad", "split_lengths",
]
