"""Serving: continuous batching over the decode path.

``ContinuousBatcher`` streams ragged requests through a fixed slot batch;
``kv_cache="paged"`` swaps the dense KV slab for the planner-sized page
pool (``serving.paged_cache``) with admission backpressure, chunked
prefill and decode-priority preemption.
"""
from repro_torch.serving.paged_cache import (
    DEFAULT_PAGE_SMEM,
    PageManager,
    plan_page_geometry,
)
from repro_torch.serving.scheduler import ContinuousBatcher, Request, TruncatedRun

__all__ = [
    "ContinuousBatcher", "Request", "TruncatedRun",
    "PageManager", "plan_page_geometry", "DEFAULT_PAGE_SMEM",
]
