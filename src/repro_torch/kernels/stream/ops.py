"""STREAM kernels as registry entries (1-D API).

Counterpart of ``repro.kernels.stream.ops``.  Each kernel declares its
stream signature, oracle and launch body via ``@register_kernel``;
``repro_torch.api.launch`` resolves the plan (padded 2-D shape, rows per
CTA) under the ambient ``PlanContext`` and calls the body.
``bytes_moved`` reports STREAM-convention traffic (no RFO) and
``bytes_moved_rfo`` the traffic with a read for ownership on the store,
mirroring the paper's 4/3 remark.
"""
from __future__ import annotations

import torch

from repro_torch.api.registry import register_kernel
from repro_torch.api.spmd import Partitioning
from repro_torch.core.autotune import StreamSignature
from repro_torch.kernels.stream import kernel, ref
from repro_torch.kernels.util import (
    from_tiles,
    plan_args_1d,
    resolve_device,
    to_tiles,
)


# 1-D streams are batch-parallel: each device would run its own slice.
def _elementwise_1d(n: int) -> Partitioning:
    return Partitioning(in_axes=(("batch",),) * n, out_axes=("batch",))


@register_kernel("stream.copy", signature=StreamSignature(n_read=1, n_write=1),
                 ref=ref.copy, plan_args=plan_args_1d,
                 partitioning=_elementwise_1d(1))
def _launch_copy(plan, a):
    """C = A, streamed as whole warp-wide vector spans."""
    a2, n = to_tiles(a, plan)
    return from_tiles(kernel.copy2d(a2, brows=plan.block_rows), n)


@register_kernel("stream.scale",
                 signature=StreamSignature(n_read=1, n_write=1),
                 ref=lambda c, *, s: ref.scale(c, s), plan_args=plan_args_1d,
                 partitioning=_elementwise_1d(1))
def _launch_scale(plan, c, *, s):
    """B = s * C."""
    c2, n = to_tiles(c, plan)
    return from_tiles(kernel.scale2d(c2, s, brows=plan.block_rows), n)


@register_kernel("stream.add", signature=StreamSignature(n_read=2, n_write=1),
                 ref=ref.add, plan_args=plan_args_1d,
                 partitioning=_elementwise_1d(2))
def _launch_add(plan, a, b):
    """C = A + B."""
    a2, n = to_tiles(a, plan)
    b2, _ = to_tiles(b, plan)
    return from_tiles(kernel.add2d(a2, b2, brows=plan.block_rows), n)


@register_kernel("stream.triad",
                 signature=StreamSignature(n_read=2, n_write=1),
                 ref=lambda b, c, *, s: ref.triad(b, c, s),
                 plan_args=plan_args_1d,
                 partitioning=_elementwise_1d(2))
def _launch_triad(plan, b, c, *, s):
    """A = B + s * C (the paper's bandwidth headline)."""
    b2, n = to_tiles(b, plan)
    c2, _ = to_tiles(c, plan)
    return from_tiles(kernel.triad2d(b2, c2, s, brows=plan.block_rows), n)


def random_vectors(n: int, count: int, dtype=torch.float32, *, seed: int = 0,
                   device=None) -> list[torch.Tensor]:
    """``count`` standard-normal vectors of length ``n``, made on
    ``device`` (CUDA unless named) from a ``torch.Generator`` seeded with
    ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(n, generator=gen, device=dev).to(dtype)
            for _ in range(count)]


def bytes_moved(op: str, n: int, elem_bytes: int = 8) -> int:
    """STREAM-reported bytes (store not counted as RFO read)."""
    streams = {"copy": 2, "scale": 2, "add": 3, "triad": 3}[op]
    return streams * n * elem_bytes


def bytes_moved_rfo(op: str, n: int, elem_bytes: int = 8) -> int:
    """Traffic including read-for-ownership on the store stream."""
    streams = {"copy": 3, "scale": 3, "add": 4, "triad": 4}[op]
    return streams * n * elem_bytes
