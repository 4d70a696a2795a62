"""Jacobi: registry entry + multi-sweep loop.

Counterpart of ``repro.kernels.jacobi.ops`` (single device).  The planner
lays the grid out: columns padded to the vector unit, so the row pitch
keeps every row 16-B aligned, and the interior rows cut into blocks of rows
per CTA.  The TPU reference pads the whole grid and builds three shifted
row views on every sweep; the port keeps the grid in a pitched buffer and
the kernel reads its neighbours in place.

``jacobi_sweeps`` allocates two pitched buffers once and ping-pongs them:
each sweep overwrites the buffer the previous sweep read.  The caller's
tensor is copied in first and never written.
"""
from __future__ import annotations

import torch

from repro_torch.api import dispatch
from repro_torch.api.registry import register_kernel
from repro_torch.api.spmd import Partitioning, halo_body_pending
from repro_torch.core.autotune import StreamSignature
from repro_torch.core.planner import KernelPlan
from repro_torch.kernels.jacobi import kernel, ref
from repro_torch.kernels.util import resolve_device


def _plan_args(src, **_scalars):
    """Jacobi plans on its *interior* rows (boundaries are copied through)."""
    if src.ndim != 2 or min(src.shape) < 2:
        raise ValueError(
            f"jacobi needs an (N, M) grid with N, M >= 2, got {tuple(src.shape)}")
    n, m = src.shape
    return (n - 2, m), src.dtype


def pitched(src: torch.Tensor, plan: KernelPlan) -> torch.Tensor:
    """A copy of the (N, M) grid in an (N, width) buffer at the plan's row
    pitch; the padding columns are zero."""
    n, m = src.shape
    buf = src.new_zeros((n, plan.width))
    buf[:, :m] = src
    return buf


@register_kernel("jacobi", signature=StreamSignature(n_read=1, n_write=1),
                 ref=ref.jacobi_step, plan_args=_plan_args,
                 cta_buffers=4,
                 # the stencil couples neighbouring rows: the row split
                 # needs a one-row halo exchange (not ported: a launch over
                 # a mesh raises)
                 partitioning=Partitioning(in_axes=(("batch", None),),
                                           out_axes=("batch", None)),
                 spmd_body=halo_body_pending)
def _launch_jacobi(plan, src):
    """One 5-point sweep on an (N, M) grid (boundaries copied).  A grid
    already at the plan's pitch is read in place; any other is copied into
    a pitched buffer first."""
    n, m = src.shape
    if m == plan.width and src.is_contiguous():
        grid = src
    else:
        grid = pitched(src, plan)
    out = kernel.sweep(grid, torch.empty_like(grid), n_cols=m,
                       brows=plan.block_rows)
    return out[:, :m]


def jacobi_sweeps(src: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` sweeps with the plan resolved once, ping-ponging two
    pitched buffers (see the module doc)."""
    n, m = src.shape
    plan = dispatch.plan_for("jacobi", _plan_args(src)[0], src.dtype)
    a = pitched(src, plan)
    if iters <= 0:
        return a[:, :m]
    b = torch.empty_like(a)
    for _ in range(iters):
        kernel.sweep(a, b, n_cols=m, brows=plan.block_rows)
        a, b = b, a
    return a[:, :m]


def init_grid(n: int, m: int, dtype=torch.float32, *, seed: int = 0,
              device=None) -> torch.Tensor:
    """A uniform [0, 1) (N, M) grid made on ``device`` (CUDA unless named)
    from a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand((n, m), generator=gen, device=dev).to(dtype)


def jacobi_bytes(n: int, m: int, elem_bytes: int = 8, *, rfo: bool = True) -> int:
    """Per-sweep traffic when two rows fit in cache: read each source
    row once, write each destination row (+RFO) -- 4 (6) B/flop."""
    sites = (n - 2) * (m - 2)
    return (3 if rfo else 2) * sites * elem_bytes


def jacobi_flops(n: int, m: int) -> int:
    return 4 * (n - 2) * (m - 2)


def mlups(n: int, m: int, seconds: float, iters: int = 1) -> float:
    return (n - 2) * (m - 2) * iters / seconds / 1e6
