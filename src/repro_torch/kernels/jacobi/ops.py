"""Jacobi: registry entry + multi-sweep loop.

Counterpart of ``repro.kernels.jacobi.ops`` (single device).  The planner
lays the grid out: columns padded to the vector unit, so the row pitch
keeps every row 16-B aligned, and the grid cut into 2-D tiles, a strip of
rows by a column tile a CTA.  The TPU reference pads the whole grid and
builds three shifted row views on every sweep; the port keeps the grid in
a pitched buffer and the kernel reads its neighbours in place.

``jacobi_sweeps`` allocates two pitched buffers once and ping-pongs them:
each sweep overwrites the buffer the previous sweep read.  The caller's
tensor is copied in first and never written.

Under a mesh of ranks the grid *rows* shard over the data axis, and each
rank exchanges one-row halos with its neighbours -- the paper's domain
decomposition: each thread's working set stays with its own memory
controller and only the boundary rows travel.  The shard body is
overlapped (the reference's docs/OVERLAP.md): the two halo shifts are
issued first, the kernel sweeps the rank's pitched stripe, whose interior
rows read only rows the rank holds, while they travel, and the two
boundary rows are swept last, each by one launch of the kernel's row entry
that reads the row from the neighbour, the rank's edge row and the one
beside it where they lie and writes the stripe's row in place, with the
interior's arithmetic, so it rounds exactly as the interior does.  The
global edge rows of the first and last rank are copied through: Jacobi's
edges are not periodic.  ``_spmd_jacobi_blocking``, the exchange-then-
compute body, is kept as the parity oracle and as the counter-example
``api.spmd.overlap_report`` classifies as blocking.  ``jacobi_sweeps``
under a mesh keeps two pitched stripes a rank and issues sweep k's halo
before its interior launch.
"""
from __future__ import annotations

import torch

from repro_torch.api import dispatch
from repro_torch.api import spmd as spmd_lib
from repro_torch.api.registry import register_kernel
from repro_torch.api.spmd import Partitioning
from repro_torch.launch.mesh import Arrived
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


def _halo_exchange(ctx, src, row_axes, n_shards, idx):
    """Issue the one-row halo transfers of the (nl, M) logical stripe
    ``src``: my up-neighbour's last row arrives as ``above``, my
    down-neighbour's first row as ``below``; the first and last rank
    receive zeros they never read.  Returns the two transfers.  Where the
    rows shard over more than one mesh axis the edge rows are gathered
    instead, which blocks."""
    if len(row_axes) == 1:
        down = [(i, i + 1) for i in range(n_shards - 1)]
        up = [(i, i - 1) for i in range(1, n_shards)]
        return (ctx.ppermute(src[-1:], row_axes, down),
                ctx.ppermute(src[:1], row_axes, up))
    edges = ctx.all_gather(torch.cat([src[:1], src[-1:]]), row_axes)
    zero = torch.zeros_like(src[:1])
    above = edges[idx - 1, 1:2] if idx > 0 else zero
    below = edges[idx + 1, 0:1] if idx < n_shards - 1 else zero
    return Arrived(above), Arrived(below)


def _slab(parts, width: int, m: int) -> torch.Tensor:
    """The first ``m`` columns of the row blocks ``parts`` stacked into a
    new pitched (rows, width) slab, its padding columns zero."""
    slab = parts[1].new_zeros((sum(p.shape[0] for p in parts), width))
    r = 0
    for p in parts:
        slab[r:r + p.shape[0], :m] = p[:, :m]
        r += p.shape[0]
    return slab


def _sweep_stripe(ctx, a: torch.Tensor, b: torch.Tensor, m: int,
                  plan: KernelPlan, *, overlapped: bool = True) -> None:
    """One sweep of this rank's pitched (nl, width) stripe ``a`` into
    ``b``, exchanging halos over the rows' mesh axes (the module doc)."""
    row_axes = ctx.axes(0, 0)
    n_shards, idx = ctx.size(row_axes), ctx.index(row_axes)
    nl, width = a.shape
    # 1) issue the halo exchange ...
    above, below = _halo_exchange(ctx, a[:, :m], row_axes, n_shards, idx)
    if overlapped and nl > 2:
        # 2) ... sweep the stripe while it travels: its interior rows
        # 1..nl-2 read rows 0..nl-1 only; rows 0 and nl-1 are copied ...
        kernel.sweep(a, b, n_cols=m, block=plan.block_shape)
        # 3) ... and the boundary rows last, the only reads of the halos,
        # each swept in place into the stripe; the global edge rows stay
        # copied
        above, below = above.wait(), below.wait()
        if idx > 0:
            kernel.sweep_row(above[0], a[0], a[1], b[0], n_cols=m)
        if idx < n_shards - 1:
            kernel.sweep_row(a[-2], a[-1], below[0], b[-1], n_cols=m)
        return
    # the stripe waits for both halos: the blocking body, and a stripe of
    # one or two rows, every one of them a boundary row
    ext = _slab([above.wait(), a, below.wait()], width, m)
    b.copy_(kernel.sweep(ext, torch.empty_like(ext), n_cols=m,
                         block=plan.block_shape)[1:-1])
    # the global edge rows pass through
    if idx == 0:
        b[0] = a[0]
    if idx == n_shards - 1:
        b[-1] = a[-1]


def _shard_sweeps(ctx, src: torch.Tensor, iters: int, *,
                  overlapped: bool = True) -> torch.Tensor:
    """``iters`` sweeps of this rank's (nl, M) stripe on two pitched
    buffers; with the rows whole on this rank (a size-1 data axis or a
    divisibility fallback) the one-device sweeps on a local plan."""
    nl, m = src.shape
    if ctx.size(ctx.axes(0, 0)) <= 1:
        plan = dispatch.plan_for("jacobi", _plan_args(src)[0], src.dtype,
                                 local=True)
        return _sweeps(src, iters, plan)
    # the plan cell is the whole stripe, as the planner prices its halo
    plan = dispatch.plan_for("jacobi", (nl, m), src.dtype, local=True)
    a = pitched(src, plan)
    b = torch.empty_like(a)
    for _ in range(iters):
        _sweep_stripe(ctx, a, b, m, plan, overlapped=overlapped)
        a, b = b, a
    return a[:, :m]


def _spmd_jacobi(ctx, src):
    """The overlapped shard body: one sweep of this rank's row stripe."""
    return _shard_sweeps(ctx, src, 1)


def _spmd_jacobi_blocking(ctx, src):
    """The exchange-then-compute shard body: the whole stripe waits for
    the halos before any row is swept (the parity oracle of the overlapped
    body, and what ``overlap_report`` classifies as blocking)."""
    return _shard_sweeps(ctx, src, 1, overlapped=False)


@register_kernel("jacobi", signature=StreamSignature(n_read=1, n_write=1),
                 ref=ref.jacobi_step, plan_args=_plan_args,
                 # the stencil couples neighbouring rows: the row split
                 # carries a one-row halo exchange each way in its body
                 partitioning=Partitioning(in_axes=(("batch", None),),
                                           out_axes=("batch", None)),
                 spmd_body=_spmd_jacobi)
def _launch_jacobi(plan, src):
    """One 5-point sweep on an (N, M) grid (boundaries copied).  A grid
    already at the plan's pitch, 16-B aligned, is read in place; any other
    is copied into a pitched buffer first."""
    n, m = src.shape
    if m == plan.width and src.is_contiguous() and kernel.aligned(src):
        grid = src
    else:
        grid = pitched(src, plan)
    out = kernel.sweep(grid, torch.empty_like(grid), n_cols=m,
                       block=plan.block_shape)
    return out[:, :m]


def _sweeps(src: torch.Tensor, iters: int, plan: KernelPlan) -> torch.Tensor:
    n, m = src.shape
    a = pitched(src, plan)
    b = torch.empty_like(a)
    for _ in range(iters):
        kernel.sweep(a, b, n_cols=m, block=plan.block_shape)
        a, b = b, a
    return a[:, :m]


def jacobi_sweeps(src: torch.Tensor, iters: int, *,
                  global_shapes=None) -> torch.Tensor:
    """``iters`` sweeps with the plan resolved once, ping-ponging two
    pitched buffers (see the module doc).  Under an ambient mesh of ranks
    ``src`` is this rank's row stripe, and so is the result;
    ``global_shapes`` as ``api.launch`` takes it."""
    mesh = spmd_lib.spmd_mesh()
    if mesh is not None:
        with spmd_lib.shard_scope("jacobi", mesh, (src,),
                                  global_shapes) as (ctx, _):
            return _shard_sweeps(ctx, src, iters)
    plan = dispatch.plan_for("jacobi", _plan_args(src)[0], src.dtype)
    return _sweeps(src, iters, plan)


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
