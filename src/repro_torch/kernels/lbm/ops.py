"""LBM D3Q19 step: registry entries per layout, the multi-step loop,
traffic accounting.

Counterpart of ``repro.kernels.lbm.ops`` (single device).  ``lbm.soa`` and
``lbm.ivjk`` register as separate kernels: the paper's Fig. 7 layout
comparison is a planning decision, so it lives in the kernel name.  The
planner fixes the padded site count S_pad, the block and, for ivjk, the
interleave width L (the vector unit); everything here takes them from the
plan, so the lattice is padded exactly once (``_flatten_pad``).

One step: pull-propagate (``torch.roll`` per direction) into a zero-padded
(Q, S_pad) buffer, interleave to (S_pad/L, Q, L) for ivjk, collide with the
CUDA kernel, de-interleave, and keep the pre-step f on non-fluid cells.
Propagation and the interleave copies are plain PyTorch, as the reference's
are plain jnp.  ``lbm_run`` and the registered entries share that loop,
which allocates its buffers once and ping-pongs two lattices; the caller's
tensor is copied in and never written.

Under a mesh of ranks the lattice shards its X axis over the data axis
with per-direction halo depths: of D3Q19's 19 directions 5 have c_x = +1,
5 have c_x = -1 and 9 never cross an X cut, so a step shifts two
(5, 1, Y, Z) slabs around the periodic ring instead of replicating the
lattice.  The shard body is overlapped (the reference's docs/OVERLAP.md):
the slabs are issued first, the interior planes, which pull only from
planes the rank holds, propagate and collide on the layout's kernel while
they travel, and the two boundary planes, the only reads of the slabs,
collide last in one launch of the SoA kernel (B7) whatever the layout:
both kernels give a site the same bits (``tests/test_torch_cuda.py``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.api import dispatch
from repro_torch.api import spmd as spmd_lib
from repro_torch.api.registry import register_kernel
from repro_torch.api.spmd import Partitioning
from repro_torch.core.aliasing import InterleavedMemoryModel
from repro_torch.core.autotune import StreamSignature, choose_layout
from repro_torch.core.planner import KernelPlan
from repro_torch.kernels.lbm import kernel, ref
from repro_torch.kernels.lbm.ref import Q
from repro_torch.kernels.util import resolve_device
from repro_torch.launch.mesh import Arrived

LAYOUTS = ("soa", "ivjk")

_SIG = StreamSignature(n_read=19, n_write=19)

# The lattice shards its X axis ("batch" -> the data mesh axis); streaming
# across a cut travels as the two 5-direction halo slabs of the shard body.
_LBM_PART = Partitioning(in_axes=((None, "batch", None, None),),
                         out_axes=(None, "batch", None, None))

# Direction indices by x-component: the per-direction halo depth |c_x| is 1
# for the 5 + 5 directions crossing an X cut and 0 for the rest (the
# planner's ``_comm_lbm`` prices exactly these two 5-plane slabs).
_PLUS_X = tuple(v for v in range(Q) if int(ref.C[v][0]) == 1)
_MINUS_X = tuple(v for v in range(Q) if int(ref.C[v][0]) == -1)
_ZERO_X = tuple(v for v in range(Q) if int(ref.C[v][0]) == 0)


def _plan_args(f, **_scalars):
    return tuple(f.shape), f.dtype


def _padded_sites(plan: KernelPlan) -> int:
    if len(plan.padded_shape) == 2:          # soa: (Q, S_pad)
        return plan.padded_shape[1]
    return plan.padded_shape[0] * plan.padded_shape[2]   # ivjk: (S_pad/L, Q, L)


def _flatten_pad(f: torch.Tensor, plan: KernelPlan) -> tuple[torch.Tensor, int]:
    """A fresh zero-padded (Q, S_pad) copy of the (Q, X, Y, Z) lattice, with
    S_pad taken from the *plan's* padded shape -- never recomputed from a
    block multiple, so the lattice cannot be double-padded (or
    under-padded) relative to the grid the plan derived.  Returns the
    buffer and the logical site count."""
    q = f.shape[0]
    s = f[0].numel()
    spad = _padded_sites(plan)
    if spad < s:
        raise ValueError(f"plan {plan.kernel} pads {spad} sites < logical {s}")
    flat = f.new_zeros((q, spad))
    flat[:, :s] = f.reshape(q, s)
    return flat, s


def _logical(flat: torch.Tensor, shape) -> torch.Tensor:
    """The (Q, X, Y, Z) view of a padded (Q, S_pad) buffer's logical sites."""
    return flat[:, :math.prod(shape[1:])].view(shape)


def _check_mask(mask: torch.Tensor | None, f: torch.Tensor) -> None:
    if mask is not None and (mask.dtype != torch.bool
                             or tuple(mask.shape) != tuple(f.shape[1:])
                             or mask.device != f.device):
        raise ValueError(
            f"mask must be a bool tensor of shape {tuple(f.shape[1:])} on "
            f"{f.device}, got {mask.dtype} {tuple(mask.shape)} on {mask.device}")


class _Collision:
    """The buffers of the planned collision of a (Q, X, Y, Z) lattice of
    ``shape``: the propagated lattice goes into ``prop``'s logical sites
    (its padded sites stay zero), and ``run`` collides it into ``out``, both
    zero-padded (Q, S_pad), interleaving for ivjk."""

    def __init__(self, layout: str, plan: KernelPlan, shape, like):
        self.layout, self.plan, self.shape = layout, plan, tuple(shape)
        self.prop = like.new_zeros((Q, _padded_sites(plan)))
        self.out = torch.empty_like(self.prop)
        if layout == "ivjk":
            self.lanes = plan.padded_shape[2]
            self.inter = like.new_empty(plan.padded_shape)
            self.post = torch.empty_like(self.inter)

    def run(self, omega: float) -> torch.Tensor:
        plan = self.plan
        if self.layout == "soa":
            return kernel.collide_soa(self.prop, omega, bs=plan.block_cols,
                                      out=self.out)
        self.inter.copy_(self.prop.view(Q, -1, self.lanes).transpose(0, 1))
        kernel.collide_ivjk(self.inter, omega, bsb=plan.block_rows,
                            out=self.post)
        self.out.view(Q, -1, self.lanes).copy_(self.post.transpose(0, 1))
        return self.out


def _steps(layout: str, f: torch.Tensor, omega: float, iters: int,
           mask: torch.Tensor | None, plan: KernelPlan) -> torch.Tensor:
    """``iters`` pull-scheme steps of f (Q, X, Y, Z) on the plan's layout
    (see the module doc).  Returns the (Q, X, Y, Z) view of the logical
    sites of a padded buffer."""
    _check_mask(mask, f)
    shape = tuple(f.shape)
    cur, _ = _flatten_pad(f, plan)
    col = _Collision(layout, plan, shape, f)
    for _ in range(iters):
        src, dst = _logical(cur, shape), _logical(col.prop, shape)
        for v in range(Q):
            dst[v] = torch.roll(src[v], shifts=tuple(int(c) for c in ref.C[v]),
                                dims=(0, 1, 2))
        new = _logical(col.run(omega), shape)
        if mask is not None:
            new.copy_(torch.where(mask[None], new, src))
        cur, col.out = col.out, cur
    return _logical(cur, shape)


# ---- SPMD: X-sharded lattice with per-direction halos ----------------------

def _roll_yz(a: torch.Tensor, v: int) -> torch.Tensor:
    """The y/z part of direction ``v``'s pull shift (the x part is the
    choice of plane, or the halo slab)."""
    return torch.roll(a, shifts=(int(ref.C[v][1]), int(ref.C[v][2])),
                      dims=(-2, -1))


def _halo_exchange_x(ctx, f, x_axes, n_shards, idx):
    """Issue the per-direction halo transfers of one step of the (Q, XL,
    Y, Z) stripe ``f``: the last plane of the 5 +x-moving populations goes
    down the ring (arriving as ``halo_lo``, what my plane 0 pulls) and the
    first plane of the 5 -x-moving ones up it (``halo_hi``).  The ring
    wraps: the global propagation is periodic.  Returns the two transfers;
    where X shards over more than one mesh axis the slabs are gathered
    instead, which blocks."""
    plus_last = f[list(_PLUS_X), -1:]          # (5, 1, Y, Z)
    minus_first = f[list(_MINUS_X), :1]        # (5, 1, Y, Z)
    if len(x_axes) == 1:
        down = [(j, (j + 1) % n_shards) for j in range(n_shards)]
        up = [(j, (j - 1) % n_shards) for j in range(n_shards)]
        return (ctx.ppermute(plus_last, x_axes, down),
                ctx.ppermute(minus_first, x_axes, up))
    edges = ctx.all_gather(torch.cat([plus_last, minus_first], dim=1), x_axes)
    return (Arrived(edges[(idx - 1) % n_shards][:, :1]),
            Arrived(edges[(idx + 1) % n_shards][:, 1:]))


def _propagate_interior(f: torch.Tensor, dst: torch.Tensor) -> None:
    """Pull-propagate planes 1..XL-2 of the stripe ``f`` into ``dst`` (Q,
    XL-2, Y, Z): every source plane is the rank's own, so this work does
    not wait for the halo slabs."""
    for v in _ZERO_X:
        dst[v] = _roll_yz(f[v, 1:-1], v)
    for v in _PLUS_X:
        dst[v] = _roll_yz(f[v, :-2], v)
    for v in _MINUS_X:
        dst[v] = _roll_yz(f[v, 2:], v)


def _propagate_boundary(f, halo_lo, halo_hi, dst) -> None:
    """Pull-propagate the boundary planes of the stripe ``f`` into ``dst``
    (Q, min(XL, 2), Y, Z): plane 0 and, for XL >= 2, plane XL-1 -- the only
    planes that read the arrived slabs."""
    lo = dst[:, 0]
    for v in _ZERO_X:
        lo[v] = _roll_yz(f[v, 0], v)
    for k, v in enumerate(_PLUS_X):
        lo[v] = _roll_yz(halo_lo[k, 0], v)
    for k, v in enumerate(_MINUS_X):
        lo[v] = _roll_yz(f[v, 1] if f.shape[1] > 1 else halo_hi[k, 0], v)
    if f.shape[1] < 2:
        return
    hi = dst[:, 1]
    for v in _ZERO_X:
        hi[v] = _roll_yz(f[v, -1], v)
    for k, v in enumerate(_PLUS_X):
        hi[v] = _roll_yz(f[v, -2], v)
    for k, v in enumerate(_MINUS_X):
        hi[v] = _roll_yz(halo_hi[k, 0], v)


def _shard_steps(ctx, layout: str, f: torch.Tensor, omega: float,
                 iters: int, mask: torch.Tensor | None) -> torch.Tensor:
    """``iters`` steps of this rank's (Q, XL, Y, Z) X stripe (see the
    module doc); ``mask`` is the global (X, Y, Z) mask, of which the rank
    takes its own planes.  With X whole on this rank (a size-1 data axis
    or a divisibility fallback) the one-device steps on a local plan."""
    x_axes = ctx.axes(0, 1)
    n_shards = ctx.size(x_axes)
    if n_shards <= 1:
        plan = dispatch.plan_for(f"lbm.{layout}", tuple(f.shape), f.dtype,
                                 local=True)
        return _steps(layout, f, omega, iters, mask, plan)
    q, xl, y, z = f.shape
    idx = ctx.index(x_axes)
    if mask is not None:
        if tuple(mask.shape) != (xl * n_shards, y, z):
            raise ValueError(f"mask of shape {tuple(mask.shape)} is not the "
                             f"global lattice's {(xl * n_shards, y, z)}")
        mask = mask[idx * xl:(idx + 1) * xl]
        _check_mask(mask, f)
    cur = f.clone(memory_format=torch.contiguous_format)
    nxt = torch.empty_like(cur)
    if xl > 2:
        # the plan cell is the interior slab this rank sweeps
        inner = _Collision(layout, dispatch.plan_for(
            f"lbm.{layout}", (q, xl - 2, y, z), f.dtype, local=True),
            (q, xl - 2, y, z), f)
        inner_prop = _logical(inner.prop, inner.shape)
    edge_shape = (q, min(xl, 2), y, z)
    edge_prop = f.new_empty((q, math.prod(edge_shape[1:])))
    edge_out = torch.empty_like(edge_prop)
    for _ in range(iters):
        # 1) issue the halo exchange ...
        lo, hi = _halo_exchange_x(ctx, cur, x_axes, n_shards, idx)
        if xl > 2:
            # 2) ... propagate and collide the interior while it travels
            _propagate_interior(cur, inner_prop)
            nxt[:, 1:-1] = _logical(inner.run(omega), inner.shape)
        # 3) the boundary planes last, in one SoA launch
        _propagate_boundary(cur, lo.wait(), hi.wait(),
                            edge_prop.view(edge_shape))
        post = kernel.collide_soa(edge_prop, omega,
                                  out=edge_out).view(edge_shape)
        nxt[:, 0] = post[:, 0]
        if xl > 1:
            nxt[:, -1] = post[:, -1]
        if mask is not None:
            nxt.copy_(torch.where(mask[None], nxt, cur))
        cur, nxt = nxt, cur
    return cur


def _spmd_lbm_soa(ctx, f, *, omega, mask=None):
    """Shard body: X-sharded SoA lattice with per-direction halos."""
    return _shard_steps(ctx, "soa", f, omega, 1, mask)


def _spmd_lbm_ivjk(ctx, f, *, omega, mask=None):
    """Shard body: X-sharded IvJK lattice with per-direction halos."""
    return _shard_steps(ctx, "ivjk", f, omega, 1, mask)


def _lbm_ref(f, *, omega, mask=None):
    return ref.lbm_step(f, omega, mask)


@register_kernel("lbm.soa", signature=_SIG, ref=_lbm_ref,
                 plan_args=_plan_args, partitioning=_LBM_PART,
                 spmd_body=_spmd_lbm_soa)
def _launch_soa(plan, f, *, omega, mask=None):
    """Propagate (torch.roll) + CUDA BGK collision, f stored (Q, S)."""
    return _steps("soa", f, omega, 1, mask, plan)


@register_kernel("lbm.ivjk", signature=_SIG, ref=_lbm_ref,
                 plan_args=_plan_args, partitioning=_LBM_PART,
                 spmd_body=_spmd_lbm_ivjk)
def _launch_ivjk(plan, f, *, omega, mask=None):
    """Collision with directions interleaved every L sites (the paper's
    auto-skewed IvJK layout)."""
    return _steps("ivjk", f, omega, 1, mask, plan)


def lbm_run(f: torch.Tensor, omega: float, iters: int, *,
            layout: str = "ivjk", global_shapes=None) -> torch.Tensor:
    """``iters`` steps with the plan resolved once under the ambient
    ``PlanContext`` (see the module doc).  Under an ambient mesh of ranks
    ``f`` is this rank's X stripe, and so is the result;
    ``global_shapes`` as ``api.launch`` takes it."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}")
    mesh = spmd_lib.spmd_mesh()
    if mesh is not None:
        with spmd_lib.shard_scope(f"lbm.{layout}", mesh, (f,),
                                  global_shapes) as (ctx, _):
            return _shard_steps(ctx, layout, f, omega, iters, None)
    plan = dispatch.plan_for(f"lbm.{layout}", tuple(f.shape), f.dtype)
    return _steps(layout, f, omega, iters, None, plan)


def init_equilibrium(n: int, dtype=torch.float32, *, device=None) -> torch.Tensor:
    """Unit-density fluid at rest with a small sinusoidal shear along z
    (a non-trivial but stable flow), made on ``device`` (CUDA unless
    named).  x_k = 2*pi*k/n, k < n, as the reference's
    ``linspace(0, 2*pi, n, endpoint=False)``."""
    dev = resolve_device(device)
    x = torch.linspace(0, 2 * math.pi, n + 1, dtype=dtype, device=dev)[:n]
    ux = 0.02 * torch.sin(x)[None, None, :] * torch.ones(
        (n, n, n), dtype=dtype, device=dev)
    u = torch.stack([ux, torch.zeros_like(ux), torch.zeros_like(ux)])
    return ref.equilibrium(torch.ones((n, n, n), dtype=dtype, device=dev), u)


# ---- accounting (paper numbers) -------------------------------------------

def site_bytes(elem_bytes: int = 8, *, rfo: bool = True) -> int:
    """Paper: 19 reads + 19 writes (+19 RFO) = 456 B/site at 8 B elems."""
    return (3 if rfo else 2) * Q * elem_bytes


def site_flops() -> int:
    """~180 flops/site for D3Q19 BGK (paper's ~2.5 B/flop at 456 B)."""
    return 180


def layout_balance_scores(
    model: InterleavedMemoryModel | None = None,
    *,
    n: int = 100,
    elem_bytes: int = 8,
) -> tuple[str, dict[str, float]]:
    """Conflict-model comparison of the two layouts (paper Fig. 7 analysis).

    Stream bases for the 19 write streams of one thread on a cubic N^3
    domain (Fortran notation, i fastest):
      soa  (IJKv, f(i,j,k,v)) -- direction v starts at v * N^3 * elem_bytes:
           for any N with 64 | N^3 the bases all alias onto one channel,
      ivjk (f(i,v,j,k))       -- direction v starts at v * N * elem_bytes:
           for generic N the 19 odd-count streams spread over the channels
           ("the fortunate number of 19 distribution functions leads to an
           automatic skew"), collapsing only when N % 64 == 0 -- the paper's
           residual "ruinous" cache-thrashing sizes, removable by padding.
    """
    s = n ** 3
    soa_bases = [v * s * elem_bytes for v in range(Q)]
    ivjk_bases = [v * n * elem_bytes for v in range(Q)]
    mask = [True] * Q
    return choose_layout(
        {"soa": (soa_bases, mask), "ivjk": (ivjk_bases, mask)},
        model or InterleavedMemoryModel(),
    )
