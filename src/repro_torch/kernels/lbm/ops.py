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
"""
from __future__ import annotations

import math

import torch

from repro_torch.api import dispatch
from repro_torch.api.registry import register_kernel
from repro_torch.api.spmd import Partitioning, halo_body_pending
from repro_torch.core.aliasing import InterleavedMemoryModel
from repro_torch.core.autotune import StreamSignature, choose_layout
from repro_torch.core.planner import KernelPlan
from repro_torch.kernels.lbm import kernel, ref
from repro_torch.kernels.lbm.ref import Q
from repro_torch.kernels.util import resolve_device

LAYOUTS = ("soa", "ivjk")

_SIG = StreamSignature(n_read=19, n_write=19)

# The lattice shards its X axis with per-direction halos; that exchange is
# not ported, so a launch over a mesh raises (``halo_body_pending``).
_LBM_PART = Partitioning(in_axes=((None, "batch", None, None),),
                         out_axes=(None, "batch", None, None))


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


def _steps(layout: str, f: torch.Tensor, omega: float, iters: int,
           mask: torch.Tensor | None, plan: KernelPlan) -> torch.Tensor:
    """``iters`` pull-scheme steps of f (Q, X, Y, Z) on the plan's layout
    (see the module doc).  Returns the (Q, X, Y, Z) view of the logical
    sites of a padded buffer."""
    _check_mask(mask, f)
    shape = tuple(f.shape)
    cur, _ = _flatten_pad(f, plan)
    nxt = torch.empty_like(cur)
    prop = torch.zeros_like(cur)          # its padded sites stay zero
    if layout == "ivjk":
        lanes = plan.padded_shape[2]
        inter = f.new_empty(plan.padded_shape)
        post = torch.empty_like(inter)
    for _ in range(iters):
        src, dst = _logical(cur, shape), _logical(prop, shape)
        for v in range(Q):
            dst[v] = torch.roll(src[v], shifts=tuple(int(c) for c in ref.C[v]),
                                dims=(0, 1, 2))
        if layout == "soa":
            kernel.collide_soa(prop, omega, bs=plan.block_cols, out=nxt)
        else:
            inter.copy_(prop.view(Q, -1, lanes).transpose(0, 1))
            kernel.collide_ivjk(inter, omega, bsb=plan.block_rows, out=post)
            nxt.view(Q, -1, lanes).copy_(post.transpose(0, 1))
        if mask is not None:
            new = _logical(nxt, shape)
            new.copy_(torch.where(mask[None], new, src))
        cur, nxt = nxt, cur
    return _logical(cur, shape)


def _lbm_ref(f, *, omega, mask=None):
    return ref.lbm_step(f, omega, mask)


@register_kernel("lbm.soa", signature=_SIG, ref=_lbm_ref,
                 plan_args=_plan_args, partitioning=_LBM_PART,
                 spmd_body=halo_body_pending)
def _launch_soa(plan, f, *, omega, mask=None):
    """Propagate (torch.roll) + CUDA BGK collision, f stored (Q, S)."""
    return _steps("soa", f, omega, 1, mask, plan)


@register_kernel("lbm.ivjk", signature=_SIG, ref=_lbm_ref,
                 plan_args=_plan_args, partitioning=_LBM_PART,
                 spmd_body=halo_body_pending)
def _launch_ivjk(plan, f, *, omega, mask=None):
    """Collision with directions interleaved every L sites (the paper's
    auto-skewed IvJK layout)."""
    return _steps("ivjk", f, omega, 1, mask, plan)


def lbm_run(f: torch.Tensor, omega: float, iters: int, *,
            layout: str = "ivjk") -> torch.Tensor:
    """``iters`` steps with the plan resolved once under the ambient
    ``PlanContext`` (see the module doc)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}")
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
