"""RMSNorm (plain + gated, one-pass and split): registry entries,
planner-derived padding.

Counterpart of ``repro.kernels.rmsnorm.ops`` (single device).  Leading dims
flatten into rows; the planner pads the feature dim to its minor unit (one
warp of 16-B vectors) and leaves the rows as they are (row unit 1), so a
model's (B, S, d) activation with d a whole number of vector spans reaches
the kernel as a view, with no copy.  The statistics are taken over the
logical columns only (the kernel masks the padding).

The split norm's passes (``rmsnorm.sumsq``, ``rmsnorm.gated.sumsq``,
``rmsnorm.apply``, ``rmsnorm.gated.apply``) run on a rank's block of a row
whose columns the rules cut over "mlp": the stats pass returns each row's
fp32 sum of squares over the block, shaped like x's leading dims; the apply
pass normalises the block by ``rsqrt(ss / d_total + eps)``, ``ss`` the sum
of the ranks' statistics (``models.blocks.rms_norm_split`` sums them).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.api.registry import register_kernel
from repro_torch.api.spmd import Partitioning
from repro_torch.core.autotune import StreamSignature
from repro_torch.kernels.rmsnorm import kernel, ref


def _plan_args_plain(x, scale, **_scalars):
    if scale.shape != x.shape[-1:]:
        raise ValueError(
            f"scale shape {tuple(scale.shape)} must match minor dim of "
            f"{tuple(x.shape)}")
    *lead, d = x.shape
    rows = 1
    for s in lead:
        rows *= s
    return (rows, d), x.dtype


def _plan_args_gated(x, z, scale, **_scalars):
    # z is padded with the plan derived from x; a mismatched z would
    # otherwise be silently zero-padded into wrong output rows.
    if z.shape != x.shape:
        raise ValueError(f"z shape {tuple(z.shape)} must match x shape "
                         f"{tuple(x.shape)}")
    return _plan_args_plain(x, scale)


def _pad_rows(x: torch.Tensor, plan) -> torch.Tensor:
    """x as the plan's contiguous (rows, width) block: a view when nothing
    pads, else one zero-padded copy."""
    d = x.shape[-1]
    rp, wp = plan.padded_shape
    x2 = x.reshape(-1, d)
    if (rp, wp) != tuple(x2.shape):
        x2 = F.pad(x2, (0, wp - d, 0, rp - x2.shape[0]))
    return x2.contiguous()


def _unpad(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    rows = x.numel() // x.shape[-1]
    return y[:rows, :x.shape[-1]].reshape(x.shape)


def _pad_scale(scale: torch.Tensor, plan) -> torch.Tensor:
    return F.pad(scale, (0, plan.width - scale.shape[0]))


# Row statistics are per-row: shard the leading (token/batch) axis, keep the
# feature dim whole and the scale vector replicated (stored until A11).
_ROWWISE = Partitioning(in_axes=(("batch", ..., None), (None,)),
                        out_axes=("batch", ..., None))
_ROWWISE_GATED = Partitioning(
    in_axes=(("batch", ..., None), ("batch", ..., None), (None,)),
    out_axes=("batch", ..., None))


@register_kernel("rmsnorm", signature=StreamSignature(n_read=2, n_write=1),
                 ref=lambda x, scale, *, eps=1e-6: ref.rmsnorm(x, scale, eps),
                 plan_args=_plan_args_plain, partitioning=_ROWWISE)
def _launch_rmsnorm(plan, x, scale, *, eps: float = 1e-6):
    """y = x * rsqrt(mean(x^2) + eps) * scale, fused over row blocks."""
    y = kernel.rmsnorm2d(_pad_rows(x, plan), _pad_scale(scale, plan),
                         d_logical=x.shape[-1], eps=eps,
                         brows=plan.block_rows)
    return _unpad(y, x)


@register_kernel("rmsnorm.gated",
                 signature=StreamSignature(n_read=3, n_write=1),
                 ref=lambda x, z, scale, *, eps=1e-6:
                     ref.gated_rmsnorm(x, z, scale, eps),
                 plan_args=_plan_args_gated, partitioning=_ROWWISE_GATED)
def _launch_gated(plan, x, z, scale, *, eps: float = 1e-6):
    """Gated variant: normalize x * silu(z) (the mamba2/xlstm norm)."""
    y = kernel.gated_rmsnorm2d(_pad_rows(x, plan), _pad_rows(z, plan),
                               _pad_scale(scale, plan), d_logical=x.shape[-1],
                               eps=eps, brows=plan.block_rows)
    return _unpad(y, x)


def _plan_args_split(x, *_operands, **_scalars):
    *lead, d = x.shape
    return (math.prod(lead), d), x.dtype


def _rows(ss: torch.Tensor, plan) -> torch.Tensor:
    """ss (x's leading dims) as the plan's (rows,) fp32 vector."""
    ss = ss.reshape(-1).to(torch.float32)
    return F.pad(ss, (0, plan.padded_shape[0] - ss.shape[0])).contiguous()


def _unrows(ss: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return ss[:x.numel() // x.shape[-1]].reshape(x.shape[:-1])


# A rank's block of rows cut over "mlp": the statistic is per row of the
# block, the scale the block's columns; the kernel never sees the cut.
_SPLIT = ("batch", ..., "mlp")
_SPLIT_ROWS = ("batch", ...)


@register_kernel("rmsnorm.sumsq", signature=StreamSignature(n_read=1,
                                                             n_write=0),
                 ref=ref.sumsq,
                 plan_args=_plan_args_split,
                 partitioning=Partitioning(in_axes=(_SPLIT,),
                                           out_axes=_SPLIT_ROWS))
def _launch_sumsq(plan, x):
    """The split norm's stats pass: sum(x^2) over the block's columns."""
    ss = kernel.sumsq2d(_pad_rows(x, plan), d_logical=x.shape[-1],
                        brows=plan.block_rows)
    return _unrows(ss, x)


@register_kernel("rmsnorm.gated.sumsq",
                 signature=StreamSignature(n_read=2, n_write=0),
                 ref=lambda x, z: ref.sumsq(ref.gate(x, z)),
                 plan_args=_plan_args_split,
                 partitioning=Partitioning(in_axes=(_SPLIT, _SPLIT),
                                           out_axes=_SPLIT_ROWS))
def _launch_gated_sumsq(plan, x, z):
    """The stats pass on x * silu(z), the gate rounded to x's dtype."""
    ss = kernel.gated_sumsq2d(_pad_rows(x, plan), _pad_rows(z, plan),
                              d_logical=x.shape[-1], brows=plan.block_rows)
    return _unrows(ss, x)


@register_kernel("rmsnorm.apply", signature=StreamSignature(n_read=2,
                                                             n_write=1),
                 ref=lambda x, scale, ss, *, d_total, eps=1e-6:
                     ref.apply(x, scale, ss, d_total, eps),
                 plan_args=_plan_args_split,
                 partitioning=Partitioning(
                     in_axes=(_SPLIT, ("mlp",), _SPLIT_ROWS),
                     out_axes=_SPLIT))
def _launch_apply(plan, x, scale, ss, *, d_total: int, eps: float = 1e-6):
    """The split norm's apply pass: x * rsqrt(ss / d_total + eps) * scale."""
    y = kernel.apply2d(_pad_rows(x, plan), _pad_scale(scale, plan),
                       _rows(ss, plan), d_logical=x.shape[-1],
                       d_total=d_total, eps=eps, brows=plan.block_rows)
    return _unpad(y, x)


@register_kernel("rmsnorm.gated.apply",
                 signature=StreamSignature(n_read=3, n_write=1),
                 ref=lambda x, z, scale, ss, *, d_total, eps=1e-6:
                     ref.apply(ref.gate(x, z), scale, ss, d_total, eps),
                 plan_args=_plan_args_split,
                 partitioning=Partitioning(
                     in_axes=(_SPLIT, _SPLIT, ("mlp",), _SPLIT_ROWS),
                     out_axes=_SPLIT))
def _launch_gated_apply(plan, x, z, scale, ss, *, d_total: int,
                        eps: float = 1e-6):
    """The apply pass on x * silu(z), the gate rounded to x's dtype."""
    y = kernel.gated_apply2d(_pad_rows(x, plan), _pad_rows(z, plan),
                             _pad_scale(scale, plan), _rows(ss, plan),
                             d_logical=x.shape[-1], d_total=d_total, eps=eps,
                             brows=plan.block_rows)
    return _unpad(y, x)
