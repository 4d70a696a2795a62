"""Vector triad: registry entry plus the segmented and phased experiment
variants.

Counterpart of ``repro.kernels.triad.ops``.
``repro_torch.api.launch("triad", b, c, d)`` is the planner-driven aligned
case.  ``vector_triad_segmented`` runs it once per segment of a
``SegmentedArray`` (paper Fig. 5).  ``vector_triad_phased`` is the paper's
offset experiment: stream k is read from ``phase[k]`` elements into its own
padded buffer, so its base address is off the 16-B vector grid unless the
phase is a multiple of 16 / itemsize.  The TPU reference pads and slices
back, which lets the compiler realign the data; here the kernel reads the
unaligned bases as they are (its scalar path), which is what the paper
measured.
"""
from __future__ import annotations

import torch

from repro_torch.api import dispatch
from repro_torch.api.registry import register_kernel
from repro_torch.api.spmd import Partitioning
from repro_torch.core.autotune import StreamSignature
from repro_torch.core.planner import KernelPlan
from repro_torch.core.segmented import SegmentedArray, seg_map_into
from repro_torch.kernels.triad import kernel, ref
from repro_torch.kernels.util import from_tiles, plan_args_1d, to_tiles


@register_kernel("triad", signature=StreamSignature(n_read=3, n_write=1),
                 ref=ref.triad, plan_args=plan_args_1d,
                 # elementwise over the vector: each device would triad
                 # its own slice
                 partitioning=Partitioning(in_axes=(("batch",),) * 3,
                                           out_axes=("batch",)))
def _launch_triad(plan, b, c, d, *, out=None):
    """Schoenauer vector triad A = B + C * D (paper SS2.2).  With ``out``
    (a 1-D tensor of the inputs' length) the result is written there: in
    place when ``out`` fills the plan's tiles exactly, else through one
    copy of the ragged result."""
    b2, n = to_tiles(b, plan)
    c2, _ = to_tiles(c, plan)
    d2, _ = to_tiles(d, plan)
    if out is None:
        return from_tiles(kernel.triad2d(b2, c2, d2, brows=plan.block_rows), n)
    if out.shape != b.shape:
        raise ValueError(f"triad out has shape {tuple(out.shape)}, inputs "
                         f"{tuple(b.shape)}")
    if n == plan.rows * plan.width and out.is_contiguous():
        kernel.triad2d(b2, c2, d2, brows=plan.block_rows,
                       out=out.view(plan.rows, plan.width))
        return out
    res = kernel.triad2d(b2, c2, d2, brows=plan.block_rows)
    return out.copy_(from_tiles(res, n))


def phased_tiles(x: torch.Tensor, phase: int, plan: KernelPlan) -> torch.Tensor:
    """Copy ``x`` into a fresh zero-padded buffer at element ``phase`` and
    return the plan's (rows, width) view starting there: the stream's base
    is ``phase * itemsize`` bytes past an allocation boundary."""
    (n,) = x.shape
    if plan.logical_shape != (n,):
        raise ValueError(
            f"plan {plan.kernel} is for shape {plan.logical_shape}, "
            f"got tensor of shape {(n,)}")
    if phase < 0:
        raise ValueError(f"phase must be non-negative, got {phase}")
    rows, width = plan.padded_shape
    buf = x.new_zeros(phase + rows * width)
    buf[phase:phase + n] = x
    return buf[phase:].view(rows, width)


def vector_triad_phased(
    b: torch.Tensor,
    c: torch.Tensor,
    d: torch.Tensor,
    *,
    phases: tuple[int, int, int] = (0, 0, 0),
    plan: KernelPlan | None = None,
) -> torch.Tensor:
    """A = B + C * D with stream k read from element ``phases[k]`` of its
    own padded buffer.  The phases change where each stream starts, never
    the result."""
    plan = plan or dispatch.plan_for("triad", b.shape, b.dtype)
    tiles = [phased_tiles(x, p, plan) for x, p in zip((b, c, d), phases)]
    out = kernel.triad2d(*tiles, brows=plan.block_rows)
    return from_tiles(out, b.shape[0])


def vector_triad_segmented(
    a: SegmentedArray, b: SegmentedArray, c: SegmentedArray, d: SegmentedArray
) -> SegmentedArray:
    """Segmented-iterator port: one ``api.launch("triad", ...)`` per
    segment, each planned on its own logical length, each writing straight
    into the logical slice of a fresh block that carries ``a``'s padding.
    ``a``..``d`` are never written."""

    def _one(bb, cc, dd, *, out):
        dispatch.launch("triad", bb, cc, dd, out=out)

    return seg_map_into(_one, a, b, c, d)


def triad_bytes(n: int, elem_bytes: int = 8, *, rfo: bool = True) -> int:
    """Application traffic: 3 reads + 1 write (+1 RFO read) per element --
    the paper's 16 B/flop balance at 8-byte elements without RFO."""
    return (5 if rfo else 4) * n * elem_bytes


def triad_flops(n: int) -> int:
    return 2 * n  # one mul + one add per element
