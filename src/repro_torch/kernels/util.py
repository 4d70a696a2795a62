"""Shared helpers for the streaming kernels.

Counterpart of ``repro.kernels.util``.  A long vector is processed as a
(rows, width) 2-D tensor whose width, from the plan, is a whole number of
warp-wide 16-B vector spans, so every row starts 16-B aligned.  That
reshape is the paper's alignment rule and is centralized here.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.core.planner import KernelPlan

_TRACE = threading.local()


def trace(kind: str, **fields) -> None:
    """Append one event to this thread's trace while one is taken
    (``tracing``); nothing otherwise.  The wrappers of the kernels that run
    on a mesh (Jacobi, LBM, the cross-entropy's vocab-shard partials) trace
    each launch, on the card and on the CPU's plain path alike, and
    ``launch.mesh.Mesh`` each transfer's issue and wait: the order
    ``api.spmd.overlap_report`` reads."""
    events = getattr(_TRACE, "events", None)
    if events is not None:
        events.append((kind, fields))


@contextlib.contextmanager
def tracing():
    """Collect this thread's ``trace`` events into the yielded list."""
    prev = getattr(_TRACE, "events", None)
    _TRACE.events = events = []
    try:
        yield events
    finally:
        _TRACE.events = prev


def resolve_device(device=None) -> torch.device:
    """The device an entry point that makes data runs on: CUDA unless the
    caller names another.  Raises when CUDA is asked for (or defaulted to)
    and absent; nothing falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def to_tiles(x: torch.Tensor, plan: KernelPlan) -> tuple[torch.Tensor, int]:
    """Lay a 1-D tensor out as the plan's (rows, width) tiles.

    Returns ``(tiles, n)`` with ``n`` the logical length.  When ``n`` fills
    the plan exactly the tiles are a view of ``x``; a ragged tail costs one
    copy into a zero-padded buffer."""
    (n,) = x.shape
    # A plan is only valid for the logical shape it was derived from; a
    # mismatched plan would silently drop tail rows from the grid.
    if plan.logical_shape != (n,):
        raise ValueError(
            f"plan {plan.kernel} is for shape {plan.logical_shape}, "
            f"got tensor of shape {(n,)}"
        )
    rows, width = plan.padded_shape
    if width % plan.minor_unit:
        raise ValueError(
            f"plan width {width} is not a multiple of its minor unit "
            f"{plan.minor_unit}")
    if n == rows * width and x.is_contiguous():
        return x.view(rows, width), n
    tiles = x.new_zeros(rows * width)
    tiles[:n] = x
    return tiles.view(rows, width), n


def from_tiles(x2: torch.Tensor, n: int) -> torch.Tensor:
    """The logical 1-D view of a tiled result (no copy)."""
    return x2.reshape(-1)[:n]


def plan_args_1d(a: torch.Tensor, *_rest, **_scalars):
    """Registry ``plan_args`` for 1-D streaming kernels: plan on the first
    tensor's logical length and dtype (all streams share one layout)."""
    if a.ndim != 1:
        raise ValueError(f"1-D stream kernel got rank-{a.ndim} tensor")
    return tuple(a.shape), a.dtype


def overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the memory spans of two strided tensors intersect (each span
    runs from the first to the last element the tensor can address)."""
    def span(t):
        lo = t.data_ptr()
        if t.numel() == 0:
            return lo, lo
        last = sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
        return lo, lo + (last + 1) * t.element_size()

    (a0, a1), (b0, b1) = span(a), span(b)
    return a0 < b1 and b0 < a1


def block_rows(rows: int, target: int = 4) -> int:
    """Rows per CTA when a kernel wrapper is called without a plan: the
    largest divisor of ``rows`` not above ``target``."""
    b = max(1, min(rows, target))
    while rows % b:
        b -= 1
    return b


def refuse_autograd(kernel: str, function: str, *tensors) -> None:
    """Raise when a CUDA kernel would drop a gradient: with grad mode on and
    an input that requires grad, its output (filled outside autograd) would
    carry no ``grad_fn`` and the gradient would vanish without an error.
    ``function`` names the ``torch.autograd.Function`` to call instead;
    inside its ``forward`` grad mode is off and the kernel runs."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} kernel got an input that requires grad with grad mode "
            f"on; its output would have no gradient.  Call it through "
            f"{function}, or under torch.no_grad()")


def at_storage_offset(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of ``x`` that starts ``offset`` elements into a
    fresh buffer, so that at a nonzero offset its base is no longer 16-B
    aligned: the input that shows a kernel reads views in place."""
    if not offset:
        return x
    base = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = base[offset:].view(x.shape)
    view.copy_(x)
    return view
