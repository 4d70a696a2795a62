"""Analytic layout autotuner -- the paper's "no trial and error" claim.

Given a kernel's *stream signature* (how many read/write streams, their
element size and lengths) and a memory model (the address->channel map), the
tuner derives alignment, per-stream offsets and per-segment shifts in closed
form, then verifies them against the model.  This mirrors the paper's SS2.3:

    "Note that these parameters are the same for all problem sizes and can be
     obtained by analyzing the data access properties of the loop kernel,
     together with some knowledge about the mapping between addresses and
     memory controllers.  No trial and error is required."
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core import aliasing
from repro_torch.core.aliasing import InterleavedMemoryModel, Stream


@dataclasses.dataclass(frozen=True)
class StreamSignature:
    """Data-access properties of a loop kernel."""

    n_read: int
    n_write: int
    elem_bytes: int = 8

    @property
    def n_streams(self) -> int:
        return self.n_read + self.n_write

    @property
    def balance_bytes_per_flop(self) -> float | None:
        return None  # kernels attach their own flop counts


@dataclasses.dataclass(frozen=True)
class LayoutPlan:
    """The tuner's output: how to lay the kernel's arrays out."""

    align_bytes: int            # align every array/segment base to this
    offsets_bytes: tuple[int, ...]   # per-stream additional offset (skew)
    segment_shift_bytes: int    # extra shift between consecutive segments
    predicted_balance: float    # model-predicted channel balance in (0,1]

    def offset_elems(self, elem_bytes: int) -> tuple[int, ...]:
        return tuple(o // elem_bytes for o in self.offsets_bytes)


def plan_streams(
    sig: StreamSignature,
    model: InterleavedMemoryModel | None = None,
    *,
    n_threads: int = 1,
    chunk_bytes: int | None = None,
) -> LayoutPlan:
    """Closed-form plan: align to the interleave period, skew stream k by
    k * channel-step, shift consecutive segments by one channel step.

    For >= n_channels streams this provably reaches balance 1.0 under the
    model (each channel gets streams k = c, c+n, ...); for fewer streams the
    *segment* shift takes over (the paper's Jacobi case: only 2 effective
    streams, so rows are shifted 128 B against each other).
    """
    model = model or InterleavedMemoryModel()
    step = 1 << model.channel_shift
    offsets = tuple(k * step for k in range(sig.n_streams))
    plan = LayoutPlan(
        align_bytes=model.period_bytes,
        offsets_bytes=offsets,
        segment_shift_bytes=step,
        predicted_balance=_score(offsets, sig, model, n_threads, chunk_bytes),
    )
    return plan


def _score(
    offsets: Sequence[int],
    sig: StreamSignature,
    model: InterleavedMemoryModel,
    n_threads: int,
    chunk_bytes: int | None,
) -> float:
    streams = [
        Stream(base=o, kind=("write" if k < sig.n_write else "read"))
        for k, o in enumerate(offsets)
    ]
    kw = {"n_threads": n_threads}
    if chunk_bytes is not None:
        kw["chunk_bytes"] = chunk_bytes
    return model.balance(streams, **kw)


def verify_plan_optimal(
    sig: StreamSignature,
    model: InterleavedMemoryModel | None = None,
) -> tuple[LayoutPlan, float]:
    """Check the analytic plan against exhaustive search over one period.

    Returns (plan, exhaustive_best_balance).  Tests assert
    ``plan.predicted_balance >= exhaustive_best - eps`` -- i.e. the paper's
    analytic offsets are as good as anything brute force finds.
    """
    model = model or InterleavedMemoryModel()
    plan = plan_streams(sig, model)
    _, best = aliasing.exhaustive_best_skews(
        model, sig.n_streams, write_idx=0
    )
    return plan, best


def choose_layout(
    candidates: dict[str, tuple[Sequence[int], Sequence[bool]]],
    model: InterleavedMemoryModel | None = None,
    **kw,
) -> tuple[str, dict[str, float]]:
    """Pick the best data layout by model balance (paper SS2.4, LBM).

    ``candidates[name] = (stream_base_addresses, write_mask)``.  Returns the
    argmax name and all scores, e.g. IvJK vs IJKv for D3Q19.
    """
    model = model or InterleavedMemoryModel()
    scores = {
        name: aliasing.layout_balance(model, bases, mask, **kw)
        for name, (bases, mask) in candidates.items()
    }
    best = max(scores, key=scores.__getitem__)
    return best, scores
