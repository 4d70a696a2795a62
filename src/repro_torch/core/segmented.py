"""Segmented arrays: the paper's segmented container and iterators.

Counterpart of ``repro.core.segmented``.  The paper splits each array into
per-thread segments, aligns every segment to a controller-period boundary,
then shifts segment ``t`` by ``t * shift`` bytes so concurrent threads land
on different memory controllers; STL-style *segmented iterators* keep the
inner loops at plain-C speed (Fig. 5 shows zero overhead).

A ``SegmentedArray`` holds one 1-D tensor per segment.  Each segment has a
*logical* length and a *physical* (padded) length; the pad is the
alignment analogue.  The shift survives as ``phase``: a per-segment element
offset into the physical block, so segment k's data starts at a different
phase -- the paper's skew.

``seg_map`` is the segmented-iterator equivalent: it applies a flat kernel
per segment.  Results are functional, as in the reference: every call
returns fresh blocks, and the operands' blocks are never written.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.core.layout import round_up


def split_lengths(n: int, n_segments: int) -> list[int]:
    """Paper's manual schedule: floor(N/t)+1 for the first N%t segments."""
    if n_segments <= 0:
        raise ValueError("n_segments must be positive")
    base, rem = divmod(n, n_segments)
    return [base + 1 if s < rem else base for s in range(n_segments)]


class SegmentedArray:
    """1-D array stored as padded, phase-shifted segments.

    segments[k] has physical length P_k; the logical data of segment k lives
    at segments[k][phase_k : phase_k + L_k].
    """

    def __init__(
        self,
        segments: Sequence[torch.Tensor],
        lengths: Sequence[int],
        phases: Sequence[int],
    ):
        if not (len(segments) == len(lengths) == len(phases)):
            raise ValueError("segments/lengths/phases must align")
        for seg in segments:
            if seg.ndim != 1:
                raise ValueError("segments must be 1-D")
        self.segments = tuple(segments)
        self.lengths = tuple(int(x) for x in lengths)
        self.phases = tuple(int(x) for x in phases)

    # ---- construction ----------------------------------------------------
    @classmethod
    def from_flat(
        cls,
        x: torch.Tensor,
        n_segments: int,
        *,
        align: int = 128,
        shift: int = 0,
    ) -> "SegmentedArray":
        """Split ``x`` into near-equal segments on ``x``'s device; pad each
        physical block to a multiple of ``align`` elements; give segment k a
        phase of ``(k * shift) % align`` elements (the paper's per-segment
        skew)."""
        (n,) = x.shape
        lengths = split_lengths(n, n_segments)
        phases = [(k * shift) % align if align else 0 for k in range(n_segments)]
        segs = []
        start = 0
        for length, p in zip(lengths, phases):
            phys = round_up(p + length, align) if align else p + length
            block = x.new_zeros((phys,))
            block[p:p + length] = x[start:start + length]
            segs.append(block)
            start += length
        return cls(segs, lengths, phases)

    def to_flat(self) -> torch.Tensor:
        """Concatenate the logical contents (inverse of from_flat)."""
        if self.segments:
            return torch.cat([self.seg_view(k) for k in range(self.n_segments)])
        return torch.zeros((0,), dtype=torch.float32)

    # ---- metadata ----------------------------------------------------------
    @property
    def n_segments(self) -> int:
        return len(self.segments)

    @property
    def logical_size(self) -> int:
        return sum(self.lengths)

    @property
    def physical_size(self) -> int:
        return sum(s.numel() for s in self.segments)

    @property
    def waste(self) -> float:
        ps = self.physical_size
        return (ps - self.logical_size) / ps if ps else 0.0

    def like(self, segments: Sequence[torch.Tensor]) -> "SegmentedArray":
        return SegmentedArray(segments, self.lengths, self.phases)

    # ---- segmented "iterators" --------------------------------------------
    def seg_view(self, k: int) -> torch.Tensor:
        """Logical view of segment k (no copy: callers must not write it)."""
        p = self.phases[k]
        return self.segments[k][p:p + self.lengths[k]]

    def fresh_block(self, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """A new physical block for segment k and its logical view: the
        padding around the view is copied from segment k, the view itself
        is left for the caller to fill."""
        old = self.segments[k]
        p, length = self.phases[k], self.lengths[k]
        blk = torch.empty_like(old)
        blk[:p] = old[:p]
        blk[p + length:] = old[p + length:]
        return blk, blk[p:p + length]


def _check_lengths(out: SegmentedArray, ins: Sequence[SegmentedArray]) -> None:
    for a in ins:
        if a.lengths != out.lengths:
            raise ValueError("segment length mismatch between operands")


def seg_map(
    fn: Callable[..., torch.Tensor],
    out: SegmentedArray,
    *ins: SegmentedArray,
) -> SegmentedArray:
    """Apply ``fn(*segment_views) -> segment`` per segment (the generic
    dispatching algorithm of the paper's ``triad()``).

    ``fn`` receives the *logical* views of each input segment and must return
    the new logical content for the output segment; the result takes fresh
    blocks with ``out``'s padding and phases.
    """
    _check_lengths(out, ins)
    new_segments = []
    for k in range(out.n_segments):
        res = fn(*(a.seg_view(k) for a in ins))
        blk, view = out.fresh_block(k)
        view.copy_(res)
        new_segments.append(blk)
    return out.like(new_segments)


def seg_map_into(
    fn: Callable[..., None],
    out: SegmentedArray,
    *ins: SegmentedArray,
) -> SegmentedArray:
    """As ``seg_map``, but ``fn(*segment_views, out=view)`` writes each new
    logical content straight into the fresh block's view, so no result is
    copied."""
    _check_lengths(out, ins)
    new_segments = []
    for k in range(out.n_segments):
        blk, view = out.fresh_block(k)
        fn(*(a.seg_view(k) for a in ins), out=view)
        new_segments.append(blk)
    return out.like(new_segments)


def seg_triad(a: SegmentedArray, b: SegmentedArray, c: SegmentedArray,
              d: SegmentedArray) -> SegmentedArray:
    """Segmented Schoenauer vector triad A = B + C * D (paper SS2.2)."""
    return seg_map(lambda bb, cc, dd: bb + cc * dd, a, b, c, d)


# ---------------------------------------------------------------------------
# Page tables: the 2-D generalization of the segmented container
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PageGeometry:
    """Static geometry of a paged pool: the segmented container generalized
    from "one segment per thread" to "one page table per sequence".

    A ``SegmentedArray`` splits one logical array into aligned, phase-shifted
    physical segments.  A paged pool inverts the mapping: many logical
    sequences share one physical pool of fixed-size *pages*, and a per
    -sequence page table maps logical position ``p`` to physical page
    ``table[p // page_len]`` at offset ``p % page_len``.  The paper's two
    layout rules survive intact:

      * *alignment* -- ``page_len`` is a whole number of the planner's
        alignment units (the controller-period analogue), so no page
        straddles a unit boundary;
      * *skew* -- :meth:`alloc_order` hands out physical pages round-robin
        across ``banks`` interleave groups (``page_id % banks``), so the
        consecutive logical pages of one sequence land on different banks --
        the per-segment ``phase`` shift of §2.3, re-targeted at page
        granularity.

    Physical page 0 is reserved as the *null page*: empty page-table rows
    point at it and masked writes are routed into it, so a scatter over a
    partially occupied batch never touches live data.
    """

    page_len: int          # logical positions per page (alignment-unit multiple)
    n_pages: int           # physical pages in the pool, including null page 0
    banks: int = 1         # allocation-interleave width (controller analogue)

    def __post_init__(self):
        if self.page_len <= 0:
            raise ValueError("page_len must be positive")
        if self.n_pages < 2:
            raise ValueError("n_pages must include the null page and at "
                             "least one allocatable page")
        if self.banks <= 0:
            raise ValueError("banks must be positive")

    @property
    def live_pages(self) -> int:
        """Allocatable pages (everything but the reserved null page)."""
        return self.n_pages - 1

    def pages_for(self, length: int) -> int:
        """Pages needed to hold ``length`` logical positions."""
        if length <= 0:
            return 0
        return -(-length // self.page_len)

    def page_of(self, pos: int) -> int:
        return pos // self.page_len

    def offset_of(self, pos: int) -> int:
        return pos % self.page_len

    def alloc_order(self) -> list[int]:
        """Bank-skewed allocation order over pages ``1..n_pages-1``.

        Successive allocations -- and therefore the consecutive logical
        pages of a growing sequence -- cycle through the ``banks``
        interleave groups, the paper's skew applied to page placement."""
        by_bank: list[list[int]] = [[] for _ in range(self.banks)]
        for pid in range(1, self.n_pages):
            by_bank[pid % self.banks].append(pid)
        order: list[int] = []
        queues = [list(b) for b in by_bank if b]
        while any(queues):
            for q in queues:
                if q:
                    order.append(q.pop(0))
        return order
