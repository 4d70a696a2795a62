"""Planner-packed paged KV cache for the continuous batcher.

Counterpart of ``repro.serving.paged_cache``.  The dense serving cache is
one ``(layers, slots, max_len, ...)`` slab in which every slot pre-pays
``max_len`` positions; the paged pool replaces it with the paper's
segmentation discipline applied to serving:

  * **pages are planner tiles** -- :func:`plan_page_geometry` asks the
    registry for the tile plan of the per-slot KV stream
    ``(max_len, n_kv_heads * head_dim)`` under a page-sized shared-memory
    budget (``api.plan_tile``) and takes the plan's block rows as the page
    length;
  * **placement is skewed** -- free pages are handed out round-robin across
    ``banks`` interleave groups (``core.segmented.PageGeometry``);
  * **memory returns immediately** -- a retired or preempted slot's pages go
    back to the free pool the moment it retires.

The page-length rule on Hopper.  The reference's TPU rule is "one page is
one planned VMEM tile, a whole number of sublane tiles" under an 8 KiB
budget.  Hopper has no sublane tile (row unit 1), and under 8 KiB a 2 KB KV
row (8 heads x 128 x bf16) would give pages of one row.  The port's rule: a
page holds a whole number of 128-B lines of every KV row (``line_rows``),
and at least ``ATTN_TILE_ROWS`` positions -- the KV positions one
``mma.sync`` m16n8k16 tile of a paged-attention kernel takes as its
reduction dim (16 for bf16), so no such tile straddles two pages.  The
default budget, ``DEFAULT_PAGE_SMEM`` = 128 KiB, makes the planner's tile
for Qwen3-4B's KV stream 16 rows (128 KiB over 4 rmsnorm buffers of one
2 KB row); 16 positions is also vLLM's default block size.  An explicit
``page_len`` must be a whole number of the planner's row unit and of
``line_rows``.

For a hybrid (zamba2) the KV stream is the shared attention block's, and
there is one pool for each of its applications; the Mamba2 conv and SSM
state is O(1) per slot and never paged.  An ssm model (xlstm) has no
attention stage and no pool at all: ``plan_page_geometry`` still plans
pages for the config's nominal KV width (``n_kv_heads * hd``), as the
reference does, and the page tables back nothing -- paged serving then
runs the scheduler's page bookkeeping and the ``act`` masking of the
mLSTM and sLSTM state, and must give the dense cache's tokens.  The pools live in the model cache
tree (``models.transformer.paged_cache_defs``); ``PageManager`` owns the
host-side bookkeeping: the free list, each slot's pages, and the admission
arithmetic of the scheduler's backpressure and preemption.
"""
from __future__ import annotations

import math
from collections import deque

from repro_torch import api
from repro_torch.core.layout import LINE_BYTES, ROW_UNIT, round_up
from repro_torch.core.segmented import PageGeometry

__all__ = ["PageManager", "plan_page_geometry", "DEFAULT_PAGE_SMEM",
           "ATTN_TILE_ROWS", "line_rows"]

# Per-page shared-memory budget handed to the planner when no explicit page
# length is requested (see the module docstring).
DEFAULT_PAGE_SMEM = 128 * 1024

# Least positions a default page holds: the reduction dim of one bf16
# m16n8k16 mma tile over KV positions.
ATTN_TILE_ROWS = 16


def line_rows(kv_width: int, itemsize: int) -> int:
    """Fewest KV rows whose bytes are a whole number of 128-B lines."""
    return LINE_BYTES // math.gcd(kv_width * itemsize, LINE_BYTES)


def plan_page_geometry(cfg, max_len: int, *, page_len: int | None = None,
                       n_pages: int | None = None, slots: int = 1,
                       banks: int = 4, mesh=None):
    """Derive the page geometry for a model's KV stream from the planner.

    Returns ``(PageGeometry, KernelPlan)``.  With ``page_len=None`` the page
    length is the planner's tile rows for the ``(max_len, kv_width)``
    stream under ``DEFAULT_PAGE_SMEM``, raised to ``ATTN_TILE_ROWS`` and to
    a whole number of ``line_rows``; an explicit ``page_len`` must already
    be a whole number of both units (the alignment rule is not optional).
    ``n_pages`` defaults to enough pages for ``slots`` full-length
    sequences plus the reserved null page -- shrink it to exercise
    backpressure and preemption.  An explicit ``mesh`` plans under it
    (else the ambient ``plan_context``'s), as the reference's does; the
    page is the KV stream's whole width, so every rank of a mesh pages
    its KV heads alike.
    """
    kv_width = max(1, int(cfg.n_kv_heads) * int(cfg.hd))
    dtype = cfg.adtype
    unit = line_rows(kv_width, dtype.itemsize)
    ctx = api.current_context()
    if mesh is not None:
        ctx = ctx.evolve(mesh=mesh)
    if page_len is None:
        plan = api.plan_tile("rmsnorm", (max_len, kv_width), dtype,
                             smem_budget=DEFAULT_PAGE_SMEM, ctx=ctx)
        page_len = round_up(max(plan.block_rows, ATTN_TILE_ROWS),
                            math.lcm(unit, ROW_UNIT))
    else:
        plan = api.plan_tile("rmsnorm", (max_len, kv_width), dtype, ctx=ctx)
        if page_len <= 0 or page_len % ROW_UNIT or page_len % unit:
            raise ValueError(
                f"page_len {page_len} is not a whole number of the planner's "
                f"row unit {ROW_UNIT} and of {unit} row(s), the fewest that "
                f"fill whole 128-B lines of a {kv_width}-wide {plan.dtype} "
                f"KV row")
    max_pages = -(-max_len // page_len)
    if n_pages is None:
        n_pages = 1 + max(1, slots) * max_pages
    geom = PageGeometry(page_len=int(page_len), n_pages=int(n_pages),
                        banks=max(1, int(banks)))
    return geom, plan


class PageManager:
    """Host-side free-page pool + per-slot page tables.

    All methods are O(pages touched); allocation is all-or-nothing so a
    half-admitted request never strands pages.  The scheduler mirrors every
    ``alloc``/``release`` into the device-side ``pages`` leaf of the cache.
    """

    def __init__(self, geometry: PageGeometry, n_slots: int):
        self.geometry = geometry
        self._free: deque[int] = deque(geometry.alloc_order())
        self._slot_pages: list[list[int]] = [[] for _ in range(n_slots)]
        # Pages withdrawn from service by shrink() -- capacity loss modelled
        # without re-allocating the device pool.  Never handed out again.
        self._retired: list[int] = []

    # ---- accounting ------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        """Allocatable pages: the geometry's live pool minus any retired by
        :meth:`shrink` (admission arithmetic must use this)."""
        return self.geometry.live_pages - len(self._retired)

    @property
    def used_pages(self) -> int:
        return self.live_pages - len(self._free)

    # ---- capacity loss ---------------------------------------------------
    def shrink(self, live_pages: int) -> int:
        """Retire free pages until at most ``live_pages`` remain in service.
        Returns the remaining deficit: pages still to retire once the caller
        frees some (by preempting tenants) and calls again."""
        target = max(0, int(live_pages))
        while self.live_pages > target and self._free:
            self._retired.append(self._free.pop())
        return max(0, self.live_pages - target)

    def slot_pages(self, slot: int) -> tuple[int, ...]:
        return tuple(self._slot_pages[slot])

    def needed(self, slot: int, upto_pos: int) -> int:
        """Pages ``slot`` is missing to cover logical position ``upto_pos``."""
        want = self.geometry.pages_for(upto_pos + 1)
        return max(0, want - len(self._slot_pages[slot]))

    def can_fit(self, length: int) -> bool:
        """Could a fresh sequence of ``length`` positions be paged in now?"""
        return self.geometry.pages_for(length) <= len(self._free)

    # ---- allocation ------------------------------------------------------
    def alloc(self, slot: int, upto_pos: int) -> list[tuple[int, int]] | None:
        """Grow ``slot``'s table to cover ``upto_pos``.  Returns the new
        ``(logical_page, physical_page)`` assignments, or ``None`` (and
        allocates nothing) if the free pool cannot supply them all."""
        need = self.needed(slot, upto_pos)
        if need > len(self._free):
            return None
        out = []
        table = self._slot_pages[slot]
        for _ in range(need):
            pid = self._free.popleft()
            out.append((len(table), pid))
            table.append(pid)
        return out

    def release(self, slot: int) -> list[int]:
        """Return all of ``slot``'s pages to the free pool, re-queued in
        bank-skewed order so reuse keeps the interleave discipline."""
        pages = self._slot_pages[slot]
        self._slot_pages[slot] = []
        pages.sort(key=lambda pid: (pid % self.geometry.banks, pid))
        self._free.extend(pages)
        return pages
