"""Layout policy on a Hopper machine model: padding, alignment, block shapes.

The counterpart of ``repro.core.layout``.  The paper's remedy is *analytic*
padding and alignment derived from the hardware's address->resource map.
On an NVIDIA Hopper card the controllable analogues are

  * the warp's coalesced access: 32 threads, each loading one 16-B vector,
    read one contiguous 512-B span.  A minor dimension that is a whole
    number of such spans keeps every row start 16-B aligned, so every
    stream can use vector loads (``vector_unit``);
  * the 128-B line: the unit a request moves between L2 and device memory;
  * the thread block (CTA): the rows one CTA walks must keep its in-flight
    bytes within the per-CTA shared-memory budget, and the grid must hold
    enough CTAs to fill every SM.

There is no row (sublane) tile on Hopper: the row unit is 1.

The device limits are read from ``torch.cuda.get_device_properties`` when a
CUDA device is present; otherwise the H100 SXM data-sheet values apply
(232,448 B opt-in shared memory per block, 132 SMs).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Mapping

import torch

# Hopper machine model (NVIDIA H100 data sheet and Hopper tuning guide).
WARP = 32            # threads per warp
VEC_BYTES = 16       # widest per-thread vector load/store
LINE_BYTES = 128     # L2 <-> device-memory line
CTAS_PER_SM = 4      # grid target: at least this many CTAs per SM
CTA_THREADS = 256    # threads per CTA of every kernel (kThreads, csrc/common.cuh)
ROW_UNIT = 1         # rows pad to no tile: Hopper has no sublane tile

# Data-sheet defaults for an H100 SXM, used when no CUDA device is present.
H100_SMEM_PER_CTA = 232_448   # 227 KiB opt-in shared memory per block
H100_SM_COUNT = 132


def vector_unit(itemsize: int) -> int:
    """Minor-dim unit in elements: one warp of 16-B vector loads
    (128 for fp32, 256 for bf16)."""
    if itemsize <= 0 or VEC_BYTES % itemsize:
        raise ValueError(f"unsupported element size {itemsize}")
    return WARP * VEC_BYTES // itemsize


@dataclasses.dataclass(frozen=True)
class HopperLimits:
    """Per-device limits the planner sizes blocks against."""

    smem_per_cta: int
    sm_count: int


@functools.cache
def _device_limits(index: int) -> HopperLimits:
    props = torch.cuda.get_device_properties(index)
    smem = None
    for attr in ("shared_memory_per_block_optin", "sharedMemPerBlockOptin"):
        smem = getattr(props, attr, None)
        if smem:
            break
    if not smem:
        raise RuntimeError(
            f"cannot read the opt-in shared memory per block of {props.name}")
    return HopperLimits(int(smem), int(props.multi_processor_count))


def hopper_limits() -> HopperLimits:
    """The current CUDA device's limits, or the H100 data-sheet defaults
    when no CUDA device is present."""
    if torch.cuda.is_available():
        return _device_limits(torch.cuda.current_device())
    return HopperLimits(H100_SMEM_PER_CTA, H100_SM_COUNT)


def round_up(n: int, multiple: int) -> int:
    """Smallest m >= n with m % multiple == 0 (multiple >= 1)."""
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    if n < 0:
        raise ValueError(f"n must be non-negative, got {n}")
    return ((n + multiple - 1) // multiple) * multiple


def round_down(n: int, multiple: int) -> int:
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    return (n // multiple) * multiple


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class PaddedDim:
    """A logical dimension and the physical size the policy chose for it."""

    logical: int
    physical: int
    reason: str = ""

    @property
    def pad(self) -> int:
        return self.physical - self.logical

    @property
    def waste(self) -> float:
        """Fraction of the physical extent that is padding."""
        return self.pad / self.physical if self.physical else 0.0


@dataclasses.dataclass(frozen=True)
class LayoutPolicy:
    """Analytic padding policy for model dimensions on Hopper.

    minor_unit:
        minor-dim unit in elements (``vector_unit(itemsize)``: 128 for fp32).
    tp:
        tensor-parallel degree; a sharded minor dim pads to ``tp * minor_unit``
        so every shard keeps 16-B aligned rows.
    pad_to_mesh:
        if False, produce the paper-naive layout (logical sizes untouched).
    """

    minor_unit: int = WARP * VEC_BYTES // 4
    tp: int = 1
    pad_to_mesh: bool = True

    def pad_minor(self, n: int, *, sharded: bool = False) -> PaddedDim:
        """Pad a minor dimension to whole warp-wide vector spans."""
        if not self.pad_to_mesh:
            return PaddedDim(n, n, "plain")
        m = self.minor_unit * (self.tp if sharded else 1)
        return PaddedDim(n, round_up(n, m), f"vec{'xTP' if sharded else ''}={m}")

    def pad_count(self, n: int, *, sharded: bool = False) -> PaddedDim:
        """Pad a 'count' dimension (heads, experts): only mesh divisibility
        matters."""
        if not self.pad_to_mesh or not sharded or self.tp <= 1:
            return PaddedDim(n, n, "plain")
        return PaddedDim(n, round_up(n, self.tp), f"count%TP={self.tp}")

    def pad_vocab(self, n: int) -> PaddedDim:
        """Vocab is sharded minor-most over TP for the output projection."""
        return self.pad_minor(n, sharded=True)

    def plan(self, dims: Mapping[str, tuple[int, str]]) -> dict[str, PaddedDim]:
        """Plan named dims: ``dims[name] = (logical, kind)`` with kind in
        {minor, minor_sharded, count, count_sharded, vocab}.  Rows need no
        padding on Hopper (row unit 1)."""
        rules = {
            "minor": lambda n: self.pad_minor(n),
            "minor_sharded": lambda n: self.pad_minor(n, sharded=True),
            "count": lambda n: self.pad_count(n),
            "count_sharded": lambda n: self.pad_count(n, sharded=True),
            "vocab": self.pad_vocab,
        }
        out: dict[str, PaddedDim] = {}
        for name, (n, kind) in dims.items():
            if kind not in rules:
                raise ValueError(f"unknown dim kind {kind!r} for {name!r}")
            out[name] = rules[kind](n)
        return out

    @staticmethod
    def total_waste(plan: Mapping[str, PaddedDim]) -> float:
        """Aggregate padding fraction over a plan (unweighted mean)."""
        if not plan:
            return 0.0
        return sum(d.waste for d in plan.values()) / len(plan)


def choose_block_shape(
    rows: int,
    cols: int,
    *,
    bytes_per_el: int,
    n_buffers: int,
    smem_budget: int,
    sm_count: int,
    minor_unit: int,
) -> tuple[int, int]:
    """Pick the (rows, cols) block one CTA of a full-width streaming kernel
    walks.  Closed form, no search:

      * columns: the whole row, rounded to whole warp-wide vector spans;
      * fit: one CTA's in-flight bytes, ``n_buffers`` row blocks of
        ``cols * bytes_per_el``, stay within the per-CTA shared-memory
        budget -> ``rows <= smem_budget // (cols * bytes_per_el * n_buffers)``;
      * fill: the grid holds at least ``CTAS_PER_SM`` CTAs per SM when the
        rows allow -> ``rows <= rows_total // (CTAS_PER_SM * sm_count)``;
      * the block takes the largest row count both rules allow, and at
        least one row (a single row wider than the budget is walked by one
        CTA, a grid with fewer rows than SMs gives every row its own CTA).
    """
    bcols = round_up(max(cols, 1), minor_unit)
    fit = smem_budget // max(bcols * bytes_per_el * n_buffers, 1)
    fill = rows // (CTAS_PER_SM * sm_count)
    brows = max(1, min(fit, fill, rows))
    return int(brows), int(bcols)
