"""Layout planner: from a kernel's stream signature to its Hopper launch geometry.

The counterpart of ``repro.core.planner`` (single-device part).  Each kernel
family declares its ``StreamSignature`` (how many read/write streams of what
element size) and the planner derives, in closed form and without search,

  * the padded *physical* shape: the minor dim a whole number of warp-wide
    16-B vector spans (``layout.vector_unit``), rows unpadded (row unit 1);
  * the block one CTA walks (``_fit_block``): in-flight bytes within the
    per-CTA shared-memory budget, enough CTAs to fill every SM; the LBM
    collision holds no shared-memory tile, and its block is one site per
    thread of a CTA (``_plan_lbm``); a column-tiled family (``COL_TILED``,
    the cross-entropy) walks whole rows in passes of its CTA's threads
    (``_plan_col_tiled``); a stencil family (``STENCIL``, Jacobi) owns a
    2-D tile, a column tile of one vector a thread by a strip of rows
    (``stencil_block``);
  * the per-stream skews and segment shift (``plan_streams``), scored under
    the interleaved-memory conflict model.

Plans are memoized in a process-level cache keyed on
``(kernel, shape, dtype, mesh, model, smem_budget, sm_count, local)``.

Under a mesh (``api.plan_context(mesh=)``) a *global* plan widens the minor
dim so every model-axis shard keeps whole 16-B vectors, and a *local* plan
(``local=True``: one rank's shard under the SPMD path) pads to the plain
vector width, since a shard has no shard boundary inside it.  A
column-tiled plan, whose kernel reads rows of any width, pads nothing on
one device or in a local plan, and a global one only to equal shards.  A
local plan also prices the collectives of its launch
(``predicted_comm_bytes``, the ring cost model of ``COMM_MODEL``) and,
given the rates measured on the card, the part of them its interior cannot
hide (``predicted_exposed_comm_bytes``, ``HALO_MODEL``).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Mapping

import numpy as np
import torch

from repro_torch.core.aliasing import InterleavedMemoryModel, Stream
from repro_torch.core.autotune import LayoutPlan, StreamSignature, plan_streams
from repro_torch.core.layout import (
    CTA_THREADS,
    CTAS_PER_SM,
    VEC_BYTES,
    WARP,
    cdiv,
    choose_block_shape,
    hopper_limits,
    round_up,
    vector_unit,
)

# Widest 1-D reshape width in elements: a row long enough that every CTA
# streams many whole vector spans, short enough that a block of one row per
# stream stays far inside the per-CTA budget.
MAX_WIDTH = 4096

# The paper's per-kernel "data access properties" table: how many read and
# write streams each kernel family drives against device memory.  Element
# size is rebound to the actual dtype at planning time.
FAMILIES: dict[str, StreamSignature] = {
    "stream.copy": StreamSignature(n_read=1, n_write=1),
    "stream.scale": StreamSignature(n_read=1, n_write=1),
    "stream.add": StreamSignature(n_read=2, n_write=1),
    "stream.triad": StreamSignature(n_read=2, n_write=1),
    "triad": StreamSignature(n_read=3, n_write=1),          # Schoenauer B+C*D
    "jacobi": StreamSignature(n_read=1, n_write=1),         # rows stream once
    "lbm.soa": StreamSignature(n_read=19, n_write=19),      # D3Q19 collide
    "lbm.ivjk": StreamSignature(n_read=19, n_write=19),
}

# D3Q19 direction count, needed for the LBM block geometry.  Kept local so
# core never imports the kernels package.
_LBM_Q = 19

# In-flight row buffers per CTA when it differs from the stream count + 1.
# A Jacobi thread holds a ring of row vectors in registers (``kRing`` of
# ``csrc/jacobi.cu``): the rows above, at and below its output row and the
# rows whose loads are in flight below them.
CTA_BUFFERS: dict[str, int] = {"jacobi": 4}

# How many of a family's streams move a full planned array each launch;
# absent families move one per signature stream.  Jacobi's neighbour rows
# are re-read from cache, so the grid streams in once and out once; the LBM
# lattice already holds all 19 direction rows and is read and written once;
# RMSNorm reads x (and the gate z) and writes y, its scale vector is a
# width-sized side stream; the cross-entropy reads its logits once, and its
# labels and per-token NLL are row-sized side streams
# (``MINOR_STREAM_BYTES``).  The split norm's stats pass reads x (and z)
# and writes only a row statistic; its apply pass reads x (and z) and
# writes y, with the scale and the statistic as side streams.
MAJOR_STREAMS: dict[str, int] = {"jacobi": 2, "lbm.soa": 2, "lbm.ivjk": 2,
                                 "rmsnorm": 2, "rmsnorm.gated": 3, "xent": 1,
                                 "rmsnorm.sumsq": 1, "rmsnorm.gated.sumsq": 2,
                                 "rmsnorm.apply": 2,
                                 "rmsnorm.gated.apply": 3}

# Side-operand bytes per launch beside the major streams: (rows, width,
# element bytes) -> bytes.  RMSNorm's scale is one row; labels are int32 and
# the NLL fp32 whatever the logits' dtype; the split norm's row statistic
# is fp32 (written by the stats pass, read by the apply pass).
MINOR_STREAM_BYTES: dict[str, Callable[[int, int, int], int]] = {
    "rmsnorm": lambda rows, width, eb: width * eb,
    "rmsnorm.gated": lambda rows, width, eb: width * eb,
    "xent": lambda rows, width, eb: rows * 4 + rows * 4,
    "rmsnorm.sumsq": lambda rows, width, eb: rows * 4,
    "rmsnorm.gated.sumsq": lambda rows, width, eb: rows * 4,
    "rmsnorm.apply": lambda rows, width, eb: width * eb + rows * 4,
    "rmsnorm.gated.apply": lambda rows, width, eb: width * eb + rows * 4,
}

# Families whose kernels tile the minor dim too.  Every other 2-D kernel
# streams full-width row blocks, so its rows are charged against the whole
# padded width; a column-tiled kernel (online softmax) folds a row in passes
# and holds one pass of it at a time (``_plan_col_tiled``).
COL_TILED = {"xent"}

# Stencil families whose kernels tile both dims (``_plan_stencil``): a CTA
# owns a column tile of one 16-B vector a thread and walks a strip of rows,
# so the rows it holds are a ring of vectors, not full-width rows.
STENCIL = {"jacobi"}

# The rows a stencil CTA walks when the grid is tall enough: as many as a
# thread's ring of row vectors holds (``CTA_BUFFERS``), so that a CTA issues
# the loads of its whole strip but the two rows below it at once, one trip
# to memory as the STREAM kernels make; the strip's two halo rows, read
# again by the strips above and below while they are in flight, come from
# L2.
STRIP_ROWS = CTA_BUFFERS["jacobi"]

# A column-tiled CTA walks rows until it has streamed at least this many
# bytes, so a narrow row does not pay a CTA's reduction and launch alone;
# a row this wide or wider is one CTA's block.
COL_TILED_CTA_BYTES = 64 * 1024


# ---------------------------------------------------------------------------
# Predicted interconnect traffic (SPMD launches)
# ---------------------------------------------------------------------------
# Per-rank wire bytes one SPMD launch of a *local* plan moves, under the
# ring cost model (the reference's formulas):
#
#     all-reduce           2 (N-1)/N x payload
#     shift (ppermute)               payload
#
# The mesh-axis names are the ``parallel.rules.DEFAULT_RULES`` targets the
# kernels' partitionings resolve to ("batch" -> data, "vocab" -> model).
# The model assumes the declared partitioning engaged; a divisibility
# fallback to replication moves fewer bytes.  Families absent here
# communicate nothing (batch-parallel shards are independent).


def _ring_all_reduce_bytes(payload: int, n: int) -> int:
    return int(2 * (n - 1) / n * payload) if n > 1 else 0


def _comm_jacobi(plan: "KernelPlan", sizes: Mapping[str, int]) -> int:
    # One (1, cols) halo row shifted up and one down per sweep, at the
    # logical column count (the stripe is pitched after the exchange).
    if sizes.get("data", 1) <= 1:
        return 0
    return 2 * int(plan.logical_shape[-1]) * plan.elem_bytes


# Of D3Q19's 19 directions, 5 have c_x = +1 and 5 have c_x = -1 (one face
# and four edges each way); the other 9 never cross an X cut.  Kept here so
# core never imports the kernels package (as ``_LBM_Q``).
_LBM_X_DIRS = 5


def _comm_lbm(plan: "KernelPlan", sizes: Mapping[str, int]) -> int:
    # X-sharded lattice (Q, X, Y, Z): each step shifts one (5, 1, Y, Z)
    # slab of +x-moving populations down the ring and one of -x-moving
    # populations up it -- only the 10 directions with c_x != 0 cross the
    # cut, at depth |c_x| = 1.
    if sizes.get("data", 1) <= 1:
        return 0
    y, z = (int(s) for s in plan.logical_shape[2:4])
    return 2 * _LBM_X_DIRS * y * z * plan.elem_bytes


def _comm_xent(plan: "KernelPlan", sizes: Mapping[str, int]) -> int:
    # Vocab-parallel lse combine: pmax(m) + psum(l) + psum(label logit),
    # three fp32 vectors over the local token rows, all-reduced across the
    # model axis; plus the 4-byte scalar pmean of the per-shard NLL over the
    # batch axes.
    mv = sizes.get("model", 1)
    d = sizes.get("data", 1)
    rows = int(plan.logical_shape[0])
    return (_ring_all_reduce_bytes(3 * rows * 4, mv)
            + _ring_all_reduce_bytes(4, d))


COMM_MODEL: dict[str, Callable[["KernelPlan", Mapping[str, int]], int]] = {
    "jacobi": _comm_jacobi,
    "xent": _comm_xent,
    "lbm.soa": _comm_lbm,
    "lbm.ivjk": _comm_lbm,
}

# Halo geometry of the families whose shard bodies overlap their exchange
# with the interior: (sharded logical dim, halo depth).  While the interior
# streams ``MAJOR_STREAMS x interior elements`` through device memory, the
# link moves that window scaled by link rate / memory rate; the rest of the
# halo stays exposed.  A family with a ``COMM_MODEL`` entry but no halo
# (the cross-entropy's combine, whose compute needs its result) exposes all
# of it.  The rates are measured on the card and passed in
# (``KernelPlan.predicted_exposed_comm_bytes``): no rate is assumed here.
HALO_MODEL: dict[str, tuple[int, int]] = {
    "jacobi": (0, 1),     # one row up and one row down over the data axis
    "lbm.soa": (1, 1),    # X planes; 2 x 5 direction slabs of depth 1
    "lbm.ivjk": (1, 1),
}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a torch, numpy or string dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"not a dtype: {dtype!r}")
    return out


def dtype_name(dtype) -> str:
    """Canonical name of a torch, numpy or string dtype ("float32", ...)."""
    return str(torch_dtype(dtype)).removeprefix("torch.")


def itemsize(dtype) -> int:
    return torch_dtype(dtype).itemsize


def register_family(name: str, signature: StreamSignature, *,
                    cta_buffers: int | None = None,
                    col_tiled: bool = False) -> None:
    """Declare (or re-assert) a kernel family's stream signature.

    The registry calls this when a kernel registers, so the planner's table
    and the registered kernels cannot drift: a second declaration with a
    different signature or buffer count is a shadowed name and raises.  A
    declaration that brings new block geometry (a first ``cta_buffers``, or
    ``col_tiled`` newly set) drops the family's cached plans.
    """
    cur = FAMILIES.get(name)
    if cur is not None and (cur.n_read, cur.n_write) != (
            signature.n_read, signature.n_write):
        raise ValueError(
            f"kernel family {name!r} already declared with "
            f"{cur.n_read}R+{cur.n_write}W; refusing shadow declaration "
            f"{signature.n_read}R+{signature.n_write}W"
        )
    geometry_changed = False
    if cta_buffers is not None:
        prev = CTA_BUFFERS.get(name)
        if prev is not None and prev != cta_buffers:
            raise ValueError(
                f"kernel family {name!r} already declared with {prev} CTA "
                f"buffers; refusing shadow declaration {cta_buffers}"
            )
        geometry_changed = prev is None
        CTA_BUFFERS[name] = cta_buffers
    FAMILIES[name] = signature
    if col_tiled and name not in COL_TILED:
        COL_TILED.add(name)
        geometry_changed = True
    if geometry_changed:
        with _LOCK:
            for key in [k for k in _CACHE if k[0] == name]:
                del _CACHE[key]


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Everything a kernel wrapper needs to lay its arrays out."""

    kernel: str
    logical_shape: tuple[int, ...]
    dtype: str
    padded_shape: tuple[int, ...]
    block_shape: tuple[int, ...]
    signature: StreamSignature
    layout: LayoutPlan
    naive_balance: float
    # Minor-dim unit the width is a multiple of: the dtype's vector unit,
    # or the fp32 unit when the narrow-dtype rule took the fp32 geometry;
    # 1 (one element) for a column-tiled family, whose kernel reads rows of
    # any width.
    minor_unit: int = 128
    # ((axis, size), ...) of the mesh the plan was made under; () for one
    # device.
    mesh: tuple[tuple[str, int], ...] = ()
    # True for one rank's shard under the SPMD path (``plan_for(...,
    # local=True)``): the minor dim was not widened for the model axis, and
    # ``predicted_comm_bytes`` describes the shard's collectives.
    local: bool = False
    # "analytic" (the closed form) or where a pinned plan came from.
    provenance: str = dataclasses.field(default="analytic", compare=False)

    # ---- geometry --------------------------------------------------------
    @property
    def rows(self) -> int:
        return self.padded_shape[0]

    @property
    def width(self) -> int:
        return self.padded_shape[-1]

    @property
    def block_rows(self) -> int:
        return self.block_shape[0]

    @property
    def block_cols(self) -> int:
        return self.block_shape[-1]

    @property
    def grid(self) -> tuple[int, ...]:
        return tuple(cdiv(p, b) for p, b in zip(self.padded_shape, self.block_shape))

    # ---- accounting ------------------------------------------------------
    @property
    def logical_elems(self) -> int:
        return int(np.prod(self.logical_shape, dtype=np.int64))

    @property
    def padded_elems(self) -> int:
        return int(np.prod(self.padded_shape, dtype=np.int64))

    @property
    def waste(self) -> float:
        """Fraction of the physical footprint that is padding."""
        p = self.padded_elems
        return (p - self.logical_elems) / p if p else 0.0

    @property
    def elem_bytes(self) -> int:
        return itemsize(self.dtype)

    @property
    def waste_bytes(self) -> int:
        """Padding overhead in bytes: a bf16 plan can pad more elements
        than the fp32 plan of the same shape yet cost fewer bytes."""
        return (self.padded_elems - self.logical_elems) * self.elem_bytes

    @property
    def predicted_balance(self) -> float:
        return self.layout.predicted_balance

    # ---- predicted traffic ----------------------------------------------
    def _traffic_bytes(self, elems: int, shape: tuple[int, ...]) -> int:
        major = MAJOR_STREAMS.get(self.kernel, self.signature.n_streams)
        total = major * elems * self.elem_bytes
        minor = MINOR_STREAM_BYTES.get(self.kernel)
        if minor is not None:
            total += minor(int(shape[0]), int(shape[-1]), self.elem_bytes)
        return total

    @property
    def predicted_hbm_bytes(self) -> int:
        """Device-memory traffic per launch at the planned physical
        footprint: every major stream moves one padded array, plus the
        family's side operands."""
        return self._traffic_bytes(self.padded_elems, self.padded_shape)

    @property
    def predicted_logical_bytes(self) -> int:
        """The same traffic at the logical footprint; the difference to
        ``predicted_hbm_bytes`` is what the padding costs per launch."""
        return self._traffic_bytes(self.logical_elems, self.logical_shape)

    @property
    def predicted_comm_bytes(self) -> int:
        """Per-rank interconnect bytes one SPMD launch of this plan moves
        (ring cost model, ``COMM_MODEL``).  Nonzero only for *local* plans
        under a mesh: a global plan describes the single-device path, which
        communicates nothing."""
        if not self.local or not self.mesh:
            return 0
        fn = COMM_MODEL.get(self.kernel)
        return 0 if fn is None else fn(self, dict(self.mesh))

    def predicted_exposed_comm_bytes(
            self, *, hbm_bytes_per_s: float | None = None,
            link_bytes_per_s: float | None = None) -> int:
        """The part of ``predicted_comm_bytes`` left on the critical path:
        the total less what the interior's device-memory stream can hide
        (``HALO_MODEL``), at the device-memory and link rates measured on
        the card.  Raises without both rates: the planner holds none."""
        if hbm_bytes_per_s is None or link_bytes_per_s is None:
            raise ValueError(
                "predicted_exposed_comm_bytes needs the measured "
                "device-memory and link rates (hbm_bytes_per_s=, "
                "link_bytes_per_s=)")
        total = self.predicted_comm_bytes
        spec = HALO_MODEL.get(self.kernel)
        if total == 0 or spec is None:
            return total
        dim, depth = spec
        interior = [int(s) for s in self.logical_shape]
        interior[dim] = max(interior[dim] - 2 * depth, 0)
        major = MAJOR_STREAMS.get(self.kernel, self.signature.n_streams)
        window = major * int(np.prod(interior, dtype=np.int64)) * self.elem_bytes
        hidden = min(total, int(window * link_bytes_per_s / hbm_bytes_per_s))
        return total - hidden

    def explain(self) -> str:
        """Human-readable report: predicted balance, waste, block geometry."""
        sig = self.signature
        grid = "x".join(str(g) for g in self.grid)
        block = "x".join(str(b) for b in self.block_shape)
        return (
            f"plan[{self.kernel}] logical={self.logical_shape} {self.dtype}"
            f" -> physical {self.padded_shape}, block {block}, grid {grid},"
            f" minor unit {self.minor_unit}"
            + (" (column-tiled: the kernel reads rows of any width in"
               " place)" if self.kernel in COL_TILED else "")
            + (" (2-D tiles: a strip of rows x a column tile a CTA)"
               if self.kernel in STENCIL else "")
            + "\n"
            f"  streams: {sig.n_read}R+{sig.n_write}W x {sig.elem_bytes}B"
            f"  align={self.layout.align_bytes}B"
            f" offsets={self.layout.offsets_bytes}B"
            f" segment-shift={self.layout.segment_shift_bytes}B\n"
            f"  predicted balance {self.predicted_balance:.2f}"
            f" (naive {self.naive_balance:.2f}),"
            f" waste {self.waste:.1%}"
            f" ({self.padded_elems - self.logical_elems} pad elems)\n"
            f"  predicted traffic {self.predicted_hbm_bytes}B"
            f" (logical {self.predicted_logical_bytes}B,"
            f" comm {self.predicted_comm_bytes}B)"
            + ("" if not self.local
               else f"\n  local shard plan for mesh "
                    f"{dict(self.mesh) or '(none)'}")
            + ("" if self.provenance == "analytic"
               else f"\n  source: {self.provenance}")
        )


# ---------------------------------------------------------------------------
# Plan cache
# ---------------------------------------------------------------------------

_CACHE: dict[tuple, KernelPlan] = {}
_STATS = {"hits": 0, "misses": 0}
_LOCK = threading.RLock()
_DEFAULT_MODEL = InterleavedMemoryModel()


def _mesh_key(mesh) -> tuple[tuple[str, int], ...]:
    """``((axis, size), ...)`` of a ``launch.mesh.Mesh``, a mapping or
    pairs; () for none."""
    if mesh is None:
        return ()
    if hasattr(mesh, "axis_names") and hasattr(mesh, "shape"):
        return tuple((str(a), int(n)) for a, n in zip(mesh.axis_names,
                                                      mesh.shape))
    if isinstance(mesh, Mapping):
        return tuple(sorted((str(k), int(v)) for k, v in mesh.items()))
    return tuple((str(k), int(v)) for k, v in mesh)


def plan_kernel(
    kernel: str,
    shape,
    dtype,
    *,
    mesh=None,
    model: InterleavedMemoryModel | None = None,
    smem_budget: int | None = None,
    sm_count: int | None = None,
    local: bool = False,
) -> KernelPlan:
    """Memoized analytic plan for ``kernel`` on a logical ``shape``/``dtype``.

    ``smem_budget`` (per-CTA bytes) and ``sm_count`` default to the current
    CUDA device's limits, or the H100 data sheet when there is none
    (``layout.hopper_limits``); both are normally supplied by the ambient
    ``repro_torch.api.PlanContext``, as is ``mesh`` (a ``Mesh``, a mapping
    or ``(axis, size)`` pairs), which widens a 2-D plan's minor dim so each
    model-axis shard keeps whole vectors.  ``local=True`` plans one rank's
    shard under the SPMD path: the shape is already a slice, so its minor
    dim is not widened again; the mesh still keys the memo, so local plans
    never collide with global plans of the same shape.
    """
    if kernel not in FAMILIES:
        raise KeyError(
            f"unknown kernel family {kernel!r}; known: {sorted(FAMILIES)}"
        )
    name = dtype_name(dtype)
    model = model or _DEFAULT_MODEL
    if smem_budget is None or sm_count is None:
        limits = hopper_limits()
        smem_budget = limits.smem_per_cta if smem_budget is None else smem_budget
        sm_count = limits.sm_count if sm_count is None else sm_count
    budget, sms = int(smem_budget), int(sm_count)
    if budget <= 0:
        raise ValueError(f"smem_budget must be positive, got {smem_budget}")
    if sms <= 0:
        raise ValueError(f"sm_count must be positive, got {sm_count}")
    mesh_key = _mesh_key(mesh)
    key = (kernel, tuple(int(s) for s in shape), name, mesh_key, model,
           budget, sms, bool(local))
    with _LOCK:
        plan = _CACHE.get(key)
        if plan is not None:
            _STATS["hits"] += 1
            return plan
        _STATS["misses"] += 1
        plan = _plan_uncached(kernel, key[1], name, model, budget, sms,
                              mesh_key=mesh_key, local=bool(local))
        _CACHE[key] = plan
        return plan


def plan_cache_info() -> dict[str, int]:
    with _LOCK:
        return {"hits": _STATS["hits"], "misses": _STATS["misses"],
                "size": len(_CACHE)}


def plan_cache_keys() -> list[tuple]:
    """Snapshot of the memo keys ``(kernel, shape, dtype, mesh, model,
    smem_budget, sm_count, local)``: which cells reached the planner."""
    with _LOCK:
        return list(_CACHE)


def clear_plan_cache() -> None:
    with _LOCK:
        _CACHE.clear()
        _STATS["hits"] = _STATS["misses"] = 0


def invalidate_mesh_plans(mesh) -> int:
    """Drop every memoized plan keyed to ``mesh`` (global and local cells);
    returns the count.  Plans for other meshes and the single-device cells
    survive: a topology change makes only its own mesh's plans stale."""
    if mesh is None:
        return 0
    mesh_key = _mesh_key(mesh)
    with _LOCK:
        stale = [k for k in _CACHE if k[3] == mesh_key]
        for k in stale:
            del _CACHE[k]
        return len(stale)


def explain(kernel: str, shape, dtype, *, mesh=None,
            model: InterleavedMemoryModel | None = None,
            smem_budget: int | None = None,
            sm_count: int | None = None) -> str:
    """Convenience: plan and render the report in one call."""
    return plan_kernel(kernel, shape, dtype, mesh=mesh, model=model,
                       smem_budget=smem_budget, sm_count=sm_count).explain()


# ---------------------------------------------------------------------------
# Closed-form planning rules
# ---------------------------------------------------------------------------

def _plan_uncached(kernel: str, shape: tuple[int, ...], name: str,
                   model: InterleavedMemoryModel, budget: int,
                   sms: int, *, mesh_key=(), local: bool = False
                   ) -> KernelPlan:
    size = itemsize(name)
    sig = dataclasses.replace(FAMILIES[kernel], elem_bytes=size)
    n_buffers = CTA_BUFFERS.get(kernel, sig.n_streams + 1)
    unit = vector_unit(size)
    # A shard-local plan pads the minor dim to the plain vector unit: the
    # tensor-parallel widening aligns *global* arrays to their shard
    # boundaries, and one rank's slice has no shard boundary in it.
    tp = 1 if local else max(dict(mesh_key).get("model", 1), 1)
    if kernel.startswith("lbm."):
        padded, block = _plan_lbm(kernel, shape, unit)
    elif kernel in COL_TILED:
        padded, block = _plan_col_tiled(kernel, shape, size, sms, tp)
        unit = 1
    elif kernel in STENCIL:
        padded, block = _plan_stencil(kernel, shape, size, unit, sms, tp)
    elif len(shape) == 1:
        padded, block = _plan_1d(shape[0], size, unit, n_buffers, budget, sms)
    elif len(shape) == 2:
        padded, block = _plan_2d(shape, size, unit, n_buffers, budget, sms,
                                 tp)
    else:
        raise ValueError(f"{kernel}: cannot plan rank-{len(shape)} shape {shape}")
    plan = KernelPlan(
        kernel=kernel,
        logical_shape=shape,
        dtype=name,
        padded_shape=padded,
        block_shape=block,
        signature=sig,
        layout=_plan_layout(sig, model),
        naive_balance=_naive_balance(sig, model),
        minor_unit=unit,
        mesh=mesh_key,
        local=local,
    )
    # Narrow-dtype waste guarantee: a bf16 plan never pays more padding
    # bytes than the fp32 plan of the same logical shape.  The bf16 vector
    # unit (256 elements) is twice the fp32 one, so a minor dim just past a
    # 128 multiple can pad more bytes at bf16.  The fp32 geometry is legal
    # at bf16 (128 bf16 elements = 256 B keeps every row 16-B aligned) and
    # costs exactly itemsize/4 of the fp32 padding bytes, so take the
    # cheaper of the two.  A column-tiled plan pads nothing on one device
    # (its kernel reads any width), so the rule has nothing to save there.
    if size < 4 and kernel not in COL_TILED:
        f32 = plan_kernel(kernel, shape, torch.float32, mesh=mesh_key,
                          model=model, smem_budget=budget, sm_count=sms,
                          local=local)
        if plan.waste_bytes * 4 > f32.waste_bytes * size:
            block = f32.block_shape
            if kernel in STENCIL:       # the tile is vectors of this dtype
                rows, width = f32.padded_shape
                block = stencil_block(rows, width, size, sms)
            plan = dataclasses.replace(
                plan, padded_shape=f32.padded_shape,
                block_shape=block, minor_unit=f32.minor_unit,
            )
    return plan


def _plan_layout(sig: StreamSignature, model: InterleavedMemoryModel) -> LayoutPlan:
    """The analytic skew plan, scored as deployed: n_channels concurrent
    segments whose chunk stride is congruent to one channel step."""
    step = 1 << model.channel_shift
    return plan_streams(
        sig, model,
        n_threads=model.n_channels,
        chunk_bytes=model.period_bytes + step,
    )


def _naive_balance(sig: StreamSignature, model: InterleavedMemoryModel) -> float:
    """Score of the unplanned layout: page-aligned streams, period-aliased
    segments (paper Fig. 2, offset zero)."""
    streams = [
        Stream(base=0, kind="write" if k < sig.n_write else "read")
        for k in range(sig.n_streams)
    ]
    return model.balance(streams, n_threads=model.n_channels,
                         chunk_bytes=model.period_bytes)


def _fit_block(rows: int, width: int, size: int, unit: int, n_buffers: int,
               budget: int, sms: int) -> tuple[int, int, int]:
    """Rows per CTA for a full-width (rows, width) kernel.

    ``choose_block_shape`` gives the largest block that fits the budget and
    fills the SMs.  A divisor of the row count within half of it is taken
    (no extra padding, at most twice the CTAs); failing that, rows pad up to
    a block multiple, which costs at most one block of padding.
    Returns (padded rows, block rows, block cols)."""
    brows, bcols = choose_block_shape(
        rows, width, bytes_per_el=size, n_buffers=n_buffers,
        smem_budget=budget, sm_count=sms, minor_unit=unit,
    )
    for cand in range(brows, max(brows // 2, 1) - 1, -1):
        if rows % cand == 0:
            return rows, cand, bcols
    return round_up(rows, brows), brows, bcols


def _plan_1d(n: int, size: int, unit: int, n_buffers: int, budget: int,
             sms: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """1-D stream of n elements -> (rows, width) layout.

    The width is n rounded up to the vector unit, capped at MAX_WIDTH; the
    rows are as many as n needs.  Padding is therefore under one vector
    unit for n <= MAX_WIDTH and under one row beyond."""
    n = max(int(n), 1)
    width = round_up(min(n, MAX_WIDTH), unit)
    rows, brows, bcols = _fit_block(cdiv(n, width), width, size, unit,
                                    n_buffers, budget, sms)
    return (rows, width), (brows, bcols)


def _plan_2d(shape: tuple[int, ...], size: int, unit: int, n_buffers: int,
             budget: int, sms: int, tp: int = 1
             ) -> tuple[tuple[int, int], tuple[int, int]]:
    """(rows, cols) kernel: rows as they are, cols padded to the vector
    unit (the row pitch keeps every row 16-B aligned), times ``tp`` when
    the minor dim shards over a model axis of that size."""
    r, c = shape
    width = round_up(max(int(c), 1), unit * tp)
    rows, brows, bcols = _fit_block(max(int(r), 1), width, size, unit,
                                    n_buffers, budget, sms)
    return (rows, width), (brows, bcols)


def stencil_block(rows: int, width: int, size: int,
                  sms: int) -> tuple[int, int]:
    """The 2-D tile one CTA of a stencil kernel (``STENCIL``) owns on a
    (rows, width) grid.  Closed form, no search:

      * columns: one 16-B vector a thread, ``CTA_THREADS`` threads, fewer
        on a narrow grid (whole warps covering the width): the tile is
        ``threads * VEC_BYTES / size`` columns.  A thread holds
        ``CTA_BUFFERS`` row vectors in registers, not rows in shared
        memory, so the width puts no bound on the strip;
      * rows: a strip of ``STRIP_ROWS``, fewer where the grid would
        otherwise hold under ``CTAS_PER_SM`` CTAs on every SM (column tiles
        x strips), and at least one row: a 3-row boundary slab still
        spreads over width / tile CTAs.  The kernel cuts the last strip
        short itself, so the rows are not padded.

    Returns (strip rows, tile columns)."""
    vec = VEC_BYTES // size
    threads = min(CTA_THREADS, round_up(cdiv(max(width, 1), vec), WARP))
    tile = threads * vec
    tiles = cdiv(max(width, 1), tile)
    fill = rows * tiles // (CTAS_PER_SM * sms)
    strip = max(1, min(STRIP_ROWS, fill, rows))
    return strip, tile


def _plan_stencil(kernel: str, shape: tuple[int, ...], size: int, unit: int,
                  sms: int, tp: int = 1
                  ) -> tuple[tuple[int, int], tuple[int, int]]:
    """(rows, cols) stencil layout: rows as they are, cols padded to the
    vector unit as in ``_plan_2d`` (every row 16-B aligned), the block a
    2-D tile (``stencil_block``)."""
    if len(shape) != 2:
        raise ValueError(f"{kernel}: needs a (rows, cols) shape, got {shape}")
    width = round_up(max(int(shape[1]), 1), unit * tp)
    rows = max(int(shape[0]), 1)
    return (rows, width), stencil_block(rows, width, size, sms)


def _plan_lbm(kernel: str, shape: tuple[int, ...],
              unit: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """D3Q19 collision layouts.  ``shape`` is the lattice (Q, X, Y, Z); its
    S = X*Y*Z sites are cut into chunks of L = ``unit`` sites (the vector
    unit: 128 at fp32), so a warp's 32 neighbouring sites of one direction
    are one coalesced line walk in either layout.

    soa : f stored (Q, S_pad)        -- block (Q, bsb*L);
    ivjk: f stored (S_pad/L, Q, L)   -- directions interleaved every L
                                        sites; block (bsb, Q, L).

    The collision keeps one site per thread in registers and holds no
    shared-memory tile, so the budget rule does not apply.  The block is
    the fewest chunks that give each of a CTA's ``CTA_THREADS`` threads one
    site, and the grid fills the SMs by count: S_pad / (bsb*L) CTAs, at
    least CTAS_PER_SM per SM above 135,168 sites at fp32.  Small blocks
    keep the last, partial wave of CTAs down to one block's sites, where a
    grid of one block per resident CTA slot would leave a whole block to
    run alone when the count misses a wave by one.  S_pad pads S up to a
    block multiple, less than bsb*L sites."""
    q = int(shape[0])
    if q != _LBM_Q:
        raise ValueError(f"{kernel}: leading dim must be Q={_LBM_Q}, got {q}")
    sites = max(int(np.prod(shape[1:], dtype=np.int64)), 1)
    bsb = max(CTA_THREADS // unit, 1)
    chunks = round_up(cdiv(sites, unit), bsb)
    if kernel == "lbm.soa":
        return (q, chunks * unit), (q, bsb * unit)
    return (chunks, q, unit), (bsb, q, unit)


def _plan_col_tiled(kernel: str, shape: tuple[int, ...], size: int,
                    sms: int, tp: int = 1
                    ) -> tuple[tuple[int, int], tuple[int, int]]:
    """(rows, cols) online-softmax layout: a CTA owns whole rows and folds
    each in passes of its ``CTA_THREADS`` threads, one 16-B vector a thread.

    * width: cols as they are, on one device and in a shard-local plan.
      The kernel reads a row of any width in place (its ragged head and
      tail by scalar loads, ``csrc/xent.cu``), so nothing is padded and
      the caller's tensor reaches it without a copy; rows are not padded
      either, the kernel stops at the last row.  A global plan under a
      model axis of ``tp`` ranks rounds the width up to a multiple of
      ``tp`` only, so that the vocab shards are equal.
    * block: (rows a CTA walks, the columns one pass covers).  A CTA holds
      one pass in flight whatever its row count, so no shared-memory budget
      bounds the rows; they are the fewest that stream
      ``COL_TILED_CTA_BYTES``, capped so the grid keeps ``CTAS_PER_SM``
      CTAs on every SM where the rows allow.  On the TPU the block was a
      (rows, vocab-tile) VMEM tile with the vocab axis a sequential grid
      dimension; here the loop inside the CTA takes that axis."""
    if len(shape) != 2:
        raise ValueError(f"{kernel}: needs a (rows, cols) shape, got {shape}")
    rows, cols = max(int(shape[0]), 1), max(int(shape[1]), 1)
    width = round_up(cols, tp)
    fill = rows // (CTAS_PER_SM * sms)
    want = cdiv(COL_TILED_CTA_BYTES, width * size)
    brows = max(1, min(want, fill, rows))
    bcols = min(CTA_THREADS * (VEC_BYTES // size), width)
    return (int(shape[0]), width), (brows, bcols)
