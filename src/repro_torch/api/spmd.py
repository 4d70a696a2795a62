"""SPMD kernel launch over a mesh of ranks.

Counterpart of ``repro.api.spmd``.  A registered kernel's ``Partitioning``
says which operand axes are batch-parallel (each rank owns a shard and
launches the planned kernel on it), which are replicated, and how a scalar
result combines across shards.  ``api.launch`` detects an ambient
multi-rank ``launch.mesh.Mesh`` (``spmd_mesh``) and routes through
``spmd_launch``:

  * the specs come from ``parallel.rules`` -- the logical-axis tables the
    model uses -- restricted to the mesh's axes, with the divisibility
    fallback to replication (a vocab of 1111 over model=2 replicates, with
    a logged reason);
  * each rank plans its own *local* shape (``plan_for(..., local=True)``),
    memoized under ``(kernel, local shape, dtype, mesh, local)``;
  * scalar outputs declare their cross-shard combine (``reduce="mean"`` for
    the cross-entropy's token mean);
  * a kernel whose shards must talk declares an ``spmd_body``, which gets a
    ``ShardContext`` (the mesh axes each operand dim mapped to, and the
    collectives and shifts over them) and owns its communication: the
    cross-entropy combines its vocab shards' online-softmax partials with a
    cross-shard log-sum-exp; Jacobi shards its grid rows and LBM its X
    planes, and each rank shifts its boundary rows or direction planes to
    its neighbours, sweeps its interior while they travel, and finishes the
    boundary from what arrived (the reference's docs/OVERLAP.md).

The reference is single-controller: ``launch`` takes the global arrays and
``shard_map`` cuts them.  The port is multi-controller: each rank passes
its own shards, laid out by the declared partitioning of the global shape,
and ``spmd_launch`` checks the local shapes against that layout.  A rank
cannot tell a replicated dim from a sharded one by its local extent alone,
so a dim mapped to mesh axes is taken as sharded (global = local x shards)
unless the caller gives the global extent (``launch(..., global_shapes=)``,
one tuple an operand, ``None`` for an extent to infer) -- as the model does
for the vocab, which falls back to replication when it does not divide.

The path never nests: inside a shard body ``spmd_mesh`` returns None, and
``plan_context(spmd=False)`` opts a scope out.  A loop of many sweeps or
steps (``jacobi_sweeps``, ``lbm_run``) enters one ``shard_scope`` and runs
its shard body's step on buffers it keeps.

``overlap_report`` says which collectives and shifts of a call can hide
behind a kernel.  The reference reads the dataflow of a jaxpr; torch runs
eagerly and has none.  Its analogue here is program order, recorded while
the call runs (``kernels.util.tracing``): ``launch.mesh.Mesh`` traces the
issue of every collective and shift and its ``wait()``, and the kernel
wrappers trace every launch, on the card and on the CPU's plain path.  A
site is overlappable when at least one kernel launch lies between its
issue and its wait.  Such a launch reads nothing the transfer delivers,
since what a transfer delivers exists only once its ``wait()`` returns,
and the transfer reads nothing the launch writes, since its payload is
taken when it is issued (on the card, copied behind an event recorded
then).  A blocking collective waits where it is issued, so it is never
overlappable.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
from typing import Mapping

import torch

from repro_torch.api import context as context_lib
from repro_torch.kernels.util import tracing
from repro_torch.obs import bus as obs_bus
from repro_torch.obs import events as obs_events
from repro_torch.parallel import rules as rules_lib

__all__ = ["Partitioning", "SCALAR", "replicated", "partitioning_for",
           "spmd_mesh", "spmd_launch", "shard_scope", "ShardContext",
           "shard_specs", "overlap_report", "OverlapReport",
           "CollectiveSite"]

_log = logging.getLogger(__name__)

# Sentinel out_axes: the kernel reduces to a scalar (rank-0) result.
SCALAR = "scalar"

_REDUCES = (None, "mean", "sum")


@dataclasses.dataclass(frozen=True)
class Partitioning:
    """How one registered kernel partitions over a mesh.

    in_axes:
        one template per positional operand: a tuple of *logical* axis
        names ("batch", "vocab", ...) or ``None`` (replicate that dim), one
        entry per dimension.  An ``...`` entry expands to ``None`` for
        however many middle dims the operand has: ``("batch", ..., None)``
        is ``("batch", None)`` for (rows, d) and ``("batch", None, None)``
        for (B, S, d).
    out_axes:
        the output's template (the output is shaped like operand 0), or
        ``SCALAR`` for a rank-0 reduction result.
    reduce:
        cross-shard combine for ``SCALAR`` outputs: "mean" (exact for
        equal-sized shards) or "sum".  Required for SCALAR, forbidden
        otherwise.
    """

    in_axes: tuple[tuple, ...]
    out_axes: tuple | str = (...,)
    reduce: str | None = None

    def __post_init__(self):
        if self.reduce not in _REDUCES:
            raise ValueError(
                f"reduce must be one of {_REDUCES}, got {self.reduce!r}")
        if self.out_axes == SCALAR and self.reduce is None:
            raise ValueError(
                "a SCALAR output needs a cross-shard reduce: each shard "
                "computes only its local partial")
        if self.reduce is not None and self.out_axes != SCALAR:
            raise ValueError(
                f"reduce={self.reduce!r} only applies to SCALAR outputs")


def replicated(n_inputs: int) -> Partitioning:
    """Fully replicated: every rank computes the whole array."""
    return Partitioning(in_axes=((...,),) * n_inputs, out_axes=(...,))


def partitioning_for(entry, n_inputs: int) -> Partitioning:
    """The entry's declared partitioning, or the replicated default."""
    part = getattr(entry, "partitioning", None)
    return part if part is not None else replicated(n_inputs)


def _expand(template, ndim: int) -> tuple:
    """Instantiate an axes template for a rank-``ndim`` operand."""
    t = tuple(template)
    if Ellipsis in t:
        i = t.index(Ellipsis)
        head, tail = t[:i], t[i + 1:]
        n_mid = ndim - len(head) - len(tail)
        if n_mid < 0:
            raise ValueError(
                f"axes template {template} needs rank >= "
                f"{len(head) + len(tail)}, operand has rank {ndim}")
        return head + (None,) * n_mid + tail
    if len(t) != ndim:
        raise ValueError(
            f"axes template {template} is rank-{len(t)}, "
            f"operand has rank {ndim}")
    return t


@dataclasses.dataclass(frozen=True)
class ShardContext:
    """What a kernel's ``spmd_body`` knows about its placement.

    operand_axes:
        per operand, per dimension: the mesh axes that dimension was
        sharded over (empty = whole on this rank: declared replicated or a
        divisibility fallback).
    axis_sizes:
        ``{mesh axis: size}``.
    mesh:
        this rank's ``launch.mesh.Mesh``: its coordinates and the process
        groups the collectives below run on.
    """

    operand_axes: tuple[tuple[tuple[str, ...], ...], ...]
    axis_sizes: Mapping[str, int]
    mesh: object = None

    def axes(self, operand: int = 0, dim: int = 0) -> tuple[str, ...]:
        return self.operand_axes[operand][dim]

    def size(self, axes: tuple[str, ...]) -> int:
        """Number of shards along ``axes`` (1 when unsharded)."""
        n = 1
        for a in axes:
            n *= int(self.axis_sizes.get(a, 1))
        return n

    def index(self, axes: tuple[str, ...]) -> int:
        """This rank's linear index along ``axes`` (0 when unsharded),
        row-major over the axis tuple like the sharding is."""
        return self.mesh.index(axes) if axes else 0

    def pmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self.mesh.all_reduce(x, axes, "max")

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self.mesh.all_reduce(x, axes, "sum")

    def pmean(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self.mesh.all_reduce(x, axes, "mean")

    def ppermute(self, x: torch.Tensor, axes, perm):
        """Start shifting ``x`` by ``perm`` along ``axes``; the returned
        transfer's ``wait()`` gives what this rank received
        (``launch.mesh.Mesh.ppermute``)."""
        return self.mesh.ppermute(x, axes, perm)

    def all_gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Every rank's ``x`` along ``axes`` stacked on a new leading dim in
        the order of their index, as ``jax.lax.all_gather(tiled=False)``."""
        return self.mesh.all_gather(x[None], axes, 0)


def global_shape(local_shape, axes: tuple, table, sizes, given=None
                 ) -> tuple[int, ...]:
    """The global extent of each dim of a local shard whose logical axes
    are ``axes`` under rules ``table``: ``given[d]`` where the caller states
    it, else the local extent times the shards its mapped mesh axes make
    (first dim wins an axis, as in ``rules.spec_report``)."""
    out, used = [], set()
    for d, (n, ax) in enumerate(zip(local_shape, axes)):
        names = rules_lib.target_axes(table.get(ax) if ax is not None
                                      else None)
        kept = [a for a in names if a not in used]
        k = rules_lib.spec_size(kept, sizes)
        g = int(n) * k if given is None or given[d] is None else int(given[d])
        if g % k == 0:   # a dim that replicates consumes no mesh axis
            used.update(kept)
        out.append(g)
    return tuple(out)


def shard_specs(mesh, templates, tensors, global_shapes=None):
    """``(specs, operand_axes, axis_sizes, fallbacks, shapes)`` for axis
    ``templates`` over this rank's ``tensors`` under the ambient (or
    default) rules restricted to ``mesh``: ``shapes`` are the global
    shapes, the specs derived from them with the divisibility fallback.
    Raises if a tensor is not this rank's shard of its global shape."""
    table = rules_lib.restrict_to_mesh(
        rules_lib.current_rules() or rules_lib.DEFAULT_RULES, mesh)
    sizes = rules_lib.axis_sizes_of(mesh)
    specs, fallbacks, shapes = [], [], []
    for i, (t, a) in enumerate(zip(templates, tensors)):
        axes = _expand(t, a.ndim)
        given = None if global_shapes is None else global_shapes[i]
        gshape = global_shape(tuple(a.shape), axes, table, sizes, given)
        s, fb = rules_lib.spec_report(*axes, rules=table, shape=gshape,
                                      axis_sizes=sizes)
        want = tuple(
            g // (rules_lib.spec_size(p, sizes)) for g, p in zip(
                gshape, rules_lib.dim_axes(s, a.ndim)))
        if want != tuple(a.shape):
            raise ValueError(
                f"operand {i}: local shape {tuple(a.shape)} is not this "
                f"rank's shard {want} of global {gshape} under spec {s}")
        specs.append(s)
        fallbacks.extend(fb)
        shapes.append(gshape)
    operand_axes = tuple(rules_lib.dim_axes(s, a.ndim)
                         for s, a in zip(specs, tensors))
    return tuple(specs), operand_axes, sizes, fallbacks, tuple(shapes)


def _spec_mesh_axes(spec: tuple) -> tuple[str, ...]:
    """Every mesh axis name appearing in a spec, in order."""
    names: list[str] = []
    for part in spec:
        for n in rules_lib.target_axes(part):
            if n not in names:
                names.append(n)
    return tuple(names)


_TLS = threading.local()


@contextlib.contextmanager
def _inside_body():
    prev = getattr(_TLS, "inside", False)
    _TLS.inside = True
    try:
        yield
    finally:
        _TLS.inside = prev


def spmd_mesh(ctx: "context_lib.PlanContext | None" = None):
    """The mesh ``launch`` would route over right now, or ``None``.

    Routing requires a ``launch.mesh.Mesh`` of more than one rank (a
    ``{axis: size}`` mapping plans shard-aligned padding but places
    nothing), an SPMD-enabled context, and no enclosing shard body."""
    ctx = ctx if ctx is not None else context_lib.current_context()
    if not ctx.spmd:
        return None
    mesh = ctx.mesh
    if mesh is None:
        mesh = rules_lib.current_mesh()
    if mesh is None or isinstance(mesh, Mapping) or not hasattr(mesh,
                                                                "group"):
        return None
    if mesh.size <= 1:
        return None
    if getattr(_TLS, "inside", False):
        return None
    return mesh


_FALLBACK_LOGGED: set[tuple] = set()


def _log_fallbacks(entry, mesh, shapes, fallbacks) -> None:
    """Log (once per kernel, global shapes and mesh) every declared
    sharding that fell back to replication: the vocab-parallel rule
    degrading to whole-vocab shards is a real cost, not a detail.  Under
    an ``obs`` session each occurrence also emits an
    ``SpmdFallbackEvent``."""
    if not fallbacks:
        return
    if obs_bus.enabled():
        # every degraded launch emits; only the log line below dedups
        obs_bus.emit(obs_events.SpmdFallbackEvent(
            kernel=entry.name,
            mesh=tuple(zip(tuple(mesh.axis_names), tuple(mesh.shape))),
            reasons=tuple(fallbacks)))
    key = (entry.name, tuple(shapes), tuple(mesh.axis_names),
           tuple(mesh.shape))
    if key in _FALLBACK_LOGGED:
        return
    _FALLBACK_LOGGED.add(key)
    _log.info(
        "SPMD launch of %r over mesh %s: declared partitioning partially "
        "replicated (%s)", entry.name, mesh.axis_sizes, "; ".join(fallbacks))


@contextlib.contextmanager
def shard_scope(entry, mesh, tensors, global_shapes=None):
    """Enter the shard body of ``entry`` (a registry entry, or a kernel
    name) on this rank's shards ``tensors`` over ``mesh``: checks the local
    shapes against the declared partitioning, logs any fallback to
    replication, and yields ``(ctx, specs)``, the ``ShardContext`` and the
    operands' specs; inside, ``spmd_mesh`` is None."""
    if isinstance(entry, str):
        from repro_torch.api import registry  # lazy: registry imports this

        entry = registry.resolve(entry)
    part = partitioning_for(entry, len(tensors))
    if len(part.in_axes) != len(tensors):
        raise ValueError(
            f"{entry.name}: partitioning declares {len(part.in_axes)} "
            f"operand(s), launch got {len(tensors)}")
    specs, operand_axes, sizes, fallbacks, shapes = shard_specs(
        mesh, part.in_axes, tensors, global_shapes)
    _log_fallbacks(entry, mesh, shapes, fallbacks)
    ctx = ShardContext(operand_axes=operand_axes, axis_sizes=sizes,
                       mesh=mesh)
    with _inside_body():
        yield ctx, specs


def spmd_launch(entry, mesh, tensors, scalars, global_shapes=None):
    """Launch ``entry`` on this rank's shards ``tensors`` over ``mesh``.

    A kernel that registered an ``spmd_body`` owns its shard body: it gets
    a ``ShardContext`` and does its own exchange or combine.  Otherwise the
    generic body plans the rank's *local* shape, runs the registered body
    on it and applies the declared scalar reduce over every mesh axis the
    data operand was split across."""
    from repro_torch.api import dispatch  # lazy: dispatch imports this module

    with shard_scope(entry, mesh, tensors, global_shapes) as (ctx, specs):
        if entry.spmd_body is not None:
            return entry.spmd_body(ctx, *tensors, **scalars)
        part = partitioning_for(entry, len(tensors))
        shape, dtype = entry.plan_args(*tensors, **scalars)
        plan = dispatch.plan_for(entry.name, shape, dtype, local=True)
        dispatch._validate(entry, plan, shape, dtype)
        out = entry.body(plan, *tensors, **scalars)
        reduce_axes = (_spec_mesh_axes(specs[0])
                       if part.out_axes == SCALAR else ())
        if reduce_axes:
            out = (ctx.pmean(out, reduce_axes) if part.reduce == "mean"
                   else ctx.psum(out, reduce_axes))
        return out


# ---------------------------------------------------------------------------
# Overlap structure (see the module doc for the torch analogue of the
# reference's jaxpr dataflow).


@dataclasses.dataclass(frozen=True)
class CollectiveSite:
    """One collective or shift a call issued on this rank.

    axes:
        mesh axis names it communicates over.
    result_bytes:
        the payload this rank put on the wire, the bytes ``Mesh.comm``
        counts and the planner prices (a shift's result has its size).
    overlappable:
        True iff some kernel launch lies between its issue and its wait.
    """

    primitive: str
    axes: tuple[str, ...]
    result_bytes: int
    overlappable: bool


@dataclasses.dataclass(frozen=True)
class OverlapReport:
    collectives: tuple[CollectiveSite, ...]
    n_kernel_launches: int

    @property
    def n_overlappable(self) -> int:
        return sum(1 for c in self.collectives if c.overlappable)

    @property
    def all_overlappable(self) -> bool:
        """Every collective can hide (vacuously true with none)."""
        return all(c.overlappable for c in self.collectives)


def _report_of(events) -> OverlapReport:
    """The report of a trace (``kernels.util.tracing``'s events)."""
    sites, launches = [], 0
    for i, (kind, ev) in enumerate(events):
        if kind == "launch":
            launches += 1
        if kind != "issue":
            continue
        between = 0
        for later_kind, later in events[i + 1:]:
            if later_kind == "wait" and later["tag"] == ev["tag"]:
                break
            between += later_kind == "launch"
        else:
            between = 0               # never waited on: nothing hid it
        sites.append(CollectiveSite(primitive=ev["primitive"],
                                    axes=ev["axes"],
                                    result_bytes=ev["nbytes"],
                                    overlappable=between > 0))
    return OverlapReport(collectives=tuple(sites), n_kernel_launches=launches)


def overlap_report(fn, *args, **kwargs) -> OverlapReport:
    """Run ``fn(*args, **kwargs)`` on this rank and classify every
    collective and shift it issued as overlappable or blocking (the module
    doc says how).  The overlapped Jacobi and LBM shard bodies pass: their
    shifts are issued before the interior sweep and waited on after it.
    The blocking Jacobi body (``kernels.jacobi.ops._spmd_jacobi_blocking``)
    and the cross-entropy's log-sum-exp combine fail: nothing runs while
    they are in flight.  Under a mesh every rank calls it, as it runs
    ``fn``."""
    with tracing() as events:
        fn(*args, **kwargs)
    return _report_of(events)
