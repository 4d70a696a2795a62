"""Logical-axis sharding rules (Megatron/MaxText style).

Counterpart of ``repro.parallel.rules``.  Model code names its tensors'
dims by *logical* axes ("batch", "vocab", "heads", ...); a rules table,
chosen per mesh and per arch, maps each logical axis to zero or more mesh
axes.  A spec is the port's own tuple, one entry per dim: ``None`` (whole on
every rank), a mesh-axis name, or a tuple of them; trailing ``None``s are
dropped, as a ``jax.sharding.PartitionSpec`` drops them.

The reference applies a spec inside ``jit`` with ``with_sharding_constraint``
(``shard``), and XLA inserts the collectives a layout change needs.  The
port is multi-controller: each rank is a process that holds only its own
shards, and nothing moves data between ranks unless the code says so.  So
``shard`` has no counterpart here; the model calls the explicit
collectives of ``launch.mesh.Mesh`` (through ``api.spmd.ShardContext``)
where the reference relied on a constraint.  So do FSDP's all-gathers of
the weights and reduce-scatters of their gradients, which GSPMD inserts
for the reference where "embed" is cut over "data"
(``models.blocks.gather_params``).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Mapping

AxisTarget = str | tuple[str, ...] | None

# sensible single-pod defaults; launchers override per mesh/arch/shape
DEFAULT_RULES: dict[str, AxisTarget] = {
    "batch": ("data",),
    "seq": None,
    "embed": None,          # -> ("data",) under FSDP
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "vocab": ("model",),
    "expert": ("model",),
    "expert_mlp": None,     # grok-style few-expert TP: -> ("model",)
    "expert_cap": ("data",),  # MoE dispatch-buffer capacity axis
    "expert_out": None,       # expert-TP: reduce-scatter the output d axis
    "cache_seq": None,      # -> ("data",) for long-context decode
    "state": None,
    "layers": None,
    "conv": None,
    "frames": None,
}

# The logical axes of the models' parameters.  A rule that cuts one of them
# over a mesh axis of more than one rank is tensor parallelism or FSDP, which
# the port runs only where ``require_ported`` lets it: FSDP ("embed") over
# the batch's mesh axes, tensor parallelism off them.
PARAMETER_AXES = ("embed", "vocab", "heads", "kv_heads", "head_dim", "mlp",
                  "expert", "expert_mlp", "layers", "conv")

# The logical axes whose sharding means tensor parallelism inside a layer:
# attention heads and KV heads, the MLP, the experts (or, under
# ``expert_tp``, each expert's MLP).
TENSOR_PARALLEL_AXES = ("heads", "kv_heads", "mlp", "expert", "expert_mlp")

# The families whose layers run tensor-parallel (ROADMAP A11.5): every
# one.  The hybrid and ssm families' gated norm (and the sLSTM's output
# norm) spans the whole ``d_inner`` (or ``d``) row, which carries the "mlp"
# axis, so on a cut row it runs split: each rank's sum of squares over its
# columns, summed over the ranks, then each rank's columns normalised
# (``models.blocks.rms_norm_split``).
TENSOR_PARALLEL_FAMILIES = ("dense", "vlm", "moe", "encdec", "hybrid", "ssm")

_active: contextvars.ContextVar[Mapping[str, AxisTarget] | None] = (
    contextvars.ContextVar("repro_torch_sharding_rules", default=None)
)
_axis_sizes: contextvars.ContextVar[Mapping[str, int] | None] = (
    contextvars.ContextVar("repro_torch_mesh_axis_sizes", default=None)
)
_mesh: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


def axis_sizes_of(mesh) -> dict[str, int]:
    """``{axis: size}`` of a ``launch.mesh.Mesh`` or a mapping."""
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.axis_names, mesh.shape))


@contextlib.contextmanager
def use_rules(rules: Mapping[str, AxisTarget] | None, mesh=None):
    token = _active.set(rules)
    token2 = _axis_sizes.set(axis_sizes_of(mesh) if mesh is not None
                             else None)
    token3 = _mesh.set(mesh)
    try:
        yield
    finally:
        _active.reset(token)
        _axis_sizes.reset(token2)
        _mesh.reset(token3)


def current_mesh():
    return _mesh.get()


def current_rules() -> Mapping[str, AxisTarget] | None:
    return _active.get()


def target_axes(target: AxisTarget) -> tuple[str, ...]:
    if target is None:
        return ()
    return (target,) if isinstance(target, str) else tuple(target)


def _divisible(dim: int, target: AxisTarget,
               axis_sizes: Mapping[str, int] | None = None) -> bool:
    """True when ``dim`` can be evenly sharded over the mapped mesh axes.
    ``axis_sizes`` overrides the sizes registered via ``use_rules``.
    Unknown axis sizes are assumed fine."""
    sizes = axis_sizes if axis_sizes is not None else _axis_sizes.get()
    if sizes is None or target is None:
        return True
    n = 1
    for a in target_axes(target):
        n *= sizes.get(a, 1)
    return dim % n == 0


def restrict_to_mesh(rules: Mapping[str, AxisTarget],
                     mesh) -> dict[str, AxisTarget]:
    """A copy of ``rules`` with every target filtered to axes ``mesh``
    actually has (a ``Mesh`` or an ``{axis: size}`` mapping); missing axes
    fall back to replication."""
    names = set(axis_sizes_of(mesh))
    out: dict[str, AxisTarget] = {}
    for k, tgt in rules.items():
        kept = tuple(a for a in target_axes(tgt) if a in names)
        out[k] = (kept if len(kept) > 1 else kept[0]) if kept else None
    return out


def mesh_table(mesh, rules: Mapping[str, AxisTarget] | None = None
               ) -> dict[str, AxisTarget]:
    """``rules`` (else the ambient rules, else ``DEFAULT_RULES``) restricted
    to the axes ``mesh`` has."""
    return restrict_to_mesh(rules or current_rules() or DEFAULT_RULES, mesh)


def mesh_axes(name: str, mesh,
              rules: Mapping[str, AxisTarget] | None = None
              ) -> tuple[str, ...]:
    """The axes of ``mesh`` that the logical axis ``name`` shards over
    under ``mesh_table(mesh, rules)``."""
    return target_axes(mesh_table(mesh, rules).get(name))


def make_rules(
    *,
    multi_pod: bool = False,
    fsdp: bool = False,
    expert_tp: bool = False,
    shard_cache_seq: bool = False,
    overrides: Mapping[str, AxisTarget] | None = None,
) -> dict[str, AxisTarget]:
    """Build a rules table for a mesh/arch/shape combination."""
    rules = dict(DEFAULT_RULES)
    rules["batch"] = ("pod", "data") if multi_pod else ("data",)
    if multi_pod:
        # keep the pod axis on the MoE capacity axis so the group->expert
        # reshard stays pod-local
        rules["expert_cap"] = ("pod", "data")
    if fsdp:
        rules["embed"] = ("data",)
    if expert_tp:
        rules["expert"] = None
        rules["expert_mlp"] = ("model",)
    if shard_cache_seq:
        rules["cache_seq"] = ("data",)
    if overrides:
        rules.update(overrides)
    return rules


def launcher_rules(cfg) -> dict[str, AxisTarget]:
    """The rules a launcher trains model config ``cfg`` under on a mesh:
    the reference's ``make_rules(fsdp=cfg.fsdp, expert_tp=cfg.expert_tp)``
    (``repro.launch.train``), for every family.  Heads, KV heads, the MLP
    (and the hybrid and ssm families' ``d_inner`` columns, which carry the
    "mlp" axis) and the experts (each expert's MLP under ``expert_tp``)
    shard over "model"; under ``cfg.fsdp`` every "embed" dim of the
    parameters and their optimizer state shards over "data" (FSDP: the
    layers gather their weights whole, ``models.blocks.gather_params``)."""
    return make_rules(fsdp=cfg.fsdp, expert_tp=cfg.expert_tp)


def decode_rules(cfg, mesh) -> dict[str, AxisTarget]:
    """The rules a model config ``cfg`` decodes and serves under on
    ``mesh`` (a ``launch.mesh.Mesh`` or an ``{axis: size}`` mapping): the
    reference's decode-cell rules (``repro.launch.lowering.cell_rules`` for
    a decode shape), ``make_rules(fsdp=cfg.fsdp, expert_tp=cfg.expert_tp)``
    and, where the KV heads do not divide the model ranks, the
    flash-decoding override ``{"cache_seq": ("model",), "kv_heads":
    None}``: the cache cut over its positions, the softmax's partials
    combined across the ranks (``models.blocks.decode_attention``)."""
    overrides = {}
    m = axis_sizes_of(mesh).get("model", 1)
    if cfg.n_kv_heads % m:
        overrides = {"cache_seq": ("model",), "kv_heads": None}
    return make_rules(fsdp=cfg.fsdp, expert_tp=cfg.expert_tp,
                      overrides=overrides)


def require_ported(family: str, mesh,
                   rules: Mapping[str, AxisTarget] | None = None,
                   recurrent: tuple[tuple[int, int], ...] = ()) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP A11 where ``rules``
    (else the ambient rules) cut a parameter axis the port does not run for
    ``family`` over a mesh axis of more than one rank (a cut of the KV
    cache's positions, "cache_seq", runs: flash decoding, where
    ``require_cache_len`` refuses a length the cut does not divide).  "embed"
    (FSDP) runs over the batch's mesh axes only, in every family.  Tensor
    parallelism must keep off the batch's mesh axes, and the KV heads on
    the heads' axes.  ``recurrent`` lists each recurrent block's ``(heads,
    columns)``: the Mamba2's ``d_inner / ssm_head_dim`` heads over its
    ``d_inner`` columns, the mLSTM's and the sLSTM's ``n_heads`` over their
    ``2 d`` and ``d``.  A rank's columns must be its heads' columns, so the
    heads must be cut over the same mesh axes as the columns, and where the
    columns divide, so must the heads (``spec`` would cut the one and keep
    the other whole, splitting a recurrent head across ranks)."""
    table = mesh_table(mesh, rules)
    sizes = axis_sizes_of(mesh)

    def cut(ax):
        return tuple(a for a in target_axes(table.get(ax))
                     if sizes.get(a, 1) > 1)

    ok = ("vocab", "embed") + (TENSOR_PARALLEL_AXES
                               if family in TENSOR_PARALLEL_FAMILIES else ())
    for ax in PARAMETER_AXES:
        axes = cut(ax)
        if not axes:
            continue
        what = ("tensor parallelism" if ax in TENSOR_PARALLEL_AXES else
                "sharding")
        if ax not in ok:
            raise NotImplementedError(
                f"the rules shard {ax!r} over mesh axes {axes}: {what} of "
                f"the {family} family is not ported (ROADMAP A11); train "
                f"it under rules.launcher_rules(cfg)")
        if ax == "embed" and not set(axes) <= set(cut("batch")):
            raise NotImplementedError(
                f"the rules shard 'embed' over mesh axes {axes}, off the "
                f"batch's {cut('batch')}: FSDP over other than the batch's "
                f"mesh axes is not ported (ROADMAP A11)")
        if ax in TENSOR_PARALLEL_AXES and set(axes) & set(cut("batch")):
            raise NotImplementedError(
                f"the rules shard {ax!r} over the batch's mesh axes {axes}: "
                f"tensor parallelism over a data axis is not ported "
                f"(ROADMAP A11)")
    if cut("kv_heads") and cut("kv_heads") != cut("heads"):
        raise NotImplementedError(
            f"the rules shard 'kv_heads' over {cut('kv_heads')} and 'heads' "
            f"over {cut('heads')}: tensor parallelism with the KV heads off "
            f"their query heads' axes is not ported (ROADMAP A11)")
    cols = cut("mlp")
    n = spec_size(cols, sizes)
    for heads, width in recurrent:
        if n > 1 and width % n == 0 and (cut("heads") != cols
                                         or heads % n):
            raise NotImplementedError(
                f"the rules cut the {family} family's {width} recurrent "
                f"columns over {cols} (x{n}) but its {heads} recurrent "
                f"heads over {cut('heads')}: tensor parallelism that splits "
                f"a recurrent head across ranks is not ported (ROADMAP "
                f"A11)")


def require_cache_len(d, rules: Mapping[str, AxisTarget],
                      axis_sizes: Mapping[str, int]) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP A11, before any
    collective, where ``rules`` cut the positions ("cache_seq") of the
    cache leaf ``d`` (a ``ParamDef``) over mesh axes whose ranks do not
    divide its length: each rank's block must hold ``max_len / n``
    positions of every row (flash decoding, ``models.blocks``).  The cut a
    decode step reads off the rules (``blocks.cache_seq_parallel``) takes
    the slots as dividing their mesh axes; where they do not and that
    moves the positions' cut (the batch and the positions on one axis),
    it raises too."""
    at = d.axes.index("cache_seq")
    n = math.prod(int(axis_sizes.get(a, 1)) for a in axis_sizes)

    def cut_of(held):
        shape = tuple(n if ax in held else k
                      for ax, k in zip(d.axes, d.shape))
        s = spec(*d.axes, rules=rules, shape=shape, axis_sizes=axis_sizes)
        return dim_axes(s, len(shape))[at]

    axes = cut_of(("cache_seq",))
    if axes != cut_of(("cache_seq", "batch")):
        raise NotImplementedError(
            f"the rules cut a KV cache's positions over {axes} only "
            f"because its {d.shape[d.axes.index('batch')]} slots do not "
            f"divide their mesh axes: not ported (ROADMAP A11)")
    cut = spec_size(axes, axis_sizes)
    if d.shape[at] % cut:
        raise NotImplementedError(
            f"the rules cut a KV cache's {d.shape[at]} positions "
            f"('cache_seq') {cut} ways: a length the cut does not divide "
            f"is not ported (ROADMAP A11)")


def spec(*axes: str | None, rules: Mapping[str, AxisTarget] | None = None,
         shape: tuple[int, ...] | None = None,
         axis_sizes: Mapping[str, int] | None = None) -> tuple:
    """Spec for a tuple of logical axis names.

    When ``shape`` is given (and a mesh is registered via ``use_rules``, or
    ``axis_sizes`` passes mesh axis sizes explicitly), any dimension that is
    not evenly divisible by its mapped mesh axes falls back to replication.
    """
    p, _ = spec_report(*axes, rules=rules, shape=shape, axis_sizes=axis_sizes)
    return p


def spec_report(*axes: str | None,
                rules: Mapping[str, AxisTarget] | None = None,
                shape: tuple[int, ...] | None = None,
                axis_sizes: Mapping[str, int] | None = None
                ) -> tuple[tuple, list[str]]:
    """``spec`` plus a human-readable reason for every dimension whose
    declared sharding fell back to replication (divisibility, or a mesh axis
    already consumed by an earlier dim).  The SPMD launch path logs these,
    so a vocab of 1111 over ``model=2`` replicating instead of sharding is a
    recorded decision, not a silent one."""
    rules = rules if rules is not None else (current_rules() or {})
    parts = []
    fallbacks: list[str] = []
    used: set[str] = set()
    for i, ax in enumerate(axes):
        tgt = rules.get(ax) if ax is not None else None
        if tgt is not None and shape is not None and not _divisible(
                shape[i], tgt, axis_sizes):
            sizes = axis_sizes if axis_sizes is not None else _axis_sizes.get()
            names = target_axes(tgt)
            n = 1
            for a in names:
                n *= (sizes or {}).get(a, 1)
            fallbacks.append(
                f"dim {i} ({ax!r}, size {shape[i]}) replicated: not "
                f"divisible by mesh axes {names} (x{n})")
            tgt = None
        if tgt is not None:
            # a mesh axis may appear at most once per spec: first dim wins
            names = target_axes(tgt)
            kept = tuple(n for n in names if n not in used)
            if kept != names:
                fallbacks.append(
                    f"dim {i} ({ax!r}) dropped mesh axes "
                    f"{tuple(n for n in names if n in used)}: already used "
                    f"by an earlier dim")
            used.update(kept)
            tgt = kept or None
            if tgt is not None and shape is not None and not _divisible(
                    shape[i], tgt, axis_sizes):
                fallbacks.append(
                    f"dim {i} ({ax!r}, size {shape[i]}) replicated: not "
                    f"divisible by remaining mesh axes {tgt}")
                tgt = None
        if tgt is None:
            parts.append(None)
        elif isinstance(tgt, str):
            parts.append(tgt)
        else:
            parts.append(tuple(tgt) if len(tgt) > 1 else tgt[0])
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts), fallbacks


def dim_axes(spec_: tuple, ndim: int) -> tuple[tuple[str, ...], ...]:
    """Per-dimension mesh axis names of a spec, padded to rank."""
    out = []
    for d in range(ndim):
        p = spec_[d] if d < len(spec_) else None
        out.append(target_axes(p))
    return tuple(out)


def spec_size(names: tuple[str, ...], axis_sizes: Mapping[str, int]) -> int:
    """Shards a dim makes over mesh axes ``names`` (1 for none)."""
    n = 1
    for a in names:
        n *= int(axis_sizes.get(a, 1))
    return n


def tree_specs(axes_tree, rules: Mapping[str, AxisTarget] | None = None):
    """Map a tree (nested dicts) of logical-axes tuples to specs."""
    rules = rules if rules is not None else (current_rules() or {})
    if isinstance(axes_tree, dict):
        return {k: tree_specs(v, rules) for k, v in axes_tree.items()}
    return spec(*axes_tree, rules=rules)
