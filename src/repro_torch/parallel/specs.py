"""Specs of parameters, optimizer state and batches, and the cut of a
global tree into one rank's shards and back.

Counterpart of ``repro.parallel.specs``.  A spec is ``parallel.rules``'s
tuple of mesh axes a dim; the reference hands its specs to ``jit``, which
places the global arrays.  The port is multi-controller, so the same specs
cut a global state into this rank's shards (``shard_tree``, at start-up and
on restore) and put the shards back together (``gather_leaf``, for a
checkpoint, which is written in the single-device layout).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.params import ParamDef, map_tree
from repro_torch.parallel.rules import (
    dim_axes,
    require_cache_len,
    spec,
    spec_size,
)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """How a global array lies over the ranks: a ``launch.mesh.Mesh`` and a
    spec (the counterpart of ``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: tuple


def _floating(d: ParamDef) -> bool:
    return d.dtype.is_floating_point


def param_specs(defs, rules, axis_sizes=None) -> dict:
    return map_tree(lambda d: spec(*d.axes, rules=rules, shape=d.shape,
                                   axis_sizes=axis_sizes), defs)


def opt_state_specs(defs, rules, axis_sizes=None) -> dict:
    """Specs matching ``optim.adamw.init_state``'s structure."""
    moment = map_tree(
        lambda d: spec(*d.axes, rules=rules, shape=d.shape,
                       axis_sizes=axis_sizes) if _floating(d) else (), defs)
    return {"step": (), "m": moment, "v": moment}


def master_specs(defs, rules, axis_sizes=None) -> dict:
    return param_specs(defs, rules, axis_sizes)


def state_specs(defs, rules, *, master: bool, axis_sizes=None) -> dict:
    out = {"params": param_specs(defs, rules, axis_sizes),
           "opt": opt_state_specs(defs, rules, axis_sizes)}
    if master:
        out["opt"]["master"] = master_specs(defs, rules, axis_sizes)
    return out


def cache_specs(cache_defs_tree, rules, axis_sizes=None) -> dict:
    """Specs of a serving cache's leaves from their declared axes: a dense
    KV cache on "batch" and "kv_heads", a paged pool (no batch axis) on
    "kv_heads" alone, the page table, ``act`` and ``idx`` on "batch", the
    recurrent state on "batch" and "heads" or "mlp", the encoder-decoder's
    cross K/V on "batch" and "kv_heads"; a dim that does not divide stays
    whole, as a parameter's does.  Where the rules cut a dense KV cache's
    positions ("cache_seq", flash decoding) a rank's block holds
    ``max_len / n`` of them: a ``max_len`` that n does not divide raises
    ``NotImplementedError`` naming ROADMAP A11
    (``rules.require_cache_len``)."""

    def one(d):
        if "cache_seq" in d.axes and axis_sizes:
            require_cache_len(d, rules, axis_sizes)
        return spec(*d.axes, rules=rules, shape=d.shape,
                    axis_sizes=axis_sizes)

    return map_tree(one, cache_defs_tree)


def batch_specs(batch_tree, rules, axis_sizes=None) -> dict:
    """Leading axis of every batch leaf is the (global) batch axis."""
    return {k: spec("batch", *(None,) * (v.ndim - 1), rules=rules,
                    shape=tuple(v.shape), axis_sizes=axis_sizes)
            for k, v in batch_tree.items()}


def _coords(mesh, rank):
    """``{axis: (index, size)}`` of ``rank`` on a ``Mesh`` or an ``{axis:
    size}`` mapping (ranks row-major over the mapping's order)."""
    if hasattr(mesh, "coords") and rank is None:
        names, shape, coords = mesh.axis_names, mesh.shape, mesh.coords
    else:
        names = tuple(mesh.axis_names if hasattr(mesh, "axis_names")
                      else mesh)
        shape = tuple(mesh.shape if hasattr(mesh, "shape")
                      else mesh.values())
        coords = np.unravel_index(int(rank or 0), shape)
    return {a: (int(c), int(n)) for a, c, n in zip(names, coords, shape)}


def shard_leaf(x, spec_: tuple, mesh, rank=None):
    """This rank's block of the global tensor or array ``x`` under
    ``spec_``: each sharded dim narrowed to the rank's index along its mesh
    axes (row-major over them)."""
    where = _coords(mesh, rank)
    sizes = {a: n for a, (_, n) in where.items()}
    for d, axes in enumerate(dim_axes(spec_, x.ndim)):
        n = spec_size(axes, sizes)
        if n <= 1:
            continue
        idx = 0
        for a in axes:
            idx = idx * where[a][1] + where[a][0]
        step = x.shape[d] // n
        if step * n != x.shape[d]:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"{n} ways under spec {spec_}")
        if isinstance(x, torch.Tensor):
            x = x.narrow(d, idx * step, step)
        else:
            x = np.take(x, np.arange(idx * step, (idx + 1) * step), axis=d)
    return x.contiguous() if isinstance(x, torch.Tensor) else x


def leaf_cutter(specs, mesh):
    """``cut(path, leaf)``: the leaf at ``path`` cut to this rank's block
    under the spec tree ``specs``, for ``params.init_params(cut=)`` (each
    leaf drawn whole and cut as it is drawn)."""

    def cut(path, leaf):
        node = specs
        for key in path:
            node = node[key]
        return shard_leaf(leaf, node, mesh)

    return cut


def map_with_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over the leaves of ``tree`` and the specs of the
    spec tree of the same structure."""
    return {k: (map_with_specs(fn, v, specs[k]) if isinstance(v, dict)
                else fn(v, specs[k])) for k, v in tree.items()}


def shard_tree(tree, specs, mesh, rank=None):
    """Every leaf of a global tree cut to this rank's block (``rank`` picks
    another rank of a mapping mesh)."""
    return map_with_specs(lambda x, s: shard_leaf(x, s, mesh, rank), tree, specs)


def gather_leaf(x: torch.Tensor, spec_: tuple, mesh) -> torch.Tensor:
    """The global tensor of which every rank holds its block ``x`` under
    ``spec_`` (a collective: every rank of the mesh calls it)."""
    for d, axes in enumerate(dim_axes(spec_, x.ndim)):
        if axes:
            x = mesh.all_gather(x, axes, d)
    return x



def sharded_paths(specs, axis_sizes, path=()) -> list[tuple[str, ...]]:
    """Paths of the leaves a spec tree cuts over mesh axes of more than one
    rank (``axis_sizes``)."""
    out = []
    for k, v in specs.items():
        if isinstance(v, dict):
            out.extend(sharded_paths(v, axis_sizes, path + (k,)))
        elif any(spec_size(axes, axis_sizes) > 1
                 for axes in dim_axes(v, len(v))):
            out.append(path + (k,))
    return out
