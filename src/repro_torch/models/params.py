"""Parameter definition trees: one source of truth for shapes and init.

Counterpart of ``repro.models.params``.  Every model builds a nested dict
of ``ParamDef``s; from it come the materialized tensors (``init_params``)
and the meta-device shapes (``abstract_params``, no allocation).  The
logical axes stay on every definition: the serving scheduler reads each
cache leaf's batch axis from them.

Initialisation draws each leaf from its own ``torch.Generator``, seeded
from the base seed and a CRC-32 of the leaf's path, so a leaf's values do
not depend on the order of the tree or on the process.  PyTorch's and
JAX's generators differ, so a seed gives other numbers than the reference;
parity tests carry the weights across (``repro_torch.interop``).

A leaf's init std is 1/sqrt(fan-in).  The reference takes every leaf's
fan-in as ``shape[-2]``, which is wrong for the attention weights (ROADMAP
§C): ``wq`` (d, h, hd) gets 1/sqrt(h), ``wo`` (h, hd, d) 1/sqrt(hd).  A
port ``ParamDef`` names its input axes in ``fan_in_axes`` where the rule of
``shape[-2]`` does not hold, so those weights get 1/sqrt(d) and
1/sqrt(h*hd), and the sLSTM's input projection ``wx`` (d, 4, d) 1/sqrt(d)
where the reference gives 1/sqrt(4) -- deliberate divergences from the
reference.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, Callable

import torch

from repro_torch.kernels.util import resolve_device

Tree = dict  # nested dict[str, ParamDef | Tree]

# A normal leaf of more elements than this is drawn one slice of its leading
# axis at a time into a tensor of its own dtype, so init never holds a whole
# fp32 draw of it beside its result: qwen3-moe-30b-a3b's stacked experts
# (48, 128, 2048, 768) are 9.66 G elements, 38.7 GB as one fp32 draw.  The
# slices give other values than one whole draw, so the limit lies above
# every leaf of the other configs (the largest, qwen3-14b's stacked MLP, is
# 3.57 G elements): those keep the values of one whole draw.
WHOLE_DRAW_LIMIT = 1 << 32


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: shape + logical axes + init recipe."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical axis names, len == ndim
    init: str = "normal"                  # normal | zeros | ones | embed
    scale: float | None = None            # stddev override (normal/embed)
    dtype: torch.dtype = torch.float32
    # the input axes whose sizes multiply to the fan-in (default shape[-2])
    fan_in_axes: tuple[str, ...] | None = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")

    @property
    def fan_in(self) -> int:
        if self.fan_in_axes:
            return math.prod(n for n, a in zip(self.shape, self.axes)
                             if a in self.fan_in_axes)
        return self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]

    def materialize(self, gen: torch.Generator,
                    device: torch.device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        if self.init == "neg_inf":
            return torch.full(self.shape, -1e30, dtype=self.dtype,
                              device=device)
        std = self.scale
        if std is None:
            std = 0.02 if self.init == "embed" else 1.0 / math.sqrt(self.fan_in)
        if math.prod(self.shape) > WHOLE_DRAW_LIMIT:
            out = torch.empty(self.shape, dtype=self.dtype, device=device)
            for part in out:          # views along the leading axis
                part.copy_(torch.randn(self.shape[1:], generator=gen,
                                       dtype=torch.float32,
                                       device=device).mul_(std))
            return out
        x = torch.randn(self.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return x.mul_(std).to(self.dtype)

    def abstract(self) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def is_def(x: Any) -> bool:
    return isinstance(x, ParamDef)


def map_tree(fn: Callable[[ParamDef], Any], tree: Tree) -> Tree:
    """Map a function over every ParamDef in a nested dict."""
    return {k: fn(v) if is_def(v) else map_tree(fn, v)
            for k, v in tree.items()}


def path_seed(seed: int, path: tuple[str, ...]) -> int:
    """The generator seed of the leaf at ``path``: stable across processes
    (CRC-32, not Python's salted ``hash``)."""
    return (int(seed) * 1_000_003 + zlib.crc32("/".join(path).encode())) \
        & 0x7FFF_FFFF_FFFF_FFFF


def init_params(seed: int, tree: Tree, *, device=None, cut=None) -> Tree:
    """Materialize every ParamDef on ``device`` (CUDA unless named), each
    leaf from a generator seeded by ``path_seed(seed, path)``.  With
    ``cut``, each leaf is drawn whole and handed to ``cut(path, leaf)``
    before the next is drawn, and the tree holds what it returns (a mesh
    rank's block), so the whole tree is never on the device at once."""
    dev = resolve_device(device)

    def rec(t: Tree, path: tuple[str, ...]) -> Tree:
        out = {}
        for k, v in t.items():
            p = path + (k,)
            if is_def(v):
                gen = torch.Generator(device=dev).manual_seed(path_seed(seed, p))
                leaf = v.materialize(gen, dev)
                out[k] = leaf if cut is None else cut(p, leaf)
                del leaf
            else:
                out[k] = rec(v, p)
        return out

    return rec(tree, ())


def abstract_params(tree: Tree) -> Tree:
    return map_tree(lambda d: d.abstract(), tree)


def stack_defs(tree: Tree, n: int, axis_name: str | None = "layers") -> Tree:
    """Prepend a stacked-layer dimension to every ParamDef."""
    return map_tree(
        lambda d: dataclasses.replace(
            d, shape=(n, *d.shape), axes=(axis_name, *d.axes)),
        tree,
    )


def leaves(tree: Tree, path: tuple[str, ...] = ()):
    """``(path, leaf)`` for every leaf of a nested dict, in key order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, path + (k,))
        else:
            yield path + (k,), v


def map_leaves(fn: Callable, *trees: Tree) -> Tree:
    """``fn`` over the corresponding leaves of trees of one structure."""
    first = trees[0]
    return {k: (map_leaves(fn, *(t[k] for t in trees))
                if isinstance(first[k], dict) else fn(*(t[k] for t in trees)))
            for k in first}
