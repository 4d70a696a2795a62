"""Carry the reference package's state into the port.

The JAX package and the port meet only through numpy: ``to_torch`` turns a
numpy array (a JAX array's ``np.asarray``) into a port tensor on a given
device and dtype, ``plan_from_dict`` turns a reference ``KernelPlan``'s
fields (``dataclasses.asdict``) into a port plan, so a test can pin the
same geometry on both sides, ``params_from_jax`` turns a reference
model's parameter tree (as numpy arrays) into the port's, and
``train_state_from_jax`` a reference train state (parameters and AdamW
state) into the port's.  ``numpy_params`` draws the seeded numpy weights
that parity checks hand to both sides.

numpy has no bf16 of its own: a bf16 array (``ml_dtypes.bfloat16``, as JAX
returns it) goes through float32, which holds every bf16 value exactly, and
a float32 array asked for as bf16 is rounded by ``.to(torch.bfloat16)``,
round-to-nearest-even like JAX's cast.
"""
from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.autotune import LayoutPlan, StreamSignature
from repro_torch.core.layout import vector_unit
from repro_torch.core.planner import KernelPlan, dtype_name, itemsize, torch_dtype
from repro_torch.kernels.util import resolve_device


def to_torch(x, *, device=None, dtype=None) -> torch.Tensor:
    """A port tensor holding numpy array ``x`` on ``device`` (CUDA unless
    named), converted to ``dtype`` when given."""
    dev = resolve_device(device)
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        # a read-only array (a JAX array's view) is copied, not shared
        t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    return t.to(dev)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t``; bf16 widens to float32 (exact)."""
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy().copy()


def numpy_params(defs: Mapping, seed: int, *,
                 true_fan_in: bool = False, cfg=None) -> dict:
    """Seeded numpy weights for a parameter-definition tree, to hand to
    both frameworks: a normal leaf at its init std, ones as 1 + 0.1 noise
    and zeros as 0.02 noise, so every bias and norm scale reaches the loss.
    The two packages' trees match leaf for leaf, and the leaves are drawn
    in sorted key order, so either tree gives the same arrays.  An integer
    leaf (an MoE layer's expert permutation ``perm``) is not a weight: it
    stays int32 and takes its init, zeros; with the model config ``cfg``
    each MoE stage's ``perm`` is the skew table ``model.init`` writes
    (``models.moe.make_perms``), on both sides.

    A normal leaf without an explicit ``scale`` takes 0.02 (embeddings) or
    1/sqrt(fan-in).  By default the fan-in is the reference's rule,
    ``shape[-2]``, whose attention and sLSTM ``wx`` stds are the wrong
    ones (ROADMAP §C); it gives the weights the parity tests were written
    against.  With ``true_fan_in`` it is the port's ``ParamDef.fan_in``
    (1/sqrt(d) for ``wq``/``wk``/``wv`` and ``wx``, 1/sqrt(h*hd) for
    ``wo``, as ``model.init`` draws them); ``defs`` must then be the port's
    tree."""
    from repro_torch.models.params import ParamDef

    rng = np.random.default_rng(seed)

    def rec(tree):
        out = {}
        for key in sorted(tree):
            d = tree[key]
            if isinstance(d, Mapping):
                out[key] = rec(d)
                continue
            if true_fan_in and not isinstance(d, ParamDef):
                raise TypeError(f"true_fan_in needs the port's ParamDefs, "
                                f"got {type(d).__name__} at {key!r}")
            noise = rng.standard_normal(d.shape)
            if _is_int(d.dtype):
                out[key] = np.zeros(d.shape, np.int32)
                continue
            if d.init == "ones":
                a = 1.0 + 0.1 * noise
            elif d.init == "zeros":
                a = 0.02 * noise
            else:
                fan_in = d.fan_in if true_fan_in else (
                    d.shape[-2] if len(d.shape) >= 2 else d.shape[-1])
                std = d.scale or (0.02 if d.init == "embed"
                                  else 1.0 / math.sqrt(fan_in))
                a = std * noise
            out[key] = a.astype(np.float32)
        return out

    tree = rec(defs)
    if cfg is not None:
        from repro_torch.models import moe, transformer

        for i, (kind, count) in enumerate(cfg.stages()):
            if kind == "moe":
                tree[transformer.stage_name(i, kind)]["moe"]["perm"] = (
                    moe.make_perms(cfg, count, transformer.expert_shards(cfg)))
    return tree


def _is_int(dtype) -> bool:
    """Whether a torch or numpy/JAX dtype is an integer type."""
    if isinstance(dtype, torch.dtype):
        return not (dtype.is_floating_point or dtype.is_complex)
    return np.dtype(dtype).kind in "iub"


def plan_from_dict(fields: Mapping[str, Any]) -> KernelPlan:
    """A port ``KernelPlan`` with the geometry of a reference plan given as
    ``dataclasses.asdict(plan)``.  The reference's sublane tile has no
    counterpart; the minor unit is the largest vector unit the width is a
    multiple of.  A plan for a mesh or a shard has no single-device
    counterpart and is refused."""
    if fields.get("mesh") or fields.get("local"):
        raise ValueError("plan_from_dict takes single-device plans only, got "
                         f"mesh={fields.get('mesh')!r} local={fields.get('local')!r}")
    name = dtype_name(fields["dtype"])
    padded = tuple(int(s) for s in fields["padded_shape"])
    layout = dict(fields["layout"])
    layout["offsets_bytes"] = tuple(layout["offsets_bytes"])
    return KernelPlan(
        kernel=fields["kernel"],
        logical_shape=tuple(int(s) for s in fields["logical_shape"]),
        dtype=name,
        padded_shape=padded,
        block_shape=tuple(int(s) for s in fields["block_shape"]),
        signature=StreamSignature(**fields["signature"]),
        layout=LayoutPlan(**layout),
        naive_balance=float(fields["naive_balance"]),
        minor_unit=math.gcd(padded[-1], vector_unit(itemsize(name))),
        provenance=f"reference:{fields.get('provenance', 'analytic')}",
    )


def params_from_jax(tree: Mapping[str, Any], cfg, *, device=None,
                    dtype=None) -> dict:
    """The port's parameter tree for model config ``cfg`` holding the
    reference's parameters ``tree`` (a nested dict of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``), on ``device`` (CUDA unless
    named), its floating leaves converted to ``dtype`` when given (an
    integer leaf, an MoE layer's ``perm``, stays int32).

    The two trees share names and shapes leaf for leaf (stacked stages
    included, an xlstm's mLSTM and sLSTM stages with their fp32 gate and
    recurrence leaves, and a hybrid's one ``shared_attn`` subtree,
    unstacked);
    every reference leaf must land exactly once, with its shape
    unchanged, or this raises naming the leaves that do not."""
    from repro_torch.models import transformer
    from repro_torch.models.params import leaves

    device = resolve_device(device)
    want = dict(leaves(transformer.param_defs(cfg)))
    got = dict(leaves(tree))
    missing = sorted("/".join(p) for p in want.keys() - got.keys())
    extra = sorted("/".join(p) for p in got.keys() - want.keys())
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing}, "
                         f"not in the port {extra}")
    bad = [f"{'/'.join(p)} {np.shape(got[p])} != {d.shape}"
           for p, d in want.items() if tuple(np.shape(got[p])) != d.shape]
    if bad:
        raise ValueError(f"parameter shapes differ: {bad}")
    out: dict = {}
    for path, d in want.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        cast = dtype if d.dtype.is_floating_point else None
        node[path[-1]] = to_torch(got[path], device=device,
                                  dtype=cast or d.dtype)
    return out


def train_state_from_jax(state: Mapping[str, Any], cfg, *,
                         device=None, mesh=None, rank=None,
                         rules=None) -> dict:
    """The port's train state ``{"params", "opt"}`` for model config
    ``cfg`` holding a reference train state (``steps.init_train_state``'s
    tree, or a trained one, as numpy arrays): the parameters as
    ``params_from_jax`` carries them, the AdamW ``step``, moments ``m``/``v``
    and fp32 ``master`` copy leaf for leaf with their dtypes, on ``device``
    (CUDA unless named).

    With a ``mesh`` (a ``launch.mesh.Mesh``, or an ``{axis: size}``
    mapping with the ``rank`` to cut for) the state is that rank's blocks,
    cut by ``parallel.specs.state_specs`` under ``rules`` (default: the
    ambient rules, else ``make_rules(tensor_parallel=False)``)."""
    device = resolve_device(device)
    if mesh is not None:
        from repro_torch.models import transformer
        from repro_torch.parallel import rules as rules_lib
        from repro_torch.parallel import specs as specs_lib

        full = train_state_from_jax(state, cfg, device=device)
        table = rules_lib.restrict_to_mesh(
            rules or rules_lib.current_rules()
            or rules_lib.make_rules(tensor_parallel=False), mesh)
        specs = specs_lib.state_specs(
            transformer.param_defs(cfg), table,
            master="master" in state["opt"],
            axis_sizes=rules_lib.axis_sizes_of(mesh))
        return specs_lib.shard_tree(full, specs, mesh, rank)

    def tree(t):
        return {k: tree(v) if isinstance(v, Mapping)
                else to_torch(v, device=device) for k, v in t.items()}

    params = params_from_jax(state["params"], cfg, device=device)
    opt = {k: tree(v) if isinstance(v, Mapping) else to_torch(v, device=device)
           for k, v in state["opt"].items()}
    return {"params": params, "opt": opt}
