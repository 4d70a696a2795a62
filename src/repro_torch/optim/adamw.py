"""AdamW with global-norm clipping and an optional fp32 master copy.

Counterpart of ``repro.optim.adamw`` over the port's parameter trees
(nested dicts of tensors).  The optimizer state is a tree shaped like the
parameters: ``{"step", "m", "v"}`` and, with ``master``, ``"master"``, an
fp32 copy of every trainable leaf that the update works on, the bf16 weight
being its rounding.  A leaf is trainable when it is floating point and no
key on its path is ``perm`` (the MoE skew permutations are structure, not
weights); other leaves pass through and get scalar zero moments.

Written out leaf by leaf as the reference does, not as
``torch.optim.AdamW``: the clipping scale, the master weights and the
``perm`` exclusion are part of the update.  The update makes new tensors
and leaves its inputs as they were, as the reference's pure function does.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.params import leaves


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    master: bool = True            # keep fp32 master weights when params are bf16


def _trainable(path: tuple[str, ...], p: torch.Tensor) -> bool:
    return p.is_floating_point() and "perm" not in path


def _map_with_path(fn, *trees, path: tuple[str, ...] = ()):
    first = trees[0]
    return {k: (_map_with_path(fn, *(t[k] for t in trees), path=path + (k,))
                if isinstance(first[k], dict)
                else fn(path + (k,), *(t[k] for t in trees)))
            for k in first}


def init_state(params: dict, cfg: AdamWConfig) -> dict:
    def moment(path, p):
        if _trainable(path, p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return torch.zeros((), dtype=torch.float32, device=p.device)

    device = next(iter(leaves(params)))[1].device
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": _map_with_path(moment, params),
        "v": _map_with_path(moment, params),
    }
    if cfg.master:
        state["master"] = _map_with_path(
            lambda path, p: p.to(torch.float32, copy=True)
            if _trainable(path, p) else p, params)
    return state


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every floating leaf, in fp32."""
    sq = [torch.sum(torch.square(g.to(torch.float32)))
          for _, g in leaves(tree) if g is not None and g.is_floating_point()]
    if not sq:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(torch.stack(sq).sum())


# elements a donated update works on at once (``apply_updates``)
DONATE_CHUNK = 1 << 26


def apply_updates(params: dict, grads: dict, state: dict, lr,
                  cfg: AdamWConfig, *, gnorm: torch.Tensor | None = None,
                  donate: bool = False):
    """One AdamW step.  Integer/perm leaves pass through untouched.

    Returns ``(params, state, {"grad_norm": ...})``.  ``lr`` is a float or
    a 0-d tensor (a schedule's value at the state's step).  ``gnorm`` is the
    global gradient norm when the caller has it: on a mesh the leaves are
    this rank's shards, and the norm sums every shard's squares once
    (``parallel.steps``).

    ``donate`` (the counterpart of the reference's ``donate_argnums``)
    writes the new parameters, moments and master copy into the input
    state's tensors, ``DONATE_CHUNK`` elements at a time, so a step holds
    one state and a chunk's temporaries instead of two states: the same
    arithmetic element by element, so the same bits."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=stepf.device)
    master = state.get("master", params)

    def update(p, g, m, v, w):
        gf = g.to(torch.float32) * scale
        m1 = cfg.b1 * m + (1 - cfg.b1) * gf
        v1 = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        upd = (m1 / b1c) / (torch.sqrt(v1 / b2c) + cfg.eps)
        wf = w.to(torch.float32)
        base = wf - lr * (upd + cfg.weight_decay * wf)
        return base.to(p.dtype), m1, v1, base

    def one(path, p, g, m, v, w):
        if not _trainable(path, p):
            return p, m, v, w
        if not donate:
            return update(p, g, m, v, w)
        flat = [t.view(-1) for t in (p, m, v, w)]
        gflat = g.reshape(-1)
        for i in range(0, p.numel(), DONATE_CHUNK):
            part = [t[i:i + DONATE_CHUNK] for t in flat]
            got = update(part[0], gflat[i:i + DONATE_CHUNK], *part[1:])
            for dst, src in zip(part[:3], got[:3]):
                dst.copy_(src)
            if w is not p:
                part[3].copy_(got[3])
        return p, m, v, w

    fused = _map_with_path(one, params, grads, state["m"], state["v"], master)
    # unzip the 4-tuples
    out_p, out_m, out_v, out_w = (
        _map_with_path(lambda _, t, k=k: t[k], fused) for k in range(4))
    out_state = {"step": step, "m": out_m, "v": out_v}
    if cfg.master:
        out_state["master"] = out_w
    return out_p, out_state, {"grad_norm": gnorm}
