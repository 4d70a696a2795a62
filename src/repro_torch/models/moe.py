"""Mixture-of-Experts block: top-k router, capacity dispatch and the skewed
expert placement (counterpart of ``repro.models.moe``).

It computes the reference's function, not a dropless MoE.  Tokens are split
into ``cfg.moe_groups`` groups; within a group each (token, pick)
assignment is ranked among the assignments of the same expert in token
order (a stable sort), an assignment whose rank reaches the group's
capacity ``ceil(cf * tokens * k / E)``, rounded up to a multiple of 8, is
dropped, the kept ones fill an (E, cap, d) buffer that the stacked expert
FFNs run over as three batched products, and the outputs come back
weighted by the renormalised router probabilities.  The capacity's
multiple of 8 is the reference's semantics (it decides which assignments
drop), kept here although it was a TPU tile there.

Skewed placement (``core.sharding_skew``): the experts are stored in the
order of a per-layer permutation ``perm`` (storage slot s holds expert
``perm[s]``), rotated by one device a layer, so a hot expert index does not
sit on the same device in every layer.  It is a relabelling of storage and
never changes a result.

Three decisions keep the serving contracts bit-exact on the card, where
``index_add_``/``scatter_add_`` of floats sum in an order that changes from
run to run:

  * the dispatch is a gather: every (expert, rank) cell of the buffer has at
    most one source token (a dropped assignment gets a cell of its own past
    the buffer, an empty cell the index of a zero row);
  * the combine gathers each assignment's output and sums the k picks of a
    token in one reduction over a (T, k, d) view, in a fixed order; in bf16
    it rounds once, where the reference's scatter-add rounds after each of
    the k adds (ROADMAP §C);
  * the capacity is static from the shapes, and the ranks come from
    ``torch.sort(stable=True)`` and integer ``scatter_add_``/``cumsum`` on
    the card: no boolean-mask indexing, no host synchronisation.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.sharding_skew import expert_permutation
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef


def moe_defs(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    dt = cfg.adtype
    return {
        "router": ParamDef((d, e), ("embed", None), dtype=torch.float32),
        "wi": ParamDef((e, d, f), ("expert", "embed", "expert_mlp"), dtype=dt),
        "wg": ParamDef((e, d, f), ("expert", "embed", "expert_mlp"), dtype=dt),
        "wo": ParamDef((e, f, d), ("expert", "expert_mlp", "embed"), dtype=dt),
        # static, not learned: the layer's expert -> storage slot permutation
        "perm": ParamDef((e,), (None,), init="zeros", dtype=torch.int32),
    }


def make_perms(cfg: ModelConfig, n_layers: int,
               n_expert_shards: int) -> np.ndarray:
    """(L, E) int32 permutation table: the identity if the skew is off."""
    e = cfg.n_experts
    if not cfg.skewed_experts or n_expert_shards <= 1:
        return np.tile(np.arange(e, dtype=np.int32), (n_layers, 1))
    return np.stack([expert_permutation(e, n_expert_shards, layer)
                     .astype(np.int32) for layer in range(n_layers)])


def capacity(cfg: ModelConfig, group_tokens: int) -> int:
    """Slots an expert has in a group of ``group_tokens`` tokens:
    ``ceil(cf * tokens * k / E)`` rounded up to a multiple of 8."""
    cap = int(np.ceil(cfg.capacity_factor * group_tokens * cfg.top_k
                      / cfg.n_experts))
    return cap + (-cap) % 8


def expert_slots(perm: torch.Tensor) -> torch.Tensor:
    """logical expert -> storage slot, ``argsort(perm)`` along the last
    axis (a stage's (L, E) table at once)."""
    return torch.argsort(perm, dim=-1, stable=True)


def _ranks(slots: torch.Tensor, e: int) -> torch.Tensor:
    """(G, n) rank of each assignment among the earlier assignments of its
    group to the same slot: its position in a stable sort by slot less its
    slot's first position."""
    counts = torch.zeros((slots.shape[0], e), dtype=slots.dtype,
                         device=slots.device)
    counts.scatter_add_(1, slots, torch.ones_like(slots))
    starts = torch.cumsum(counts, dim=1) - counts
    ordered, order = torch.sort(slots, dim=1, stable=True)
    n = slots.shape[1]
    rank_sorted = (torch.arange(n, device=slots.device)
                   - torch.gather(starts, 1, ordered))
    return torch.empty_like(slots).scatter_(1, order, rank_sorted)


def route(p: dict, xf: torch.Tensor, cfg: ModelConfig):
    """The router and the capacity ranking of (T, d) rows: ``(probs (T, E),
    top_e (T, k), weights (T, k), slot (G, tg*k), pos (G, tg*k), keep
    (G, tg*k), cap)``; assignments are ordered token-major within a group.
    ``p["slot_of"]``, when present, is ``expert_slots(p["perm"])``
    computed once for the stage."""
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    g = max(cfg.moe_groups, 1)
    if t % g:
        raise ValueError(f"{t} tokens do not split into {g} groups")
    logits = torch.matmul(xf.to(torch.float32), p["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    weights = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    slot_of = p["slot_of"] if "slot_of" in p else expert_slots(p["perm"])
    slot = slot_of[top_e].reshape(g, (t // g) * k)
    cap = capacity(cfg, t // g)
    pos = _ranks(slot, e)
    return probs, top_e, weights, slot, pos, pos < cap, cap


def combine(picked: torch.Tensor, weights: torch.Tensor,
            k: int) -> torch.Tensor:
    """(G, n, d) output rows of a group's assignments times their (G, n)
    weights, both in the activation dtype (a dropped assignment's weight is
    0), and the k picks of each token summed in one reduction: (G, n / k,
    d).  The products round to the dtype, as the reference's do; the sum
    of a token's k products rounds once (fp32 accumulation)."""
    g, n, d = picked.shape
    return (picked * weights[..., None]).reshape(g, n // k, k, d).sum(2)


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              with_aux: bool = True):
    """x: (B, S, d) -> (out (B, S, d), aux): the routed experts' output and
    the switch-style load-balance loss (fp32 scalar; ``None`` without
    ``with_aux``, as a decode step discards it)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xf = x.reshape(t, d)
    probs, top_e, weights, slot, pos, keep, cap = route(p, xf, cfg)
    g, n = slot.shape
    tg = t // g
    dev = x.device

    # dispatch: the source row of each (expert, rank) cell; a dropped
    # assignment writes a cell of its own past the buffer, so no cell is
    # written twice, and an empty cell keeps the index of a zero row
    idx = slot * cap + torch.clamp(pos, max=cap - 1)   # the reference's cell
    spill = e * cap + torch.arange(n, device=dev)
    cell = torch.where(keep, idx, spill)                            # (G, n)
    src = torch.full((g, e * cap + n), tg, dtype=torch.int64, device=dev)
    token_of = torch.arange(tg, device=dev).repeat_interleave(k)
    src.scatter_(1, cell, token_of.expand(g, n))
    zero = torch.zeros((g, 1, d), dtype=x.dtype, device=dev)
    xg = torch.cat([xf.reshape(g, tg, d), zero], dim=1)             # (G, tg+1, d)
    buf = torch.gather(xg, 1, src[:, :e * cap, None].expand(-1, -1, d))
    eb = buf.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)

    # the expert FFNs: three batched products over E
    h = torch.bmm(eb, p["wi"])
    gate = torch.bmm(eb, p["wg"])
    # jax.nn.gelu defaults to the tanh approximation
    act = (F.silu(gate) if cfg.act == "silu"
           else F.gelu(gate, approximate="tanh"))
    y = torch.bmm(act * h, p["wo"])                                 # (E, G*cap, d)

    # combine: each assignment's output row times its weight (a dropped
    # one's 0, as the reference's), the k picks of a token summed at once
    yg = y.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
    picked = torch.gather(yg, 1, idx[..., None].expand(-1, -1, d))  # (G, n, d)
    wk = torch.where(keep, weights.reshape(g, n), 0.0).to(x.dtype)
    out = combine(picked, wk, k).reshape(b, s, d)
    if not with_aux:
        return out, None

    # the load-balance loss over logical experts: mean router probability
    # times the share of assignments, E * sum(me * ce) * weight
    me = probs.mean(0)
    ce = torch.zeros(e, dtype=torch.float32, device=dev).scatter_add_(
        0, top_e.reshape(-1), torch.ones(t * k, device=dev)) / (t * k)
    aux = e * torch.sum(me * ce) * cfg.router_aux_weight
    return out, aux
