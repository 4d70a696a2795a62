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

On a mesh of ranks a rank holds its rows of the batch, and the layer
computes the reference's function of the global batch, whose groups are
the global token order cut in ``cfg.moe_groups``:

  * where the groups are a multiple of the data ranks, a rank's tokens are
    whole groups and it ranks them alone; where a group spans several
    ranks (``moe_groups`` 1, every config's), each rank all-gathers the
    group's slot ids (int32, T * k a layer over the data axis, no
    activations), ranks them as one device does and keeps its own
    assignments' ranks.  The capacity is the global group's;
  * the expert FFNs are row-wise, so a rank's buffer holds only the
    cells of its own tokens: where a group spans ranks, a rank's kept
    assignments to an expert are a run of consecutive global ranks, and
    ``own_cells`` shifts each run to start at 0 and sizes the buffer to
    the longest run (rounded up to 8, at most the capacity; read on the
    host, which the all-gather has already synchronised), so the three
    products run over the rank's own kept rows, not over the global
    buffer's.  The keep decision stays the global ranking's;
  * the load-balance loss's router mean and assignment shares are summed
    over the data ranks before their product, the mean through
    ``blocks.SumOverRanks``: every rank holds the global loss, and its
    backward gives each rank the gradient through its own tokens, which
    the train step's sum over the data axes completes once.

Where the rules cut the experts over a model axis (the default rules:
"expert" on "model"), a rank holds a block of the storage slots, rows of
``wi``/``wg``/``wo``, and the skewed placement maps logical experts to
them as on one device.  The tokens are whole on every rank of a model
line, so the router, the capacity ranking and the load-balance loss run
whole on each; a rank fills and multiplies only its own slots' cells.
Under ``expert_tp`` ("expert_mlp" on "model") every rank holds every
expert and a slice of each one's MLP columns, column- then row-parallel as
``blocks.apply_mlp``.  Either way a rank's combine is its part of each
token's sum, in fp32; the parts are summed over the model ranks
(``blocks.SumOverRanks``) and rounded once, so the output still rounds
once, as above.  The rows and the routing weights enter the rank's part
through ``blocks.SumGradOverRanks``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.api import spmd as spmd_lib
from repro_torch.core.sharding_skew import expert_permutation
from repro_torch.models.blocks import SumOverRanks, enter, leave, model_parallel
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef
from repro_torch.parallel import rules as rules_lib


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


def data_parallel():
    """``(mesh, axes)``: the ambient mesh of ranks and the mesh axes the
    batch's rows shard over (the rules' "batch"), or ``(None, ())`` outside
    a mesh or on a data axis of one rank."""
    mesh = spmd_lib.spmd_mesh()
    if mesh is None:
        return None, ()
    axes = rules_lib.mesh_axes("batch", mesh)
    return (mesh, axes) if mesh.axis_size(axes) > 1 else (None, ())


def own_cells(slot: torch.Tensor, pos: torch.Tensor, keep: torch.Tensor,
              e: int, cap: int) -> tuple[torch.Tensor, int]:
    """A rank's (1, n) assignments with their ranks in a group that spans
    ranks: ``(local, cells)``, each rank less the first rank this rank's
    assignments hold at the same slot (they are consecutive, its tokens
    being consecutive in the group's order), and the buffer rows an expert
    needs for the kept ones, the longest run rounded up to a multiple of 8
    (at least 8, at most ``cap``)."""
    first = torch.full((slot.shape[0], e), cap, dtype=pos.dtype,
                       device=pos.device)
    first.scatter_reduce_(1, slot, pos, "amin")
    local = pos - torch.gather(first, 1, slot)
    longest = int(torch.where(keep, local + 1, 0).max())
    return local, min(max(longest + (-longest) % 8, 8), cap)


def route(p: dict, xf: torch.Tensor, cfg: ModelConfig):
    """The router and the capacity ranking of (T, d) rows: ``(probs (T, E),
    top_e (T, k), weights (T, k), slot (G, tg*k), pos (G, tg*k), keep
    (G, tg*k), cap)``; assignments are ordered token-major within a group.
    ``p["slot_of"]``, when present, is ``expert_slots(p["perm"])``
    computed once for the stage.  On a data axis of D ranks the rows are
    this rank's and the ranks and the capacity the global batch's: G / D
    whole groups of ``slot``, ``pos`` and ``keep`` where D divides G, else
    one row of this rank's assignments in the group that holds them."""
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    g = max(cfg.moe_groups, 1)
    mesh, axes = data_parallel()
    n = mesh.axis_size(axes) if mesh is not None else 1
    if (t * n) % g:
        raise ValueError(f"{t * n} tokens do not split into {g} groups")
    if g % n and n % g:
        raise ValueError(f"{g} MoE groups over {n} data ranks: a rank's rows "
                         f"would cut a group at both ends")
    tg = t * n // g
    logits = torch.matmul(xf.to(torch.float32), p["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    weights = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    slot_of = p["slot_of"] if "slot_of" in p else expert_slots(p["perm"])
    slot = slot_of[top_e]
    cap = capacity(cfg, tg)
    if g % n == 0:      # whole groups on this rank (and on one device)
        slot = slot.reshape(g // n, tg * k)
        pos = _ranks(slot, e)
    else:               # a group spans n // g ranks, in token order
        span, i = n // g, mesh.index(axes)
        every = mesh.all_gather(slot.reshape(1, t * k).to(torch.int32),
                                axes, dim=1).to(slot.dtype)
        group = every.reshape(g, tg * k)[i // span][None]
        mine = (i % span) * t * k
        slot = slot.reshape(1, t * k)
        pos = _ranks(group, e)[:, mine:mine + t * k]
    return probs, top_e, weights, slot, pos, pos < cap, cap


def combine(picked: torch.Tensor, weights: torch.Tensor, k: int,
            dtype: torch.dtype | None = None) -> torch.Tensor:
    """(G, n, d) output rows of a group's assignments times their (G, n)
    weights, both in the activation dtype (a dropped assignment's weight is
    0), and the k picks of each token summed in one reduction: (G, n / k,
    d).  The products round to the dtype, as the reference's do; the sum
    of a token's k products rounds once (fp32 accumulation), to ``dtype``
    where given (fp32 for a rank's part, summed over the ranks before the
    one rounding)."""
    g, n, d = picked.shape
    return (picked * weights[..., None]).reshape(g, n // k, k, d).sum(
        2, dtype=dtype)


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
    mesh, axes = data_parallel()
    ranks = mesh.axis_size(axes) if mesh is not None else 1
    if max(cfg.moe_groups, 1) % ranks:      # a group spans ranks
        pos, cap = own_cells(slot, pos, keep, e, cap)

    # tensor parallelism over the model ranks: a block of the storage
    # slots (expert-parallel) or of each expert's MLP columns (expert_tp)
    mesh_e, e_axes = model_parallel("expert", e)
    mesh_f, f_axes = model_parallel("expert_mlp", cfg.moe_d_ff)
    tp_mesh, tp = mesh_e or mesh_f, e_axes + f_axes
    e_loc = p["wi"].shape[0]
    s0 = mesh_e.index(e_axes) * e_loc if e_axes else 0
    xt = enter(xf, tp_mesh, tp)

    # dispatch: the source row of each (expert, rank) cell; a dropped
    # assignment writes a cell of its own past the buffer, so no cell is
    # written twice, and an empty cell keeps the index of a zero row
    idx = slot * cap + torch.clamp(pos, max=cap - 1)   # the reference's cell
    #                                                   or the rank's own
    spill = e * cap + torch.arange(n, device=dev)
    cell = torch.where(keep, idx, spill)                            # (G, n)
    src = torch.full((g, e * cap + n), tg, dtype=torch.int64, device=dev)
    token_of = torch.arange(tg, device=dev).repeat_interleave(k)
    src.scatter_(1, cell, token_of.expand(g, n))
    zero = torch.zeros((g, 1, d), dtype=x.dtype, device=dev)
    xg = torch.cat([xt.reshape(g, tg, d), zero], dim=1)             # (G, tg+1, d)
    mine = src[:, s0 * cap:(s0 + e_loc) * cap]      # this rank's slots' cells
    buf = torch.gather(xg, 1, mine[..., None].expand(-1, -1, d))
    eb = buf.reshape(g, e_loc, cap, d).transpose(0, 1).reshape(
        e_loc, g * cap, d)

    # the expert FFNs: three batched products over the rank's experts
    h = torch.bmm(eb, p["wi"])
    gate = torch.bmm(eb, p["wg"])
    # jax.nn.gelu defaults to the tanh approximation
    act = (F.silu(gate) if cfg.act == "silu"
           else F.gelu(gate, approximate="tanh"))
    y = torch.bmm(act * h, p["wo"])                                 # (E', G*cap, d)

    # combine: each assignment's output row times its weight (a dropped
    # one's 0, as the reference's), the k picks of a token summed at once;
    # under tensor parallelism a rank's part (an assignment to another
    # rank's slot reads a zero row) in fp32, summed over the ranks, then
    # rounded once
    yg = y.reshape(e_loc, g, cap, d).transpose(0, 1).reshape(
        g, e_loc * cap, d)
    at = idx - s0 * cap
    if e_axes:
        yg = torch.cat([yg, zero], dim=1)
        at = torch.where((slot >= s0) & (slot < s0 + e_loc), at, e_loc * cap)
    picked = torch.gather(yg, 1, at[..., None].expand(-1, -1, d))   # (G, n, d)
    wk = torch.where(keep, enter(weights, tp_mesh, tp).reshape(g, n),
                     0.0).to(x.dtype)
    if tp:
        out = leave(combine(picked, wk, k, torch.float32), tp_mesh, tp)
        out = out.to(x.dtype).reshape(b, s, d)
    else:
        out = combine(picked, wk, k).reshape(b, s, d)
    if not with_aux:
        return out, None

    # the load-balance loss over logical experts: mean router probability
    # times the share of assignments, E * sum(me * ce) * weight, both over
    # the global batch on a mesh
    me = probs.mean(0)
    counts = torch.zeros(e, dtype=torch.float32, device=dev).scatter_add_(
        0, top_e.reshape(-1), torch.ones(t * k, device=dev))
    if mesh is not None:
        me = SumOverRanks.apply(me, mesh, axes) / ranks
        counts = mesh.all_reduce(counts, axes, "sum")
    ce = counts / (t * ranks * k)
    aux = e * torch.sum(me * ce) * cfg.router_aux_weight
    return out, aux
