"""Step functions: train / eval / prefill / decode / chunked decode.

Counterpart of ``repro.parallel.steps``.  PyTorch runs eagerly, so a step
is a plain function (the reference wraps them in ``jax.jit``), and a
``lax.scan`` (over microbatches, over the chunk step's micro-steps) is a
Python loop.

On a mesh of ranks (``make_train_step(..., mesh=, rules=)``) the state and
the batch are this rank's shards, in every family.  The loss is the global
one (the vocab-parallel ``xent`` combines over the model axis and means
over the data axis; an MoE layer's load-balance term sums its statistics
over the data axis), and each rank's backward gives the gradient through
its own rows, so each rank's gradient is its share of the global loss's
gradient: every leaf is summed over the data axes -- the mean over the data
ranks of each rank's own-token gradient, which the reference's ``jit`` gets
from its global arrays.  Under tensor parallelism a rank's gradient of a
leaf the rules cut is already its block's whole gradient (the layers sum
over the model ranks where a replicated tensor enters a rank's part,
``models.blocks``), so the model axis adds no sum.  Under FSDP a leaf
cut over the data axes is summed over them by its gather's backward (a
reduce-scatter, ``blocks.GatherOverRanks``), so the data axes add no sum
to it either.  The replicated leaves
then hold the same bits on every rank; the sharded ones (the embedding,
and the heads', MLP's and experts' weights) keep their own blocks.  The
clipping norm sums each leaf's squares once: over the mesh axes that cut
it, never for a replicated leaf.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.api import context as context_lib
from repro_torch.models.params import leaves, map_leaves
from repro_torch.optim import adamw
from repro_torch.parallel import rules as rules_lib
from repro_torch.parallel import specs as specs_lib


def _tree(pairs) -> dict:
    out: dict = {}
    for path, leaf in pairs:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def value_and_grad(model, params: dict, batch: dict):
    """``(loss, grads)`` of ``model.loss`` at ``params``: the counterpart of
    ``jax.value_and_grad(model.loss, allow_int=True)``.  Every floating
    leaf is differentiated (a leaf the loss does not reach gets zeros); an
    integer leaf's gradient is ``None``.  ``params`` are left as they are:
    the loss runs on detached views that require grad."""
    flat = list(leaves(params))
    live = [p.detach().requires_grad_(True) if p.is_floating_point() else p
            for _, p in flat]
    loss = model.loss(_tree((path, t) for (path, _), t in zip(flat, live)),
                      batch)
    wrt = [t for t in live if t.is_floating_point()]
    got = iter(torch.autograd.grad(loss, wrt, allow_unused=True,
                                   materialize_grads=True))
    grads = _tree((path, next(got) if t.is_floating_point() else None)
                  for (path, _), t in zip(flat, live))
    return loss.detach(), grads


def _mesh_grads(grads: dict, mesh, data_axes, shard_axes: dict):
    """``(grads, global norm)`` of one rank's gradients on a mesh: every
    leaf summed over ``data_axes`` but those ``shard_axes`` (path -> axes)
    cuts over one of them (FSDP's: ``blocks.GatherOverRanks``' backward
    summed them over the data ranks already, and a second sum would
    double them); the norm's squares of a leaf sharded over mesh axes
    summed over those axes, one collective an axis set."""
    if data_axes and mesh.axis_size(data_axes) > 1:
        summed = set(data_axes)
        grads = _tree(
            (path, g if g is None or summed & set(shard_axes.get(path, ()))
             else mesh.all_reduce(g, data_axes, "sum"))
            for path, g in leaves(grads))
    sq, by_axes = [], {}
    for path, g in leaves(grads):
        if g is None or not g.is_floating_point():
            continue
        by_axes.setdefault(shard_axes.get(path, ()), []).append(len(sq))
        sq.append(torch.sum(torch.square(g.to(torch.float32))))
    if not sq:
        return grads, torch.zeros((), dtype=torch.float32)
    sq = torch.stack(sq)
    for axes, idx in by_axes.items():
        if axes:
            sel = torch.tensor(idx, device=sq.device)
            sq[sel] = mesh.all_reduce(sq[sel], axes, "sum")
    return grads, torch.sqrt(sq.sum())


def make_grad_fn(model, *, microbatches: int = 1, mesh=None,
                 rules=None) -> Callable:
    """``grad_fn(params, batch) -> (loss, grads, gnorm)``: the loss and the
    gradient of every leaf the optimizer sees, and the global gradient norm
    on a mesh (``None`` on one device, where ``adamw`` takes it).

    With ``microbatches > 1`` the batch is processed as micro-slices along
    its leading axis with fp32 gradient accumulation.  With a ``mesh`` of
    more than one rank it runs under the mesh and ``rules`` (default:
    ``rules.launcher_rules(model.cfg)``) on this rank's shards, and sums the
    gradients over the data axes."""
    on_mesh = mesh is not None and mesh.size > 1
    if on_mesh:
        rules = rules_lib.mesh_table(
            mesh, rules or rules_lib.launcher_rules(model.cfg))
        data_axes = rules_lib.mesh_axes("batch", mesh, rules)
        pspecs = specs_lib.param_specs(model.param_defs(), rules,
                                       mesh.axis_sizes)
        shard_axes = {}
        for path in specs_lib.sharded_paths(pspecs, mesh.axis_sizes):
            node = pspecs
            for k in path:
                node = node[k]
            shard_axes[path] = tuple(a for part in node
                                     for a in rules_lib.target_axes(part))

    def loss_and_grads(params: dict, batch: dict):
        if microbatches == 1:
            return value_and_grad(model, params, batch)
        split = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                              *v.shape[1:]) for k, v in batch.items()}
        loss = torch.zeros((), dtype=torch.float32)
        grads = None
        for i in range(microbatches):
            mloss, mgrads = value_and_grad(
                model, params, {k: v[i] for k, v in split.items()})
            loss = loss.to(mloss.device) + mloss.to(torch.float32)
            grads = map_leaves(
                lambda g: None if g is None else g.to(torch.float32),
                mgrads) if grads is None else map_leaves(
                lambda a, g: a if g is None else a + g.to(torch.float32),
                grads, mgrads)
        inv = 1.0 / microbatches
        return loss * inv, map_leaves(
            lambda g: None if g is None else g * inv, grads)

    def grad_fn(params: dict, batch: dict):
        if not on_mesh:
            loss, grads = loss_and_grads(params, batch)
            return loss, grads, None
        with context_lib.plan_context(mesh=mesh), \
                rules_lib.use_rules(rules, mesh):
            loss, grads = loss_and_grads(params, batch)
            with torch.no_grad():
                grads, gnorm = _mesh_grads(grads, mesh, data_axes,
                                           shard_axes)
        return loss, grads, gnorm

    return grad_fn


def make_train_step(model, opt_cfg: adamw.AdamWConfig, schedule: Callable, *,
                    microbatches: int = 1, mesh=None, rules=None,
                    donate: bool = False) -> Callable:
    """Train step with optional gradient accumulation (``make_grad_fn``).

    ``train_step(state, batch) -> (state, metrics)`` with ``state`` =
    ``{"params", "opt"}`` and metrics ``loss``, ``lr`` and ``grad_norm`` as
    0-d tensors; the input state is left as it was, unless ``donate``
    (``adamw.apply_updates``: the update written into its tensors, so a
    step holds one state).  With a ``mesh`` of more than one rank the state
    and the batch are this rank's shards."""
    grad_fn = make_grad_fn(model, microbatches=microbatches, mesh=mesh,
                           rules=rules)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        loss, grads, gnorm = grad_fn(params, batch)
        lr = schedule(state["opt"]["step"])
        with torch.no_grad():
            params, opt, metrics = adamw.apply_updates(
                params, grads, state["opt"], lr, opt_cfg, gnorm=gnorm,
                donate=donate)
        return {"params": params, "opt": opt}, {"loss": loss, "lr": lr,
                                                **metrics}

    return train_step


def make_eval_step(model) -> Callable:
    def eval_step(params: dict, batch: dict) -> torch.Tensor:
        with torch.no_grad():
            return model.loss(params, batch)

    return eval_step


def init_train_state(model, opt_cfg: adamw.AdamWConfig, seed: int = 0, *,
                     device=None, cut=None) -> dict:
    """The seeded parameters and a fresh AdamW state.  With ``cut(path,
    leaf)`` each parameter is cut as it is drawn (``params.init_params``,
    a mesh rank's block), and the moments and the master copy are made from
    the blocks: the same blocks, bit for bit, as cutting the whole state,
    whose specs are the parameters' own."""
    params = model.init(seed, device=device, cut=cut)
    return {"params": params, "opt": adamw.init_state(params, opt_cfg)}


def make_prefill_step(model) -> Callable:
    """Inference prefill: full forward; returns the fp32 logits of the last
    position (the serving handoff).  An encdec model reads the batch's
    ``frames``, a vlm model its ``img_embeds`` when there are any."""
    family = model.cfg.family

    def prefill_step(params: dict, batch: dict) -> torch.Tensor:
        if family == "encdec":
            logits, _ = model.forward(params, batch["tokens"],
                                      batch["frames"])
        elif family == "vlm":
            logits, _ = model.forward(params, batch["tokens"],
                                      batch.get("img_embeds"))
        else:
            logits, _ = model.forward(params, batch["tokens"])
        return logits[:, -1, :]

    return prefill_step


def greedy(logits: torch.Tensor, cfg) -> torch.Tensor:
    """The greedy token of each row of (B, V) logits, int32 (B,).  Under a
    vocab-parallel mesh the logits are this rank's shard: each rank's
    largest logit and its global column are all-gathered over the vocab
    ranks (one collective of (B, 2) fp32 a rank: the columns are below
    2^24, exact in fp32) and the largest taken, a tie going to the lowest
    global column, as ``torch.argmax`` breaks it on one device (a rank's
    shard holds the columns after its predecessors')."""
    from repro_torch.models import transformer

    local = torch.argmax(logits, dim=-1)
    mesh, axes = transformer.vocab_parallel(cfg)
    if not axes:
        return local.to(torch.int32)
    best = torch.gather(logits, -1, local[:, None])[:, 0]
    col = local + mesh.index(axes) * logits.shape[-1]
    pair = torch.stack([best.to(torch.float32), col.to(torch.float32)], 1)
    every = mesh.all_gather(pair, axes, 1).reshape(pair.shape[0], -1, 2)
    winner = torch.argmax(every[..., 0], dim=-1)
    return torch.gather(every[..., 1], 1, winner[:, None])[:, 0].to(
        torch.int32)


def make_decode_step(model) -> Callable:
    """serve_step: one new token against the KV cache; greedy token
    (``greedy``: across the vocab ranks on a mesh)."""
    cfg = model.cfg

    def decode_step(params: dict, cache: dict, tokens: torch.Tensor):
        logits, new_cache = model.decode_step(params, cache, tokens)
        return greedy(logits[:, -1, :], cfg)[:, None], new_cache

    return decode_step


def make_chunk_step(model, batch_axes) -> Callable:
    """Chunked serve step: advance each batch row by its own number of
    tokens (0..C) in one call -- the continuous batcher's chunked-prefill
    tick.

    ``chunk_step(params, cache, tokens, nvalid)`` runs masked micro decode
    steps: at micro-step c only rows with ``c < nvalid`` advance.  The
    cache's ``act`` leaf is set to the active rows for each micro-step, so
    the in-place writes of frozen rows change nothing: the KV caches
    (``models.blocks``), the Mamba2 conv and SSM state (``models.mamba2``)
    and the mLSTM and sLSTM state (``models.xlstm``) keep what they held.  Every leaf the
    step replaced (``idx``) is restored for frozen rows along
    its declared batch axis (``batch_axes``: a cache-shaped tree of ints,
    -1 for leaves with no batch axis), as the reference's ``_restore`` does
    for every leaf.  Rows are independent in the model, so each row's tokens
    are bit-identical to stepping it alone one token at a time.  Micro-steps
    past the longest row's count would change nothing and are not run.

    Returns ``(next_token (B, 1), cache)``; ``next_token[b]`` is the greedy
    token after row b's last valid input (garbage for rows with
    ``nvalid == 0``; the scheduler ignores them).  ``act`` is left all ones
    on a paged cache and removed from a dense one.

    On a mesh of ranks the rows are this rank's, and every rank must run
    the same micro-steps, since each makes the same collectives (the
    tensor-parallel sums, an MoE layer's ranking, FSDP's gathers, the
    greedy token's gather): the count is ``steps``, the global rows'
    longest, which the caller holds (the continuous batcher's host
    schedule), and a step on a data mesh without it raises before any
    collective.  On one device it defaults to the rows' longest.
    """
    cfg = model.cfg

    def _restore(new, old, ax, active):
        if ax < 0 or new is old:
            return new
        mask = active.reshape(
            tuple(new.shape[ax] if d == ax else 1 for d in range(new.ndim)))
        return torch.where(mask, new, old)

    def chunk_step(params: dict, cache: dict, tokens: torch.Tensor,
                   nvalid: torch.Tensor, steps: int | None = None):
        if steps is None:
            from repro_torch.models.moe import data_parallel

            if data_parallel()[1]:
                raise ValueError(
                    "a chunk step on a data mesh needs steps=, the global "
                    "rows' longest count: a rank's own rows may run fewer "
                    "micro-steps, and so fewer collectives, than another's")
            steps = int(nvalid.max()) if nvalid.numel() else 0
        if steps == 0:
            return torch.zeros_like(tokens[:, :1]), cache
        paged = "act" in cache
        cur = dict(cache)
        axes = {**batch_axes, "act": -1}
        toks = []
        for c in range(steps):
            active = c < nvalid                                   # (B,)
            cur["act"] = active.to(torch.int32)
            logits, nc = model.decode_step(params, cur, tokens[:, c:c + 1])
            cur = map_leaves(lambda n, o, ax: _restore(n, o, ax, active),
                             nc, cur, axes)
            toks.append(greedy(logits[:, -1, :], cfg))
        toks = torch.stack(toks, dim=1)                           # (B, C')
        sel = torch.clamp(nvalid.to(torch.int64) - 1, 0, toks.shape[1] - 1)
        next_tok = torch.gather(toks, 1, sel[:, None])
        if paged:
            cur["act"] = torch.ones_like(cur["act"])
        else:
            del cur["act"]
        return next_tok, cur

    return chunk_step
