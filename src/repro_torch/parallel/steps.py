"""Step functions: train / eval / prefill / decode / chunked decode.

Counterpart of ``repro.parallel.steps`` (single device).  PyTorch runs
eagerly, so a step is a plain function (the reference wraps them in
``jax.jit``), and a ``lax.scan`` (over microbatches, over the chunk step's
micro-steps) is a Python loop.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.params import leaves, map_leaves
from repro_torch.optim import adamw


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


def make_train_step(model, opt_cfg: adamw.AdamWConfig, schedule: Callable, *,
                    microbatches: int = 1) -> Callable:
    """Train step with optional gradient accumulation.

    With ``microbatches > 1`` the global batch is processed as micro-slices
    along its leading axis with fp32 gradient accumulation (the optimizer
    still sees the full-batch gradient, up to fp32 summation order).
    ``train_step(state, batch) -> (state, metrics)`` with ``state`` =
    ``{"params", "opt"}`` and metrics ``loss``, ``lr`` and ``grad_norm`` as
    0-d tensors; the input state is left as it was."""

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        if microbatches == 1:
            loss, grads = value_and_grad(model, params, batch)
        else:
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
            loss = loss * inv
            grads = map_leaves(lambda g: None if g is None else g * inv, grads)
        lr = schedule(state["opt"]["step"])
        with torch.no_grad():
            params, opt, metrics = adamw.apply_updates(
                params, grads, state["opt"], lr, opt_cfg)
        return {"params": params, "opt": opt}, {"loss": loss, "lr": lr,
                                                **metrics}

    return train_step


def make_eval_step(model) -> Callable:
    def eval_step(params: dict, batch: dict) -> torch.Tensor:
        with torch.no_grad():
            return model.loss(params, batch)

    return eval_step


def init_train_state(model, opt_cfg: adamw.AdamWConfig, seed: int = 0, *,
                     device=None) -> dict:
    params = model.init(seed, device=device)
    return {"params": params, "opt": adamw.init_state(params, opt_cfg)}


def make_prefill_step(model) -> Callable:
    """Inference prefill: full forward; returns the fp32 logits of the last
    position (the serving handoff)."""
    def prefill_step(params: dict, batch: dict) -> torch.Tensor:
        logits, _ = model.forward(params, batch["tokens"])
        return logits[:, -1, :]

    return prefill_step


def make_decode_step(model) -> Callable:
    """serve_step: one new token against the KV cache; greedy token."""

    def decode_step(params: dict, cache: dict, tokens: torch.Tensor):
        logits, new_cache = model.decode_step(params, cache, tokens)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok[:, None], new_cache

    return decode_step


def make_chunk_step(model, batch_axes) -> Callable:
    """Chunked serve step: advance each batch row by its own number of
    tokens (0..C) in one call -- the continuous batcher's chunked-prefill
    tick.

    ``chunk_step(params, cache, tokens, nvalid)`` runs masked micro decode
    steps: at micro-step c only rows with ``c < nvalid`` advance.  The
    cache's ``act`` leaf is set to the active rows for each micro-step, so
    the in-place KV writes of frozen rows change nothing (``models.blocks``);
    every leaf the step replaced (``idx``) is restored for frozen rows along
    its declared batch axis (``batch_axes``: a cache-shaped tree of ints,
    -1 for leaves with no batch axis), as the reference's ``_restore`` does
    for every leaf.  Rows are independent in the model, so each row's tokens
    are bit-identical to stepping it alone one token at a time.  Micro-steps
    past the longest row's count would change nothing and are not run.

    Returns ``(next_token (B, 1), cache)``; ``next_token[b]`` is the greedy
    token after row b's last valid input (garbage for rows with
    ``nvalid == 0``; the scheduler ignores them).  ``act`` is left all ones
    on a paged cache and removed from a dense one.
    """

    def _restore(new, old, ax, active):
        if ax < 0 or new is old:
            return new
        mask = active.reshape(
            tuple(new.shape[ax] if d == ax else 1 for d in range(new.ndim)))
        return torch.where(mask, new, old)

    def chunk_step(params: dict, cache: dict, tokens: torch.Tensor,
                   nvalid: torch.Tensor):
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
            toks.append(torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32))
        toks = torch.stack(toks, dim=1)                           # (B, C')
        sel = torch.clamp(nvalid.to(torch.int64) - 1, 0, toks.shape[1] - 1)
        next_tok = torch.gather(toks, 1, sel[:, None])
        if paged:
            cur["act"] = torch.ones_like(cur["act"])
        else:
            del cur["act"]
        return next_tok, cur

    return chunk_step
