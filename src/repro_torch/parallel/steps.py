"""Step functions: prefill / decode / chunked decode.

Counterpart of the inference steps of ``repro.parallel.steps``; the train
and eval steps come with the training slice.  PyTorch runs eagerly, so a
step is a plain function (the reference wraps them in ``jax.jit``), and
the chunk step's ``lax.scan`` over micro-steps is a Python loop.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.params import map_leaves


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
