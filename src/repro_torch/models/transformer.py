"""Decoder-only LM, dense family (counterpart of ``repro.models.transformer``).

Layers are grouped into homogeneous stages (``cfg.stages()``); a stage's
per-layer parameters stay stacked along a leading layer axis, as in the
reference, and a Python loop over the layer index takes the place of
``lax.scan``.  The other families (MoE, Mamba2, xLSTM, enc-dec, VLM) raise
``NotImplementedError`` before any parameter is made (ROADMAP A9), and the
training loss ``lm_loss`` comes with the training slice.

``decode_step`` writes the KV caches in place (``models.blocks``) and
returns the cache dict with ``idx`` advanced; callers that need the old
cache keep a copy.
"""
from __future__ import annotations

import torch

from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig, require_ported
from repro_torch.models.params import (
    ParamDef,
    Tree,
    abstract_params,
    init_params,
    map_leaves,
    stack_defs,
)

# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------


def block_defs(cfg: ModelConfig, kind: str) -> Tree:
    if kind != "dense":
        require_ported({"moe": "moe", "mamba": "hybrid", "shared_attn": "hybrid",
                        "mlstm": "ssm", "slstm": "ssm"}.get(kind, kind))
    return {
        "ln1": blocks.norm_defs(cfg),
        "attn": blocks.attention_defs(cfg),
        "ln2": blocks.norm_defs(cfg),
        "mlp": blocks.mlp_defs(cfg),
    }


def stage_name(i: int, kind: str) -> str:
    return f"s{i:02d}_{kind}"


def param_defs(cfg: ModelConfig) -> Tree:
    tree: Tree = {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                          init="embed", dtype=cfg.adtype),
        "final_norm": blocks.norm_defs(cfg),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                   ("embed", "vocab"), dtype=cfg.adtype)
    for i, (kind, count) in enumerate(cfg.stages()):
        tree[stage_name(i, kind)] = stack_defs(block_defs(cfg, kind), count)
    return tree


def init(cfg: ModelConfig, seed: int = 0, *, device=None) -> Tree:
    return init_params(seed, param_defs(cfg), device=device)


def layer(tree: Tree, i: int) -> Tree:
    """Layer ``i`` of a stacked stage tree (views, no copy)."""
    return map_leaves(lambda a: a[i], tree)


def _scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as the reference makes its scale
    factors arrays of the activation dtype."""
    return float(torch.tensor(value, dtype=dtype))


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _apply_block(kind: str, p: Tree, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor) -> torch.Tensor:
    """One dense layer."""
    rs = _scalar(cfg.residual_scale, x.dtype)
    h = blocks.apply_norm(p["ln1"], x, cfg)
    h = blocks.attention(p["attn"], h, cfg, positions=positions)
    x = x + rs * h
    h = blocks.apply_norm(p["ln2"], x, cfg)
    h = blocks.apply_mlp(p["mlp"], h, cfg)
    return x + rs * h


def embed_tokens(params: Tree, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    return params["embed"][tokens.to(torch.int64)] * _scalar(cfg.embed_scale,
                                                             cfg.adtype)


def unembed(params: Tree, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = blocks.apply_norm(params["final_norm"], x, cfg)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.matmul(x, head) * _scalar(cfg.logit_scale, x.dtype)
    logits = logits.to(torch.float32)
    if cfg.logit_softcap:
        cap = cfg.logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits


def forward(params: Tree, tokens: torch.Tensor, cfg: ModelConfig,
            prefix_embeds: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits, aux_loss).  ``prefix_embeds`` (the VLM stub) waits
    for the VLM family."""
    if prefix_embeds is not None:
        require_ported("vlm", cfg.name)
    x = embed_tokens(params, tokens, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    for i, (kind, count) in enumerate(cfg.stages()):
        stage = params[stage_name(i, kind)]
        for li in range(count):
            x = _apply_block(kind, layer(stage, li), x, cfg, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(params, x, cfg), aux


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> Tree:
    """Cache tree matching cfg.stages(); plus per-slot write indices
    (continuous batching: each request sits at its own depth)."""
    tree: Tree = {"idx": ParamDef((batch,), ("batch",), init="zeros",
                                  dtype=torch.int32)}
    for i, (kind, count) in enumerate(cfg.stages()):
        tree[stage_name(i, kind)] = blocks.init_kv_cache(cfg, batch, max_len,
                                                         count)
    return tree


def paged_cache_defs(cfg: ModelConfig, batch: int, max_len: int,
                     n_pages: int, page_len: int) -> Tree:
    """Paged serving cache (serving.paged_cache): attention stages share a
    physical page pool.  Extra leaves beside ``idx``: ``pages``, the
    (batch, max_pages) int32 page table (0 = null page), and ``act``, the
    (batch,) row-active mask the paged write consults."""
    max_pages = -(-max_len // page_len)
    tree: Tree = {
        "idx": ParamDef((batch,), ("batch",), init="zeros", dtype=torch.int32),
        "act": ParamDef((batch,), ("batch",), init="ones", dtype=torch.int32),
        "pages": ParamDef((batch, max_pages), ("batch", None), init="zeros",
                          dtype=torch.int32),
    }
    for i, (kind, count) in enumerate(cfg.stages()):
        tree[stage_name(i, kind)] = blocks.paged_kv_pool_defs(
            cfg, n_pages, page_len, count)
    return tree


def _decode_block(kind: str, p: Tree, cache: Tree, x: torch.Tensor,
                  idx: torch.Tensor, cfg: ModelConfig,
                  pages: torch.Tensor | None = None,
                  act: torch.Tensor | None = None):
    """One dense layer against its cache (``cache["k"]``/``["v"]`` are that
    layer's slices, written in place)."""
    rs = _scalar(cfg.residual_scale, x.dtype)
    h = blocks.apply_norm(p["ln1"], x, cfg)
    if pages is not None:
        h, ck, cv = blocks.paged_decode_attention(
            p["attn"], h, cache["k"], cache["v"], pages, idx, act, cfg)
    else:
        h, ck, cv = blocks.decode_attention(
            p["attn"], h, cache["k"], cache["v"], idx, cfg, act=act)
    x = x + rs * h
    h = blocks.apply_norm(p["ln2"], x, cfg)
    h = blocks.apply_mlp(p["mlp"], h, cfg)
    return x + rs * h, {"k": ck, "v": cv}


def decode_step(params: Tree, cache: Tree, tokens: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, Tree]:
    """One-token decode. tokens: (B, 1). Returns (logits, cache) with the
    KV written in place and ``idx`` advanced.

    A cache built by ``paged_cache_defs`` (a ``pages`` leaf) routes the
    attention through the page table.  An ``act`` leaf masks the writes of
    inactive rows on either backend (the chunk step sets one on a dense
    cache for the length of the step)."""
    idx = cache["idx"]
    pages = cache.get("pages")
    act = cache.get("act")
    x = embed_tokens(params, tokens, cfg)
    new_cache: Tree = {"idx": idx + 1}
    for key in ("pages", "act"):
        if key in cache:
            new_cache[key] = cache[key]
    for i, (kind, count) in enumerate(cfg.stages()):
        nm = stage_name(i, kind)
        for li in range(count):
            x, _ = _decode_block(kind, layer(params[nm], li),
                                 layer(cache[nm], li), x, idx, cfg, pages, act)
        new_cache[nm] = cache[nm]
    return unembed(params, x, cfg), new_cache


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------


class LM(torch.nn.Module):
    """The decoder-only LM over an explicit parameter tree (a nested dict
    of tensors, as the reference's pytree): ``init`` makes one,
    ``forward(params, tokens)`` and ``decode_step(params, cache, tokens)``
    run it.  Constructing it for a family the port does not run raises."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        cfg.stages()
        self.cfg = cfg

    def param_defs(self) -> Tree:
        return param_defs(self.cfg)

    def init(self, seed: int = 0, *, device=None) -> Tree:
        """Seeded parameters on ``device`` (CUDA unless named)."""
        return init(self.cfg, seed, device=device)

    def abstract_params(self) -> Tree:
        return abstract_params(self.param_defs())

    def forward(self, params, tokens, prefix_embeds=None):
        return forward(params, tokens, self.cfg, prefix_embeds)

    def cache_defs(self, batch: int, max_len: int) -> Tree:
        return cache_defs(self.cfg, batch, max_len)

    def paged_cache_defs(self, batch: int, max_len: int, n_pages: int,
                         page_len: int) -> Tree:
        return paged_cache_defs(self.cfg, batch, max_len, n_pages, page_len)

    def decode_step(self, params, cache, tokens):
        return decode_step(params, cache, tokens, self.cfg)
