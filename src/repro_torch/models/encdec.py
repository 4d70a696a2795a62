"""Whisper-style encoder-decoder backbone (counterpart of
``repro.models.encdec``).  The audio frontend is a stub, as in the
reference: the caller hands precomputed frame embeddings (B, T, d).

Encoder: bidirectional self-attention over the frames.  Decoder: causal
self-attention, then cross-attention over the encoder's output.  Positions
are sinusoidal on both sides (the reference's deviation from Whisper's
learned decoder table: a parameter-free encoding keeps the position table
out of the cache-length configs), so no attention takes RoPE.

The blocks are ``models.blocks``' (LayerNorm, GQA attention with
``x_kv``/``kv_positions`` for the cross attention, the tanh GELU MLP), all
plain PyTorch: the reference computes LayerNorm in plain jnp, so the
model's one registered kernel is the training loss (``transformer.lm_loss``,
B11 on the card through ``XentFn``).  As in ``models.transformer``, a
stacked stage's layers are views taken by ``transformer.layers`` and a
Python loop takes the place of ``lax.scan``; each layer goes through
``transformer.apply_layer`` (``torch.utils.checkpoint`` under
``cfg.remat`` while autograd records).

The rounding order is the reference's: ``sinusoid`` in fp32 from an fp32
``log(10000)``, rounded once to the activation dtype; ``frames`` cast to
the activation dtype before the sinusoid is added; the tied head
``embed.T``.

On a mesh of ranks the decoder's lookup and head are the
decoder-only model's vocab-parallel ones (``transformer.embed_tokens``,
``transformer.enter_vocab_parallel``): the tied embedding shards its rows
over the model axis, and so do the logits and the loss.  The encoder's
and the decoder's attention (self and cross) and MLPs are tensor-parallel
where the rules cut their heads and MLP (``models.blocks``); the cross
attention's K and V come from the encoder's output, whole on every rank
of a model line, as the activations between the layers are.  A rank
holds its rows of the batch's frames.  Under FSDP each encoder and decoder
layer gathers its weights whole first (``blocks.gather_params``; the self
and cross attention's and the MLP's "embed" dims), and the lookup and the
tied head gather the embedding (``transformer.whole_leaf``).  The
lookup's ``embed_scale`` is whisper's 1.0, so its product is exact and the
sum with the sinusoid rounds as the reference's.

Serving is a static batch (``launch.serve``'s encdec path): ``prefill_cross``
runs the encoder once and gives every decoder layer's cross K/V, which the
caller puts into the cache (``cache["cross_k"]``, ``cache["cross_v"]``);
``decode_step`` then feeds one token a row and writes the self-attention
KV cache in place.  On a mesh (``launch.serve``'s static batch over a
``(data, model)`` mesh) a rank holds its rows of the batch, its KV heads
of the self and cross caches, and its vocab shard of the logits.  The
continuous batcher refuses this family, as the reference's never fills the
cross K/V (ROADMAP §C).
"""
from __future__ import annotations

import torch

from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import (
    ParamDef,
    Tree,
    abstract_params,
    init_params,
    stack_defs,
)
from repro_torch.models.transformer import (
    apply_layer,
    embed_def,
    embed_tokens,
    enter_vocab_parallel,
    head_def,
    layers,
    lm_loss,
    ported_mesh,
    whole_leaf,
)


def sinusoid(positions: torch.Tensor, d: int,
             dtype: torch.dtype) -> torch.Tensor:
    """positions: (B, S) -> (B, S, d): sin then cos of positions times
    ``exp(-log(10000) * i / (d/2))``, in fp32, rounded once to ``dtype``."""
    half = d // 2
    f32 = dict(dtype=torch.float32, device=positions.device)
    # the log as a device fill in fp32 (the reference's jnp.log of a
    # Python float), not a host tensor that would synchronise the stream
    freqs = torch.exp(-torch.log(torch.full((), 10_000.0, **f32))
                      * torch.arange(half, **f32) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _enc_block_defs(cfg: ModelConfig) -> Tree:
    return {
        "ln1": blocks.norm_defs(cfg),
        "attn": blocks.attention_defs(cfg),
        "ln2": blocks.norm_defs(cfg),
        "mlp": blocks.mlp_defs(cfg),
    }


def _dec_block_defs(cfg: ModelConfig) -> Tree:
    return {
        "ln1": blocks.norm_defs(cfg),
        "attn": blocks.attention_defs(cfg),
        "lnx": blocks.norm_defs(cfg),
        "cross": blocks.attention_defs(cfg),
        "ln2": blocks.norm_defs(cfg),
        "mlp": blocks.mlp_defs(cfg),
    }


def param_defs(cfg: ModelConfig) -> Tree:
    tree: Tree = {
        "embed": embed_def(cfg),
        "enc": stack_defs(_enc_block_defs(cfg), cfg.n_enc_layers),
        "enc_norm": blocks.norm_defs(cfg),
        "dec": stack_defs(_dec_block_defs(cfg), cfg.n_layers),
        "final_norm": blocks.norm_defs(cfg),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = head_def(cfg)
    return tree


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _enc_layer(lp: Tree, h: torch.Tensor, pos: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    lp = blocks.gather_params(lp, _enc_block_defs(cfg))
    a = blocks.apply_norm(lp["ln1"], h, cfg)
    h = h + blocks.attention(lp["attn"], a, cfg, positions=pos, causal=False,
                             use_rope=False)
    a = blocks.apply_norm(lp["ln2"], h, cfg)
    return h + blocks.apply_mlp(lp["mlp"], a, cfg)


def encode(params: Tree, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, T, d) precomputed embeddings (the stub frontend) ->
    the encoder's normed output (B, T, d) in the activation dtype."""
    ported_mesh(cfg)
    b, t, _ = frames.shape
    pos = _positions(b, t, frames.device)
    x = frames.to(cfg.adtype) + sinusoid(pos, cfg.d_model, cfg.adtype)
    for lp in layers(params["enc"]):
        x = apply_layer(cfg, _enc_layer, lp, x, pos, cfg)
    return blocks.apply_norm(params["enc_norm"], x, cfg)


def _dec_layer(lp: Tree, h: torch.Tensor, pos: torch.Tensor,
               enc_out: torch.Tensor, epos: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    lp = blocks.gather_params(lp, _dec_block_defs(cfg))
    a = blocks.apply_norm(lp["ln1"], h, cfg)
    h = h + blocks.attention(lp["attn"], a, cfg, positions=pos, causal=True,
                             use_rope=False)
    a = blocks.apply_norm(lp["lnx"], h, cfg)
    h = h + blocks.attention(lp["cross"], a, cfg, positions=pos,
                             x_kv=enc_out, kv_positions=epos, causal=False,
                             use_rope=False)
    a = blocks.apply_norm(lp["ln2"], h, cfg)
    return h + blocks.apply_mlp(lp["mlp"], a, cfg)


def _head(params: Tree, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The final norm and the head (tied: ``embed.T``), fp32 logits (this
    rank's vocab shard of them under a vocab-parallel mesh)."""
    x = enter_vocab_parallel(
        blocks.apply_norm(params["final_norm"], x, cfg), cfg)
    head = (whole_leaf(params, "embed", cfg).T if cfg.tie_embeddings
            else whole_leaf(params, "lm_head", cfg))
    return torch.matmul(x, head).to(torch.float32)


def decode_train(params: Tree, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """The decoder over whole sequences: tokens (B, S) against the
    encoder's output (B, T, d) -> logits (B, S, V) fp32."""
    b, s = tokens.shape
    pos = _positions(b, s, tokens.device)
    epos = _positions(b, enc_out.shape[1], tokens.device)
    x = (embed_tokens(params, tokens, cfg)
         + sinusoid(pos, cfg.d_model, cfg.adtype))
    for lp in layers(params["dec"]):
        x = apply_layer(cfg, _dec_layer, lp, x, pos, enc_out, epos, cfg)
    return _head(params, x, cfg)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> Tree:
    """The decoder's self-attention KV cache, the per-row write index and
    the precomputed cross K/V, (L, B, T, KH, hd) each."""
    kh, hd, n = cfg.n_kv_heads, cfg.hd, cfg.n_layers
    cross = ParamDef((n, batch, cfg.n_frames, kh, hd),
                     ("layers", "batch", "frames", "kv_heads", None),
                     init="zeros", dtype=cfg.adtype)
    return {
        "idx": ParamDef((batch,), ("batch",), init="zeros",
                        dtype=torch.int32),
        "self": blocks.init_kv_cache(cfg, batch, max_len, n),
        "cross_k": cross,
        "cross_v": cross,
    }


def prefill_cross(params: Tree, frames: torch.Tensor, cfg: ModelConfig
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The encoder pass and every decoder layer's cross K/V:
    (L, B, T, KH, hd) each; on a mesh a rank's rows and KV heads of them
    (its block where the rules cut the KV heads, else all of them:
    ``blocks.decode_parallel``), each layer's cross weights gathered first
    under FSDP."""
    blocks.decode_parallel(cfg)
    enc = encode(params, frames, cfg)
    defs = {"cross": blocks.attention_defs(cfg)}
    ks, vs = [], []
    for lp in layers(params["dec"]):
        cp = blocks.gather_params({"cross": lp["cross"]}, defs)["cross"]
        k = torch.einsum("bsd,dhk->bshk", enc, cp["wk"])
        v = torch.einsum("bsd,dhk->bshk", enc, cp["wv"])
        if cfg.qkv_bias:
            k = k + cp["bk"]
            v = v + cp["bv"]
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


def _cross_decode(lp: Tree, x: torch.Tensor, ck: torch.Tensor,
                  cv: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One token's cross attention over fixed K/V; ck, cv: (B, T, KH, hd),
    a rank's query heads and the KV heads its cache holds under tensor
    parallelism (``blocks.decode_parallel``), the output summed over the
    ranks."""
    mesh, axes = tp = blocks.decode_parallel(cfg)
    q = torch.einsum("bsd,dhk->bshk", x, lp["wq"])
    if cfg.qkv_bias:
        q = q + lp["bq"]
    if cfg.qk_norm:
        q = blocks.rms_head_norm(lp["q_norm"], q, cfg.norm_eps)
    q0 = mesh.index(axes) * q.shape[2] if axes else 0
    ck, cv = blocks._queries_kv(ck, cv, q0, q.shape[2], cfg)
    probs = torch.softmax(blocks._gqa_scores(q, ck, cfg), dim=-1)
    return blocks._gqa_out(probs, cv, lp, x.dtype, tp)


def decode_step(params: Tree, cache: Tree, tokens: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, Tree]:
    """One decoder token a row (tokens (B, 1)) against the self-attention
    cache, written in place, and the fixed cross K/V.  Returns (logits
    (B, 1, V) fp32, cache with ``idx`` advanced).  The token goes through
    ``transformer.embed_tokens``, the lookup ``decode_train`` takes.  On a
    mesh of ranks the cache and the tokens are a rank's rows (and KV
    heads), the logits its vocab shard, each layer tensor-parallel with its
    FSDP-cut weights gathered first."""
    ported_mesh(cfg)
    blocks.decode_parallel(cfg)
    idx = torch.as_tensor(cache["idx"], dtype=torch.int32).expand(
        tokens.shape[0])
    x = (embed_tokens(params, tokens, cfg)
         + sinusoid(idx[:, None], cfg.d_model, cfg.adtype))
    self_kv = cache["self"]
    defs = _dec_block_defs(cfg)
    for lp, sk, sv, ck, cv in zip(layers(params["dec"]), self_kv["k"],
                                  self_kv["v"], cache["cross_k"],
                                  cache["cross_v"]):
        lp = blocks.gather_params(lp, defs)
        a = blocks.apply_norm(lp["ln1"], x, cfg)
        a, _, _ = blocks.decode_attention(lp["attn"], a, sk, sv, idx, cfg,
                                          use_rope=False)
        x = x + a
        a = blocks.apply_norm(lp["lnx"], x, cfg)
        x = x + _cross_decode(lp["cross"], a, ck, cv, cfg)
        a = blocks.apply_norm(lp["ln2"], x, cfg)
        x = x + blocks.apply_mlp(lp["mlp"], a, cfg)
    return _head(params, x, cfg), {**cache, "idx": idx + 1}


# ---------------------------------------------------------------------------
# Facade (the interface of transformer.LM)
# ---------------------------------------------------------------------------


class EncDecLM(torch.nn.Module):
    """The encoder-decoder over an explicit parameter tree: ``init`` makes
    one, ``forward(params, tokens, frames)``, ``loss(params, batch)``
    (``batch["frames"]``), ``prefill_cross(params, frames)`` and
    ``decode_step(params, cache, tokens)`` run it."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: EncDecLM runs the encdec family, "
                             f"not {cfg.family!r}")
        self.cfg = cfg

    def param_defs(self) -> Tree:
        return param_defs(self.cfg)

    def init(self, seed: int = 0, *, device=None, cut=None) -> Tree:
        """Seeded parameters on ``device`` (CUDA unless named), each leaf
        through ``cut(path, leaf)`` as it is drawn when given."""
        return init_params(seed, self.param_defs(), device=device, cut=cut)

    def abstract_params(self) -> Tree:
        return abstract_params(self.param_defs())

    def forward(self, params, tokens, frames):
        """(logits (B, S, V) fp32, aux 0): the encoder over ``frames``,
        then the decoder over ``tokens``."""
        enc = encode(params, frames, self.cfg)
        logits = decode_train(params, tokens, enc, self.cfg)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device)

    def loss(self, params, batch) -> torch.Tensor:
        logits, _ = self.forward(params, batch["tokens"], batch["frames"])
        return lm_loss(logits, batch["labels"], self.cfg, batch.get("mask"))

    def cache_defs(self, batch: int, max_len: int) -> Tree:
        return cache_defs(self.cfg, batch, max_len)

    def prefill_cross(self, params, frames):
        return prefill_cross(params, frames, self.cfg)

    def decode_step(self, params, cache, tokens):
        return decode_step(params, cache, tokens, self.cfg)
