"""Decoder-only LM, dense, vlm, moe, hybrid and ssm families (counterpart
of ``repro.models.transformer``).

Layers are grouped into homogeneous stages (``cfg.stages()``); a stage's
per-layer parameters stay stacked along a leading layer axis, as in the
reference, and a Python loop over the layers (``layers``: one ``unbind`` a
stage) takes the place of ``lax.scan``.  With ``cfg.remat`` and autograd
recording, each layer runs under ``torch.utils.checkpoint`` (non-reentrant),
the counterpart of the reference's ``jax.checkpoint`` of the scan body: its
activations are recomputed in the backward pass instead of kept.

An MoE layer (``models.moe``) is the dense layer with the routed experts in
place of the MLP; ``forward`` returns the sum over the layers of their
load-balance losses, which ``LM.loss`` adds to the cross-entropy, and a
decode step discards it.

The hybrid family (zamba2) runs stages of Mamba2 layers
(``models.mamba2``) and, at every ``('shared_attn', 1)`` stage, one shared
attention block: a single parameter set (``params["shared_attn"]``, not
stacked) whose input is ``concat([x, h0]) @ win``, h0 the embedded tokens,
with a KV cache (or page pool) of its own for each application.  The ssm
family (xlstm) runs stages of mLSTM layers and single sLSTM layers
(``models.xlstm``), each behind its ``ln1``, and has no attention stage and
no KV cache at all.  The vlm family (pixtral) is the dense decoder whose
``forward`` takes a prefix of image embeddings (``prefix_embeds``, the
batch's ``img_embeds`` in ``LM.loss``); it serves text alone, from position
0, as the reference does.  The encdec family (whisper) is
``models.encdec.EncDecLM``.

``lm_loss`` is the training loss: unmasked, the registered ``xent`` kernel
(B11 on the card) differentiated by ``XentFn``; masked, plain PyTorch on
one device and the same kernel path, weighted, on a mesh.

Under a mesh of ranks (an ambient ``launch.mesh.Mesh``, ``api.spmd``) the
model is *vocab-parallel*, Megatron's layout: the tied embedding (V, d)
shards its rows over the mesh axes the rules give "vocab", and so do the
logits and the loss.  Three pieces carry it:

  * the embedding lookup takes the tokens in this rank's rows
    ``[off, off + V/M)`` and sums the rows over the vocab ranks (one rank
    holds each token's row, the others add zeros); its backward is the
    identity (``blocks.SumOverRanks``);
  * before the head, the activations enter the vocab-parallel region: the
    forward is the identity and the backward sums dx over the vocab ranks
    (``blocks.SumGradOverRanks``), so the replicated activations get the
    same gradient on every rank;
  * ``XentFn`` launches ``xent`` over the mesh (B12 on each vocab shard and
    the log-sum-exp combine) and differentiates it by the vocab-parallel
    ``xent_grad``.

The layers between are *tensor-parallel* where the rules cut their heads,
MLP and experts (``models.blocks``' attention and MLP, ``models.moe``)
and the recurrent blocks' heads and ``d_inner`` columns (``models.mamba2``,
``models.xlstm``, their norms split: ``blocks.rms_norm_split``); the
activations between the layers stay whole on every rank of a model line,
and zamba2's shared block, the dense attention and MLP, takes its
``concat([x, h0]) @ win`` whole on every rank.  Every family trains on a
``(data, model)`` mesh under ``rules.launcher_rules(cfg)``, computing the
reference's function of the global batch: a rank holds its rows of the
batch (the image embeddings of a vlm batch too), an MoE layer ranks
capacity and averages its load-balance statistics over the global batch
(``models.moe``), and the encoder-decoder shares this module's
vocab-parallel lookup and head entry (``models.encdec``).  Under FSDP
(``cfg.fsdp``: "embed" cut over "data") a rank holds its half of every
"embed" dim: each layer gathers its weights whole at the start of its body
(``blocks.gather_params``, inside the remat checkpoint, so the
recomputation gathers again), the lookup and the head gather theirs where
they are used (``whole_leaf``), and the gathers' backward sums each
gradient over the data ranks and cuts it back (a reduce-scatter).  The
vlm's image prefix has no weights to gather.  The model raises where the
rules cut a parameter axis the port does not run (``rules.require_ported``:
"embed" off the batch's mesh axes, and a model axis that divides a
recurrent block's columns but not its heads, ROADMAP A11).  Decoding runs
on the same mesh (``decode_step``, ROADMAP A11.5): a rank holds its rows
of the serving cache's slots and its block of the KV heads and recurrent
state, under ``rules.decode_rules(cfg, mesh)``; where the rules cut the
cache's positions ("cache_seq", flash decoding) a rank's dense cache holds
its block of the positions, and the attention combines the ranks'
softmax partials (``models.blocks.decode_attention``).

``decode_step`` writes the KV caches, the Mamba2 conv and SSM state and
the mLSTM and sLSTM state in place (``models.blocks``, ``models.mamba2``,
``models.xlstm``) and returns the cache dict with ``idx`` advanced;
callers that need the old cache keep a copy.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.api import context as context_lib
from repro_torch.api import dispatch
from repro_torch.api import spmd as spmd_lib
from repro_torch.models import blocks, mamba2, moe, xlstm
from repro_torch.models.config import ModelConfig
from repro_torch.obs import bus as obs_bus
from repro_torch.models.params import (
    ParamDef,
    Tree,
    abstract_params,
    init_params,
    leaves,
    map_leaves,
    stack_defs,
)
from repro_torch.parallel import rules as rules_lib

# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------


# the stage kinds of one recurrent block behind its ln1: the block's
# parameter, cache and full-sequence and decode functions
_RECURRENT = {
    "mamba": (mamba2.mamba_defs, mamba2.mamba_cache_defs,
              mamba2.mamba_forward, mamba2.mamba_decode_step),
    "mlstm": (xlstm.mlstm_defs, xlstm.mlstm_cache_defs,
              xlstm.mlstm_forward, xlstm.mlstm_decode_step),
    "slstm": (xlstm.slstm_defs, xlstm.slstm_cache_defs,
              xlstm.slstm_forward, xlstm.slstm_decode_step),
}


def block_defs(cfg: ModelConfig, kind: str) -> Tree:
    if kind in _RECURRENT:
        return {"ln1": blocks.norm_defs(cfg), kind: _RECURRENT[kind][0](cfg)}
    if kind not in ("dense", "moe", "shared_attn"):
        raise ValueError(f"unknown block kind {kind!r}")
    defs: Tree = {
        "ln1": blocks.norm_defs(cfg),
        "attn": blocks.attention_defs(cfg),
        "ln2": blocks.norm_defs(cfg),
    }
    if kind == "moe":
        defs["moe"] = moe.moe_defs(cfg)
    else:
        defs["mlp"] = blocks.mlp_defs(cfg)
    if kind == "shared_attn":   # its input projection of concat([x, h0])
        defs["win"] = ParamDef((2 * cfg.d_model, cfg.d_model),
                               ("embed", "embed"), dtype=cfg.adtype)
    return defs


def stage_name(i: int, kind: str) -> str:
    return f"s{i:02d}_{kind}"


def embed_def(cfg: ModelConfig) -> ParamDef:
    """The token embedding (V, d), the tied head's too."""
    return ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                    init="embed", dtype=cfg.adtype)


def head_def(cfg: ModelConfig) -> ParamDef:
    """The untied head (d, V)."""
    return ParamDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                    dtype=cfg.adtype)


def param_defs(cfg: ModelConfig) -> Tree:
    tree: Tree = {
        "embed": embed_def(cfg),
        "final_norm": blocks.norm_defs(cfg),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = head_def(cfg)
    stages = cfg.stages()
    for i, (kind, count) in enumerate(stages):
        if kind != "shared_attn":   # one shared subtree, added below
            tree[stage_name(i, kind)] = stack_defs(block_defs(cfg, kind),
                                                   count)
    if ("shared_attn", 1) in stages:
        tree["shared_attn"] = block_defs(cfg, "shared_attn")
    return tree


def init(cfg: ModelConfig, seed: int = 0, *, device=None, cut=None) -> Tree:
    """Seeded parameters; ``cut(path, leaf)`` takes each leaf as it is drawn
    (``params.init_params``: a mesh rank's block)."""
    params = init_params(seed, param_defs(cfg), device=device, cut=cut)
    # the skew permutations are structural, not random
    for i, (kind, count) in enumerate(cfg.stages()):
        if kind == "moe":
            perms = moe.make_perms(cfg, count, expert_shards(cfg))
            params[stage_name(i, kind)]["moe"]["perm"].copy_(
                torch.from_numpy(perms))
    return params


def expert_shards(cfg: ModelConfig) -> int:
    """The devices the expert axis is sharded over, for the skew tables:
    16, the reference's single-pod model-axis width, so the tables are
    deterministic; 1 (identity tables) when the experts are split by
    tensor parallelism (``expert_tp``) instead."""
    return 16 if (cfg.n_experts and not cfg.expert_tp) else 1


def layers(tree: Tree) -> list[Tree]:
    """The layers of a stacked stage tree (views, no copy), one ``unbind``
    a leaf.  Under autograd, indexing ``a[i]`` a layer would give each
    stacked leaf one full-sized zero-filled gradient a layer; ``unbind``'s
    backward stacks the layers' gradients once."""
    split = map_leaves(lambda a: a.unbind(0), tree)
    count = len(next(iter(leaves(split)))[1])
    return [map_leaves(lambda parts: parts[i], split) for i in range(count)]


def _scope() -> tuple:
    """This thread's plan context, rules, mesh and obs sinks, for a
    backward to re-enter (``_reenter``)."""
    return (context_lib.current_context(), rules_lib.current_rules(),
            rules_lib.current_mesh(), obs_bus.current_sinks())


@contextlib.contextmanager
def _reenter(scope):
    plan_ctx, rules, mesh, sinks = scope
    with context_lib.use_context(plan_ctx), \
            rules_lib.use_rules(rules, mesh), \
            obs_bus.session(*sinks, inherit=False):
        yield


def apply_layer(cfg: ModelConfig, body, *args):
    """``body(*args)``, one layer: under ``checkpoint`` (non-reentrant) when
    ``cfg.remat`` and autograd records, else a plain call.  The backward's
    recomputation may run on autograd's device thread, which does not see
    this thread's plan context, rules and obs session, so it re-enters the
    forward's (an MoE layer on a mesh reads the mesh; the recomputation's
    launches stream their ``PlanEvent``s to the forward's sinks)."""
    if cfg.remat and torch.is_grad_enabled():
        scope = _scope()
        return checkpoint(body, *args, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              _reenter(scope)))
    return body(*args)


def stage_layers(params: Tree, i: int, kind: str) -> list[Tree]:
    """The layers of stage ``i``; an MoE layer's ``moe`` subtree gains its
    logical expert -> storage slot map ``slot_of``, one argsort of the
    stage's (L, E) permutation table for all its layers."""
    stage = params[stage_name(i, kind)]
    lps = layers(stage)
    if kind == "moe":
        slots = moe.expert_slots(stage["moe"]["perm"]).unbind(0)
        lps = [{**lp, "moe": {**lp["moe"], "slot_of": s}}
               for lp, s in zip(lps, slots)]
    return lps


def _scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as the reference makes its scale
    factors arrays of the activation dtype."""
    return float(torch.tensor(value, dtype=dtype))


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _apply_block(kind: str, p: Tree, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, h0: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One layer: dense, moe, a recurrent block (mamba, mlstm, slstm), or
    the shared attention block (whose input projection takes ``concat([x,
    h0])``), its FSDP-cut weights gathered first (``blocks.gather_params``).
    Returns ``(x, aux)``: aux the MoE layer's load-balance loss, ``None``
    for the other kinds."""
    p = blocks.gather_params(p, block_defs(cfg, kind))
    rs = _scalar(cfg.residual_scale, x.dtype)
    if kind in _RECURRENT:
        h = blocks.apply_norm(p["ln1"], x, cfg)
        return x + rs * _RECURRENT[kind][2](p[kind], h, cfg), None
    xin = x
    if kind == "shared_attn":
        xin = torch.matmul(torch.cat([x, h0], dim=-1), p["win"])
    h = blocks.apply_norm(p["ln1"], xin, cfg)
    h = blocks.attention(p["attn"], h, cfg, positions=positions)
    x = x + rs * h
    h = blocks.apply_norm(p["ln2"], x, cfg)
    aux = None
    if kind == "moe":
        h, aux = moe.apply_moe(p["moe"], h, cfg)
    else:
        h = blocks.apply_mlp(p["mlp"], h, cfg)
    return x + rs * h, aux


def ported_mesh(cfg: ModelConfig):
    """The ambient mesh of ranks (``None`` outside one); raises where the
    rules cut a parameter axis the port does not run for ``cfg``'s family
    (``rules.require_ported``, ROADMAP A11)."""
    mesh = spmd_lib.spmd_mesh()
    if mesh is not None:
        rules_lib.require_ported(cfg.family, mesh,
                                 recurrent=recurrent_heads(cfg))
    return mesh


def recurrent_heads(cfg: ModelConfig) -> tuple[tuple[int, int], ...]:
    """``(heads, columns)`` of each recurrent block kind ``cfg`` runs: the
    Mamba2's ``d_inner / ssm_head_dim`` heads over ``d_inner``, the
    mLSTM's ``n_heads`` over ``2 d``, the sLSTM's over ``d``."""
    if cfg.family not in ("hybrid", "ssm"):
        return ()
    kinds = {kind for kind, _ in cfg.stages()}
    d_inner = cfg.ssm_expand * cfg.d_model
    return tuple(hw for kind, hw in (
        ("mamba", (d_inner // cfg.ssm_head_dim, d_inner)),
        ("mlstm", (cfg.n_heads, 2 * cfg.d_model)),
        ("slstm", (cfg.n_heads, cfg.d_model))) if kind in kinds)


def vocab_parallel(cfg: ModelConfig):
    """``(mesh, axes)``: the ambient mesh of ranks and the mesh axes the
    vocabulary shards over, or ``(None, ())`` outside a mesh or when the
    vocab stays whole (a model axis of one rank, or a vocab that does not
    divide).  Raises as ``ported_mesh`` does."""
    mesh = ported_mesh(cfg)
    if mesh is None:
        return None, ()
    table = rules_lib.mesh_table(mesh)
    sizes = mesh.axis_sizes
    s = rules_lib.spec("vocab", "embed", rules=table,
                       shape=(cfg.vocab_size, cfg.d_model), axis_sizes=sizes)
    return mesh, rules_lib.dim_axes(s, 2)[0]


def whole_leaf(params: Tree, name: str, cfg: ModelConfig) -> torch.Tensor:
    """``params[name]``, the embedding or the untied head, gathered whole
    over the data ranks under FSDP (``blocks.gather_params``; its vocab
    cut stays this rank's)."""
    d = (embed_def if name == "embed" else head_def)(cfg)
    return blocks.gather_params({name: params[name]}, {name: d})[name]


def embed_tokens(params: Tree, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    emb = whole_leaf(params, "embed", cfg)
    tok = tokens.to(torch.int64)
    mesh, axes = vocab_parallel(cfg)
    if axes:
        rows = emb.shape[0]
        if rows * mesh.axis_size(axes) != cfg.vocab_size:
            raise ValueError(
                f"embed has {rows} rows: not this rank's shard of "
                f"{cfg.vocab_size} over mesh axes {axes}")
        local = tok - mesh.index(axes) * rows
        hit = (local >= 0) & (local < rows)
        x = torch.where(hit[..., None], emb[local.clamp(0, rows - 1)],
                        torch.zeros((), dtype=emb.dtype, device=emb.device))
        x = blocks.SumOverRanks.apply(x, mesh, axes)
    else:
        x = emb[tok]
    return x * _scalar(cfg.embed_scale, cfg.adtype)


def enter_vocab_parallel(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``x``, the head's input; under a vocab-parallel mesh its backward
    sums dx over the vocab ranks (``blocks.SumGradOverRanks``)."""
    return blocks.enter(x, *vocab_parallel(cfg))


def unembed(params: Tree, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits (..., V) fp32, or this rank's vocab shard of them under a
    vocab-parallel mesh."""
    x = enter_vocab_parallel(
        blocks.apply_norm(params["final_norm"], x, cfg), cfg)
    head = (whole_leaf(params, "embed", cfg).T if cfg.tie_embeddings
            else whole_leaf(params, "lm_head", cfg))
    logits = torch.matmul(x, head) * _scalar(cfg.logit_scale, x.dtype)
    logits = logits.to(torch.float32)
    if cfg.logit_softcap:
        cap = cfg.logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits


def forward(params: Tree, tokens: torch.Tensor, cfg: ModelConfig,
            prefix_embeds: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits, aux_loss).  ``prefix_embeds`` (B, P, d), the VLM
    stub's image embeddings, are cast to the activation dtype and run
    before the embedded tokens, at positions 0..P-1 (the text at P..P+S-1);
    their logits are dropped after the head, so the logits are the text's
    (B, S, V)."""
    x = embed_tokens(params, tokens, cfg)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    h0 = x
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (kind, count) in enumerate(cfg.stages()):
        if kind == "shared_attn":
            stage = [(params["shared_attn"], h0)]
        else:
            stage = [(lp, None) for lp in stage_layers(params, i, kind)]
        for lp, h in stage:
            x, a = apply_layer(cfg, _apply_block, kind, lp, x, cfg,
                               positions, h)
            if a is not None:
                aux = aux + a
    logits = unembed(params, x, cfg)
    if prefix_embeds is not None:
        logits = logits[:, prefix_embeds.shape[1]:]
    return logits, aux


def _xent_ref(logits: torch.Tensor, labels: torch.Tensor,
              logical_v: int) -> torch.Tensor:
    """Mean NLL over rows, the plain math the xent kernel fuses (padded
    vocab columns masked by column index, the label logit extracted by an
    index == label reduction)."""
    lf = logits.to(torch.float32)
    viota = torch.arange(lf.shape[-1], device=lf.device)
    if logical_v < lf.shape[-1]:
        lf = lf + torch.where(viota >= logical_v, -1e30, 0.0)
    m = lf.amax(-1, keepdim=True)
    lse = torch.log(torch.exp(lf - m).sum(-1)) + m[..., 0]
    label_logit = torch.where(viota == labels[..., None], lf, 0.0).sum(-1)
    return (lse - label_logit).mean()


class XentFn(torch.autograd.Function):
    """Cross-entropy through the registered kernel, differentiable: the
    forward is ``dispatch.launch("xent")`` (B11 on the card, whose output
    carries no autograd history; under a mesh the vocab-parallel shard body
    with B12), the backward ``kernels.xent.ops.xent_grad`` -- the
    counterpart of the reference's ``_xent_fused`` ``custom_vjp``.  Labels
    get no gradient.  The backward may run on autograd's device thread, so
    it re-enters the forward's plan context, rules (the mesh among them)
    and obs session explicitly.

    With ``mask`` (T,) fp32 (a mesh's masked loss, ``lm_loss``) the forward
    is the same launch weighted by the mask: the shard body returns the
    global ``(sum of nll * mask, sum of mask)``, the loss is their quotient
    (the denominator at least 1), and the backward's row cotangent is
    ``mask_t / max(sum of mask, 1)``."""

    @staticmethod
    def forward(ctx, logits, labels, logical_v, global_shapes=None,
                mask=None):
        ctx.save_for_backward(logits, labels)
        ctx.logical_v, ctx.global_shapes = logical_v, global_shapes
        ctx.scope = _scope()
        if mask is None:
            ctx.weights = None
            return dispatch.launch("xent", logits, labels,
                                   logical_v=logical_v,
                                   global_shapes=global_shapes)
        num, den = dispatch.launch("xent", logits, labels,
                                   logical_v=logical_v,
                                   global_shapes=global_shapes, mask=mask)
        den = torch.clamp(den, min=1.0)
        ctx.weights = mask / den
        return num / den

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.xent import ops as xent_ops

        logits, labels = ctx.saved_tensors
        with _reenter(ctx.scope):
            grad = xent_ops.xent_grad(logits, labels, g,
                                      logical_v=ctx.logical_v,
                                      global_shapes=ctx.global_shapes,
                                      weights=ctx.weights)
        return grad, None, None, None, None


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy of (..., V) fp32 logits against integer labels.

    Unmasked, the (T, V) rows go through ``XentFn`` (the registered
    ``xent`` kernel forward, ``xent_grad`` backward), as the reference
    launches its Pallas kernel; under a mesh the logits are this rank's
    vocab shard of ``cfg.vocab_size`` columns, and the loss the global
    mean.  Masked on one device, the plain math, as the reference's
    masked loss is.  Masked on a mesh, the same launch as unmasked,
    weighted: each token's NLL from the vocab ranks' partials (B12 and the
    combine), ``-(sum of ll * mask) / max(sum of mask, 1)`` over the
    global tokens, the batch's mesh axes summed (``XentFn``'s ``mask``).
    Padded vocab columns (``cfg.vocab_logical``) are masked by index."""
    v = logits.shape[-1]
    logical = getattr(cfg, "vocab_logical", 0) or cfg.vocab_size
    on_mesh = spmd_lib.spmd_mesh() is not None
    shapes = ((None, cfg.vocab_size), (None,)) if on_mesh else None
    if mask is None or on_mesh:
        return XentFn.apply(
            logits.reshape(-1, v), labels.reshape(-1).to(torch.int32),
            logical, shapes,
            None if mask is None else mask.reshape(-1).to(torch.float32))
    lf = logits.to(torch.float32)
    viota = torch.arange(v, device=lf.device)
    if logical < v:
        lf = lf + torch.where(viota >= logical, -1e30, 0.0)
    m = lf.amax(-1, keepdim=True)
    lse = torch.log(torch.exp(lf - m).sum(-1)) + m[..., 0]
    label_logit = torch.where(viota == labels[..., None], lf, 0.0).sum(-1)
    ll = label_logit - lse
    maskf = mask.to(torch.float32)
    return -(ll * maskf).sum() / torch.clamp(maskf.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> Tree:
    """Cache tree matching cfg.stages() -- a KV cache for each attention
    stage (one for each shared-block application), the per-slot state of
    each recurrent stage (Mamba2 conv and SSM, mLSTM, sLSTM) -- plus
    per-slot write indices (continuous batching: each request sits at its
    own depth)."""
    tree: Tree = {"idx": ParamDef((batch,), ("batch",), init="zeros",
                                  dtype=torch.int32)}
    for i, (kind, count) in enumerate(cfg.stages()):
        tree[stage_name(i, kind)] = (
            _RECURRENT[kind][1](cfg, batch, count) if kind in _RECURRENT
            else blocks.init_kv_cache(cfg, batch, max_len, count))
    return tree


def paged_cache_defs(cfg: ModelConfig, batch: int, max_len: int,
                     n_pages: int, page_len: int) -> Tree:
    """Paged serving cache (serving.paged_cache): each attention stage (each
    shared-block application) has a physical page pool; the recurrent state
    (Mamba2, mLSTM, sLSTM) stays per slot, never paged, so an ssm config
    has no pool at all.  Extra leaves beside ``idx``:
    ``pages``, the (batch, max_pages) int32 page table (0 = null page), and
    ``act``, the (batch,) row-active mask the paged write and the state
    writes consult."""
    max_pages = -(-max_len // page_len)
    tree: Tree = {
        "idx": ParamDef((batch,), ("batch",), init="zeros", dtype=torch.int32),
        "act": ParamDef((batch,), ("batch",), init="ones", dtype=torch.int32),
        "pages": ParamDef((batch, max_pages), ("batch", None), init="zeros",
                          dtype=torch.int32),
    }
    for i, (kind, count) in enumerate(cfg.stages()):
        tree[stage_name(i, kind)] = (
            _RECURRENT[kind][1](cfg, batch, count) if kind in _RECURRENT
            else blocks.paged_kv_pool_defs(cfg, n_pages, page_len, count))
    return tree


def _decode_block(kind: str, p: Tree, cache: Tree, x: torch.Tensor,
                  idx: torch.Tensor, cfg: ModelConfig,
                  pages: torch.Tensor | None = None,
                  act: torch.Tensor | None = None,
                  h0: torch.Tensor | None = None):
    """One layer against its cache (that layer's slices, written in
    place): the KV of a dense, moe or shared attention layer, the state of
    a recurrent layer, its FSDP-cut weights gathered first, as
    ``_apply_block`` gathers them.  An MoE layer routes all B rows, frozen
    ones included, as the reference's does."""
    p = blocks.gather_params(p, block_defs(cfg, kind))
    rs = _scalar(cfg.residual_scale, x.dtype)
    if kind in _RECURRENT:
        h = blocks.apply_norm(p["ln1"], x, cfg)
        h, nc = _RECURRENT[kind][3](p[kind], cache, h, cfg, act)
        return x + rs * h, nc
    xin = x
    if kind == "shared_attn":
        xin = torch.matmul(torch.cat([x, h0], dim=-1), p["win"])
    h = blocks.apply_norm(p["ln1"], xin, cfg)
    if pages is not None:
        h, ck, cv = blocks.paged_decode_attention(
            p["attn"], h, cache["k"], cache["v"], pages, idx, act, cfg)
    else:
        h, ck, cv = blocks.decode_attention(
            p["attn"], h, cache["k"], cache["v"], idx, cfg, act=act)
    x = x + rs * h
    h = blocks.apply_norm(p["ln2"], x, cfg)
    if kind == "moe":
        h, _ = moe.apply_moe(p["moe"], h, cfg, with_aux=False)
    else:
        h = blocks.apply_mlp(p["mlp"], h, cfg)
    return x + rs * h, {"k": ck, "v": cv}


def decode_step(params: Tree, cache: Tree, tokens: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, Tree]:
    """One-token decode. tokens: (B, 1). Returns (logits, cache) with the
    KV and the recurrent state written in place and ``idx`` advanced.

    A cache built by ``paged_cache_defs`` (a ``pages`` leaf) routes the
    attention through the page table.  An ``act`` leaf masks the writes of
    inactive rows on either backend (the chunk step sets one on a dense
    cache for the length of the step).

    On a mesh of ranks the cache is this rank's block of it
    (``parallel.specs.cache_specs``: its rows of the slots, its KV heads
    and recurrent heads and columns; a paged pool its KV heads of every
    page), the tokens its rows, and the logits its vocab shard; the layers
    run tensor-parallel and gather their FSDP-cut weights as in training.
    The rules are checked before any collective (``ported_mesh``,
    ``blocks.decode_parallel``)."""
    ported_mesh(cfg)
    if any(kind not in _RECURRENT for kind, _ in cfg.stages()):
        blocks.decode_parallel(cfg)
    idx = cache["idx"]
    pages = cache.get("pages")
    act = cache.get("act")
    x = embed_tokens(params, tokens, cfg)
    h0 = x
    new_cache: Tree = {"idx": idx + 1}
    for key in ("pages", "act"):
        if key in cache:
            new_cache[key] = cache[key]
    for i, (kind, count) in enumerate(cfg.stages()):
        nm = stage_name(i, kind)
        lps = ([params["shared_attn"]] if kind == "shared_attn"
               else stage_layers(params, i, kind))
        for lp, lc in zip(lps, layers(cache[nm])):
            x, _ = _decode_block(kind, lp, lc, x, idx, cfg, pages, act, h0)
        new_cache[nm] = cache[nm]
    return unembed(params, x, cfg), new_cache


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------


class LM(torch.nn.Module):
    """The decoder-only LM over an explicit parameter tree (a nested dict
    of tensors, as the reference's pytree): ``init`` makes one,
    ``forward(params, tokens)``, ``loss(params, batch)`` and
    ``decode_step(params, cache, tokens)`` run it.  Constructing it for a family the port does not run raises."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        cfg.stages()
        self.cfg = cfg

    def param_defs(self) -> Tree:
        return param_defs(self.cfg)

    def init(self, seed: int = 0, *, device=None, cut=None) -> Tree:
        """Seeded parameters on ``device`` (CUDA unless named), each leaf
        through ``cut(path, leaf)`` as it is drawn when given."""
        return init(self.cfg, seed, device=device, cut=cut)

    def abstract_params(self) -> Tree:
        return abstract_params(self.param_defs())

    def forward(self, params, tokens, prefix_embeds=None):
        return forward(params, tokens, self.cfg, prefix_embeds)

    def loss(self, params, batch) -> torch.Tensor:
        logits, aux = forward(params, batch["tokens"], self.cfg,
                              batch.get("img_embeds"))
        return lm_loss(logits, batch["labels"], self.cfg,
                       batch.get("mask")) + aux

    def cache_defs(self, batch: int, max_len: int) -> Tree:
        return cache_defs(self.cfg, batch, max_len)

    def paged_cache_defs(self, batch: int, max_len: int, n_pages: int,
                         page_len: int) -> Tree:
        return paged_cache_defs(self.cfg, batch, max_len, n_pages, page_len)

    def decode_step(self, params, cache, tokens):
        return decode_step(params, cache, tokens, self.cfg)
