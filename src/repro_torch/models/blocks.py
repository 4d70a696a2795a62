"""Shared transformer building blocks: norms, RoPE, GQA attention, MLP.

Counterpart of ``repro.models.blocks``: plain functions over dicts of
tensors described by ``ParamDef``s.  Softmax and norm statistics are
computed in fp32 whatever the activation dtype.  RMSNorm launches the
registered kernel (``api.launch("rmsnorm")``, the hand-written CUDA kernel
on the card), differentiated by ``RMSNormFn`` under autograd, and so does
the gated norm of the Mamba2 and mLSTM blocks
(``api.launch("rmsnorm.gated")``, ``GatedRMSNormFn``); attention and
the projections are plain PyTorch, as the JAX package leaves them to XLA.

On a mesh of ranks the attention and the MLP are tensor-parallel where
the rules cut "heads" and "mlp" (Megatron's layout; the reference's
``parallel.rules.shard`` annotations leave the same cut to GSPMD): the
query, key and value projections and the MLP's ``wi``/``wg`` are
column-parallel, each rank multiplying by its heads' or columns' slice,
and the attention's ``wo`` and the MLP's ``wo`` row-parallel, each rank's
partial product summed over the ranks.  The activations between the
layers stay whole on every rank.  Two autograd functions carry it:
``SumGradOverRanks`` (Megatron's *f*) where a tensor whole on every rank
enters a rank's own part of the work, ``SumOverRanks`` (*g*) where the
ranks' parts are summed.  Outside a mesh, or where an axis maps to no
mesh axis of more than one rank, the same code runs whole.  Under FSDP
(the rules cut "embed" over "data") a layer gathers its weights whole
first (``gather_params``, ``GatherOverRanks``: an all-gather forward, a
reduce-scatter backward) and then runs as above.

Two decisions of the port, for its bit-exact serving contracts:

  * **The KV caches are written in place.**  ``_cache_put`` and
    ``_paged_put`` write the new position into the cache tensor they are
    given (the reference returns a new array), so a decode step moves one
    position per row and layer instead of copying the cache.  A row whose
    ``act`` is 0 writes back what it found (dense) or writes into the null
    page (paged), so a frozen row's state is bit-identical to not having
    stepped -- what the reference gets by restoring after the step.
  * **One layout into the attention products.**  Every KV view reaches the
    products as a contiguous (B, KH, S, D) tensor (a no-op for the default
    ``bhsd`` slab, a copy for ``bshd`` and for the page gather), so the
    dense slab, the other layout and the paged pool run the same GEMMs on
    the same bytes and give bit-identical token streams.

Out-of-range dense writes are clamped to the last position, as the
reference's ``dynamic_update_slice`` clamps them (idle slots keep stepping).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.api import dispatch
from repro_torch.api import spmd as spmd_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef
from repro_torch.parallel import rules as rules_lib

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Sums over a mesh's ranks
# ---------------------------------------------------------------------------


class SumOverRanks(torch.autograd.Function):
    """Forward: ``x`` summed over the ranks of a mesh's ``axes``; backward:
    the identity (Megatron's *g*).  The pairing for a sum whose every rank
    goes on to compute the same thing from it: each rank's own part gets
    the whole gradient of the sum, and no rank's gradient is counted twice
    (a row-parallel product's partial sums; the vocab-parallel lookup sums
    its rows over the vocab ranks; an MoE layer sums its router statistics
    over the data ranks)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce(x, axes, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class SumGradOverRanks(torch.autograd.Function):
    """Forward: the identity; backward: the gradient summed over the ranks
    of a mesh's ``axes`` (Megatron's *f*, the pair of ``SumOverRanks``).
    Where a tensor whole on every rank enters work each rank does on its
    own part -- a column-parallel product, the vocab-parallel head, a
    parameter the rank's heads or experts use --, each rank's backward
    gives its part of the gradient, and the sum gives every rank the
    whole."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous(), ctx.axes, "sum"), None, None


class GatherOverRanks(torch.autograd.Function):
    """Forward: each of a rank's ``blocks`` (one dtype) gathered whole over
    the ranks of a mesh's ``axes`` along its dim of ``dims``, in one
    all-gather of the blocks flattened into one buffer (FSDP's flat
    parameter); backward: each gradient summed over the same ranks and cut
    back to this rank's block, in one reduce-scatter of the gradients laid
    out the same way.  The port's counterpart of the collectives GSPMD
    inserts for the reference where the rules cut "embed" over "data":
    each rank's backward gives the gradient through its own rows of the
    batch, so the sum is the data-axis sum ``parallel.steps`` takes for the
    leaves no rule cuts, and such a leaf's gradient needs no other."""

    @staticmethod
    def forward(ctx, mesh, axes, dims, *blocks):
        n = mesh.axis_size(axes)
        ctx.mesh, ctx.axes, ctx.dims, ctx.n = mesh, axes, dims, n
        ctx.shapes = [tuple(b.shape) for b in blocks]
        flat = torch.cat([b.reshape(-1) for b in blocks])
        rows = mesh.all_gather(flat, axes, 0).view(n, -1)
        out, off = [], 0
        for b, d in zip(blocks, dims):
            part = rows[:, off:off + b.numel()].reshape(n, *b.shape)
            off += b.numel()
            shape = list(b.shape)
            shape[d] *= n
            out.append(part.movedim(0, d).reshape(shape))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        # an output the loss does not reach has a zero gradient here
        # (autograd materialises it)
        n, parts = ctx.n, []
        for g, shape, d in zip(grads, ctx.shapes, ctx.dims):
            g = g.reshape(*shape[:d], n, shape[d], *shape[d + 1:])
            parts.append(g.movedim(d, 0).reshape(n, -1))
        flat = torch.cat(parts, dim=1).reshape(-1)
        mine = ctx.mesh.reduce_scatter(flat, ctx.axes, 0)
        sizes = [math.prod(shape) for shape in ctx.shapes]
        out = [t.view(shape).clone() for t, shape in
               zip(torch.split(mine, sizes), ctx.shapes)]
        return (None, None, None, *out)


def gather_params(p: dict, defs: dict) -> dict:
    """``p``, a rank's blocks of the parameters ``defs`` declares (a
    subtree of ``ParamDef``s; a leaf ``defs`` lacks passes through), with
    every leaf the ambient rules cut over the batch's mesh axes (FSDP's
    "embed") gathered whole over them by ``GatherOverRanks``, one
    all-gather a dtype.  A leaf's other cuts (tensor parallelism) stay
    this rank's.  Outside a mesh, or without FSDP, ``p`` itself.  A layer
    calls it first thing in its body, inside ``transformer.apply_layer``'s
    checkpoint, so the recomputation gathers again and no layer's whole
    weights outlive its forward (ZeRO-3)."""
    mesh = spmd_lib.spmd_mesh()
    if mesh is None:
        return p
    table = rules_lib.mesh_table(mesh)
    data = {a for a in rules_lib.mesh_axes("embed", mesh, table)
            if mesh.axis_size(a) > 1}
    if not data:
        return p
    groups: dict[tuple, list] = {}

    def walk(tree, dtree, path):
        for k, v in tree.items():
            d = dtree.get(k) if isinstance(dtree, dict) else None
            if isinstance(v, dict):
                walk(v, d, path + (k,))
            elif isinstance(d, ParamDef):
                s = rules_lib.spec(*d.axes, rules=table, shape=d.shape,
                                   axis_sizes=mesh.axis_sizes)
                for dim, axes in enumerate(rules_lib.dim_axes(s, v.ndim)):
                    if not set(axes) & data:
                        continue
                    n = mesh.axis_size(axes)
                    if v.shape[dim] * n != d.shape[dim]:
                        raise ValueError(
                            f"{'/'.join(path + (k,))} has {tuple(v.shape)}: "
                            f"not this rank's block of {d.shape} under "
                            f"spec {s}")
                    groups.setdefault((axes, v.dtype), []).append(
                        (path + (k,), v, dim))

    walk(p, defs, ())
    whole = {}
    for (axes, _), items in groups.items():
        got = GatherOverRanks.apply(mesh, axes, tuple(d for *_, d in items),
                                    *(v for _, v, _ in items))
        whole.update(zip((path for path, *_ in items), got))

    def rebuild(tree, path):
        return {k: rebuild(v, path + (k,)) if isinstance(v, dict)
                else whole.get(path + (k,), v) for k, v in tree.items()}

    return rebuild(p, ()) if whole else p


def row_parallel(y: torch.Tensor, w: torch.Tensor, tp=(None, ())
                 ) -> torch.Tensor:
    """``y @ w`` in y's dtype; under tensor parallelism ``tp`` (``(mesh,
    axes)``, y and w a rank's columns and rows) row-parallel (Megatron's
    g) with each rank's partial product in fp32 (or wider), summed over
    the ranks at that width and rounded once, as one device rounds the
    whole product once.  The recurrent blocks' down projections take it: a
    bf16 partial rounded before the sum (``_out_proj``'s rule) moves each
    value by up to one more half ulp, which their recurrences amplify (a
    (1, 2) xlstm-1.3b's step-0 loss 2.5e-4 from one device's on an NVIDIA
    H100 80GB HBM3, against Qwen2-0.5B's 1.3e-5), at twice the bytes
    through the sum."""
    mesh, axes = tp
    if not axes:
        return torch.matmul(y, w)
    acc = torch.promote_types(y.dtype, torch.float32)
    part = torch.matmul(y.to(acc), w.to(acc))
    return leave(part, mesh, axes).to(y.dtype)


def model_parallel(name: str, size: int):
    """``(mesh, axes)``: the ambient mesh of ranks and the mesh axes over
    which the rules cut the logical axis ``name`` of global ``size`` -- the
    cut ``parallel.specs.param_specs`` gives a parameter's dim, a dim that
    does not divide staying whole --, or ``(None, ())`` outside a mesh or
    where it stays whole on every rank."""
    mesh = spmd_lib.spmd_mesh()
    if mesh is None:
        return None, ()
    s = rules_lib.spec(name, rules=rules_lib.mesh_table(mesh), shape=(size,),
                       axis_sizes=mesh.axis_sizes)
    axes = rules_lib.dim_axes(s, 1)[0]
    return (mesh, axes) if mesh.axis_size(axes) > 1 else (None, ())


def enter(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` into the ranks' own parts of the work over ``axes``
    (``SumGradOverRanks``); ``x`` itself for no axes."""
    return SumGradOverRanks.apply(x, mesh, axes) if axes else x


def leave(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The ranks' partial ``x`` summed over ``axes`` (``SumOverRanks``);
    ``x`` itself for no axes."""
    return SumOverRanks.apply(x, mesh, axes) if axes else x


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_defs(cfg: ModelConfig, d: int | None = None) -> dict:
    d = d or cfg.d_model
    out = {"scale": ParamDef((d,), (None,), init="ones", dtype=cfg.adtype)}
    if cfg.norm == "layernorm":
        out["bias"] = ParamDef((d,), (None,), init="zeros", dtype=cfg.adtype)
    return out


def _rms_ref(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.to(torch.float32)).to(x.dtype)


class RMSNormFn(torch.autograd.Function):
    """RMSNorm through the registered kernel, differentiable: the forward
    is ``dispatch.launch("rmsnorm")`` (B9 on the card, whose output carries
    no autograd history), the backward the gradient of the plain math
    ``_rms_ref`` with respect to x and the scale, taken in fp32 and cast to
    each input's dtype -- the counterpart of the reference's ``_rms_fused``
    ``custom_vjp``."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return dispatch.launch("rmsnorm", x, scale, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            ss = scale.detach().requires_grad_(True)
            gx, gs = torch.autograd.grad(_rms_ref(xx, ss, ctx.eps), (xx, ss),
                                         g)
        return gx, gs, None


def apply_norm(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm through the registered kernel (the port is single-device,
    where the reference always launches it too): through ``RMSNormFn`` when
    autograd records (grad mode on and an input requires grad), straight
    through ``dispatch.launch`` otherwise, so serving pays no autograd
    cost.  LayerNorm stays plain."""
    if cfg.norm == "layernorm":
        xf = x.to(torch.float32)
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
        return y.to(x.dtype)
    return rms_norm(x, p["scale"], cfg.norm_eps)


def _records(*tensors) -> bool:
    """True when autograd records an op on ``tensors``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             tp=(None, ())) -> torch.Tensor:
    """RMSNorm of x times ``scale`` through the registered kernel, in x's
    dtype: ``RMSNormFn`` when autograd records, ``dispatch.launch`` when
    it does not.  Under tensor parallelism ``tp`` (``(mesh, axes)`` of the
    columns, x and ``scale`` a rank's block of them) the split form,
    ``rms_norm_split``."""
    if tp[1]:
        return rms_norm_split(x, None, scale, eps, tp)
    if _records(x, scale):
        return RMSNormFn.apply(x, scale, eps)
    return dispatch.launch("rmsnorm", x, scale, eps=eps)


def _gated_ref(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
               eps: float) -> torch.Tensor:
    """The gated norm in fp32 throughout: RMSNorm of x * silu(z)."""
    xf, zf = x.to(torch.float32), z.to(torch.float32)
    return _rms_ref(xf * (zf * torch.sigmoid(zf)), scale, eps)


class GatedRMSNormFn(torch.autograd.Function):
    """The gated RMSNorm through the registered kernel, differentiable: the
    forward is ``dispatch.launch("rmsnorm.gated")`` (B10 on the card, whose
    output carries no autograd history), the backward the gradient of the
    plain gated math ``_gated_ref`` with respect to x, the gate z and the
    scale, taken in fp32 and cast to each input's dtype (``RMSNormFn``'s
    rule for B9)."""

    @staticmethod
    def forward(ctx, x, z, scale, eps):
        ctx.save_for_backward(x, z, scale)
        ctx.eps = eps
        return dispatch.launch("rmsnorm.gated", x, z, scale, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, z, scale = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().to(torch.float32).requires_grad_(True)
                   for t in (x, z, scale)]
            grads = torch.autograd.grad(_gated_ref(*ins, ctx.eps), ins,
                                        g.to(torch.float32))
        return (*(d.to(t.dtype) for d, t in zip(grads, (x, z, scale))),
                None)


def apply_gated_norm(scale: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                     cfg: ModelConfig, tp=(None, ())) -> torch.Tensor:
    """RMSNorm of y * silu(z) times ``scale`` (the Mamba2 and mLSTM gate
    and norm) through the registered kernel: ``GatedRMSNormFn`` when
    autograd records, ``dispatch.launch("rmsnorm.gated")`` otherwise, as
    ``rms_norm`` does for the plain norm; under tensor parallelism ``tp``
    the split form, ``rms_norm_split``."""
    if tp[1]:
        return rms_norm_split(y, z, scale, cfg.norm_eps, tp)
    if _records(y, z, scale):
        return GatedRMSNormFn.apply(y, z, scale, cfg.norm_eps)
    return dispatch.launch("rmsnorm.gated", y, z, scale, eps=cfg.norm_eps)


def _gate_f32(x: torch.Tensor, z: torch.Tensor | None) -> torch.Tensor:
    """x (or x * silu(z)) in fp32, the plain math of the split passes'
    backward."""
    xf = x.to(torch.float32)
    if z is None:
        return xf
    zf = z.to(torch.float32)
    return xf * (zf * torch.sigmoid(zf))


def _f32_grads(fn, tensors, g):
    """The gradient of ``fn`` of the fp32 copies of ``tensors`` (``None``
    entries skipped) against ``g``, each cast to its tensor's dtype."""
    with torch.enable_grad():
        ins = [None if t is None else
               t.detach().to(torch.float32).requires_grad_(True)
               for t in tensors]
        live = [t for t in ins if t is not None]
        got = iter(torch.autograd.grad(fn(*ins), live, g.to(torch.float32)))
    return tuple(None if t is None else next(got).to(t.dtype)
                 for t in tensors)


class SumSquaresFn(torch.autograd.Function):
    """The split norm's statistic, differentiable: each row's fp32 sum of
    squares of x (or of x * silu(z)) over a rank's columns.  The forward is
    ``dispatch.launch("rmsnorm.sumsq")`` (``"rmsnorm.gated.sumsq"``), the
    stats pass of B9 (B10) on the card, whose output carries no autograd
    history; the backward the gradient of the plain fp32 math, as
    ``RMSNormFn`` and ``GatedRMSNormFn`` take theirs."""

    @staticmethod
    def forward(ctx, x, z):
        ctx.save_for_backward(x, z)
        if z is None:
            return dispatch.launch("rmsnorm.sumsq", x)
        return dispatch.launch("rmsnorm.gated.sumsq", x, z)

    @staticmethod
    def backward(ctx, g):
        def sumsq(x, z):
            h = _gate_f32(x, z)
            return (h * h).sum(-1)

        return _f32_grads(sumsq, ctx.saved_tensors, g)


class ApplyNormFn(torch.autograd.Function):
    """The split norm's apply pass, differentiable: a rank's columns of x
    (or of x * silu(z)) times ``rsqrt(ss / d_total + eps) * scale``.  The
    forward is ``dispatch.launch("rmsnorm.apply")``
    (``"rmsnorm.gated.apply"``), the apply pass of B9 (B10) on the card;
    the backward the gradient of the plain fp32 math with respect to x, z,
    the scale and the statistic."""

    @staticmethod
    def forward(ctx, x, z, scale, ss, d_total, eps):
        ctx.save_for_backward(x, z, scale, ss)
        ctx.d_total, ctx.eps = d_total, eps
        if z is None:
            return dispatch.launch("rmsnorm.apply", x, scale, ss,
                                   d_total=d_total, eps=eps)
        return dispatch.launch("rmsnorm.gated.apply", x, z, scale, ss,
                               d_total=d_total, eps=eps)

    @staticmethod
    def backward(ctx, g):
        def apply(x, z, scale, ss):
            inv = torch.rsqrt(ss[..., None] / ctx.d_total + ctx.eps)
            return _gate_f32(x, z) * inv * scale

        return (*_f32_grads(apply, ctx.saved_tensors, g), None, None)


def rms_norm_split(x: torch.Tensor, z: torch.Tensor | None,
                   scale: torch.Tensor, eps: float, tp) -> torch.Tensor:
    """RMSNorm (gated when ``z`` is given) of rows whose columns are cut
    over the ranks of ``tp`` (``(mesh, axes)``): x, z and ``scale`` are a
    rank's block.  Each rank's sum of squares over its columns (the stats
    pass) is summed over the ranks, then each rank normalises its columns
    by the sum and the whole row's width (the apply pass).

    The sum is ``enter(leave(ss))``: a sum forward and a sum backward.
    Each rank normalises only its own columns with the summed statistic,
    so the statistic's gradient is a different partial sum on each rank
    (its share of ``sum dy * g * scale``); ``leave`` alone, whose backward
    is the identity, would give each rank only its own share, and the
    gradient of x would miss the other ranks' columns' term."""
    mesh, axes = tp
    if _records(x, z, scale):
        ss = SumSquaresFn.apply(x, z)
    elif z is None:
        ss = dispatch.launch("rmsnorm.sumsq", x)
    else:
        ss = dispatch.launch("rmsnorm.gated.sumsq", x, z)
    ss = enter(leave(ss, mesh, axes), mesh, axes)
    d_total = x.shape[-1] * mesh.axis_size(axes)
    if _records(x, z, scale, ss):
        return ApplyNormFn.apply(x, z, scale, ss, d_total, eps)
    if z is None:
        return dispatch.launch("rmsnorm.apply", x, scale, ss,
                               d_total=d_total, eps=eps)
    return dispatch.launch("rmsnorm.gated.apply", x, z, scale, ss,
                           d_total=d_total, eps=eps)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Per-head RMSNorm over the last (head_dim) axis (qwen3 qk_norm)."""
    xf = x.to(torch.float32)
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Llama-style rotary embedding. x: (..., S, H, D), positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    f32 = dict(dtype=torch.float32, device=x.device)
    # theta as a device fill, not a host tensor: a host-to-device copy
    # would synchronise the stream at every layer
    freqs = torch.exp(-torch.log(torch.full((), theta, **f32))
                      * torch.arange(0, half, **f32) / half)
    ang = positions[..., None].to(torch.float32) * freqs     # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional qk-norm / bias / softcap / cross)
# ---------------------------------------------------------------------------


def attention_defs(cfg: ModelConfig) -> dict:
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.adtype
    defs = {
        # true fan-ins, where the reference takes shape[-2] (ROADMAP §C)
        "wq": ParamDef((d, h, hd), ("embed", "heads", "head_dim"), dtype=dt,
                       fan_in_axes=("embed",)),
        "wk": ParamDef((d, kh, hd), ("embed", "kv_heads", "head_dim"),
                       dtype=dt, fan_in_axes=("embed",)),
        "wv": ParamDef((d, kh, hd), ("embed", "kv_heads", "head_dim"),
                       dtype=dt, fan_in_axes=("embed",)),
        "wo": ParamDef((h, hd, d), ("heads", "head_dim", "embed"), dtype=dt,
                       fan_in_axes=("heads", "head_dim")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h, hd), ("heads", "head_dim"), init="zeros", dtype=dt)
        for name in ("bk", "bv"):
            defs[name] = ParamDef((kh, hd), ("kv_heads", "head_dim"),
                                  init="zeros", dtype=dt)
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), (None,), init="ones", dtype=dt)
        defs["k_norm"] = ParamDef((hd,), (None,), init="ones", dtype=dt)
    return defs


def _rank_heads(p: dict, cfg: ModelConfig, mesh, axes):
    """A rank's attention parameters where the query heads shard over mesh
    ``axes``: ``(p, kv_of_q)``.  The query heads' leaves (``wq``, ``bq``,
    ``wo``) are the rank's already.  The KV heads shard with them, or,
    where their count does not divide (``rules.spec_report``'s fallback),
    are whole on every rank: then a rank's query heads read the KV heads
    they belong to globally (query head ``j`` reads ``j // (H / KH)``), a
    block ``[lo, hi)`` of them, and ``kv_of_q`` maps each local query head
    to its place in the block where the groups are not equal (else
    ``None``, the block's own ratio).  The leaves whole on every rank that
    a rank uses only in part (the KV heads in the fallback, the qk-norm
    scales) enter through ``SumGradOverRanks``, so their gradient is the
    ranks' parts summed."""
    out = dict(p)
    for name in ("q_norm", "k_norm"):
        if name in p:
            out[name] = enter(p[name], mesh, axes)
    if model_parallel("kv_heads", cfg.n_kv_heads)[1]:
        return out, None
    h_loc = cfg.n_heads // mesh.axis_size(axes)
    lo, hi, kv_of_q = _kv_block(cfg, mesh.index(axes) * h_loc, h_loc)
    for name in ("wk", "wv", "bk", "bv"):
        if name in p:
            t = enter(p[name], mesh, axes)
            out[name] = t[:, lo:hi] if t.ndim == 3 else t[lo:hi]
    return out, kv_of_q


def _kv_block(cfg: ModelConfig, q0: int, hq: int, k0: int = 0):
    """``(lo, hi, kv_of_q)``: the block ``[lo, hi)`` of KV heads, counted
    from global KV head ``k0``, that ``hq`` query heads from global query
    head ``q0`` on read (query head ``j`` reads ``j // (H / KH)``), and
    each query head's place in the block where its heads do not each hold
    an equal run of them (else ``None``, the block's own ratio)."""
    group = cfg.n_heads // cfg.n_kv_heads
    kv = [(q0 + j) // group - k0 for j in range(hq)]
    lo, hi = kv[0], kv[-1] + 1
    run = hq // (hi - lo)
    equal = run * (hi - lo) == hq and kv == [lo + j // run
                                             for j in range(hq)]
    return lo, hi, None if equal else [i - lo for i in kv]


def _project_qkv(p: dict, x: torch.Tensor, x_kv: torch.Tensor,
                 cfg: ModelConfig, tp=(None, ())):
    """q, k, v of (B, S, d) rows, (B, S, H, D) each: under tensor
    parallelism ``tp`` (``(mesh, axes)`` of the heads) the rank's heads, the
    inputs entering through ``SumGradOverRanks`` (column-parallel)."""
    mesh, axes = tp
    kv_of_q = None
    if axes:
        p, kv_of_q = _rank_heads(p, cfg, mesh, axes)
        same = x_kv is x
        x = enter(x, mesh, axes)
        x_kv = x if same else enter(x_kv, mesh, axes)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x_kv, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x_kv, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    if kv_of_q is not None:         # one KV head a query head
        k, v = k[:, :, kv_of_q], v[:, :, kv_of_q]
    return q, k, v


def _heads_major(kv: torch.Tensor) -> torch.Tensor:
    """(B, S, KH, D) -> contiguous (B, KH, S, D), the one layout the
    attention products take (a view of a ``bhsd`` slab needs no copy)."""
    return kv.transpose(1, 2).contiguous()


def _gqa_scores(q: torch.Tensor, k: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """q: (B,Sq,H,D), k: (B,Sk,KH,D) -> scores (B,KH,G,Sq,Sk) in fp32."""
    b, sq, h, dhd = q.shape
    kh = k.shape[2]
    g = h // kh
    qg = q.reshape(b, sq, kh, g, dhd).permute(0, 2, 3, 1, 4)
    qg = qg.reshape(b, kh, g * sq, dhd)
    scores = torch.matmul(qg, _heads_major(k).transpose(-1, -2))
    scores = scores.reshape(b, kh, g, sq, -1).to(torch.float32)
    scores = scores / math.sqrt(dhd)
    if cfg.attn_softcap:
        cap = cfg.attn_softcap
        scores = cap * torch.tanh(scores / cap)
    return scores


def _out_proj(ctx: torch.Tensor, wo: torch.Tensor,
              tp=(None, ())) -> torch.Tensor:
    """(B, Sq, H, D) context times ``wo`` (H, D, d): under tensor
    parallelism ``tp`` the rank's heads' rows of ``wo`` and the partial
    products summed over the ranks (row-parallel).  No bias follows ``wo``.
    Unlike ``row_parallel``, the partials and their sum stay in the
    activation dtype: in bf16 each rank's GEMM rounds its product once and
    the sum rounds once more, where one device rounds the whole product
    once, so a value may move by one more half ulp, which the attention
    and the MLP (``apply_mlp`` takes the same rule) do not amplify as the
    recurrences do.  ``row_parallel``'s fp32 partials here cost a
    tensor-parallel step the collectives' doubled bytes and fp32 GEMMs
    (``scripts/row_parallel_cost.py``)."""
    return leave(torch.einsum("bqhd,hdm->bqm", ctx, wo), *tp)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor, p: dict,
             dtype: torch.dtype, tp=(None, ())) -> torch.Tensor:
    """probs: (B,KH,G,Sq,Sk), v: (B,Sk,KH,D) -> (B,Sq,d_model)."""
    b, kh, g, sq, sk = probs.shape
    ctx = torch.matmul(probs.to(v.dtype).reshape(b, kh, g * sq, sk),
                       _heads_major(v))                      # (B,KH,G*Sq,D)
    dhd = ctx.shape[-1]
    ctx = ctx.reshape(b, kh, g, sq, dhd).permute(0, 3, 1, 2, 4)
    ctx = ctx.reshape(b, sq, kh * g, dhd)
    return _out_proj(ctx, p["wo"], tp).to(dtype)


ATTN_BLOCK = 512  # KV tile length for the chunked (online-softmax) path


def _chunked_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cfg: ModelConfig, q_pos: torch.Tensor, kv_pos: torch.Tensor,
                 causal: bool, block: int = ATTN_BLOCK) -> torch.Tensor:
    """Flash-style attention: a loop over KV tiles with running (m, l, acc).

    Never materializes (Sq, Sk) scores; the working set is one
    (B, KH, G, Sq, block) tile (the reference's ``lax.scan`` body)."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    sk = k.shape[1]
    pad = (-sk) % block
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
    nk = (sk + pad) // block
    qg = q.reshape(b, sq, kh, g, d).permute(0, 2, 3, 1, 4).to(torch.float32)
    qg = qg / math.sqrt(d)
    kb = k.reshape(b, nk, block, kh, d).permute(1, 0, 3, 2, 4)  # (nk,B,KH,L,D)
    vb = v.reshape(b, nk, block, kh, d).permute(1, 0, 3, 2, 4)
    pb = kv_pos.reshape(b, nk, block).permute(1, 0, 2)          # (nk,B,L)
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((b, kh, g, sq), NEG_INF, **f32)
    l = torch.zeros((b, kh, g, sq), **f32)
    acc = torch.zeros((b, kh, g, sq, d), **f32)
    for i in range(nk):
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kb[i].to(torch.float32))
        if cfg.attn_softcap:
            cap = cfg.attn_softcap
            s = cap * torch.tanh(s / cap)
        pt = pb[i]
        valid = (pt >= 0)[:, None, None, None, :]
        if causal:
            valid = valid & (q_pos[:, None, None, :, None]
                             >= pt[:, None, None, None, :])
        s = torch.where(valid, s, NEG_INF)
        mn = torch.maximum(m, s.amax(-1))
        pmat = torch.where(s <= -1e29, 0.0, torch.exp(s - mn[..., None]))
        alpha = torch.exp(m - mn)
        l = l * alpha + pmat.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", pmat, vb[i].to(torch.float32))
        m = mn
    out = acc / torch.clamp(l, min=1e-9)[..., None]              # (B,KH,G,Sq,D)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)


def attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, causal: bool = True,
              x_kv: torch.Tensor | None = None,
              kv_positions: torch.Tensor | None = None,
              use_rope: bool = True) -> torch.Tensor:
    """Full-sequence attention (prefill / encoder / cross); on a mesh
    whose rules cut the heads, tensor-parallel: the rank's heads, the
    output summed over the ranks."""
    cross = x_kv is not None
    x_kv = x if x_kv is None else x_kv
    kv_positions = positions if kv_positions is None else kv_positions
    tp = model_parallel("heads", cfg.n_heads)
    q, k, v = _project_qkv(p, x, x_kv, cfg, tp)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, kv_positions, cfg.rope_theta)
    if k.shape[1] > ATTN_BLOCK:  # chunked path: anything beyond one tile
        ctx = _chunked_gqa(q, k, v, cfg, positions, kv_positions,
                           causal and not cross)
        return _out_proj(ctx.to(x.dtype), p["wo"], tp)
    scores = _gqa_scores(q, k, cfg)
    if causal and not cross:
        mask = positions[:, None, :, None] >= kv_positions[:, None, None, :]
        scores = torch.where(mask[:, :, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(probs, v, p, x.dtype, tp)


# ---- decode with KV cache -------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n: int) -> dict:
    """Stacked (n-layer) KV cache in the configured layout."""
    kh, hd = cfg.n_kv_heads, cfg.hd
    if cfg.kv_cache_layout == "bhsd":
        shape = (n, batch, kh, max_len, hd)
        axes = ("layers", "batch", "kv_heads", "cache_seq", None)
    else:  # bshd
        shape = (n, batch, max_len, kh, hd)
        axes = ("layers", "batch", "cache_seq", "kv_heads", None)
    return {
        "k": ParamDef(shape, axes, init="zeros", dtype=cfg.adtype),
        "v": ParamDef(shape, axes, init="zeros", dtype=cfg.adtype),
    }


def _rows_idx(idx: torch.Tensor, b: int) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.int64).expand(b)


def _cache_put(cache_kv: torch.Tensor, new: torch.Tensor, idx: torch.Tensor,
               layout: str, act: torch.Tensor | None = None) -> torch.Tensor:
    """Write (B, 1, KH, D) into one layer's cache at per-row position
    ``idx`` (B,), in place; returns the cache.  ``act`` (B,) masks rows: an
    inactive row writes back what the cache held there."""
    b = new.shape[0]
    seq = cache_kv.shape[2] if layout == "bhsd" else cache_kv.shape[1]
    pos = _rows_idx(idx, b).clamp(0, seq - 1)
    rows = torch.arange(b, device=cache_kv.device)
    val = new[:, 0]                                       # (B, KH, D)
    if layout == "bhsd":
        if act is not None:
            val = torch.where(act[:, None, None] > 0, val, cache_kv[rows, :, pos])
        cache_kv[rows, :, pos] = val
    else:
        if act is not None:
            val = torch.where(act[:, None, None] > 0, val, cache_kv[rows, pos])
        cache_kv[rows, pos] = val
    return cache_kv


def _cache_kv_view(cache_kv: torch.Tensor, layout: str) -> torch.Tensor:
    """Return the (B, S, KH, D) view of one layer's cache."""
    if layout == "bhsd":
        return cache_kv.transpose(1, 2)
    return cache_kv


def cache_seq_parallel(cfg: ModelConfig):
    """``(mesh, axes)``: the ambient mesh of ranks and the mesh axes over
    which a rank's dense KV cache holds a block of the positions (the
    rules cut "cache_seq", flash decoding), or ``(None, ())``.  The cut is
    the one ``parallel.specs.cache_specs`` gives the cache's leaf
    (``init_kv_cache``'s axes, an earlier dim taking a mesh axis first);
    ``cache_specs`` refuses a ``max_len`` that the cut does not divide."""
    mesh = spmd_lib.spmd_mesh()
    if mesh is None:
        return None, ()
    d = init_kv_cache(cfg, mesh.size, mesh.size, 1)["k"]
    s = rules_lib.spec(*d.axes, rules=rules_lib.mesh_table(mesh),
                       shape=d.shape, axis_sizes=mesh.axis_sizes)
    axes = rules_lib.dim_axes(s, len(d.shape))[d.axes.index("cache_seq")]
    axes = tuple(a for a in axes if mesh.axis_size(a) > 1)
    return (mesh, axes) if axes else (None, ())


def decode_parallel(cfg: ModelConfig):
    """``(mesh, axes)`` of a decode step's query heads (``model_parallel``):
    its query heads a rank's block.  The KV heads a rank's cache holds are
    its block where the rules cut them with the query heads, else all of
    them, a rank's query heads reading their own group's.  Where the rules
    cut the cache's positions over the query heads' mesh axes too (the
    flash-decoding override of ``rules.decode_rules``), every rank needs
    every query head against its positions (``_decode_attend``).  Raises
    ``NotImplementedError`` naming ROADMAP A11, before any collective,
    where the positions are cut over some of the query heads' mesh axes
    but not all, or over the KV heads' (a rank would hold some KV heads of
    some positions)."""
    tp = model_parallel("heads", cfg.n_heads)
    seq = set(cache_seq_parallel(cfg)[1])
    kv = set(model_parallel("kv_heads", cfg.n_kv_heads)[1])
    if seq & kv or (seq & set(tp[1]) and not set(tp[1]) <= seq):
        raise NotImplementedError(
            f"decoding with the cache's positions cut over {sorted(seq)}, "
            f"the query heads over {tp[1]} and the KV heads over "
            f"{sorted(kv)} is not ported (ROADMAP A11)")
    return tp


def _queries_kv(kv_k: torch.Tensor, kv_v: torch.Tensor, q0: int, hq: int,
                cfg: ModelConfig):
    """The KV heads (B, S, KH', D) that ``hq`` query heads from global head
    ``q0`` on read (``_kv_block``), out of the ones a rank's cache holds
    (its block where the rules cut the KV heads, else all): the cache's
    own heads where they are that block, else a block of them, else one
    KV head a query head."""
    held = kv_k.shape[2]
    k0 = 0
    if held < cfg.n_kv_heads:
        mesh, axes = model_parallel("kv_heads", cfg.n_kv_heads)
        k0 = mesh.index(axes) * held
    lo, hi, kv_of_q = _kv_block(cfg, q0, hq, k0)
    if (lo, hi) != (0, held):
        kv_k, kv_v = kv_k[:, :, lo:hi], kv_v[:, :, lo:hi]
    if kv_of_q is not None:
        kv_k, kv_v = kv_k[:, :, kv_of_q], kv_v[:, :, kv_of_q]
    return kv_k, kv_v


def _decode_attend(p, q, kv_k, kv_v, idx, cfg, dtype, tp=(None, ()),
                   seq=(None, ()), pos0: int = 0):
    """One token's attention of query heads ``q`` (B, 1, H', D), a rank's
    block under tensor parallelism ``tp``, over the cache view ``kv_k``,
    ``kv_v`` (B, S, KH', D) of positions ``pos0`` onwards (masked past
    ``idx``), then ``wo``.  Where ``seq`` (``(mesh, axes)``) cuts the
    positions, each rank's softmax partials -- the max, the sum of exps
    and the exps times v, in fp32 -- are combined over its axes: the max
    by a pmax, then the other two by one psum; a rank whose positions
    all lie past ``idx`` adds zeros.  Where the positions are cut over
    the query heads' axes, q is all-gathered over them first, and a rank
    keeps its own heads' block of the context for the row-parallel
    ``wo``."""
    mesh, axes = tp
    smesh, saxes = seq
    hq = q.shape[2]
    gather = bool(set(saxes) & set(axes))
    if gather:
        q = mesh.all_gather(q, axes, 2)
    q0 = mesh.index(axes) * hq if axes and not gather else 0
    kv_k, kv_v = _queries_kv(kv_k, kv_v, q0, q.shape[2], cfg)
    scores = _gqa_scores(q, kv_k, cfg)                     # (B,KH,G,1,S)
    s = kv_k.shape[1]
    pos = pos0 + torch.arange(s, device=q.device)
    valid = (pos[None, :] <= idx[:, None])[:, None, None, None, :]
    scores = torch.where(valid, scores, NEG_INF)
    if not saxes:
        probs = torch.softmax(scores, dim=-1)
        return _gqa_out(probs, kv_v, p, dtype, tp)
    m = smesh.all_reduce(scores.amax(-1, keepdim=True), saxes, "max")
    e = torch.where(valid, torch.exp(scores - m), 0.0)
    b, kh, g, sq, _ = e.shape
    o = torch.matmul(e.reshape(b, kh, g * sq, s),
                     _heads_major(kv_v).to(torch.float32))
    part = torch.cat([o.reshape(b, kh, g, sq, -1), e.sum(-1, keepdim=True)],
                     dim=-1)
    part = smesh.all_reduce(part, saxes, "sum")
    ctx = part[..., :-1] / torch.clamp(part[..., -1:], min=1e-30)
    ctx = ctx.permute(0, 3, 1, 2, 4).reshape(b, sq, kh * g, -1)
    if gather:
        i = mesh.index(axes)
        ctx = ctx[:, :, i * hq:(i + 1) * hq]
    return _out_proj(ctx.to(dtype), p["wo"], tp).to(dtype)


def _decode_qkv(p, x, idx, cfg, use_rope):
    """q of a rank's query heads, k and v of the KV heads its cache holds
    (its blocks of ``wq``, ``wk``, ``wv``: a decode step has no backward,
    so nothing enters through ``SumGradOverRanks``)."""
    q, k, v = _project_qkv(p, x, x, cfg)
    if use_rope:
        pos = idx[:, None]
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    return q, k, v


def _own_positions(idx: torch.Tensor, act: torch.Tensor | None, s_loc: int,
                   seq) -> tuple[torch.Tensor, torch.Tensor, int]:
    """``(local idx, act, pos0)`` of a write at global position ``idx``
    (clamped to the last position, as one device clamps it) into a rank's
    block of ``s_loc`` positions from ``pos0`` on: a row writes only on
    the rank that owns its position (``act`` 0 elsewhere: the write puts
    back what the block held)."""
    mesh, axes = seq
    pos0 = mesh.index(axes) * s_loc
    gpos = idx.clamp(0, s_loc * mesh.axis_size(axes) - 1)
    local = gpos - pos0
    own = (local >= 0) & (local < s_loc)
    if act is not None:
        own = own & (act > 0)
    return local.clamp(0, s_loc - 1), own.to(torch.int32), pos0


def decode_attention(p: dict, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, idx: torch.Tensor,
                     cfg: ModelConfig, *, act: torch.Tensor | None = None,
                     use_rope: bool = True):
    """One-token decode step.  x: (B, 1, d); idx per-slot (B,) (or a scalar).
    Writes the caches in place; returns (out, cache_k, cache_v).  On a
    mesh whose rules cut the heads, tensor-parallel (``decode_parallel``):
    the caches hold the rank's KV heads (or all of them), and the output
    is summed over the ranks.  Where the rules cut the cache's positions
    (``cache_seq_parallel``, flash decoding) the caches hold a rank's
    block of them: the new position is written by the rank that owns it
    alone, and the ranks' softmax partials are combined
    (``_decode_attend``)."""
    idx = _rows_idx(idx, x.shape[0])
    layout = cfg.kv_cache_layout
    tp = decode_parallel(cfg)
    seq = cache_seq_parallel(cfg)
    q, k, v = _decode_qkv(p, x, idx, cfg, use_rope)
    at, pos0 = idx, 0
    if seq[1]:
        s_loc = cache_k.shape[2] if layout == "bhsd" else cache_k.shape[1]
        at, act, pos0 = _own_positions(idx, act, s_loc, seq)
    _cache_put(cache_k, k, at, layout, act)
    _cache_put(cache_v, v, at, layout, act)
    out = _decode_attend(p, q, _cache_kv_view(cache_k, layout),
                         _cache_kv_view(cache_v, layout), idx, cfg, x.dtype,
                         tp, seq, pos0)
    return out, cache_k, cache_v


# ---- paged KV cache (serving) ---------------------------------------------
#
# The serving scheduler stores KV in a shared physical pool of fixed-size
# pages: each batch row owns a page table mapping logical position p to
# physical page table[p // P] at offset p % P (core.segmented.PageGeometry).
# Page 0 is the reserved null page: empty table rows point at it and masked
# writes land in it, so a scatter over a partially occupied batch never
# touches live data.  Rows writing the null page in one step may collide;
# which value lands there is undefined, and the null page is only ever read
# at positions the validity mask drops.


def paged_kv_pool_defs(cfg: ModelConfig, n_pages: int, page_len: int,
                       n: int) -> dict:
    """Stacked (n-layer) paged KV pool of (page_len, KH, D) pages shared by
    all slots; there is no batch axis -- placement is the page table's job."""
    shape = (n, n_pages, page_len, cfg.n_kv_heads, cfg.hd)
    axes = ("layers", None, None, "kv_heads", None)
    return {
        "k": ParamDef(shape, axes, init="zeros", dtype=cfg.adtype),
        "v": ParamDef(shape, axes, init="zeros", dtype=cfg.adtype),
    }


def _paged_put(pool: torch.Tensor, new: torch.Tensor, pages: torch.Tensor,
               idx: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """Write (B, 1, KH, D) at per-row logical position ``idx`` through the
    page table, in place; inactive rows (``act`` 0) write the null page."""
    p = pool.shape[1]
    b = new.shape[0]
    idx = _rows_idx(idx, b)
    lp = torch.clamp(idx // p, 0, pages.shape[1] - 1)
    phys = torch.gather(pages, 1, lp[:, None].to(torch.int64))[:, 0]
    live = act > 0
    phys = torch.where(live, phys, 0).to(torch.int64)
    off = torch.where(live, idx % p, 0)
    pool[phys, off] = new[:, 0]
    return pool


def _paged_view(pool: torch.Tensor, pages: torch.Tensor, seq=(None, ())
                ) -> tuple[torch.Tensor, int]:
    """``(view, pos0)``: the gathered (B, S, KH, D) bshd view of each row's
    page table, from position ``pos0`` on; unmapped entries read the null
    page (masked by the caller).  Whole, ``S = max_pages * page_len`` from
    0; where ``seq`` (``(mesh, axes)``) cuts the positions, a rank's block
    of them, as a dense cache's (only the pages that hold it gathered)."""
    mesh, axes = seq
    p = pool.shape[1]
    total = pages.shape[1] * p
    pos0, s = 0, total
    if axes:
        n = mesh.axis_size(axes)
        if total % n:
            raise NotImplementedError(
                f"a paged view of {total} positions cut {n} ways over "
                f"{axes} is not ported (ROADMAP A11)")
        s = total // n
        pos0 = mesh.index(axes) * s
        pages = pages[:, pos0 // p:-(-(pos0 + s) // p)]
    g = pool[pages.to(torch.int64)]                        # (B, MP, P, KH, D)
    b, mp = g.shape[:2]
    g = g.reshape(b, mp * p, *g.shape[3:])
    if axes:
        g = g[:, pos0 % p:pos0 % p + s]
    return g, pos0


def paged_decode_attention(p: dict, x: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, pages: torch.Tensor,
                           idx: torch.Tensor, act: torch.Tensor,
                           cfg: ModelConfig, *, use_rope: bool = True):
    """One-token decode against the paged pool: same math as
    ``decode_attention``, the write scattered through the page table and the
    KV view gathered from it.  Returns (out, pool_k, pool_v).  On a mesh
    the pools hold the rank's KV heads (or all of them) and the page table
    its rows.  The pool has no positions axis, so where the rules cut the
    dense cache's positions it is whole on every rank and every rank
    writes the new position; a rank attends over the dense cache's block
    of the positions, read from its pages, and the partials combine as
    the dense cache's do, so the two give the same bits."""
    idx = _rows_idx(idx, x.shape[0])
    tp = decode_parallel(cfg)
    seq = cache_seq_parallel(cfg)
    q, k, v = _decode_qkv(p, x, idx, cfg, use_rope)
    _paged_put(pool_k, k, pages, idx, act)
    _paged_put(pool_v, v, pages, idx, act)
    view_k, pos0 = _paged_view(pool_k, pages, seq)
    view_v, _ = _paged_view(pool_v, pages, seq)
    out = _decode_attend(p, q, view_k, view_v, idx, cfg, x.dtype, tp, seq,
                         pos0)
    return out, pool_k, pool_v


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def mlp_defs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.adtype
    return {
        "wi": ParamDef((d, f), ("embed", "mlp"), dtype=dt),
        "wg": ParamDef((d, f), ("embed", "mlp"), dtype=dt),
        "wo": ParamDef((f, d), ("mlp", "embed"), dtype=dt),
    }


def apply_mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The gated MLP; on a mesh whose rules cut "mlp", tensor-parallel:
    ``wi``/``wg`` column-parallel, ``wo`` row-parallel (``_out_proj``'s
    rounding)."""
    mesh, axes = model_parallel("mlp", cfg.d_ff)
    x = enter(x, mesh, axes)
    h = torch.matmul(x, p["wi"])
    g = torch.matmul(x, p["wg"])
    # jax.nn.gelu defaults to the tanh approximation
    act = F.silu(g) if cfg.act == "silu" else F.gelu(g, approximate="tanh")
    return leave(torch.matmul(act * h, p["wo"]), mesh, axes)
