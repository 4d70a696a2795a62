"""Cross-entropy: registry entry, planner-derived row layout, its
vocab-parallel shard body and its gradient.

Counterpart of ``repro.kernels.xent.ops``.  ``api.launch("xent", logits,
labels, logical_v=)`` returns the mean NLL over the (T,) tokens.  The plan
is column-tiled (``core.planner._plan_col_tiled``) and pads nothing: the
kernel reads rows of any width in place (``csrc/xent.cu``), so the caller's
contiguous (T, V) logits reach it as they are, with no copy, at every
vocab (whisper-tiny's 51,865 and minicpm-2b's 122,753 as well as
151,936).  The plan gives the rows a CTA walks.  ``xent_grad`` is the
backward half: in the reference it is the jnp vjp of the plain math (not
Pallas), and here it is plain PyTorch.

Under a mesh of ranks the loss is *vocab-parallel* (Megatron layout): the
logits' vocab axis shards over the model axis, each rank folds its own
vocab slice with the partial kernel (B12, ``kernel.xent_partials``), and
``_spmd_xent`` combines the ranks' (max, sumexp, label logit) with a
cross-shard log-sum-exp:

    m   = pmax_k(m_k)
    lse = log(psum_k(l_k * exp(m_k - m))) + m
    nll = lse - psum_k(ll_k)

Token-length fp32 vectors cross the wire instead of a replicated (T, V)
logits array; the scalar mean then crosses the batch axes with a pmean of
equal-sized shard means.  ``xent_grad`` is the matching vocab-parallel
backward.  A vocab that does not split evenly stays whole on every rank
(logged by ``api.spmd``), and the rank runs B11 on it.  The deprecated
``xent_mean`` shim is not ported: the port has no shims.
"""
from __future__ import annotations

import torch

from repro_torch.api import dispatch
from repro_torch.api import spmd as spmd_lib
from repro_torch.api.registry import register_kernel, resolve
from repro_torch.api.spmd import SCALAR, Partitioning
from repro_torch.core.autotune import StreamSignature
from repro_torch.kernels.xent import kernel, ref

# Elements of fp32 scratch per row chunk of ``xent_grad`` (256 MiB).
GRAD_CHUNK_ELEMS = 1 << 26


def _plan_args(logits, labels=None, **_scalars):
    if logits.ndim != 2:
        raise ValueError(f"xent plans (T, V) logits, got rank {logits.ndim}")
    return tuple(logits.shape), logits.dtype


def _ref(logits, labels, *, logical_v: int = 0):
    lv = logical_v or logits.shape[-1]
    return ref.xent(logits, labels, logical_v=lv).mean()


def _xent_shard_partials(plan, logits, labels, off: int, *, vl: int,
                         logical_v: int):
    """Per-token (m, l, ll) partials of one vocab shard: B12 reads the
    shard's contiguous logits in place, ``plan.block_rows`` rows a CTA."""
    return kernel.xent_partials(logits.contiguous(), labels, vl=vl, off=off,
                                logical_v=logical_v, brows=plan.block_rows)


def _spmd_xent(ctx, logits, labels, *, logical_v: int = 0, mask=None):
    """Shard body: vocab-parallel mean cross-entropy.

    ``logits`` is this rank's (T_local, V_local) shard.  When the vocab
    axis sharded (model axis > 1, divisible vocab) B12 folds the local
    slice and the log-sum-exp combine crosses the vocab ranks with
    pmax/psum; otherwise the vocab is whole here and B11 gives the NLL.
    Either way the scalar mean crosses the batch axes with a pmean of
    equal-sized shard means.

    With ``mask`` (T_local,) fp32, this rank's tokens' weights, the same
    per-token NLL is weighted instead: the result is the (2,) fp32
    ``(sum of nll * mask, sum of mask)`` over the global tokens, one psum
    over the batch axes, for the caller's masked mean."""
    t, vl = logits.shape
    vocab_axes = ctx.axes(0, 1)
    batch_axes = ctx.axes(0, 0)
    n_vocab = ctx.size(vocab_axes)
    plan = dispatch.plan_for("xent", (t, vl), logits.dtype, local=True)
    if n_vocab <= 1 and mask is not None:
        nll = kernel.xent_nll(logits.contiguous(), labels,
                              logical_v=logical_v or vl,
                              brows=plan.block_rows)
    elif n_vocab <= 1:
        out = _launch_xent(plan, logits, labels, logical_v=logical_v)
    else:
        lv = logical_v or vl * n_vocab
        off = ctx.index(vocab_axes) * vl
        m, l, ll = _xent_shard_partials(plan, logits, labels, off, vl=vl,
                                        logical_v=lv)
        # Rescale each shard's sumexp to the global max before summing; the
        # label's logit lives in exactly one shard, the others add zero.
        mg = ctx.pmax(m, vocab_axes)
        l, ll = ctx.psum(torch.stack([l * torch.exp(m - mg), ll]),
                         vocab_axes)
        nll = torch.log(torch.clamp(l, min=1e-30)) + mg - ll
        if mask is None:
            out = nll.mean()
    if mask is not None:
        out = torch.stack([(nll * mask).sum(), mask.sum()])
        return ctx.psum(out, batch_axes) if batch_axes else out
    if batch_axes:
        out = ctx.pmean(out, batch_axes)
    return out


@register_kernel("xent", signature=StreamSignature(n_read=2, n_write=1),
                 ref=_ref, plan_args=_plan_args, col_tiled=True,
                 # Tokens shard over the batch axes and the vocab over the
                 # model axis (Megatron layout); the shard body owns the
                 # cross-shard lse combine.  Each shard's mean covers its own
                 # tokens, so equal token shards combine exactly by a mean.
                 partitioning=Partitioning(
                     in_axes=(("batch", "vocab"), ("batch",)),
                     out_axes=SCALAR, reduce="mean"),
                 spmd_body=_spmd_xent)
def _launch_xent(plan, logits, labels, *, logical_v: int = 0):
    """Mean NLL over the (T,) tokens.  The logits go to the kernel as
    ``logits.contiguous()``: for contiguous logits, the caller's storage,
    at any width."""
    nll = kernel.xent_nll(logits.contiguous(), labels,
                          logical_v=logical_v or logits.shape[1],
                          brows=plan.block_rows)
    return nll.mean()


def xent_grad(logits: torch.Tensor, labels: torch.Tensor, g, *,
              logical_v: int = 0, global_shapes=None,
              weights: torch.Tensor | None = None) -> torch.Tensor:
    """d(mean NLL)/d(logits) at cotangent ``g``: ``(softmax(masked) -
    onehot) * g / T`` in fp32, cast to the logits' dtype -- the reference's
    single-device vjp of ``_ref``.  Columns at or past ``logical_v`` get a
    zero gradient (their logits were replaced by the mask), a label there
    included.  With ``weights`` (T,) fp32, the gradient of ``sum_t w_t *
    nll_t`` instead: row t's cotangent is ``g * w_t`` (the masked mean's
    ``mask_t / sum(mask)``, ``models.transformer.XentFn``).

    Under an ambient mesh of ranks this is the *vocab-parallel* gradient,
    the reference's ``xent_grad`` shard body: ``logits`` is this rank's
    shard, cut by the same partitioning as the forward (``global_shapes``
    as for ``api.launch``), the softmax is taken against the lse combined
    over the vocab ranks (pmax/psum), and T is the global token count, so
    each rank returns its shard of the gradient of the global mean.

    Memory: the result is the one (T, V) tensor this allocates.  The rows
    are walked in chunks of ``GRAD_CHUNK_ELEMS`` fp32 elements, each chunk's
    softmax computed and scaled in place and written into its rows of the
    result, so the fp32 scratch is one chunk, not a second (T, V) tensor --
    2.49 GB each at (4096, 151936) fp32."""
    t, v = logits.shape
    lv = logical_v or v
    off, t_total, vocab_axes, ctx = 0, t, (), None
    mesh = spmd_lib.spmd_mesh()
    if mesh is not None:
        # same partitioning as the registered forward, so the two can never
        # shard differently
        templates = resolve("xent").partitioning.in_axes
        _, operand_axes, sizes, _, _ = spmd_lib.shard_specs(
            mesh, templates, (logits, labels), global_shapes)
        ctx = spmd_lib.ShardContext(operand_axes=operand_axes,
                                    axis_sizes=sizes, mesh=mesh)
        vocab_axes = ctx.axes(0, 1)
        n_vocab = ctx.size(vocab_axes)
        if n_vocab > 1:
            lv = logical_v or v * n_vocab
            off = ctx.index(vocab_axes) * v
        else:
            vocab_axes = ()
        t_total = t * ctx.size(ctx.axes(0, 0))
    scale = torch.as_tensor(g, dtype=torch.float32, device=logits.device)
    if weights is None:
        scale = scale / t_total
    else:
        scale = scale * weights.to(device=logits.device,
                                   dtype=torch.float32)[:, None]
    out = torch.empty_like(logits)
    lab = labels.to(device=logits.device, dtype=torch.int64)
    chunk = max(1, GRAD_CHUNK_ELEMS // max(v, 1))
    col = off + torch.arange(v, device=logits.device)
    for r0 in range(0, t, chunk):
        r1 = min(r0 + chunk, t)
        x = logits[r0:r1].to(torch.float32, copy=True)
        if lv - off < v:
            x[:, max(lv - off, 0):] = kernel.MASK
        dead = x <= kernel.DEAD
        m = x.amax(-1, keepdim=True)
        if vocab_axes:
            m = ctx.pmax(m, vocab_axes)
        l = torch.exp(x - m).masked_fill_(dead, 0.0).sum(-1, keepdim=True)
        if vocab_axes:
            l = ctx.psum(l, vocab_axes)
        lse = torch.log(torch.clamp(l, min=1e-30)) + m
        p = x.sub_(lse).exp_().masked_fill_(dead, 0.0)
        hit = (col[None, :] == lab[r0:r1, None]) & (col[None, :] < lv)
        p.sub_(hit.to(torch.float32)).mul_(
            scale if weights is None else scale[r0:r1])
        out[r0:r1] = p
    return out
