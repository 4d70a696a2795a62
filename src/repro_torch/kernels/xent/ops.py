"""Cross-entropy: registry entry, planner-derived row layout, and its
gradient (single device).

Counterpart of ``repro.kernels.xent.ops``.  ``api.launch("xent", logits,
labels, logical_v=)`` returns the mean NLL over the (T,) tokens.  The plan
is column-tiled (``core.planner._plan_col_tiled``): rows are never padded,
and a vocab that is a whole number of 16-B vectors (151936 fp32 = 37984
float4) is not padded either, so the caller's (T, V) logits reach the kernel
as they are, with no copy.  ``xent_grad`` is the backward half: in the
reference it is the jnp vjp of the plain math (not Pallas), and here it is
plain PyTorch.

The vocab-parallel SPMD body and its partial kernel (B12), and the
deprecated ``xent_mean`` shim, are not ported (ROADMAP A11).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.api.registry import Partitioning, register_kernel
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


# Tokens shard over the batch axes and the vocab over the model axis
# (Megatron layout); the loss is a scalar mean.  Stored until A11.
_VOCAB_PARALLEL = Partitioning(in_axes=(("batch", "vocab"), ("batch",)),
                               out_axes=())


@register_kernel("xent", signature=StreamSignature(n_read=2, n_write=1),
                 ref=_ref, plan_args=_plan_args, col_tiled=True,
                 partitioning=_VOCAB_PARALLEL)
def _launch_xent(plan, logits, labels, *, logical_v: int = 0):
    """Mean NLL over the (T,) tokens.  Logits already in the plan's layout
    (contiguous, width as planned) go to the kernel as they are; others are
    padded with zero columns into one copy, masked by ``logical_v``."""
    t, v = logits.shape
    _, vp = plan.padded_shape
    lg = logits.contiguous()
    if vp != v:
        lg = F.pad(lg, (0, vp - v))
    nll = kernel.xent_nll(lg, labels, logical_v=logical_v or v,
                          brows=plan.block_rows)
    return nll.mean()


def xent_grad(logits: torch.Tensor, labels: torch.Tensor, g, *,
              logical_v: int = 0) -> torch.Tensor:
    """d(mean NLL)/d(logits) at cotangent ``g``: ``(softmax(masked) -
    onehot) * g / T`` in fp32, cast to the logits' dtype -- the reference's
    single-device vjp of ``_ref``.  Columns at or past ``logical_v`` get a
    zero gradient (their logits were replaced by the mask), a label there
    included.

    Memory: the result is the one (T, V) tensor this allocates.  The rows
    are walked in chunks of ``GRAD_CHUNK_ELEMS`` fp32 elements, each chunk's
    softmax computed and scaled in place and written into its rows of the
    result, so the fp32 scratch is one chunk, not a second (T, V) tensor --
    2.49 GB each at (4096, 151936) fp32."""
    t, v = logits.shape
    lv = logical_v or v
    scale = torch.as_tensor(g, dtype=torch.float32,
                            device=logits.device) / t
    out = torch.empty_like(logits)
    lab = labels.to(device=logits.device, dtype=torch.int64)
    chunk = max(1, GRAD_CHUNK_ELEMS // max(v, 1))
    col = torch.arange(v, device=logits.device)
    for r0 in range(0, t, chunk):
        r1 = min(r0 + chunk, t)
        x = logits[r0:r1].to(torch.float32, copy=True)
        if lv < v:
            x[:, lv:] = kernel.MASK
        dead = x <= kernel.DEAD
        m = x.amax(-1, keepdim=True)
        l = torch.exp(x - m).masked_fill_(dead, 0.0).sum(-1, keepdim=True)
        lse = torch.log(torch.clamp(l, min=1e-30)) + m
        p = x.sub_(lse).exp_().masked_fill_(dead, 0.0)
        hit = (col[None, :] == lab[r0:r1, None]) & (col[None, :] < lv)
        p.sub_(hit.to(torch.float32)).mul_(scale)
        out[r0:r1] = p
    return out
