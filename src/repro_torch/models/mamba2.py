"""Mamba2 (SSD) block -- chunked parallel form + O(1) decode.

Counterpart of ``repro.models.mamba2``, used by zamba2 (hybrid).
Dimensions: d_inner = expand * d_model, H heads of width P = ssm_head_dim,
state width N = ssm_state, a single B/C group.

The full-sequence form is the chunked state-space dual: within a chunk of
length L the output is an attention-like product with a causal decay mask;
across chunks only the (B, H, N, P) boundary states are carried.  A Python
loop over the chunks takes the place of the reference's ``lax.scan``; with
``cfg.remat`` and autograd recording each chunk runs under
``torch.utils.checkpoint``, so the (B, L, L, H) decay tile exists for one
chunk at a time.  Decay math is fp32.

One deliberate divergence (ROADMAP §C).  The reference forms the decay as
``exp(cum_i - cum_j)`` for every (i, j) of a chunk and applies the causal
mask afterwards, as a product.  Above the diagonal the exponent is positive
and grows with the chunk length; past about 110 tokens at the seeded init
exp overflows to inf, and inf * 0 is NaN, so the reference's forward is NaN
from S = 128 on.  The port masks the exponent before the exp
(``exp(where(causal, cum_i - cum_j, -inf))``): every exponent it takes is
non-positive, the masked entries are exact zeros, and their gradient is
zero, not 0 * inf.

The gate and the norm go through ``blocks.apply_gated_norm``: the gated
RMSNorm kernel (B10 on the card), where the reference computes them
inline.  In fp32 the two differ by operation order; in bf16 by the
kernel's single rounding of the gate (ROADMAP §C).

On a mesh of ranks whose rules cut "mlp" (the ``d_inner`` columns) and
"heads" (its ``d_inner / P`` heads) over the same axes, the block is
tensor-parallel, Megatron's layout as ``models.blocks`` runs it for the
attention and the MLP: ``wz``, ``wx`` and ``wdt`` are column-parallel (the
input enters through ``blocks.enter``), the depthwise convs, ``A_log``,
``D``, ``dt_bias`` and the SSD chunks are a rank's own heads (a rank's heads
are its columns), the gated norm runs split (``blocks.rms_norm_split``:
the sum of squares summed over the ranks) and ``wo`` is row-parallel
(``blocks.row_parallel``: the partial products summed in fp32, rounded
once).  ``wbc``, ``conv_bc`` and ``conv_bc_b`` (a single B/C
group for every head) are whole on every rank, which uses them for its own
heads only: they enter through ``blocks.enter``, so their gradient is the
ranks' parts summed.

``mamba_decode_step`` writes the conv and SSM state of its layer in place;
a row whose ``act`` is 0 writes back what it found, so a frozen row's state
is bit-identical to not having stepped (``models.blocks``' rule for the KV
caches).  On a mesh it is tensor-parallel as the full-sequence form is,
its state a rank's heads and columns.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef

CHUNK = 256


def mamba_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    dinner = cfg.ssm_expand * d
    h = dinner // cfg.ssm_head_dim
    n = cfg.ssm_state
    k = cfg.ssm_conv
    dt = cfg.adtype
    f32 = torch.float32
    return {
        "wz": ParamDef((d, dinner), ("embed", "mlp"), dtype=dt),
        "wx": ParamDef((d, dinner), ("embed", "mlp"), dtype=dt),
        "wbc": ParamDef((d, 2 * n), ("embed", None), dtype=dt),
        "wdt": ParamDef((d, h), ("embed", "heads"), dtype=dt),
        "conv_x": ParamDef((k, dinner), ("conv", "mlp"), scale=0.5, dtype=dt),
        "conv_x_b": ParamDef((dinner,), ("mlp",), init="zeros", dtype=dt),
        "conv_bc": ParamDef((k, 2 * n), ("conv", None), scale=0.5, dtype=dt),
        "conv_bc_b": ParamDef((2 * n,), (None,), init="zeros", dtype=dt),
        "A_log": ParamDef((h,), ("heads",), init="zeros", dtype=f32),
        "D": ParamDef((h,), ("heads",), init="ones", dtype=f32),
        "dt_bias": ParamDef((h,), ("heads",), init="zeros", dtype=f32),
        "gnorm": ParamDef((dinner,), ("mlp",), init="ones", dtype=dt),
        "wo": ParamDef((dinner, d), ("mlp", "embed"), dtype=dt),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq. x: (B,S,C), w: (K,C)."""
    k = w.shape[0]
    out = torch.zeros_like(x)
    for i in range(k):
        shift = k - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, : x.shape[1], :]
        out = out + xi * w[i]
    return out + b


def _proj(p: dict, u: torch.Tensor, cfg: ModelConfig):
    """Shared projection path for full-sequence and decode-step inputs."""
    z = torch.matmul(u, p["wz"])
    x = torch.matmul(u, p["wx"])
    bc = torch.matmul(u, p["wbc"])
    dt_pre = torch.matmul(u, p["wdt"]).to(torch.float32)
    return z, x, bc, dt_pre


def _split_heads(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    b, s, dinner = x.shape
    return x.reshape(b, s, dinner // cfg.ssm_head_dim, cfg.ssm_head_dim)


def _chunk(state: torch.Tensor, xw_c: torch.Tensor, b_c: torch.Tensor,
           c_c: torch.Tensor, cum_c: torch.Tensor, causal: torch.Tensor):
    """One chunk of the SSD: (new boundary state, y).  xw_c (B,L,H,P) is
    dt_j * x_j, b_c/c_c (B,L,N), cum_c (B,L,H) the running sum of dt * A
    (non-increasing), state (B,H,N,P); all fp32."""
    cb = torch.einsum("bin,bjn->bij", c_c, b_c)                # (B,L,L)
    # the exponent masked before the exp: above the diagonal it is positive
    diff = cum_c[:, :, None, :] - cum_c[:, None, :, :]        # (B,L,L,H)
    dec = torch.exp(torch.where(causal[None, :, :, None], diff,
                                float("-inf")))
    att = cb[..., None] * dec
    y = torch.einsum("bijh,bjhp->bihp", att, xw_c)
    y = y + torch.einsum("bin,bhnp->bihp", c_c, state) * torch.exp(
        cum_c)[..., None]
    dec_last = torch.exp(cum_c[:, -1:, :] - cum_c)            # (B,L,H)
    new_state = torch.exp(cum_c[:, -1, :])[:, :, None, None] * state + (
        torch.einsum("bjn,bjh,bjhp->bhnp", b_c, dec_last, xw_c))
    return new_state, y


def mamba_forward(p: dict, u: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence chunked SSD. u: (B, S, d_model)."""
    b, s, _ = u.shape
    n = cfg.ssm_state
    pdim = cfg.ssm_head_dim
    l = min(CHUNK, s)
    pad = (-s) % l
    tp = blocks.model_parallel("mlp", cfg.ssm_expand * cfg.d_model)
    if tp[1]:   # column-parallel in, the B/C group whole on every rank
        u = blocks.enter(u, *tp)
        p = {**p, **{k: blocks.enter(p[k], *tp)
                     for k in ("wbc", "conv_bc", "conv_bc_b")}}
    z, x, bc, dt_pre = _proj(p, u, cfg)
    x = F.silu(_causal_conv(x, p["conv_x"], p["conv_x_b"]))
    bc = F.silu(_causal_conv(bc, p["conv_bc"], p["conv_bc_b"]))
    if pad:
        x, bc, dt_pre = (F.pad(t, (0, 0, 0, pad)) for t in (x, bc, dt_pre))
    sp = s + pad
    nc = sp // l
    xh = _split_heads(x, cfg).reshape(b, nc, l, -1, pdim)      # (B,nc,L,H,P)
    bmat = bc[..., :n].reshape(b, nc, l, n).to(torch.float32)
    cmat = bc[..., n:].reshape(b, nc, l, n).to(torch.float32)
    dt = F.softplus(dt_pre + p["dt_bias"]).reshape(b, nc, l, -1)  # (B,nc,L,H)
    a = -torch.exp(p["A_log"])                                 # (H,) negative
    cum = torch.cumsum(dt * a, dim=2)                          # (B,nc,L,H)
    xw = xh.to(torch.float32) * dt[..., None]                  # dt_j * x_j
    causal = torch.ones((l, l), dtype=torch.bool, device=u.device).tril()

    remat = cfg.remat and torch.is_grad_enabled()
    state = torch.zeros((b, xh.shape[3], n, pdim), dtype=torch.float32,
                        device=u.device)
    ys = []
    for c in range(nc):
        args = (state, xw[:, c], bmat[:, c], cmat[:, c], cum[:, c], causal)
        if remat:
            state, y = checkpoint(_chunk, *args, use_reentrant=False)
        else:
            state, y = _chunk(*args)
        ys.append(y)
    y_sc = torch.stack(ys, dim=1)                              # (B,nc,L,H,P)

    y = y_sc + p["D"][None, None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(b, sp, -1)[:, :s, :].to(u.dtype)             # (B,S,d_inner)
    y = blocks.apply_gated_norm(p["gnorm"], y, z, cfg, tp)
    return blocks.row_parallel(y, p["wo"], tp)


# ---------------------------------------------------------------------------
# Decode (single token, O(1) state)
# ---------------------------------------------------------------------------


def mamba_cache_defs(cfg: ModelConfig, batch: int, n_stack: int) -> dict:
    d = cfg.d_model
    dinner = cfg.ssm_expand * d
    h = dinner // cfg.ssm_head_dim
    n = cfg.ssm_state
    k = cfg.ssm_conv
    dt = cfg.adtype
    return {
        "conv_x": ParamDef((n_stack, batch, k - 1, dinner),
                           ("layers", "batch", None, "mlp"), init="zeros",
                           dtype=dt),
        "conv_bc": ParamDef((n_stack, batch, k - 1, 2 * n),
                            ("layers", "batch", None, None), init="zeros",
                            dtype=dt),
        "ssm": ParamDef((n_stack, batch, h, n, cfg.ssm_head_dim),
                        ("layers", "batch", "heads", "state", None),
                        init="zeros", dtype=torch.float32),
    }


def _conv_step(xt: torch.Tensor, state: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor):
    """xt: (B,1,C), state: (B,K-1,C) of previous inputs. Returns (y, new
    state).  The K products are summed in fp32 and rounded once."""
    window = torch.cat([state, xt], dim=1)                     # (B,K,C)
    y = (window.to(torch.float32) * w.to(torch.float32)).sum(1)
    return y.to(xt.dtype)[:, None, :] + b, window[:, 1:, :]


def _state_put(cache: torch.Tensor, new: torch.Tensor,
               act: torch.Tensor | None) -> None:
    """Write a layer's new per-row state in place; a row whose ``act`` is 0
    writes back what it found."""
    if act is not None:
        live = (act > 0).reshape(-1, *([1] * (new.ndim - 1)))
        new = torch.where(live, new, cache)
    cache.copy_(new)


def mamba_decode_step(p: dict, cache: dict, u: torch.Tensor,
                      cfg: ModelConfig, act: torch.Tensor | None = None):
    """u: (B,1,d).  Returns (y, cache) with the layer's ``conv_x``,
    ``conv_bc`` and ``ssm`` state written in place (rows with ``act`` 0
    unchanged).  Tensor-parallel as ``mamba_forward``: the cache holds the
    rank's ``d_inner`` columns (``conv_x``) and heads (``ssm``) and the
    whole B/C group (``conv_bc``)."""
    n = cfg.ssm_state
    tp = blocks.model_parallel("mlp", cfg.ssm_expand * cfg.d_model)
    if tp[1]:   # column-parallel in, the B/C group whole on every rank
        u = blocks.enter(u, *tp)
        p = {**p, **{k: blocks.enter(p[k], *tp)
                     for k in ("wbc", "conv_bc", "conv_bc_b")}}
    z, x, bc, dt_pre = _proj(p, u, cfg)
    x, conv_x = _conv_step(x, cache["conv_x"], p["conv_x"], p["conv_x_b"])
    x = F.silu(x)
    bc, conv_bc = _conv_step(bc, cache["conv_bc"], p["conv_bc"],
                             p["conv_bc_b"])
    bc = F.silu(bc)
    xh = _split_heads(x, cfg)[:, 0].to(torch.float32)          # (B,H,P)
    bmat = bc[:, 0, :n].to(torch.float32)                      # (B,N)
    cmat = bc[:, 0, n:].to(torch.float32)
    dt = F.softplus(dt_pre[:, 0] + p["dt_bias"])               # (B,H)
    a = -torch.exp(p["A_log"])
    decay = torch.exp(dt * a)                                  # (B,H)
    h = decay[:, :, None, None] * cache["ssm"] + (
        bmat[:, None, :, None] * (dt[:, :, None] * xh)[:, :, None, :])
    y = torch.einsum("bn,bhnp->bhp", cmat, h) + p["D"][None, :, None] * xh
    y = y.reshape(u.shape[0], 1, -1).to(u.dtype)
    y = blocks.apply_gated_norm(p["gnorm"], y, z, cfg, tp)
    out = blocks.row_parallel(y, p["wo"], tp)
    _state_put(cache["conv_x"], conv_x, act)
    _state_put(cache["conv_bc"], conv_bc, act)
    _state_put(cache["ssm"], h, act)
    return out, cache
