"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, recurrent).

Counterpart of ``repro.models.xlstm``, used by xlstm-1.3b (ssm).
Dimensions: the mLSTM works at d_inner = 2 * d_model in H heads of width
P = d_inner / H; the sLSTM at d_model in H heads of d_model / H.

mLSTM recurrence (per head, stabilized in log space):
    m_t = max(lf_t + m_{t-1}, li_t)
    C_t = exp(lf_t + m_{t-1} - m_t) C_{t-1} + exp(li_t - m_t) v_t k_t^T
    n_t = exp(lf_t + m_{t-1} - m_t) n_{t-1} + exp(li_t - m_t) k_t
    h_t = (q_t C_t) / max(|q_t . n_t|, exp(-m_t))

The full-sequence form is the reference's chunkwise closed form: with
B_i = sum_{s<=i} lf_s inside a chunk and u_i = max(m_0, cummax_{j<=i}(li_j -
B_j)) the stabilizer is m_i = B_i + u_i, an attention-like intra-chunk term
plus a carry term from (C_0, n_0, m_0).  A Python loop over the chunks
takes the place of the reference's ``lax.scan``; with ``cfg.remat`` and
autograd recording each chunk runs under ``torch.utils.checkpoint``, as the
reference's ``jax.checkpoint(chunk_fn)``.  The sLSTM is a Python loop over
time (the reference's ``lax.scan``), its recurrent weights block-diagonal
per head.  Gate and recurrence math is fp32.

One deliberate divergence (ROADMAP §C).  The reference forms the intra-chunk
exponent ``dmat = (li_j - B_j) - u_i`` for every (i, j) of a chunk and
masks after the exp, ``where(causal, exp(dmat), 0)``.  Above the diagonal
the exponent grows with the chunk length (the forget gate's log is about
-0.3 a token at the init), exp overflows to inf past about 190 tokens, and
the forward hides it while the backward multiplies the masked cotangent 0
by inf: the reference's gradients are NaN.  The port masks the exponent
before the exp (``exp(where(causal, dmat, -inf))``): every exponent it takes
in a chunk is non-positive or masked, and the masked gradient is zero.

The norms go through the registered kernels: the mLSTM's output gate and
norm through ``blocks.apply_gated_norm`` (B10 on the card), the sLSTM's
output norm -- a plain RMSNorm of the fp32 cell output times ``gnorm`` --
through ``blocks.rms_norm`` on the fp32 h with the scale in fp32 (B9),
rounded once to the activation dtype.  The reference computes both inline
and rounds more often in bf16; in fp32 they differ by operation order
(ROADMAP §C).

On a mesh of ranks whose rules cut "mlp" and "heads" over the same axes,
both blocks are tensor-parallel (Megatron's layout, ``models.blocks``): a
rank holds its heads and their columns.  The mLSTM's ``wup_x`` and
``wup_z`` are column-parallel (the input enters through ``blocks.enter``),
its conv and ``wq``/``wk``/``wv`` a rank's own; ``wi`` and ``wf``
(``("mlp", "heads")``) hold a rank's rows for its columns and every head,
so the gates' pre-activations are partial sums, summed over the ranks
forward and backward (``enter(leave(...))``: each rank goes on with its
own heads alone) before a rank adds its ``bi`` and ``bf``.  The sLSTM's
``wx`` is column-parallel on its last dim, ``r`` and ``b`` a rank's own;
its recurrence needs no collective, since each head's columns live on one
rank.  Both norms run split (``blocks.rms_norm_split``) and both ``wo``
are row-parallel (``blocks.row_parallel``: the partial products summed in
fp32, rounded once).

The decode steps write their layer's state in place, as
``mamba2.mamba_decode_step`` does; a row whose ``act`` is 0 keeps the state
it had.  On a mesh they are tensor-parallel as the full-sequence forms
are, the state a rank's heads and columns.  The mLSTM's matrix memory C --
(B, H, P, P) fp32, almost all of a serving cache -- is updated by two
in-place passes (``C *= f``, then ``C += (i k) v^T``), with f = 1 and
i = 0 for frozen rows, instead of a new tensor and a masked copy.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import blocks, mamba2
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef

CHUNK = 256

# the depthwise causal conv on the q/k path: the Mamba2 block's
_causal_conv = mamba2._causal_conv


def _dims(cfg: ModelConfig) -> tuple[int, int, int]:
    dinner = 2 * cfg.d_model
    h = cfg.n_heads
    return dinner, h, dinner // h


def mlstm_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    dinner, h, p = _dims(cfg)
    dt = cfg.adtype
    f32 = torch.float32
    k = 4  # causal conv width on the q/k path
    return {
        "wup_x": ParamDef((d, dinner), ("embed", "mlp"), dtype=dt),
        "wup_z": ParamDef((d, dinner), ("embed", "mlp"), dtype=dt),
        "conv": ParamDef((k, dinner), ("conv", "mlp"), scale=0.5, dtype=dt),
        "conv_b": ParamDef((dinner,), ("mlp",), init="zeros", dtype=dt),
        # block-diagonal (per-head) projections: fan-in P = shape[-2]
        "wq": ParamDef((h, p, p), ("heads", None, "head_dim"), dtype=dt),
        "wk": ParamDef((h, p, p), ("heads", None, "head_dim"), dtype=dt),
        "wv": ParamDef((h, p, p), ("heads", None, "head_dim"), dtype=dt),
        "wi": ParamDef((dinner, h), ("mlp", "heads"), dtype=f32),
        "wf": ParamDef((dinner, h), ("mlp", "heads"), dtype=f32),
        "bi": ParamDef((h,), ("heads",), init="zeros", dtype=f32),
        "bf": ParamDef((h,), ("heads",), init="ones", dtype=f32),
        "gnorm": ParamDef((dinner,), ("mlp",), init="ones", dtype=dt),
        "wo": ParamDef((dinner, d), ("mlp", "embed"), dtype=dt),
    }


def _heads(x: torch.Tensor, nh: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], nh, x.shape[-1] // nh)


def _gates(p: dict, xc: torch.Tensor, tp=(None, ())):
    """(li, lf): the input gate's and the forget gate's log, fp32, of a
    rank's heads under tensor parallelism ``tp`` (its columns' partial
    pre-activations of every head summed over the ranks)."""
    xf = xc.to(torch.float32)
    pre_i = torch.matmul(xf, p["wi"])
    pre_f = torch.matmul(xf, p["wf"])
    mesh, axes = tp
    if axes:
        h = p["bi"].shape[0]
        h0 = mesh.index(axes) * h
        pre = torch.stack([pre_i, pre_f])
        pre = blocks.enter(blocks.leave(pre, mesh, axes), mesh, axes)
        pre_i, pre_f = pre[..., h0:h0 + h].unbind(0)
    li = pre_i + p["bi"]
    lf = F.logsigmoid(pre_f + p["bf"])
    return li, lf


def _mlstm_qkvif(p: dict, xin: torch.Tensor, cfg: ModelConfig,
                 tp=(None, ())):
    """The common pre-cell path. xin: (B, S, d_model); under tensor
    parallelism ``tp`` a rank's heads."""
    xin = blocks.enter(xin, *tp)
    x = torch.matmul(xin, p["wup_x"])
    z = torch.matmul(xin, p["wup_z"])
    xc = F.silu(_causal_conv(x, p["conv"], p["conv_b"]))
    nh = p["wq"].shape[0]
    xch, xh = _heads(xc, nh), _heads(x, nh)
    q = torch.einsum("bshp,hpq->bshq", xch, p["wq"])
    k = torch.einsum("bshp,hpq->bshq", xch, p["wk"])
    v = torch.einsum("bshp,hpq->bshq", xh, p["wv"])
    li, lf = _gates(p, xc, tp)
    return x, z, q, k, v, li, lf


def _mlstm_out(p: dict, h: torch.Tensor, z: torch.Tensor, cfg: ModelConfig,
               dtype: torch.dtype, tp=(None, ())) -> torch.Tensor:
    """h: (B, S, H, P) cell output; the gate and norm (B10, split under
    tensor parallelism ``tp``), the down projection (row-parallel)."""
    b, s = h.shape[:2]
    y = blocks.apply_gated_norm(p["gnorm"], h.reshape(b, s, -1).to(dtype), z,
                                cfg, tp)
    return blocks.row_parallel(y, p["wo"], tp)


def _chunk(c0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor,
           qi: torch.Tensor, ki: torch.Tensor, vi: torch.Tensor,
           lii: torch.Tensor, bci: torch.Tensor, causal: torch.Tensor):
    """One chunk of the mLSTM: ((C, n, m) at its end, h).  qi/ki/vi
    (B, L, H, P), lii (B, L, H) the input gate's log, bci (B, L, H) the
    running sum of the forget gate's log; carry (B, H, P, P), (B, H, P),
    (B, H); all fp32."""
    u = torch.maximum(m0[:, None, :], torch.cummax(lii - bci, dim=1).values)
    m = bci + u                                                 # m_i
    # intra: D_ij = (B_i - B_j) + li_j - m_i (j <= i), the exponent masked
    # before the exp: above the diagonal it grows with the chunk
    dmat = (bci[:, :, None, :] - bci[:, None, :, :] + lii[:, None, :, :]
            - m[:, :, None, :])                                 # (B,L,L,H)
    w = torch.exp(torch.where(causal[None, :, :, None], dmat,
                              float("-inf")))
    qk = torch.einsum("bihp,bjhp->bijh", qi, ki)
    num_intra = torch.einsum("bijh,bjhp->bihp", w * qk, vi)
    den_intra = torch.einsum("bijh,bjhp->bihp", w, ki)
    # inter: exp(B_i + m0 - m_i) q_i C_0
    winter = torch.exp(bci + m0[:, None, :] - m)                # (B,L,H)
    num_inter = torch.einsum("bihp,bhpq->bihq", qi, c0) * winter[..., None]
    den_inter = n0[:, None, :, :] * winter[..., None]
    num = num_intra + num_inter
    den = torch.einsum("bihp,bihp->bih", qi, den_intra + den_inter)
    hmax = torch.maximum(den.abs(), torch.exp(-m))
    hout = num / hmax[..., None]                                # (B,L,H,P)
    # the carry at the chunk's end
    m_l = m[:, -1, :]
    wlast = torch.exp(bci[:, -1:, :] - bci + lii - m_l[:, None, :])
    wmask = torch.exp(bci[:, -1, :] + m0 - m_l)                 # (B,H)
    c_l = wmask[:, :, None, None] * c0 + torch.einsum(
        "bjhp,bjhq->bhpq", wlast[..., None] * ki, vi)
    n_l = wmask[:, :, None] * n0 + torch.einsum("bjh,bjhp->bhp", wlast, ki)
    return c_l, n_l, m_l, hout


def mlstm_forward(p: dict, xin: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence chunkwise mLSTM. xin: (B, S, d_model)."""
    b, s, _ = xin.shape
    dinner, _, pd = _dims(cfg)
    nh = p["wq"].shape[0]                   # a rank's heads under tp
    tp = blocks.model_parallel("mlp", dinner)
    _, z, q, k, v, li, lf = _mlstm_qkvif(p, xin, cfg, tp)
    l = min(CHUNK, s)
    pad = (-s) % l
    if pad:   # the padded tail: no input (li = -1e30), no forgetting
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        li = F.pad(li, (0, 0, 0, pad), value=-1e30)
        lf = F.pad(lf, (0, 0, 0, pad))
    nc = (s + pad) // l
    qc = q.reshape(b, nc, l, nh, pd).to(torch.float32) / math.sqrt(pd)
    kc = k.reshape(b, nc, l, nh, pd).to(torch.float32)
    vc = v.reshape(b, nc, l, nh, pd).to(torch.float32)
    lic = li.reshape(b, nc, l, nh)
    bcum = torch.cumsum(lf.reshape(b, nc, l, nh), dim=2)        # B_i
    causal = torch.ones((l, l), dtype=torch.bool, device=xin.device).tril()

    f32 = dict(dtype=torch.float32, device=xin.device)
    c = torch.zeros((b, nh, pd, pd), **f32)
    n = torch.zeros((b, nh, pd), **f32)
    m = torch.full((b, nh), -1e30, **f32)
    remat = cfg.remat and torch.is_grad_enabled()
    hs = []
    for i in range(nc):
        args = (c, n, m, qc[:, i], kc[:, i], vc[:, i], lic[:, i], bcum[:, i],
                causal)
        if remat:
            c, n, m, h = checkpoint(_chunk, *args, use_reentrant=False)
        else:
            c, n, m, h = _chunk(*args)
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(b, s + pad, nh, pd)[:, :s]
    return _mlstm_out(p, h, z, cfg, xin.dtype, tp)


def mlstm_cache_defs(cfg: ModelConfig, batch: int, n_stack: int) -> dict:
    dinner, h, p = _dims(cfg)
    f32 = torch.float32
    return {
        "c": ParamDef((n_stack, batch, h, p, p),
                      ("layers", "batch", "heads", None, None),
                      init="zeros", dtype=f32),
        "n": ParamDef((n_stack, batch, h, p), ("layers", "batch", "heads", None),
                      init="zeros", dtype=f32),
        "m": ParamDef((n_stack, batch, h), ("layers", "batch", "heads"),
                      init="neg_inf", dtype=f32),
        "conv": ParamDef((n_stack, batch, 3, dinner),
                         ("layers", "batch", None, "mlp"), init="zeros",
                         dtype=cfg.adtype),
    }


def mlstm_decode_step(p: dict, cache: dict, xin: torch.Tensor,
                      cfg: ModelConfig, act: torch.Tensor | None = None):
    """xin: (B, 1, d_model), one recurrent step.  Returns (y, cache) with
    the layer's ``c``, ``n``, ``m`` and ``conv`` state written in place
    (rows with ``act`` 0 unchanged).  Tensor-parallel as
    ``mlstm_forward``: the state a rank's heads and columns."""
    dinner, _, pd = _dims(cfg)
    nh = p["wq"].shape[0]                   # a rank's heads under tp
    tp = blocks.model_parallel("mlp", dinner)
    xin = blocks.enter(xin, *tp)
    x = torch.matmul(xin, p["wup_x"])
    z = torch.matmul(xin, p["wup_z"])
    xc, conv = mamba2._conv_step(x, cache["conv"], p["conv"], p["conv_b"])
    xc = F.silu(xc)
    xch, xh = _heads(xc, nh), _heads(x, nh)
    f32 = torch.float32
    q = torch.einsum("bshp,hpq->bshq", xch, p["wq"])[:, 0].to(f32)
    k = torch.einsum("bshp,hpq->bshq", xch, p["wk"])[:, 0].to(f32)
    v = torch.einsum("bshp,hpq->bshq", xh, p["wv"])[:, 0].to(f32)
    q = q / math.sqrt(pd)
    li, lf = (g[:, 0] for g in _gates(p, xc, tp))               # (B,H)
    m0 = cache["m"]
    m = torch.maximum(lf + m0, li)
    wf = torch.exp(lf + m0 - m)
    wi = torch.exp(li - m)
    if act is not None:     # a frozen row: C * 1 + 0, n likewise
        live = (act > 0)[:, None]
        wf = torch.where(live, wf, 1.0)
        wi = torch.where(live, wi, 0.0)
        m = torch.where(live, m, m0)
    c = cache["c"]
    c.mul_(wf[:, :, None, None])
    c.addcmul_((wi[..., None] * k)[..., None], v[:, :, None, :])
    n = wf[:, :, None] * cache["n"] + wi[:, :, None] * k
    num = torch.einsum("bhp,bhpq->bhq", q, c)
    den = torch.maximum(torch.einsum("bhp,bhp->bh", q, n).abs(),
                        torch.exp(-m))
    h = (num / den[..., None])[:, None]                         # (B,1,H,P)
    out = _mlstm_out(p, h, z, cfg, xin.dtype, tp)
    cache["n"].copy_(n)
    cache["m"].copy_(m)
    mamba2._state_put(cache["conv"], conv, act)
    return out, cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    p = d // h
    dt = cfg.adtype
    f32 = torch.float32
    return {
        # input projections of the gates i, f, z, o; the true fan-in d,
        # where the reference takes shape[-2] = 4 (ROADMAP §C)
        "wx": ParamDef((d, 4, d), ("embed", None, "mlp"), dtype=f32,
                       fan_in_axes=("embed",)),
        # block-diagonal recurrent weights per head: fan-in p = shape[-2]
        "r": ParamDef((4, h, p, p), (None, "heads", None, None), dtype=f32),
        "b": ParamDef((4, d), (None, "mlp"), init="zeros", dtype=f32),
        "gnorm": ParamDef((d,), ("mlp",), init="ones", dtype=dt),
        "wo": ParamDef((d, d), ("mlp", "embed"), dtype=dt),
    }


def _slstm_cell(p: dict, carry, gx: torch.Tensor, nh: int, pd: int):
    """One sLSTM step. carry: (c, n, m, h), each (B, d) fp32; gx: (B, 4, d)
    the input part of the gates."""
    c, n, m, h = carry
    b = h.shape[0]
    gr = torch.einsum("ghpq,bhq->gbhp", p["r"], h.reshape(b, nh, pd))
    g = gx + gr.reshape(4, b, nh * pd).transpose(0, 1) + p["b"]   # (B,4,d)
    gi, gf, gz, go = g.unbind(1)
    lf = F.logsigmoid(gf)
    mn = torch.maximum(lf + m, gi)
    wf = torch.exp(lf + m - mn)
    wi = torch.exp(gi - mn)
    c1 = wf * c + wi * torch.tanh(gz)
    n1 = wf * n + wi
    h1 = torch.sigmoid(go) * c1 / torch.maximum(n1, n1.new_ones(()))
    return c1, n1, mn, h1


def _slstm_out(p: dict, h: torch.Tensor, cfg: ModelConfig,
               dtype: torch.dtype, tp=(None, ())) -> torch.Tensor:
    """The output norm of the fp32 cell output through B9 (split under
    tensor parallelism ``tp``), the scale in fp32, rounded once to
    ``dtype``; the down projection (row-parallel)."""
    hn = blocks.rms_norm(h, p["gnorm"].to(torch.float32), cfg.norm_eps, tp)
    return blocks.row_parallel(hn.to(dtype), p["wo"], tp)


def slstm_forward(p: dict, xin: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    b, s, _ = xin.shape
    # a rank's columns and heads under tensor parallelism
    d, nh = p["wx"].shape[-1], p["r"].shape[1]
    tp = blocks.model_parallel("mlp", cfg.d_model)
    xin = blocks.enter(xin, *tp)
    gx = torch.einsum("bsd,dgi->bsgi", xin.to(torch.float32), p["wx"])
    f32 = dict(dtype=torch.float32, device=xin.device)
    carry = (torch.zeros((b, d), **f32), torch.zeros((b, d), **f32),
             torch.full((b, d), -1e30, **f32),         # m: no history
             torch.zeros((b, d), **f32))
    hs = []
    for t in range(s):
        carry = _slstm_cell(p, carry, gx[:, t], nh, d // nh)
        hs.append(carry[3])
    return _slstm_out(p, torch.stack(hs, dim=1), cfg, xin.dtype, tp)


def slstm_cache_defs(cfg: ModelConfig, batch: int, n_stack: int) -> dict:
    d = cfg.d_model
    return {
        name: ParamDef((n_stack, batch, d), ("layers", "batch", "mlp"),
                       init=("neg_inf" if name == "m" else "zeros"),
                       dtype=torch.float32)
        for name in ("c", "n", "m", "h")
    }


def slstm_decode_step(p: dict, cache: dict, xin: torch.Tensor,
                      cfg: ModelConfig, act: torch.Tensor | None = None):
    """xin: (B, 1, d_model).  Returns (y, cache) with the layer's ``c``,
    ``n``, ``m`` and ``h`` written in place (rows with ``act`` 0
    unchanged).  Tensor-parallel as ``slstm_forward``: the state a rank's
    columns."""
    d, nh = p["wx"].shape[-1], p["r"].shape[1]
    tp = blocks.model_parallel("mlp", cfg.d_model)
    xin = blocks.enter(xin, *tp)
    gx = torch.einsum("bsd,dgi->bsgi", xin.to(torch.float32), p["wx"])[:, 0]
    keys = ("c", "n", "m", "h")
    new = _slstm_cell(p, tuple(cache[k] for k in keys), gx, nh, d // nh)
    out = _slstm_out(p, new[3], cfg, xin.dtype, tp)[:, None, :]
    for key, t in zip(keys, new):
        mamba2._state_put(cache[key], t, act)
    return out, cache
