"""Model configuration: one dataclass covers the reference's whole pool.

Counterpart of ``repro.models.config``.  ``ModelConfig`` carries the
logical dimensions; ``adtype`` is a ``torch.dtype``.  ``FAMILIES`` are the
reference's (``stages()``): dense, vlm (the dense decoder behind a prefix
of image embeddings), moe (top-k routed experts behind attention), hybrid
(zamba2: Mamba2 and a shared attention block), ssm (xlstm: mLSTM and
sLSTM) and encdec (whisper: its decoder's stage here, the encoder in
``models.encdec``); an unknown family raises ``ValueError``.
``padded_for_mesh(tp)`` is the reference's layout engine: the physical
config for a ``tp``-way model axis, with the Hopper
``core.layout.LayoutPolicy`` in place of the TPU one (a sharded minor dim
pads to ``tp`` warp-wide vector spans) and the logical vocab kept in
``vocab_logical``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, get_args

import torch

from repro_torch.core.layout import LayoutPolicy

Family = Literal["dense", "moe", "hybrid", "ssm", "encdec", "vlm"]

FAMILIES = get_args(Family)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None          # explicit; else d_model // n_heads
    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    attn_softcap: float | None = None
    logit_softcap: float | None = None
    kv_cache_layout: Literal["bhsd", "bshd"] = "bhsd"
    # mlp
    act: Literal["silu", "gelu"] = "silu"
    # scaling tricks (minicpm mup-like)
    tie_embeddings: bool = False
    embed_scale: float = 1.0
    residual_scale: float = 1.0
    logit_scale: float = 1.0
    # norm
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    norm_eps: float = 1e-6
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_groups: int = 1
    skewed_experts: bool = True
    # SSM / Mamba2 (zamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    shared_attn_period: int = 0
    # xLSTM
    slstm_every: int = 0
    # enc-dec (whisper)
    n_enc_layers: int = 0
    n_frames: int = 1500
    # vlm (pixtral)
    n_img_tokens: int = 0
    # numerics
    dtype: str = "bfloat16"
    remat: bool = True
    unroll: bool = False
    vocab_logical: int = 0
    # distribution hints (consumed by the SPMD slice)
    fsdp: bool = False
    expert_tp: bool = False
    parallelism: str = "tp"

    # ---- derived ---------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def stages(self) -> list[tuple[str, int]]:
        """Homogeneous layer runs, each one stacked stage; ``ValueError``
        for a family outside ``FAMILIES``."""
        if self.family in ("dense", "vlm", "encdec"):
            # vlm: the dense decoder; encdec: its decoder (the encoder's
            # layers are models.encdec's own stack)
            return [("dense", self.n_layers)]
        if self.family == "moe":
            return [("moe", self.n_layers)]
        out: list[tuple[str, int]] = []
        if self.family == "ssm":
            # runs of slstm_every - 1 mLSTM layers, each followed by one
            # sLSTM layer (all mLSTM when slstm_every is 0)
            if not self.slstm_every:
                return [("mlstm", self.n_layers)]
            remaining = self.n_layers
            while remaining > 0:
                run = min(self.slstm_every - 1, remaining)
                if run:
                    out.append(("mlstm", run))
                    remaining -= run
                if remaining > 0:
                    out.append(("slstm", 1))
                    remaining -= 1
            return out
        if self.family != "hybrid":
            raise ValueError(f"{self.name or 'model'}: unknown model family "
                             f"{self.family!r}; the families are {FAMILIES}")
        # hybrid: runs of mamba layers, the shared attention block after
        # each full run (and after a short last run only if it is full)
        period = self.shared_attn_period or self.n_layers
        remaining = self.n_layers
        while remaining > 0:
            run = min(period, remaining)
            out.append(("mamba", run))
            remaining -= run
            if remaining > 0 or run == period:
                out.append(("shared_attn", 1))
        return out

    # ---- layout engine ----------------------------------------------------
    def padded_for_mesh(self, tp: int
                        ) -> tuple["ModelConfig", dict[str, tuple[int, int]]]:
        """Physical config for a tp-way model axis (the paper's technique).

        Returns (new_config, changes) where changes[name] = (logical,
        physical)."""
        pol = LayoutPolicy(tp=tp)
        changes: dict[str, tuple[int, int]] = {}

        def upd(name: str, val: int, kind: str) -> int:
            if val == 0:
                return val
            d = pol.plan({name: (val, kind)})[name]
            if d.physical != d.logical:
                changes[name] = (d.logical, d.physical)
            return d.physical

        kw: dict = {}
        kw["d_ff"] = upd("d_ff", self.d_ff, "minor_sharded")
        kw["vocab_size"] = upd("vocab_size", self.vocab_size, "vocab")
        if kw["vocab_size"] != self.vocab_size:
            kw["vocab_logical"] = self.vocab_size
        # Attention heads.  SSM families keep their head structure (head
        # count is architectural state granularity, not a layout choice).
        if self.family != "ssm":
            heads = pol.pad_count(self.n_heads, sharded=True).physical
            if self.n_kv_heads == self.n_heads:       # MHA: pad jointly
                kv = heads
            elif self.n_kv_heads >= tp:               # GQA, shardable KV
                kv = pol.pad_count(self.n_kv_heads, sharded=True).physical
            else:                                      # GQA, replicated KV
                kv = self.n_kv_heads
            while heads % kv:                          # keep GQA ratio integral
                heads += tp
            if heads != self.n_heads:
                changes["n_heads"] = (self.n_heads, heads)
                kw["n_heads"] = heads
            if kv != self.n_kv_heads:
                changes["n_kv_heads"] = (self.n_kv_heads, kv)
                kw["n_kv_heads"] = kv
        if self.n_experts:
            if self.expert_tp:
                kw["moe_d_ff"] = upd("moe_d_ff", self.moe_d_ff,
                                     "minor_sharded")
            else:
                kw["n_experts"] = upd("n_experts", self.n_experts,
                                      "count_sharded")
                kw["moe_d_ff"] = upd("moe_d_ff", self.moe_d_ff, "minor")
        # keep per-head width stable: head_dim becomes explicit when heads pad
        if "n_heads" in changes and self.head_dim is None:
            kw["head_dim"] = self.d_model // self.n_heads
        return dataclasses.replace(self, **kw), changes
