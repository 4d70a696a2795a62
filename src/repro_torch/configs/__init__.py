"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs.

Counterpart of ``repro.configs``.  The port carries every configuration
of the reference's pool as data (dense ``qwen3-4b``, ``qwen2-0.5b``,
``qwen3-14b``, ``minicpm-2b``; vlm ``pixtral-12b``; moe
``qwen3-moe-30b-a3b``, ``grok-1-314b``; hybrid ``zamba2-1.2b``; ssm
``xlstm-1.3b``; encdec ``whisper-tiny``) with its schedule kind
(``get_schedule``).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "minicpm-2b": "minicpm_2b",
    "qwen3-4b": "qwen3_4b",
    "qwen2-0.5b": "qwen2_0p5b",
    "qwen3-14b": "qwen3_14b",
    "pixtral-12b": "pixtral_12b",
    "xlstm-1.3b": "xlstm_1p3b",
    "grok-1-314b": "grok_1_314b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b",
    "whisper-tiny": "whisper_tiny",
}

ARCHS = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[name]}").CONFIG


def get_schedule(name: str) -> str:
    """The learning-rate schedule kind of arch ``name``
    (``optim.schedules.make_schedule``)."""
    get_config(name)
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[name]}").SCHEDULE


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Same family/block structure, laptop-sized dims: the reference's
    reduced shapes (``repro.configs.reduce_for_smoke``)."""
    heads = min(cfg.n_heads, 4)
    kv = max(1, min(cfg.n_kv_heads, heads))
    kw: dict = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=heads,
        n_kv_heads=kv,
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        dtype="float32",
        remat=False,
        fsdp=False,
    )
    if cfg.head_dim:
        kw["head_dim"] = 32
    if cfg.n_experts:
        kw["n_experts"] = min(cfg.n_experts, 8)
        kw["moe_d_ff"] = min(cfg.moe_d_ff, 128)
        kw["capacity_factor"] = 4.0
    if cfg.family == "hybrid":
        kw["shared_attn_period"] = 2
        kw["ssm_state"] = 16
        kw["ssm_head_dim"] = 32
    if cfg.family == "ssm" and cfg.slstm_every:
        kw["slstm_every"] = 4
    if cfg.family == "encdec":
        kw["n_enc_layers"] = 2
        kw["n_frames"] = 16
    if cfg.family == "vlm":
        kw["n_img_tokens"] = 8
    if cfg.vocab_logical:
        kw["vocab_logical"] = 0
    return dataclasses.replace(cfg, **kw)
