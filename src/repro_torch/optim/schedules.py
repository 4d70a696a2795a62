"""LR schedules: cosine and MiniCPM's WSD (warmup-stable-decay).

Counterpart of ``repro.optim.schedules``.  Each takes the step as an int or
a 0-d tensor and returns the rate as a 0-d fp32 tensor (on the step's
device), computed in fp32 as the reference computes it.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, peak: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = peak * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor * peak + (1 - floor) * peak * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < warmup, warm, cos)


def wsd(step, *, peak: float, warmup: int, total: int, decay_frac: float = 0.1,
        floor: float = 0.01) -> torch.Tensor:
    """Warmup -> Stable (constant peak) -> Decay (final decay_frac of steps,
    exponential to floor*peak), per MiniCPM (arXiv:2404.06395)."""
    step = _f32(step)
    decay_steps = max(total * decay_frac, 1.0)
    decay_start = total - decay_steps
    warm = peak * step / max(warmup, 1)
    frac = torch.clamp((step - decay_start) / decay_steps, 0.0, 1.0)
    dec = peak * torch.exp(math.log(floor) * frac)
    out = torch.where(step < warmup, warm, torch.full_like(step, peak))
    return torch.where(step > decay_start, dec, out)


def make_schedule(kind: str, *, peak: float = 3e-4, warmup: int = 100,
                  total: int = 10_000):
    if kind == "wsd":
        return lambda s: wsd(s, peak=peak, warmup=warmup, total=total)
    if kind == "cosine":
        return lambda s: warmup_cosine(s, peak=peak, warmup=warmup, total=total)
    raise ValueError(kind)
