"""Plain PyTorch oracles for the RMSNorm kernels (counterpart of
``repro.kernels.rmsnorm.ref``)."""
from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.to(torch.float32)).to(x.dtype)


def gate(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x * silu(z) in fp32, rounded to x's dtype."""
    zf = z.to(torch.float32)
    return (x.to(torch.float32) * (zf * torch.sigmoid(zf))).to(x.dtype)


def gated_rmsnorm(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    return rmsnorm(gate(x, z), scale, eps)


def sumsq(x: torch.Tensor) -> torch.Tensor:
    """The split norm's statistic: sum(x^2) over the last dim, fp32."""
    xf = x.to(torch.float32)
    return (xf * xf).sum(-1)


def apply(x: torch.Tensor, scale: torch.Tensor, ss: torch.Tensor,
          d_total: int, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(ss / d_total + eps) * scale, ss the whole row's sum."""
    inv = torch.rsqrt(ss.to(torch.float32)[..., None] / d_total + eps)
    return (x.to(torch.float32) * inv * scale.to(torch.float32)).to(x.dtype)
