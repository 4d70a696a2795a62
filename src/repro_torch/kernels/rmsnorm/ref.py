"""Plain PyTorch oracles for the RMSNorm kernels (counterpart of
``repro.kernels.rmsnorm.ref``)."""
from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.to(torch.float32)).to(x.dtype)


def gated_rmsnorm(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    zf = z.to(torch.float32)
    g = (x.to(torch.float32) * (zf * torch.sigmoid(zf))).to(x.dtype)
    return rmsnorm(g, scale, eps)
