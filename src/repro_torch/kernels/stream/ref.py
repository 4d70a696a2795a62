"""Plain PyTorch oracles for the STREAM kernels (counterpart of
``repro.kernels.stream.ref``: each operation in the array dtype)."""
from __future__ import annotations

import torch


def copy(a: torch.Tensor) -> torch.Tensor:
    return a.clone()


def scale(c: torch.Tensor, s: float) -> torch.Tensor:
    return torch.as_tensor(s, dtype=c.dtype, device=c.device) * c


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def triad(b: torch.Tensor, c: torch.Tensor, s: float) -> torch.Tensor:
    return b + torch.as_tensor(s, dtype=b.dtype, device=b.device) * c
