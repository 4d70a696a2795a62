"""Plain PyTorch oracle for the vector triad (counterpart of
``repro.kernels.triad.ref``)."""
from __future__ import annotations

import torch


def triad(b: torch.Tensor, c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return b + c * d
