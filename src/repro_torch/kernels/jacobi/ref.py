"""Plain PyTorch oracle for the 2-D Jacobi sweep (counterpart of
``repro.kernels.jacobi.ref``: each operation in the array dtype)."""
from __future__ import annotations

import torch


def jacobi_step(src: torch.Tensor) -> torch.Tensor:
    """One 5-point sweep; boundary cells are copied through."""
    out = src.clone()
    out[1:-1, 1:-1] = (
        src[:-2, 1:-1] + src[2:, 1:-1] + src[1:-1, :-2] + src[1:-1, 2:]
    ) * torch.as_tensor(0.25, dtype=src.dtype, device=src.device)
    return out


def jacobi_sweeps(src: torch.Tensor, iters: int) -> torch.Tensor:
    for _ in range(iters):
        src = jacobi_step(src)
    return src
