"""Schoenauer vector triad A = B + C * D (paper SS2.2) on Hopper.

Three read streams and one write stream.  The kernel is the ``vtriad`` op of
``csrc/stream.cu`` (one streaming kernel serves all five STREAM-like ops);
what matters is the layout of its four streams, owned by ``ops.py``:
aligned planner tiles, or each stream at its own element phase.

On CUDA tensors ``triad2d`` launches the kernel and counts the launch in
``LAUNCHES``; on CPU tensors it returns the plain PyTorch version
(``plain``): inputs widened to fp32, one rounded multiply and add, one
rounding to the array dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.stream import kernel as stream_kernel

# launches of the CUDA kernel, counted where the wrapper launches it
LAUNCHES = {"triad": 0}


def plain(b: torch.Tensor, c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the vector triad on the same inputs."""
    x, y, z = (t.to(torch.float32) for t in (b, c, d))
    return (x + y * z).to(b.dtype, copy=True)


def triad2d(b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
            brows: int | None = None) -> torch.Tensor:
    if b.device.type == "cpu":
        return plain(b, c, d)
    out = stream_kernel.launch_cuda("vtriad", [b, c, d], None, brows)
    LAUNCHES["triad"] += 1
    return out
