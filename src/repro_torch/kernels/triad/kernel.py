"""Schoenauer vector triad A = B + C * D (paper SS2.2) on Hopper.

Three read streams and one write stream.  The kernel is the ``vtriad`` op of
``csrc/stream.cu`` (one streaming kernel serves all five STREAM-like ops);
what matters is the layout of its four streams, owned by ``ops.py``:
aligned planner tiles, or each stream at its own element phase.

On CUDA tensors ``triad2d`` launches the kernel and counts the launch in
``LAUNCHES``; on CPU tensors it returns the plain PyTorch version
(``plain``): inputs widened to fp32, one rounded multiply and add, one
rounding to the array dtype.  Either writes into a caller's ``out`` tile
when one is given (the segmented triad writes each segment in place).
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
            brows: int | None = None,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """A = B + C * D on (rows, width) tiles; writes ``out`` when given
    (checked as ``stream.kernel.launch_cuda`` checks it), else a new
    tensor; returns it."""
    if b.device.type == "cpu":
        if out is None:
            return plain(b, c, d)
        stream_kernel.check_out(out, [b, c, d])
        return out.copy_(plain(b, c, d))
    out = stream_kernel.launch_cuda("vtriad", [b, c, d], None, brows, out)
    LAUNCHES["triad"] += 1
    return out
