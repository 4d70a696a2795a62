"""2-D 5-point Jacobi sweep (paper SS2.3) on Hopper, with its plain version.

``sweep(src, dst, n_cols=M)`` writes one sweep of the pitched (N, width)
grid ``src`` into ``dst``: interior points 1 <= i <= N-2, 1 <= j <= M-2 get
(above + below + left + right) * 0.25, summed in that order in fp32 with
one rounding to the array dtype; every other point, including the padding
columns M..width-1, is copied.  On CUDA tensors it launches
``csrc/jacobi.cu`` (reading the grid in place, no shifted copies) and counts
the launch in ``LAUNCHES``; on CPU tensors it runs the plain PyTorch
version (``plain``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.stream.kernel import DTYPES
from repro_torch.kernels.util import block_rows, overlaps, trace

# launches of the CUDA kernel, counted where the wrapper launches it
LAUNCHES = {"jacobi": 0}


def plain(src: torch.Tensor, dst: torch.Tensor, n_cols: int) -> torch.Tensor:
    """The plain PyTorch version of one sweep: writes ``dst``, returns it."""
    dst.copy_(src)
    if src.shape[0] > 2 and n_cols > 2:
        s = src.to(torch.float32)
        inner = (s[:-2, 1:n_cols - 1] + s[2:, 1:n_cols - 1]
                 + s[1:-1, :n_cols - 2] + s[1:-1, 2:n_cols]) * 0.25
        dst[1:-1, 1:n_cols - 1] = inner.to(dst.dtype)
    return dst


@functools.cache
def _entry():
    from repro_torch.kernels import _build

    lib = _build.library("jacobi")
    fn = lib.jacobi_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(src: torch.Tensor, dst: torch.Tensor, n_cols: int) -> None:
    if src.ndim != 2 or src.stride(1) != 1 or src.stride(0) < src.shape[1]:
        raise ValueError(
            f"jacobi needs an (N, width) grid with unit column stride, got "
            f"shape {tuple(src.shape)} strides {src.stride()}")
    if (dst.shape != src.shape or dst.stride() != src.stride()
            or dst.dtype != src.dtype or dst.device != src.device):
        raise ValueError("jacobi src and dst must share shape, strides, "
                         "dtype and device")
    if not 1 <= n_cols <= src.shape[1]:
        raise ValueError(f"n_cols {n_cols} outside [1, {src.shape[1]}]")
    if overlaps(src, dst):
        raise ValueError("jacobi src and dst overlap")


def sweep(src: torch.Tensor, dst: torch.Tensor, *, n_cols: int,
          brows: int | None = None) -> torch.Tensor:
    """One sweep of ``src`` into ``dst`` (returned); see the module doc."""
    _check(src, dst, n_cols)
    trace("launch", name="jacobi")
    if src.device.type == "cpu":
        return plain(src, dst, n_cols)
    if src.device.type != "cuda":
        raise ValueError(f"jacobi kernel needs CUDA tensors, got {src.device}")
    if src.dtype not in DTYPES:
        raise TypeError(f"jacobi kernel supports {list(DTYPES)}, got {src.dtype}")
    from repro_torch.kernels import _build

    n_rows, width = src.shape
    brows = brows or block_rows(max(n_rows - 2, 1))
    lib, fn = _entry()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    code = fn(src.device.index, DTYPES[src.dtype], src.data_ptr(),
              dst.data_ptr(), n_rows, width, n_cols, src.stride(0),
              int(brows), stream)
    _build.check(lib, code, "jacobi_launch")
    LAUNCHES["jacobi"] += 1
    return dst
