"""2-D 5-point Jacobi sweep (paper SS2.3) on Hopper, with its plain version.

``sweep(src, dst, n_cols=M, block=(strip, tile))`` writes one sweep of the
pitched (N, width) grid ``src`` into ``dst`` in the plan's 2-D tiles:
interior points 1 <= i <= N-2, 1 <= j <= M-2 get (above + below + left +
right) * 0.25, summed in that order in fp32 with one rounding to the array
dtype; every other point, including the padding columns M..width-1, is
copied.  ``sweep_row(above, centre, below, out,
n_cols=M)`` writes one such row from three rows that lie anywhere: a mesh
rank's boundary row, from the halo row it received and its own two edge
rows.  On CUDA tensors both launch ``csrc/jacobi.cu`` (reading the grid in
place, no shifted copies; the sweep in the plan's 2-D tiles, which needs
16-B aligned rows) and count the launch in ``LAUNCHES``; on CPU tensors
they run the plain PyTorch versions (``plain``, ``plain_row``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.layout import VEC_BYTES
from repro_torch.kernels.stream.kernel import DTYPES
from repro_torch.kernels.util import overlaps, trace

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


def plain_row(above: torch.Tensor, centre: torch.Tensor, below: torch.Tensor,
              out: torch.Tensor, n_cols: int) -> torch.Tensor:
    """The plain PyTorch version of one row: writes ``out``, returns it."""
    out.copy_(centre)
    if n_cols > 2:
        a, c, b = (t[:n_cols].to(torch.float32) for t in (above, centre, below))
        inner = (a[1:-1] + b[1:-1] + c[:-2] + c[2:]) * 0.25
        out[1:n_cols - 1] = inner.to(out.dtype)
    return out


@functools.cache
def _entry():
    from repro_torch.kernels import _build

    lib = _build.library("jacobi")
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    fn = lib.jacobi_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ptr, ptr, i64, i64, i64, i64,
                   i64, i64, ptr]
    fn.restype = ctypes.c_int
    row = lib.jacobi_row_launch
    row.argtypes = [ctypes.c_int, ctypes.c_int, ptr, ptr, ptr, ptr, i64, i64,
                    ptr]
    row.restype = ctypes.c_int
    return lib, fn, row


def aligned(t: torch.Tensor) -> bool:
    """Whether a grid's base and row pitch are whole 16-B vectors, as the
    kernel's tiles read them."""
    return (t.data_ptr() % VEC_BYTES == 0
            and t.stride(0) * t.element_size() % VEC_BYTES == 0)


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
    if not (aligned(src) and aligned(dst)):
        raise ValueError(
            f"jacobi needs 16-B aligned rows (base and row pitch), got bases "
            f"{src.data_ptr() % VEC_BYTES}, {dst.data_ptr() % VEC_BYTES} B "
            f"past 16 B and a pitch of {src.stride(0)} elements; lay the "
            f"grid out with ops.pitched")
    if overlaps(src, dst):
        raise ValueError("jacobi src and dst overlap")


def _cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"jacobi kernel needs CUDA tensors, got {t.device}")
    if t.dtype not in DTYPES:
        raise TypeError(f"jacobi kernel supports {list(DTYPES)}, got {t.dtype}")


def sweep(src: torch.Tensor, dst: torch.Tensor, *, n_cols: int,
          block: tuple[int, int]) -> torch.Tensor:
    """One sweep of ``src`` into ``dst`` (returned); see the module doc.
    ``block`` is the plan's (strip rows, tile columns), its
    ``block_shape``."""
    _check(src, dst, n_cols)
    trace("launch", name="jacobi")
    if src.device.type == "cpu":
        return plain(src, dst, n_cols)
    _cuda(src)
    from repro_torch.kernels import _build

    n_rows, width = src.shape
    strip, tile = (int(b) for b in block)
    lib, fn, _ = _entry()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    code = fn(src.device.index, DTYPES[src.dtype], src.data_ptr(),
              dst.data_ptr(), n_rows, width, n_cols, src.stride(0), strip,
              tile, stream)
    _build.check(lib, code, "jacobi_launch")
    LAUNCHES["jacobi"] += 1
    return dst


def sweep_row(above: torch.Tensor, centre: torch.Tensor, below: torch.Tensor,
              out: torch.Tensor, *, n_cols: int) -> torch.Tensor:
    """Row 1 of one sweep of the rows (``above``, ``centre``, ``below``)
    into ``out`` (returned): its columns 1..n_cols-2 swept, the rest of
    ``centre``'s width copied; ``above`` and ``below`` need only ``n_cols``
    elements.  Each row is 1-D with unit stride, at any alignment."""
    rows = (above, centre, below, out)
    if any(t.ndim != 1 or t.stride(0) != 1 for t in rows):
        raise ValueError("jacobi rows must be 1-D with unit stride, got "
                         f"shapes {[tuple(t.shape) for t in rows]}")
    if any(t.dtype != out.dtype or t.device != out.device for t in rows):
        raise ValueError("jacobi rows must share dtype and device")
    width = centre.shape[0]
    if out.shape[0] != width:
        raise ValueError(f"jacobi out row has {out.shape[0]} elements, the "
                         f"centre row {width}")
    if not 1 <= n_cols <= width or min(above.shape[0],
                                       below.shape[0]) < n_cols:
        raise ValueError(f"n_cols {n_cols} outside [1, {width}] or past the "
                         f"above/below rows")
    if any(overlaps(out, t) for t in rows[:3]):
        raise ValueError("jacobi out row overlaps an input row")
    trace("launch", name="jacobi")
    if out.device.type == "cpu":
        return plain_row(above, centre, below, out, n_cols)
    _cuda(out)
    from repro_torch.kernels import _build

    lib, _, fn = _entry()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    code = fn(out.device.index, DTYPES[out.dtype], above.data_ptr(),
              centre.data_ptr(), below.data_ptr(), out.data_ptr(), width,
              n_cols, stream)
    _build.check(lib, code, "jacobi_row_launch")
    LAUNCHES["jacobi"] += 1
    return out
