"""McCalpin STREAM kernels (paper SS2.1) on Hopper, with their plain versions.

copy:  C = A          scale: B = s*C
add:   C = A + B      triad: A = B + s*C

The wrappers (``copy2d`` ...) take (rows, width) tensors laid out by the
planner.  On CUDA tensors they launch ``csrc/stream.cu`` and count the
launch in ``LAUNCHES``; on CPU tensors they return the plain PyTorch
version (``plain``), which computes the same function: inputs widened to
fp32, one rounded multiply and add, and one rounding to the array dtype.
The scalar ``s`` is rounded to the array dtype first, as the TPU kernel
casts its scalar operand (``repro.kernels.stream.kernel._call``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.util import block_rows, overlaps

# launches of each CUDA kernel, counted where the wrapper launches it
LAUNCHES = {"copy": 0, "scale": 0, "add": 0, "triad": 0}

# op and dtype codes of csrc/stream.cu
OPS = {"copy": 0, "scale": 1, "add": 2, "triad": 3, "vtriad": 4}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def round_scalar(s: float, dtype: torch.dtype) -> float:
    """``s`` rounded to ``dtype`` (exact in fp32 for fp32 and bf16)."""
    return float(torch.tensor(float(s), dtype=dtype))


def plain(op: str, ins, s: float | None = None) -> torch.Tensor:
    """The plain PyTorch version of STREAM ``op`` on the same inputs."""
    dtype = ins[0].dtype
    x = [t.to(torch.float32) for t in ins]
    if op == "copy":
        y = x[0]
    elif op == "scale":
        y = x[0] * round_scalar(s, dtype)
    elif op == "add":
        y = x[0] + x[1]
    elif op == "triad":
        y = x[0] + x[1] * round_scalar(s, dtype)
    else:
        raise ValueError(f"unknown STREAM op {op!r}")
    return y.to(dtype, copy=True)


@functools.cache
def _entry():
    from repro_torch.kernels import _build

    lib = _build.library("stream")
    fn = lib.stream_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_float, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def check_out(out: torch.Tensor, ins) -> None:
    """Raise unless ``out`` shares shape, strides, dtype and device with
    the inputs and overlaps none of them."""
    x = ins[0]
    if (out.shape != x.shape or out.stride() != x.stride()
            or out.dtype != x.dtype or out.device != x.device):
        raise ValueError("stream kernel out must share shape, strides, dtype "
                         "and device with the inputs")
    if any(overlaps(out, t) for t in ins):
        raise ValueError("stream kernel out overlaps an input")


def launch_cuda(op: str, ins, s: float | None, brows: int | None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``csrc/stream.cu`` for ``op`` on CUDA tensors; writes ``out``
    when given (same shape, strides, dtype and device as the inputs, no
    overlap with them), else a new tensor laid out with the inputs' row
    pitch.  Returns the output."""
    from repro_torch.kernels import _build

    x = ins[0]
    if x.device.type != "cuda":
        raise ValueError(f"stream kernel needs CUDA tensors, got {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"stream kernel supports {list(DTYPES)}, got {x.dtype}")
    if x.ndim != 2 or x.stride(1) != 1 or x.stride(0) < x.shape[1]:
        raise ValueError(
            f"stream kernel needs (rows, width) tensors with unit column "
            f"stride, got shape {tuple(x.shape)} strides {x.stride()}")
    for t in ins[1:]:
        if (t.device != x.device or t.dtype != x.dtype or t.shape != x.shape
                or t.stride() != x.stride()):
            raise ValueError("stream kernel inputs must share device, dtype, "
                             "shape and strides")
    rows, width = x.shape
    pitch = x.stride(0)
    if out is None:
        out = torch.empty_strided((rows, width), (pitch, 1), dtype=x.dtype,
                                  device=x.device)
    else:
        check_out(out, ins)
    brows = brows or block_rows(rows)
    ptrs = [t.data_ptr() for t in ins] + [None] * (3 - len(ins))
    lib, fn = _entry()
    scalar = 0.0 if s is None else round_scalar(s, x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = fn(x.device.index, OPS[op], DTYPES[x.dtype], *ptrs,
              out.data_ptr(), scalar, rows, width, pitch, int(brows), stream)
    _build.check(lib, code, f"stream_launch({op})")
    return out


def _run(op: str, ins, s, brows) -> torch.Tensor:
    if ins[0].device.type == "cpu":
        return plain(op, ins, s)
    out = launch_cuda(op, ins, s, brows)
    LAUNCHES[op] += 1
    return out


def copy2d(a: torch.Tensor, *, brows: int | None = None) -> torch.Tensor:
    return _run("copy", [a], None, brows)


def scale2d(c: torch.Tensor, s: float, *, brows: int | None = None) -> torch.Tensor:
    return _run("scale", [c], s, brows)


def add2d(a: torch.Tensor, b: torch.Tensor, *,
          brows: int | None = None) -> torch.Tensor:
    return _run("add", [a, b], None, brows)


def triad2d(b: torch.Tensor, c: torch.Tensor, s: float, *,
            brows: int | None = None) -> torch.Tensor:
    return _run("triad", [b, c], s, brows)
