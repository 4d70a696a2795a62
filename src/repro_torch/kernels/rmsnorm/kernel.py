"""RMSNorm on Hopper, plain and gated, with its plain version.

  * ``rmsnorm2d(x, scale, d_logical=)``: y = x * rsqrt(mean x^2 + eps) *
    scale over the first ``d_logical`` columns of a (rows, width) tensor;
  * ``gated_rmsnorm2d(x, z, scale, d_logical=)``: the same on
    g = x * silu(z), rounded to x's dtype before the statistics.

On CUDA tensors both launch ``csrc/rmsnorm.cu`` (one kernel, the gate and
the dtype template parameters) and count the launch in ``LAUNCHES``; the
kernel's output has no autograd history, so with grad mode on an input that
requires grad raises (``models.blocks.RMSNormFn`` differentiates it); on CPU
tensors they return the plain PyTorch version (``plain``), which computes
what the TPU kernel computes on the padded block: fp32 statistics over the
logical columns (padding masked by column index), one rounding to x's
dtype.  The kernel sums in another order, so the two agree to a tolerance.
The kernel reads the scale vector in x's dtype, or in fp32: a scale of
another dtype is widened to fp32 first (exact for fp32 and bf16).

The split norm, for a row whose columns are cut over the ranks of a mesh,
runs the same kernel in two passes on a rank's block:

  * ``sumsq2d(x, d_logical=)`` / ``gated_sumsq2d(x, z, d_logical=)``: each
    row's fp32 sum of squares over the block's logical columns (rows,);
  * ``apply2d(x, scale, ss, d_logical=, d_total=)`` / ``gated_apply2d``:
    the block normalised by ``rsqrt(ss / d_total + eps)``, ``ss`` the sum
    of the ranks' statistics and ``d_total`` the whole row's width.

Summed over blocks that cut a row, the stats pass and the apply pass give
the one-pass norm of the whole row (``plain_sumsq`` and ``plain(...,
ss=, d_total=)`` are their plain versions).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.stream.kernel import DTYPES
from repro_torch.kernels.util import block_rows, refuse_autograd

# launches of the CUDA kernel per variant, counted where the wrapper
# launches it: the one-pass norms, and the split norm's stats and apply
# passes
LAUNCHES = {"plain": 0, "gated": 0, "plain.sumsq": 0, "gated.sumsq": 0,
            "plain.apply": 0, "gated.apply": 0}

_MODES = {"sumsq": 1, "apply": 2}


def _rows_f32(x: torch.Tensor, d_logical: int,
              z: torch.Tensor | None) -> torch.Tensor:
    """x (or x * silu(z), rounded to x's dtype) in fp32, the padding
    columns zeroed."""
    xf = x.to(torch.float32)
    if z is not None:
        zf = z.to(torch.float32)
        xf = (xf * (zf * torch.sigmoid(zf))).to(x.dtype).to(torch.float32)
    col = torch.arange(x.shape[-1], device=x.device) < d_logical
    return torch.where(col, xf, 0.0)


def plain_sumsq(x: torch.Tensor, d_logical: int,
                z: torch.Tensor | None = None) -> torch.Tensor:
    """The stats pass's plain version: each row's fp32 sum of squares over
    the first ``d_logical`` columns of a padded (rows, width) block."""
    xf = _rows_f32(x, d_logical, z)
    return (xf * xf).sum(-1)


def plain(x: torch.Tensor, scale: torch.Tensor, d_logical: int, eps: float,
          z: torch.Tensor | None = None, *, ss: torch.Tensor | None = None,
          d_total: int | None = None) -> torch.Tensor:
    """The plain PyTorch version on a padded (rows, width) block: the
    one-pass norm, or with ``ss`` (rows,) the apply pass, which normalises
    by ``rsqrt(ss / d_total + eps)``."""
    xf = _rows_f32(x, d_logical, z)
    if ss is None:
        ms = (xf * xf).sum(-1, keepdim=True) / d_logical
    else:
        ms = ss.to(torch.float32)[:, None] / d_total
    y = xf * torch.rsqrt(ms + eps) * scale.to(torch.float32)
    return y.to(x.dtype)


@functools.cache
def _entry():
    from repro_torch.kernels import _build

    lib = _build.library("rmsnorm")
    fn = lib.rmsnorm_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    split = lib.rmsnorm_split_launch
    split.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                      ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
                      ctypes.c_void_p]
    split.restype = ctypes.c_int
    return lib, fn, split


def _check(x: torch.Tensor, z: torch.Tensor | None,
           scale: torch.Tensor | None, d_logical: int) -> None:
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError(
            f"rmsnorm kernel needs a contiguous (rows, width) tensor, got "
            f"shape {tuple(x.shape)} strides {x.stride()}")
    if z is not None and (z.shape != x.shape or z.dtype != x.dtype
                          or z.device != x.device or not z.is_contiguous()):
        raise ValueError("rmsnorm gate z must be contiguous and share shape, "
                         "dtype and device with x")
    if scale is not None and (scale.shape != x.shape[-1:]
                              or scale.device != x.device):
        raise ValueError(f"rmsnorm scale must be ({x.shape[-1]},) on "
                         f"{x.device}, got {tuple(scale.shape)} on "
                         f"{scale.device}")
    if not 0 < d_logical <= x.shape[-1]:
        raise ValueError(f"d_logical {d_logical} outside (0, {x.shape[-1]}]")


def _cuda_ready(function: str, x: torch.Tensor, *tensors) -> bool:
    """False for a CPU ``x`` (the caller runs the plain version); raises
    for a tensor the kernel does not take (``function`` names the autograd
    Function that differentiates the call)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm kernel needs CUDA tensors, got {x.device}")
    refuse_autograd("rmsnorm", f"repro_torch.models.blocks.{function}", x,
                    *tensors)
    if x.dtype not in DTYPES:
        raise TypeError(f"rmsnorm kernel supports {list(DTYPES)}, got {x.dtype}")
    if x.shape[-1] * x.element_size() % 16:
        raise ValueError(f"rmsnorm kernel needs rows of whole 16-B vectors, "
                         f"got width {x.shape[-1]} of {x.dtype}")
    return True


def _scale_arg(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    s = scale if scale.dtype == x.dtype else scale.to(torch.float32)
    return s.contiguous()


def _run(variant: str, x: torch.Tensor, z: torch.Tensor | None,
         scale: torch.Tensor, d_logical: int, eps: float,
         brows: int | None) -> torch.Tensor:
    _check(x, z, scale, d_logical)
    if not _cuda_ready("RMSNormFn", x, z, scale):
        return plain(x, scale, d_logical, eps, z)
    from repro_torch.kernels import _build

    rows, width = x.shape
    s = _scale_arg(scale, x)
    out = torch.empty_like(x)
    lib, fn, _ = _entry()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = fn(x.device.index, DTYPES[x.dtype], DTYPES[s.dtype],
              int(z is not None),
              x.data_ptr(), None if z is None else z.data_ptr(), s.data_ptr(),
              out.data_ptr(), rows, width, int(brows or block_rows(rows)),
              int(d_logical), float(eps), stream)
    _build.check(lib, code, f"rmsnorm_launch({variant})")
    LAUNCHES[variant] += 1
    return out


def _run_split(variant: str, mode: str, x: torch.Tensor,
               z: torch.Tensor | None, scale: torch.Tensor | None,
               ss: torch.Tensor | None, d_logical: int, d_total: int,
               eps: float, brows: int | None) -> torch.Tensor:
    """One pass of the split norm: ``mode`` "sumsq" returns the (rows,)
    fp32 statistic, "apply" the normalised block."""
    _check(x, z, scale, d_logical)
    rows, width = x.shape
    if ss is not None and (ss.shape != (rows,) or ss.dtype != torch.float32
                           or ss.device != x.device):
        raise ValueError(f"rmsnorm split statistic must be ({rows},) fp32 on "
                         f"{x.device}, got {tuple(ss.shape)} {ss.dtype} on "
                         f"{ss.device}")
    if not d_logical <= d_total:
        raise ValueError(f"d_total {d_total} below d_logical {d_logical}")
    if not _cuda_ready("SumSquaresFn" if mode == "sumsq" else "ApplyNormFn",
                       x, z, scale, ss):
        if mode == "sumsq":
            return plain_sumsq(x, d_logical, z)
        return plain(x, scale, d_logical, eps, z, ss=ss, d_total=d_total)
    from repro_torch.kernels import _build

    s = None if scale is None else _scale_arg(scale, x)
    if mode == "sumsq":
        ss = torch.empty((rows,), dtype=torch.float32, device=x.device)
        out = None
    else:
        ss = ss.contiguous()
        out = torch.empty_like(x)
    lib, _, fn = _entry()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = fn(x.device.index, DTYPES[x.dtype],
              DTYPES[x.dtype if s is None else s.dtype], int(z is not None),
              _MODES[mode], x.data_ptr(),
              None if z is None else z.data_ptr(),
              None if s is None else s.data_ptr(), ss.data_ptr(),
              None if out is None else out.data_ptr(), rows, width,
              int(brows or block_rows(rows)), int(d_logical), int(d_total),
              float(eps), stream)
    _build.check(lib, code, f"rmsnorm_split_launch({variant}.{mode})")
    LAUNCHES[f"{variant}.{mode}"] += 1
    return ss if mode == "sumsq" else out


def rmsnorm2d(x: torch.Tensor, scale: torch.Tensor, *, d_logical: int,
              eps: float = 1e-6, brows: int | None = None) -> torch.Tensor:
    """RMSNorm of x (rows, width) over its first ``d_logical`` columns; a
    CTA walks ``brows`` rows."""
    return _run("plain", x, None, scale, d_logical, eps, brows)


def gated_rmsnorm2d(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, *,
                    d_logical: int, eps: float = 1e-6,
                    brows: int | None = None) -> torch.Tensor:
    """RMSNorm of x * silu(z) (rows, width), the gate rounded to x's dtype
    first; a CTA walks ``brows`` rows."""
    return _run("gated", x, z, scale, d_logical, eps, brows)


def sumsq2d(x: torch.Tensor, *, d_logical: int,
            brows: int | None = None) -> torch.Tensor:
    """The split norm's stats pass: each row's fp32 sum of squares over the
    first ``d_logical`` columns of x (rows, width), (rows,)."""
    return _run_split("plain", "sumsq", x, None, None, None, d_logical,
                      d_logical, 0.0, brows)


def gated_sumsq2d(x: torch.Tensor, z: torch.Tensor, *, d_logical: int,
                  brows: int | None = None) -> torch.Tensor:
    """The stats pass on x * silu(z), the gate rounded to x's dtype first."""
    return _run_split("gated", "sumsq", x, z, None, None, d_logical,
                      d_logical, 0.0, brows)


def apply2d(x: torch.Tensor, scale: torch.Tensor, ss: torch.Tensor, *,
            d_logical: int, d_total: int, eps: float = 1e-6,
            brows: int | None = None) -> torch.Tensor:
    """The split norm's apply pass: x * rsqrt(ss / d_total + eps) * scale
    over the first ``d_logical`` columns of x (rows, width), ``ss`` (rows,)
    the summed statistic of rows ``d_total`` wide."""
    return _run_split("plain", "apply", x, None, scale, ss, d_logical,
                      d_total, eps, brows)


def gated_apply2d(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                  ss: torch.Tensor, *, d_logical: int, d_total: int,
                  eps: float = 1e-6, brows: int | None = None
                  ) -> torch.Tensor:
    """The apply pass on x * silu(z), the gate rounded to x's dtype first."""
    return _run_split("gated", "apply", x, z, scale, ss, d_logical, d_total,
                      eps, brows)
