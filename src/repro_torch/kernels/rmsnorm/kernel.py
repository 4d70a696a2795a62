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
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.stream.kernel import DTYPES
from repro_torch.kernels.util import block_rows, refuse_autograd

# launches of the CUDA kernel per variant, counted where the wrapper launches it
LAUNCHES = {"plain": 0, "gated": 0}


def plain(x: torch.Tensor, scale: torch.Tensor, d_logical: int, eps: float,
          z: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version on a padded (rows, width) block."""
    xf = x.to(torch.float32)
    if z is not None:
        zf = z.to(torch.float32)
        xf = (xf * (zf * torch.sigmoid(zf))).to(x.dtype).to(torch.float32)
    col = torch.arange(x.shape[-1], device=x.device) < d_logical
    xf = torch.where(col, xf, 0.0)
    ms = (xf * xf).sum(-1, keepdim=True) / d_logical
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
    return lib, fn


def _check(x: torch.Tensor, z: torch.Tensor | None, scale: torch.Tensor,
           d_logical: int) -> None:
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError(
            f"rmsnorm kernel needs a contiguous (rows, width) tensor, got "
            f"shape {tuple(x.shape)} strides {x.stride()}")
    if z is not None and (z.shape != x.shape or z.dtype != x.dtype
                          or z.device != x.device or not z.is_contiguous()):
        raise ValueError("rmsnorm gate z must be contiguous and share shape, "
                         "dtype and device with x")
    if scale.shape != x.shape[-1:] or scale.device != x.device:
        raise ValueError(f"rmsnorm scale must be ({x.shape[-1]},) on "
                         f"{x.device}, got {tuple(scale.shape)} on "
                         f"{scale.device}")
    if not 0 < d_logical <= x.shape[-1]:
        raise ValueError(f"d_logical {d_logical} outside (0, {x.shape[-1]}]")


def _run(variant: str, x: torch.Tensor, z: torch.Tensor | None,
         scale: torch.Tensor, d_logical: int, eps: float,
         brows: int | None) -> torch.Tensor:
    _check(x, z, scale, d_logical)
    if x.device.type == "cpu":
        return plain(x, scale, d_logical, eps, z)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm kernel needs CUDA tensors, got {x.device}")
    refuse_autograd("rmsnorm", "repro_torch.models.blocks.RMSNormFn", x, z,
                    scale)
    if x.dtype not in DTYPES:
        raise TypeError(f"rmsnorm kernel supports {list(DTYPES)}, got {x.dtype}")
    if x.shape[-1] * x.element_size() % 16:
        raise ValueError(f"rmsnorm kernel needs rows of whole 16-B vectors, "
                         f"got width {x.shape[-1]} of {x.dtype}")
    from repro_torch.kernels import _build

    rows, width = x.shape
    s = scale if scale.dtype == x.dtype else scale.to(torch.float32)
    s = s.contiguous()
    out = torch.empty_like(x)
    lib, fn = _entry()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = fn(x.device.index, DTYPES[x.dtype], DTYPES[s.dtype],
              int(z is not None),
              x.data_ptr(), None if z is None else z.data_ptr(), s.data_ptr(),
              out.data_ptr(), rows, width, int(brows or block_rows(rows)),
              int(d_logical), float(eps), stream)
    _build.check(lib, code, f"rmsnorm_launch({variant})")
    LAUNCHES[variant] += 1
    return out


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
