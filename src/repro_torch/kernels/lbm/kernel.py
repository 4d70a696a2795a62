"""D3Q19 BGK collision (paper SS2.4) on Hopper, in two layouts, with its
plain version.

  * ``collide_soa(f, omega)``:  f stored (Q, S_pad) -- every direction its
    own contiguous stream (the paper's IJKv);
  * ``collide_ivjk(f, omega)``: f stored (S_pad/L, Q, L) -- directions
    interleaved every L sites (the paper's IvJK), L the plan's vector unit.

On CUDA tensors both launch ``csrc/lbm.cu`` (one kernel, the layout a
template parameter) and count the launch in ``LAUNCHES``; on CPU tensors
they return the plain PyTorch version (``plain``), which does the same
operations in the same order, one tensor op per term: fp32 throughout, one
rounding to the array dtype.  The weights and omega are rounded to the
array dtype first, as the TPU kernel takes them as dtype operands.

A padded site holds zeros, so its rho is 0 and its velocity NaN: the
padding of the output is garbage in both versions, and callers slice it off
before any check.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.layout import CTA_THREADS
from repro_torch.kernels.lbm.ref import C, Q, W
from repro_torch.kernels.stream.kernel import DTYPES, round_scalar
from repro_torch.kernels.util import overlaps, trace

# launches of the CUDA kernel per layout, counted where the wrapper launches it
LAUNCHES = {"soa": 0, "ivjk": 0}

# layout codes of csrc/lbm.cu, and the axis that holds the 19 directions
LAYOUTS = {"soa": 0, "ivjk": 1}
V_AXIS = {"soa": 0, "ivjk": 1}

# fp32 operations a site, as csrc/lbm.cu evaluates the collision: rho 18,
# momenta 30, u 3, usq 5 and 1.5*usq 1, then per direction cu 5, the
# polynomial 6, feq 2 and the relaxation 3.
OPS_PER_SITE = 18 + 30 + 3 + 5 + 1 + Q * (5 + 6 + 2 + 3)


def weights(dtype: torch.dtype) -> list[float]:
    """The D3Q19 weights rounded to ``dtype``."""
    return [round_scalar(w, dtype) for w in W]


def plain(f: torch.Tensor, omega: float, layout: str) -> torch.Tensor:
    """The plain PyTorch version of the collision on ``f`` in ``layout``,
    in csrc/lbm.cu's evaluation order."""
    axis = V_AXIS[layout]
    x = f.to(torch.float32)
    fv = [x.select(axis, v) for v in range(Q)]
    rho = fv[0]
    for v in range(1, Q):
        rho = rho + fv[v]
    u = []
    for k in range(3):
        m = torch.zeros_like(rho)
        for v in range(Q):
            if C[v][k] == 1:
                m = m + fv[v]
            elif C[v][k] == -1:
                m = m - fv[v]
        u.append(m / rho)
    ux, uy, uz = u
    usq15 = 1.5 * ((ux * ux + uy * uy) + uz * uz)
    w = weights(f.dtype)
    om = round_scalar(omega, f.dtype)
    out = torch.empty_like(f)
    for v in range(Q):
        cx, cy, cz = (float(c) for c in C[v])
        cu = (cx * ux + cy * uy) + cz * uz
        poly = ((1.0 + 3.0 * cu) + (4.5 * cu) * cu) - usq15
        feq = (w[v] * rho) * poly
        out.select(axis, v).copy_(fv[v] - om * (fv[v] - feq))
    return out


@functools.cache
def _entry():
    from repro_torch.kernels import _build

    lib = _build.library("lbm")
    fn = lib.lbm_collide
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                   ctypes.c_float, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(f: torch.Tensor, out: torch.Tensor | None, layout: str) -> None:
    axis = V_AXIS[layout]
    if f.ndim != axis + 2 or f.shape[axis] != Q or not f.is_contiguous():
        want = "(Q, S_pad)" if layout == "soa" else "(S_pad/L, Q, L)"
        raise ValueError(
            f"lbm {layout} collision needs a contiguous {want} tensor with "
            f"Q = {Q}, got shape {tuple(f.shape)} strides {f.stride()}")
    if out is None:
        return
    if (out.shape != f.shape or out.stride() != f.stride()
            or out.dtype != f.dtype or out.device != f.device):
        raise ValueError("lbm out must share shape, strides, dtype and "
                         "device with f")
    if overlaps(f, out):
        raise ValueError("lbm f and out overlap")


def _collide(layout: str, f: torch.Tensor, omega: float, block_sites: int,
             out: torch.Tensor | None) -> torch.Tensor:
    _check(f, out, layout)
    trace("launch", name=f"lbm.{layout}")
    if f.device.type == "cpu":
        res = plain(f, omega, layout)
        return res if out is None else out.copy_(res)
    if f.device.type != "cuda":
        raise ValueError(f"lbm kernel needs CUDA tensors, got {f.device}")
    if f.dtype not in DTYPES:
        raise TypeError(f"lbm kernel supports {list(DTYPES)}, got {f.dtype}")
    from repro_torch.kernels import _build

    if out is None:
        out = torch.empty_like(f)
    sites = f.numel() // Q
    lanes = 1 if layout == "soa" else f.shape[2]
    w = (ctypes.c_float * Q)(*weights(f.dtype))
    lib, fn = _entry()
    stream = torch.cuda.current_stream(f.device).cuda_stream
    code = fn(f.device.index, LAYOUTS[layout], DTYPES[f.dtype], f.data_ptr(),
              out.data_ptr(), w, round_scalar(omega, f.dtype), sites, lanes,
              int(block_sites), stream)
    _build.check(lib, code, f"lbm_collide({layout})")
    LAUNCHES[layout] += 1
    return out


def collide_soa(f: torch.Tensor, omega: float, *, bs: int | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """Collision of f (Q, S_pad); a CTA takes ``bs`` sites (default one
    per thread).  Writes ``out`` when given, else a new tensor; returns it."""
    return _collide("soa", f, omega, bs or CTA_THREADS, out)


def collide_ivjk(f: torch.Tensor, omega: float, *, bsb: int | None = None,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """Collision of f (S_pad/L, Q, L); a CTA takes ``bsb`` chunks of L
    sites (default: one site per thread).  Writes ``out`` when given, else
    a new tensor; returns it."""
    lanes = f.shape[-1] if f.ndim == 3 else 1
    bsb = bsb or max(CTA_THREADS // lanes, 1)
    return _collide("ivjk", f, omega, bsb * lanes, out)
