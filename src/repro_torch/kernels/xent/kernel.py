"""Per-token cross-entropy on Hopper, and the partials of one vocab shard,
with their plain versions.

``xent_nll(logits, labels, logical_v=)``: the NLL of each row of a
(rows, width) logits tensor whose first ``logical_v`` columns are the
vocabulary, by online softmax over the row.

On CUDA tensors it launches ``csrc/xent.cu`` and counts the launch in
``LAUNCHES``.  The kernel reads the logits where they lie: any width (a
row need not be a whole number of 16-B vectors) and any storage offset,
so a contiguous view is never copied.  The kernel's output has no autograd
history, so with grad mode on, logits that require grad raise
(``models.transformer.XentFn`` differentiates the loss).  On CPU tensors it
returns the plain PyTorch version (``plain``), which computes what the TPU
kernel computes: logits cast to fp32 before the padding columns are masked
to -1e30, exps of masked values counted as 0, ``lse = log(max(l, 1e-30)) +
m``, and the label's logit taken by the masked-sum rule (a label in the
padding picks -1e30, one past the row picks 0).  The kernel sums in another order, with a faster exp
(``__expf``), so the two agree to a tolerance.

``xent_partials(logits, labels, vl=, off=, logical_v=)``: the online-softmax
partials ``(m, l, ll)`` of each row of one vocab shard (B12), whose local
column c is global column ``c + off``; columns past the shard's own width
``vl`` or the global vocabulary ``logical_v`` are masked, and the label's
logit counts only inside the valid columns (a padded column's global index
can alias another shard's label).  The same dispatch: the kernel on CUDA
tensors (counted in ``LAUNCHES["xent.partial"]``), ``plain_partials`` on CPU
tensors.  ``m`` and ``ll`` are exact (a max, and a single term); ``l`` sums
in another order than the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.stream.kernel import DTYPES
from repro_torch.kernels.util import refuse_autograd, trace

# launches of the CUDA kernel, counted where the wrapper launches it
LAUNCHES = {"xent": 0, "xent.partial": 0}

MASK = -1e30    # value of a masked column
DEAD = -1e29    # at or below: contributes no exp


def plain(logits: torch.Tensor, labels: torch.Tensor,
          logical_v: int) -> torch.Tensor:
    """The plain PyTorch version: per-row NLL (rows,) in fp32."""
    x = logits.to(torch.float32)
    v = x.shape[-1]
    if logical_v < v:
        col = torch.arange(v, device=x.device)
        x = torch.where(col < logical_v, x, MASK)
    m = x.amax(-1)
    l = torch.where(x <= DEAD, 0.0, torch.exp(x - m[:, None])).sum(-1)
    lse = torch.log(torch.clamp(l, min=1e-30)) + m
    lab = labels.to(torch.int64)
    inside = (lab >= 0) & (lab < v)
    ll = torch.gather(x, 1, torch.where(inside, lab, 0)[:, None])[:, 0]
    return lse - torch.where(inside, ll, 0.0)


def plain_partials(logits: torch.Tensor, labels: torch.Tensor, *, vl: int,
                   off: int, logical_v: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of B12: per-row (m, l, ll), each (rows,)
    fp32, of a vocab shard at global column offset ``off``."""
    x = logits.to(torch.float32)
    col = torch.arange(x.shape[-1], device=x.device)
    valid = (col < vl) & (col + off < logical_v)
    x = torch.where(valid, x, MASK)
    m = torch.clamp(x.amax(-1), min=MASK)
    l = torch.where(x <= DEAD, 0.0, torch.exp(x - m[:, None])).sum(-1)
    hit = valid & (col + off == labels.to(torch.int64)[:, None])
    ll = torch.where(hit, x, 0.0).sum(-1)
    return m, l, ll


@functools.cache
def _entry():
    from repro_torch.kernels import _build

    lib = _build.library("xent")
    fn = lib.xent_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _partial_entry():
    from repro_torch.kernels import _build

    lib = _build.library("xent")
    fn = lib.xent_partial_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_logits(logits: torch.Tensor, labels: torch.Tensor) -> None:
    if logits.ndim != 2 or not logits.is_contiguous():
        raise ValueError(
            f"xent kernel needs contiguous (rows, width) logits, got shape "
            f"{tuple(logits.shape)} strides {logits.stride()}")
    rows = logits.shape[0]
    if labels.shape != (rows,) or labels.device != logits.device:
        raise ValueError(f"xent labels must be ({rows},) on {logits.device}, "
                         f"got {tuple(labels.shape)} on {labels.device}")


def _check_cuda(logits: torch.Tensor) -> None:
    if logits.device.type != "cuda":
        raise ValueError(f"xent kernel needs CUDA tensors, got {logits.device}")
    refuse_autograd("xent", "repro_torch.models.transformer.XentFn", logits)
    if logits.dtype not in DTYPES:
        raise TypeError(f"xent kernel supports {list(DTYPES)}, got "
                        f"{logits.dtype}")


def xent_nll(logits: torch.Tensor, labels: torch.Tensor, *, logical_v: int,
             brows: int = 1) -> torch.Tensor:
    """NLL (rows,) fp32 of contiguous (rows, width) logits against (rows,)
    integer labels, over the first ``logical_v`` columns; a CTA walks
    ``brows`` rows."""
    _check_logits(logits, labels)
    rows, width = logits.shape
    if not 0 < logical_v <= width:
        raise ValueError(f"logical_v {logical_v} outside (0, {width}]")
    if logits.device.type == "cpu":
        return plain(logits, labels, logical_v)
    _check_cuda(logits)
    from repro_torch.kernels import _build

    lab = labels.to(torch.int32).contiguous()
    out = torch.empty(rows, dtype=torch.float32, device=logits.device)
    lib, fn = _entry()
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    code = fn(logits.device.index, DTYPES[logits.dtype], logits.data_ptr(),
              lab.data_ptr(), out.data_ptr(), rows, width, int(brows),
              int(logical_v), stream)
    _build.check(lib, code, "xent_launch")
    LAUNCHES["xent"] += 1
    return out


def xent_partials(logits: torch.Tensor, labels: torch.Tensor, *, vl: int,
                  off: int, logical_v: int, brows: int = 1
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row online-softmax partials ``(m, l, ll)``, each (rows,) fp32, of
    one vocab shard: contiguous (rows, width) logits whose first ``vl``
    columns are the shard (global columns ``off`` onwards) and the rest
    local padding, integer *global* labels, the global vocabulary
    ``logical_v``; a CTA walks ``brows`` rows."""
    _check_logits(logits, labels)
    rows, width = logits.shape
    if not 0 < vl <= width:
        raise ValueError(f"vl {vl} outside (0, {width}]")
    if off < 0 or logical_v <= 0:
        raise ValueError(f"need off >= 0 and logical_v > 0, got off {off} "
                         f"logical_v {logical_v}")
    trace("launch", name="xent.partial")
    if logits.device.type == "cpu":
        return plain_partials(logits, labels, vl=vl, off=off,
                              logical_v=logical_v)
    _check_cuda(logits)
    from repro_torch.kernels import _build

    lab = labels.to(torch.int32).contiguous()
    m, l, ll = (torch.empty(rows, dtype=torch.float32, device=logits.device)
                for _ in range(3))
    lib, fn = _partial_entry()
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    code = fn(logits.device.index, DTYPES[logits.dtype], logits.data_ptr(),
              lab.data_ptr(), m.data_ptr(), l.data_ptr(), ll.data_ptr(), rows,
              width, int(brows), int(vl), int(off), int(logical_v), stream)
    _build.check(lib, code, "xent_partial_launch")
    LAUNCHES["xent.partial"] += 1
    return m, l, ll
