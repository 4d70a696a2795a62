"""Plain PyTorch oracle for the cross-entropy kernel (counterpart of
``repro.kernels.xent.ref``)."""
from __future__ import annotations

import torch


def xent(logits: torch.Tensor, labels: torch.Tensor, *,
         logical_v: int) -> torch.Tensor:
    """Per-token NLL with padded-vocab masking. logits (T, V), labels (T,)."""
    lf = logits.to(torch.float32)
    v = lf.shape[-1]
    if logical_v < v:
        col = torch.arange(v, device=lf.device)
        lf = torch.where(col[None, :] < logical_v, lf, -1e30)
    lse = torch.logsumexp(lf, dim=-1)
    lab = torch.gather(lf, 1, labels.to(torch.int64)[:, None])[:, 0]
    return lse - lab
