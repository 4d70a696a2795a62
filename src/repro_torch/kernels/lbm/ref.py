"""Plain PyTorch D3Q19 lattice-Boltzmann oracle (paper SS2.4).

Counterpart of ``repro.kernels.lbm.ref``: BGK single-relaxation-time
collision, pull-scheme propagation on a periodic cubic domain, optional
fluid mask (non-fluid cells hold their distributions, the paper's
``if fluidCell`` guard).

The state is kept in the SoA / "IJKv" layout ``f[v, x, y, z]``; the layout
transforms live in ops.py.  ``C`` and ``W`` are copies of the reference's
tables, not imports.
"""
from __future__ import annotations

import numpy as np
import torch

# D3Q19 velocity set: rest, 6 faces, 12 edges.
C = np.array(
    [
        [0, 0, 0],
        [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
        [1, 1, 0], [-1, -1, 0], [1, -1, 0], [-1, 1, 0],
        [1, 0, 1], [-1, 0, -1], [1, 0, -1], [-1, 0, 1],
        [0, 1, 1], [0, -1, -1], [0, 1, -1], [0, -1, 1],
    ],
    dtype=np.int32,
)
W = np.array([1 / 3] + [1 / 18] * 6 + [1 / 36] * 12, dtype=np.float64)
Q = 19


def _table(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def equilibrium(rho: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """f_eq[v, ...] for density rho[...] and velocity u[3, ...]."""
    c = _table(C, rho)                                   # (Q, 3)
    w = _table(W, rho)                                   # (Q,)
    cu = torch.tensordot(c, u, dims=([1], [0]))          # (Q, ...)
    usq = torch.sum(u * u, dim=0)                        # (...)
    return w.reshape((Q,) + (1,) * rho.ndim) * rho * (
        1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq)


def moments(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(rho, u) from f[v, ...]."""
    rho = torch.sum(f, dim=0)
    c = _table(C, f)
    mom = torch.tensordot(c.T, f, dims=([1], [0]))       # (3, ...)
    return rho, mom / rho


def collide(f: torch.Tensor, omega: float) -> torch.Tensor:
    rho, u = moments(f)
    feq = equilibrium(rho, u)
    return f - omega * (f - feq)


def propagate(f: torch.Tensor) -> torch.Tensor:
    """Pull: f'[v](x) = f[v](x - c_v), periodic."""
    return torch.stack([
        torch.roll(f[v], shifts=tuple(int(s) for s in C[v]), dims=(0, 1, 2))
        for v in range(Q)
    ])


def lbm_step(f: torch.Tensor, omega: float,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """One pull-scheme step on f[v, X, Y, Z]."""
    fpost = collide(propagate(f), omega)
    if mask is not None:
        fpost = torch.where(mask[None], fpost, f)
    return fpost
