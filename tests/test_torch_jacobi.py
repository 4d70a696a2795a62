"""Jacobi: the port against the JAX package.

The same numpy grid (fixed seed) goes through ``repro.api.launch`` /
``repro.kernels.jacobi.ops.jacobi_sweeps`` (Pallas in interpret mode on the
CPU) and through the port on the CPU (the kernel's plain version).
Tolerances are tests/test_kernels.py's: fp32 rtol 1e-5 / atol 1e-6 (both
sides sum the four neighbours in the same order in fp32); bf16 2e-2 (the
reference rounds to bf16 after every addition, the port once per sweep).
Boundary rows and columns are copied, so they must match exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.kernels.jacobi import ops as jjops
from repro_torch import api, interop
from repro_torch.kernels.jacobi import kernel as jkernel
from repro_torch.kernels.jacobi import ops as jops

SHAPES = [(34, 130), (66, 257)]
DTYPES = ["float32", "bfloat16"]


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(
        rtol=1e-5, atol=1e-6)


def grids(shape, dtype, seed=0):
    x = np.random.default_rng(seed).random(shape, dtype=np.float32)
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            interop.to_torch(x, device="cpu", dtype=dtype))


def check(got, want, src, dtype):
    g = interop.to_numpy(got)
    w = np.asarray(want, np.float32)
    s = interop.to_numpy(src)
    assert g.shape == w.shape == s.shape
    np.testing.assert_allclose(g, w, **tol(dtype))
    # boundary rows and columns pass through exactly
    for edge in (np.s_[0, :], np.s_[-1, :], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_array_equal(g[edge], s[edge])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_one_sweep_matches_reference(shape, dtype):
    jx, tx = grids(shape, dtype)
    check(api.launch("jacobi", tx), japi.launch("jacobi", jx), tx, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_ten_sweeps_match_reference(shape, dtype):
    jx, tx = grids(shape, dtype, seed=1)
    before = tx.clone()
    got = jops.jacobi_sweeps(tx, 10)
    check(got, jjops.jacobi_sweeps(jx, 10), tx, dtype)
    assert torch.equal(tx, before)      # the caller's grid is never written


def test_pitched_sweep_passes_padding_through():
    """The kernel's plain version on a pitched buffer: columns past n_cols
    are copied, as the reference's roll-and-mask leaves them."""
    _, tx = grids((34, 130), "float32", seed=2)
    plan = api.plan_for("jacobi", (32, 130), "float32")
    assert plan.width == 256
    src = jops.pitched(tx, plan)
    src[:, 130:] = 7.0
    out = jkernel.sweep(src, torch.empty_like(src), n_cols=130,
                        block=plan.block_shape)
    assert torch.equal(out[:, 130:], src[:, 130:])
    with pytest.raises(ValueError, match="overlap"):
        jkernel.sweep(src, src, n_cols=130, block=plan.block_shape)
    with pytest.raises(ValueError):
        api.launch("jacobi", torch.zeros(1, 5))


def test_traffic_accounting_matches_reference():
    assert jops.jacobi_bytes(34, 130, 4) == jjops.jacobi_bytes(34, 130, 4)
    assert jops.jacobi_flops(34, 130) == jjops.jacobi_flops(34, 130)
    assert jops.mlups(34, 130, 0.5, 3) == jjops.mlups(34, 130, 0.5, 3)


def test_init_grid_needs_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        jops.init_grid(8, 8)
    assert jops.init_grid(8, 8, device="cpu", seed=3).shape == (8, 8)
