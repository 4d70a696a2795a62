"""The port's RMSNorm (plain and gated) against the JAX package.

The same numpy inputs, made from a seed, go through
``repro.api.launch("rmsnorm"/"rmsnorm.gated")`` (Pallas in interpret mode on
the CPU) and ``repro_torch.api.launch`` (the kernel's plain PyTorch version
on CPU tensors), on the shapes of tests/test_kernels.py's ``TestRMSNorm``.
Tolerances are that file's: fp32 rtol 1e-5 / atol 1e-6 (both sides take
fp32 statistics, in another summation order), bf16 2e-2 (one bf16 rounding
of the output, and of the gate).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro_torch import api, interop
from repro_torch.kernels.rmsnorm import kernel, ref

DTYPES = ["float32", "bfloat16"]


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(
        rtol=1e-5, atol=1e-6)


def inputs(shape, dtype, seed, count):
    """``count`` standard-normal arrays of ``shape`` and a scale of 1 + noise,
    as (numpy fp32, jax, torch) triples at ``dtype``."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for _ in range(count)]
    arrays.append(rng.standard_normal(shape[-1:]).astype(np.float32) + 1.0)
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    tx = [interop.to_torch(a, device="cpu", dtype=dtype) for a in arrays]
    return jx, tx


@pytest.mark.parametrize("shape", [(4, 8, 64), (2, 100), (16, 2304)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_matches_reference(shape, dtype):
    jx, tx = inputs(shape, dtype, 0, 1)
    got = api.launch("rmsnorm", *tx)
    assert got.shape == tx[0].shape and got.dtype == tx[0].dtype
    np.testing.assert_allclose(interop.to_numpy(got),
                               np.asarray(japi.launch("rmsnorm", *jx),
                                          np.float32), **tol(dtype))


@pytest.mark.parametrize("shape", [(3, 7, 96), (8, 512)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gated_matches_reference(shape, dtype):
    jx, tx = inputs(shape, dtype, 1, 2)
    got = api.launch("rmsnorm.gated", *tx)
    np.testing.assert_allclose(interop.to_numpy(got),
                               np.asarray(japi.launch("rmsnorm.gated", *jx),
                                          np.float32), **tol(dtype))


@pytest.mark.parametrize("gated", [False, True])
def test_padded_columns_are_masked_from_the_statistics(gated):
    """A width past the vector unit pads; the plain version on the padded
    block (what the CUDA kernel computes) equals the oracle on the logical
    columns, with garbage in the padding."""
    _, (x, z, s) = inputs((5, 100), "float32", 2, 2)
    plan = api.plan_for("rmsnorm", (5, 100), torch.float32)
    assert plan.padded_shape == (5, 128)
    pad = [torch.cat([t, torch.full((5, 28), 7.0)], 1) for t in (x, z)]
    sp = torch.cat([s, torch.ones(28)])
    if gated:
        got = kernel.gated_rmsnorm2d(*pad, sp, d_logical=100)[:, :100]
        want = ref.gated_rmsnorm(x, z, s)
    else:
        got = kernel.rmsnorm2d(pad[0], sp, d_logical=100)[:, :100]
        want = ref.rmsnorm(x, s)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_shape_mismatches_are_refused():
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="scale shape"):
        api.launch("rmsnorm", x, torch.ones(32))
    with pytest.raises(ValueError, match="z shape"):
        api.launch("rmsnorm.gated", x, torch.zeros(4, 32), torch.ones(64))
    with pytest.raises(ValueError, match="scale shape"):
        api.launch("rmsnorm.gated", x, torch.zeros(4, 64), torch.ones(63))
    with pytest.raises(ValueError, match="d_logical"):
        kernel.rmsnorm2d(torch.zeros(4, 128), torch.ones(128), d_logical=129)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.rmsnorm2d(torch.zeros(128, 4).T, torch.ones(128), d_logical=128)
    # the JAX package refuses the same calls
    with pytest.raises(ValueError):
        japi.launch("rmsnorm", jnp.zeros((4, 64)), jnp.ones(32))
    with pytest.raises(ValueError):
        japi.launch("rmsnorm.gated", jnp.zeros((4, 64)), jnp.zeros((4, 32)),
                    jnp.ones(64))


def test_model_shapes_launch_without_a_copy():
    """A (B, S, d) activation whose d fills whole vector spans reaches the
    kernel as a view: the plan pads nothing (row unit 1)."""
    for rows, d, dtype in [(8, 2560, torch.bfloat16),
                           (2048, 2560, torch.bfloat16),
                           (2048, 4096, torch.bfloat16), (8, 128, torch.float32)]:
        plan = api.plan_for("rmsnorm", (rows, d), dtype)
        assert plan.padded_shape == (rows, d), plan.explain()
        assert plan.rows % plan.block_rows == 0


def test_plan_tile_sizes_by_budget_not_by_grid():
    """plan_tile plans one tile: the fill rule would cut a 1024-row stream
    to one row a CTA; the budget alone gives 128 KiB / (4 x 2 KB) rows."""
    grid = api.plan_for("rmsnorm", (1024, 1024), torch.bfloat16)
    tile = api.plan_tile("rmsnorm", (1024, 1024), torch.bfloat16,
                         smem_budget=128 * 1024)
    assert grid.block_rows == 1
    assert tile.block_rows == 16
    assert api.plan_tile("rmsnorm", (1024, 1024), torch.bfloat16,
                         smem_budget=64 * 1024).block_rows == 8
