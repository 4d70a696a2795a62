"""LBM D3Q19: the port against the JAX package.

The same numpy lattice (the reference's ``init_equilibrium`` plus a seeded
numpy perturbation) goes through ``repro.api.launch`` / ``lbm_run`` (Pallas
in interpret mode on the CPU) and through the port on the CPU (the
collision kernel's plain version).  Tolerances are tests/test_kernels.py's:
one step fp32 rtol 2e-5 / atol 1e-7 (both sides compute the collision in
fp32, in different summation orders); several steps rtol 2e-4 / atol 1e-6;
bf16 2e-2 (the reference rounds to bf16 after every operation, the port
once per step).  Only logical sites are compared: a padded site's velocity
is NaN by design (rho = 0 there) in both packages.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.kernels.lbm import ops as jlops
from repro.kernels.lbm import ref as jlref
from repro_torch import api, interop
from repro_torch.core import layout, planner
from repro_torch.kernels.lbm import kernel as lkernel
from repro_torch.kernels.lbm import ops as lops
from repro_torch.kernels.lbm import ref as lref

STEP = dict(rtol=2e-5, atol=1e-7)
MULTI = dict(rtol=2e-4, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)


def lattice(n, seed=0):
    """The reference's equilibrium flow with a seeded +-2.5 % perturbation,
    as a float32 numpy array."""
    f = np.asarray(jlops.init_equilibrium(n, jnp.float32))
    rng = np.random.default_rng(seed)
    return (f * (1 + 0.05 * (rng.random(f.shape, dtype=np.float32) - 0.5))
            ).astype(np.float32)


def both(x, dtype="float32"):
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            interop.to_torch(x, device="cpu", dtype=dtype))


def close(got, want, tol):
    np.testing.assert_allclose(interop.to_numpy(got),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout_", ["soa", "ivjk"])
@pytest.mark.parametrize("n", [8, 12, 16])
def test_one_step_matches_reference(n, layout_, dtype):
    jf, tf = both(lattice(n, seed=n), dtype)
    before = tf.clone()
    got = api.launch(f"lbm.{layout_}", tf, omega=1.2)
    assert got.shape == tf.shape and got.dtype == tf.dtype
    close(got, japi.launch(f"lbm.{layout_}", jf, omega=1.2),
          STEP if dtype == "float32" else BF16)
    assert torch.equal(tf, before)      # the caller's lattice is never written


def test_lbm_run_layouts_agree_with_each_other_and_reference():
    jf, tf = both(lattice(12, seed=1))
    soa = lops.lbm_run(tf, 1.0, 3, layout="soa")
    ivjk = lops.lbm_run(tf, 1.0, 3, layout="ivjk")
    close(soa, interop.to_numpy(ivjk), MULTI)
    close(soa, jlops.lbm_run(jf, 1.0, 3, layout="soa"), MULTI)
    close(ivjk, jlops.lbm_run(jf, 1.0, 3, layout="ivjk"), MULTI)
    with pytest.raises(ValueError, match="layout"):
        lops.lbm_run(tf, 1.0, 1, layout="aos")


def test_masked_cells_hold_the_pre_step_values():
    jf, tf = both(lattice(12, seed=2))
    mask = np.ones((12, 12, 12), bool)
    mask[3:6, 3:6, 3:6] = False
    tmask = torch.from_numpy(mask)
    for name in ("lbm.soa", "lbm.ivjk"):
        got = api.launch(name, tf, omega=1.2, mask=tmask)
        close(got, japi.launch(name, jf, omega=1.2, mask=jnp.asarray(mask)),
              STEP)
        assert torch.equal(got[:, 3:6, 3:6, 3:6], tf[:, 3:6, 3:6, 3:6])
        close(got, lref.lbm_step(tf, 1.2, tmask), STEP)
    with pytest.raises(ValueError, match="mask"):
        api.launch("lbm.soa", tf, omega=1.2, mask=tmask[:4])


def test_equilibrium_is_a_fixed_point():
    f = lref.equilibrium(torch.ones((8, 8, 8)), torch.zeros((3, 8, 8, 8)))
    np.testing.assert_array_equal(
        interop.to_numpy(f),
        np.asarray(jlref.equilibrium(jnp.ones((8, 8, 8)),
                                     jnp.zeros((3, 8, 8, 8)))))
    for name in ("lbm.soa", "lbm.ivjk"):
        torch.testing.assert_close(api.launch(name, f, omega=1.7), f,
                                   rtol=0, atol=1e-6)


def test_mass_and_momentum_are_conserved():
    f = lops.init_equilibrium(16, device="cpu")
    f5 = lops.lbm_run(f, 1.2, 5, layout="ivjk")
    m0, m5 = float(f.sum()), float(f5.sum())
    assert abs(m5 - m0) / m0 < 1e-3
    c = torch.as_tensor(lref.C, dtype=torch.float32)

    def mom(g):
        return (c.T @ g.reshape(19, -1)).sum(dim=1)

    torch.testing.assert_close(mom(f5), mom(f), rtol=0, atol=m0 * 2e-3)


@pytest.mark.parametrize("n", [8, 12, 16, 100])
def test_init_equilibrium_matches_reference(n):
    got = lops.init_equilibrium(n, device="cpu")
    # the shear's grid: x_k = 2*pi*k/n, as linspace(..., endpoint=False)
    np.testing.assert_allclose(interop.to_numpy(got),
                               np.asarray(jlops.init_equilibrium(n)),
                               rtol=1e-6, atol=1e-7)


def test_init_equilibrium_needs_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        lops.init_equilibrium(8)
    assert lops.init_equilibrium(8, device="cpu").shape == (19, 8, 8, 8)


@pytest.mark.parametrize("n", [100, 96, 64, 50])
def test_layout_balance_scores_equal_reference(n):
    assert lops.layout_balance_scores(n=n) == jlops.layout_balance_scores(n=n)


def test_traffic_accounting_matches_reference():
    for eb in (4, 8):
        for rfo in (True, False):
            assert lops.site_bytes(eb, rfo=rfo) == jlops.site_bytes(eb, rfo=rfo)
    assert lops.site_bytes() == 456          # paper SS2.4
    assert lops.site_flops() == jlops.site_flops()
    assert lkernel.OPS_PER_SITE == 361


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [2, 8, 12, 37, 64, 250, 256])
def test_lbm_plans_tile_the_lattice(n, dtype):
    shape = (19, n, n, n)
    size = torch.tensor([], dtype=getattr(torch, dtype)).element_size()
    soa = planner.plan_kernel("lbm.soa", shape, dtype)
    ivjk = planner.plan_kernel("lbm.ivjk", shape, dtype)
    for p in (soa, ivjk):
        for padded, block in zip(p.padded_shape, p.block_shape):
            assert padded % block == 0, p.explain()
        assert p.minor_unit in (layout.vector_unit(size), layout.vector_unit(4))
        # 19 + 19 streams, but traffic counts one lattice in and one out
        assert p.predicted_hbm_bytes == 2 * p.padded_elems * size
    assert soa.padded_shape[0] == 19 and soa.block_shape[0] == 19
    sb, q, lanes = ivjk.padded_shape
    assert (q, lanes) == (19, ivjk.minor_unit)
    assert soa.padded_shape[1] == sb * lanes >= n ** 3
    # the padding is under one block of sites
    assert sb * lanes - n ** 3 < ivjk.block_rows * lanes
    # one site per thread of a CTA
    assert ivjk.block_rows * lanes == max(layout.CTA_THREADS, lanes)
    if dtype == "bfloat16":
        for name, p in (("lbm.soa", soa), ("lbm.ivjk", ivjk)):
            assert p.waste_bytes <= planner.plan_kernel(
                name, shape, "float32").waste_bytes
    with pytest.raises(ValueError, match="Q=19"):
        planner.plan_kernel("lbm.soa", (18, n, n, n), dtype)


@pytest.mark.parametrize("layout_", ["soa", "ivjk"])
def test_a_reference_plan_pinned_in_the_port_gives_the_same_step(layout_):
    """The reference's geometry (interleave width 128, its own blocks)
    drives the port's step and gives the step the port's own plan gives."""
    name = f"lbm.{layout_}"
    jf, tf = both(lattice(12, seed=3))
    jplan = japi.plan_for(name, (19, 12, 12, 12), jnp.float32)
    plan = interop.plan_from_dict(dataclasses.asdict(jplan))
    assert plan.padded_shape == tuple(jplan.padded_shape)
    assert plan.minor_unit == 128
    pinned = api.launch(name, tf, omega=1.2, plan=plan)
    assert torch.equal(pinned, api.launch(name, tf, omega=1.2))
    close(pinned, japi.launch(name, jf, omega=1.2), STEP)
    with api.plan_context(plan_overrides={name: plan}):
        assert api.plan_for(name, tf.shape, tf.dtype) is plan
        pinned_run = lops.lbm_run(tf, 1.2, 2, layout=layout_)
    assert torch.equal(pinned_run, lops.lbm_run(tf, 1.2, 2, layout=layout_))


def test_flatten_pad_takes_the_plans_padding_only():
    _, tf = both(lattice(12, seed=4))
    plan = api.plan_for("lbm.soa", tf.shape, tf.dtype)
    flat, s = lops._flatten_pad(tf, plan)
    assert s == 12 ** 3 and flat.shape == plan.padded_shape
    assert torch.equal(flat[:, :s], tf.reshape(19, s))
    assert not flat[:, s:].any()
    short = dataclasses.replace(plan, padded_shape=(19, s - 1))
    with pytest.raises(ValueError, match="pads"):
        lops._flatten_pad(tf, short)


@pytest.mark.parametrize("layout_", ["soa", "ivjk"])
def test_collision_wrappers_match_reference_collide(layout_):
    """The plain version, in its own evaluation order, against the
    reference's collision on the same logical sites; the wrappers check
    what they are given."""
    n = 12
    jf, tf = both(lattice(n, seed=5))
    plan = api.plan_for(f"lbm.{layout_}", tf.shape, tf.dtype)
    flat, s = lops._flatten_pad(tf, plan)
    if layout_ == "soa":
        got = lkernel.collide_soa(flat, 1.2)
        logical = got[:, :s]
    else:
        lanes = plan.padded_shape[2]
        x = flat.view(19, -1, lanes).transpose(0, 1).contiguous()
        got = lkernel.collide_ivjk(x, 1.2)
        logical = got.transpose(0, 1).reshape(19, -1)[:, :s]
    want = jlref.collide(jf, 1.2)
    close(logical.reshape(tf.shape), want, STEP)
    out = torch.empty_like(got)
    src = flat if layout_ == "soa" else x
    wrapper = getattr(lkernel, f"collide_{layout_}")
    assert wrapper(src, 1.2, out=out) is out
    torch.testing.assert_close(out, got, rtol=0, atol=0, equal_nan=True)
    with pytest.raises(ValueError, match="overlap"):
        wrapper(src, 1.2, out=src)
    with pytest.raises(ValueError):
        wrapper(src[..., :-1], 1.2)
