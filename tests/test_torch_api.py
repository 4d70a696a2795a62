"""The port's launch API: lazy family resolution, shadow refusal, overrides
by name and by cell, plan validation, and pinned reference geometry.

Results are compared with the JAX package run in Pallas interpret mode at
the fp32 tolerance of tests/test_kernels.py (rtol 1e-5, atol 1e-6): the port
and the reference round each product and sum separately, so they agree to
the last few ulps.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import api as japi
from repro_torch import api, interop
from repro_torch.api import registry
from repro_torch.core import planner
from repro_torch.core.autotune import StreamSignature

ROOT = Path(__file__).resolve().parents[1]
FP32 = dict(rtol=1e-5, atol=1e-6)


def vec(n, seed):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return x, interop.to_torch(x, device="cpu")


def test_families_resolve_lazily():
    code = (
        "import sys\n"
        "from repro_torch import api\n"
        "mod = 'repro_torch.kernels.jacobi.ops'\n"
        "assert mod not in sys.modules\n"
        "assert api.resolve('jacobi').name == 'jacobi'\n"
        "assert mod in sys.modules\n"
        "assert 'repro_torch.kernels.triad.ops' not in sys.modules\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert set(registry.FAMILY_MODULES) == {"stream", "triad", "jacobi", "lbm",
                                            "rmsnorm", "xent"}
    assert all(m.startswith("repro_torch.kernels.")
               for m in registry.FAMILY_MODULES.values())
    assert api.list_kernels() == ["jacobi", "lbm.ivjk", "lbm.soa",
                                  "rmsnorm", "rmsnorm.apply", "rmsnorm.gated",
                                  "rmsnorm.gated.apply",
                                  "rmsnorm.gated.sumsq", "rmsnorm.sumsq",
                                  "stream.add", "stream.copy", "stream.scale",
                                  "stream.triad", "triad", "xent"]
    with pytest.raises(KeyError):
        api.resolve("no_such_family")


def test_shadowed_names_are_refused():
    api.resolve("stream.copy")
    with pytest.raises(ValueError, match="shadow"):
        @api.register_kernel("stream.copy",
                             signature=StreamSignature(1, 1),
                             ref=lambda a: a, plan_args=lambda a: (a.shape, a.dtype))
        def _other(plan, a):
            return a
    with pytest.raises(ValueError, match="shadow"):
        planner.register_family("triad", StreamSignature(2, 1))
    with pytest.raises(ValueError, match="shadow"):
        planner.register_family("jacobi", StreamSignature(1, 1), cta_buffers=3)
    with pytest.raises(TypeError):
        @api.register_kernel("test.bad_partitioning",
                             signature=StreamSignature(1, 1), ref=None,
                             plan_args=None, partitioning=("batch",))
        def _bad(plan, a):
            return a
    assert "test.bad_partitioning" not in planner.FAMILIES


def test_overrides_by_name_and_by_cell():
    base = api.plan_for("triad", (1000,), "float32")
    by_name = dataclasses.replace(base, block_shape=(1, 512),
                                  provenance="pinned-name")
    by_cell = dataclasses.replace(base, block_shape=(1, 256),
                                  provenance="pinned-cell")
    with api.plan_context(plan_overrides={"triad": by_name}):
        assert api.plan_for("triad", (1000,), "float32") is by_name
        # another shape falls through to the planner
        assert api.plan_for("triad", (999,), "float32").provenance == "analytic"
        with api.plan_context(
                plan_overrides={("triad", (1000,), "float32"): by_cell}):
            assert api.plan_for("triad", (1000,), "float32") is by_cell
            # an explicit None clears every inherited pin
            with api.plan_context(plan_overrides=None):
                assert api.plan_for("triad", (1000,), "float32") is base
        assert "source: pinned-name" in api.explain("triad", (1000,), "float32")
    assert api.plan_for("triad", (1000,), "float32") is base
    with api.plan_context(smem_budget=1 << 30, sm_count=1):
        assert api.current_context().smem_budget == 1 << 30
        assert api.plan_for("stream.copy", (1 << 22,), "float32").block_rows > 1


def test_validate_refuses_stale_plans():
    _, b = vec(1000, 0)
    stale = api.plan_for("triad", (999,), "float32")
    with pytest.raises(ValueError, match="shape"):
        api.launch("triad", b, b, b, plan=stale)
    with pytest.raises(ValueError, match="dtype"):
        api.launch("triad", b, b, b,
                   plan=api.plan_for("triad", (1000,), "bfloat16"))
    with pytest.raises(ValueError, match="kernel"):
        api.launch("triad", b, b, b,
                   plan=api.plan_for("stream.add", (1000,), "float32"))


@pytest.mark.parametrize("n", [1000, 8192])
def test_pinned_reference_geometry_gives_the_same_result(n):
    """A test can pin the reference's plan on both sides through
    ``interop.plan_from_dict``."""
    (xb, b), (xc, c), (xd, d) = vec(n, 1), vec(n, 2), vec(n, 3)
    jplan = japi.plan_for("triad", (n,), np.float32)
    plan = interop.plan_from_dict(dataclasses.asdict(jplan))
    assert plan.padded_shape == jplan.padded_shape
    assert plan.block_shape == jplan.block_shape
    assert plan.layout == planner.plan_kernel("triad", (n,), "float32").layout
    got = api.launch("triad", b, c, d, plan=plan)
    want = japi.launch("triad", xb, xc, xd, plan=jplan)
    np.testing.assert_allclose(interop.to_numpy(got), np.asarray(want), **FP32)
    with pytest.raises(ValueError):
        interop.plan_from_dict({**dataclasses.asdict(jplan), "local": True})
