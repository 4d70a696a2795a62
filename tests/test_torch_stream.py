"""STREAM and vector triad: the port against the JAX package.

The same numpy inputs (fixed seeds) go through ``repro.api.launch`` (Pallas
in interpret mode on the CPU, as tests/test_kernels.py runs it) and through
``repro_torch.api.launch`` on the CPU, where the wrappers run their kernels'
plain PyTorch versions.  Tolerances are tests/test_kernels.py's: fp32
rtol 1e-5 / atol 1e-6, because both sides round each product and sum in
fp32 and may differ only where a compiler contracts them into an FMA; bf16
2e-2, because the reference rounds to bf16 after every operation while the
port rounds once, which may differ by one bf16 ulp (2**-8 relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.kernels.triad import ops as jtops
from repro_torch import api, interop
from repro_torch.kernels.stream import ops as sops
from repro_torch.kernels.triad import ops as tops

SIZES = [1, 7, 128, 1000, 8192, 20000]
DTYPES = ["float32", "bfloat16"]
CASES = [  # (kernel, arity, scalar)
    ("stream.copy", 1, None),
    ("stream.scale", 1, 3.0),
    ("stream.add", 2, None),
    ("stream.triad", 2, 3.0),
    ("triad", 3, None),
]


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(
        rtol=1e-5, atol=1e-6)


def inputs(n, count, dtype, seed):
    """numpy fp32 inputs; each side casts to ``dtype`` (round to nearest
    even on both)."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(n).astype(np.float32) for _ in range(count)]
    jx = [jnp.asarray(x).astype(getattr(jnp, dtype)) for x in xs]
    tx = [interop.to_torch(x, device="cpu", dtype=dtype) for x in xs]
    return jx, tx


def compare(got: torch.Tensor, want, dtype):
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(interop.to_numpy(got),
                               np.asarray(want, np.float32), **tol(dtype))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel,arity,s", CASES)
def test_launch_matches_reference(kernel, arity, s, dtype, n):
    jx, tx = inputs(n, arity, dtype, seed=n + arity)
    kw = {} if s is None else {"s": s}
    compare(api.launch(kernel, *tx, **kw), japi.launch(kernel, *jx, **kw),
            dtype)
    # the registered oracles agree as well
    compare(api.ref(kernel, *tx, **kw), japi.ref(kernel, *jx, **kw), dtype)


@pytest.mark.parametrize("phases", [(0, 0, 0), (1, 2, 3), (16, 32, 48)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_phased_triad_matches_reference(phases, dtype):
    """The paper's offsets change where each stream starts, never the
    result."""
    jx, tx = inputs(3000, 3, dtype, seed=11)
    got = tops.vector_triad_phased(*tx, phases=phases)
    compare(got, jtops.vector_triad_phased(*jx, phases=phases), dtype)
    plan = api.plan_for("triad", (3000,), dtype)
    tiles = tops.phased_tiles(tx[0], phases[2], plan)
    assert tiles.shape == plan.padded_shape
    assert tiles.storage_offset() == phases[2]


def test_to_tiles_views_full_plans_and_pads_ragged_tails():
    from repro_torch.kernels.util import from_tiles, to_tiles

    full = api.plan_for("stream.copy", (8192,), "float32")
    x = torch.arange(8192, dtype=torch.float32)
    t, n = to_tiles(x, full)
    assert t.data_ptr() == x.data_ptr() and n == 8192
    ragged = api.plan_for("stream.copy", (1000,), "float32")
    y = torch.arange(1000, dtype=torch.float32)
    t, n = to_tiles(y, ragged)
    assert t.shape == ragged.padded_shape and t.data_ptr() != y.data_ptr()
    assert float(t.reshape(-1)[1000:].abs().sum()) == 0.0
    assert torch.equal(from_tiles(t, n), y)
    with pytest.raises(ValueError):
        to_tiles(x, ragged)


def test_traffic_accounting_matches_reference():
    from repro.kernels.stream import ops as jsops

    for op in ("copy", "scale", "add", "triad"):
        assert sops.bytes_moved(op, 100, 4) == jsops.bytes_moved(op, 100, 4)
        assert sops.bytes_moved_rfo(op, 100) == jsops.bytes_moved_rfo(op, 100)
    assert tops.triad_bytes(100, 4, rfo=False) == jtops.triad_bytes(
        100, 4, rfo=False)
    assert tops.triad_flops(100) == jtops.triad_flops(100)
    assert sops.bytes_moved_rfo("triad", 3) * 3 == sops.bytes_moved("triad", 3) * 4


def test_data_helpers_need_cuda_unless_told_otherwise():
    """Entry points that make data default to CUDA and raise without it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        sops.random_vectors(16, 2)
    xs = sops.random_vectors(16, 2, torch.bfloat16, seed=1, device="cpu")
    assert [x.dtype for x in xs] == [torch.bfloat16] * 2
