"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips where
``torch.cuda.is_available()`` is false; run them on the card with
``python -m pytest -q tests/test_torch_cuda.py``.  This file imports no JAX:
the machine with the card has none.

Tolerances: fp32 copy/scale/add and the Jacobi sweep round at most once and
must be bit-exact; both triads round the product and the sum separately on
both sides, so they are expected bit-exact, and the stated tolerance (fp32
rtol 1e-5 / atol 1e-6, bf16 2e-2, as tests/test_kernels.py) only allows for
a compiler contracting them into an FMA.
"""
import pytest
import torch

from repro_torch import api
from repro_torch.kernels.jacobi import kernel as jkernel
from repro_torch.kernels.jacobi import ops as jops
from repro_torch.kernels.stream import kernel as skernel
from repro_torch.kernels.stream import ops as sops
from repro_torch.kernels.triad import kernel as tkernel
from repro_torch.kernels.triad import ops as tops
from repro_torch.kernels.util import to_tiles

pytestmark = pytest.mark.cuda

SIZES = [1, 7, 1000, 8191, 20000, 1 << 20]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(
        rtol=1e-5, atol=1e-6)


def exact(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_stream_kernels_match_plain(n, dtype):
    a, b, c = sops.random_vectors(n, 3, dtype, seed=n)
    for op, count, s in [("copy", 1, None), ("scale", 1, 3.0), ("add", 2, None),
                         ("triad", 2, 3.0)]:
        plan = api.plan_for(f"stream.{op}", (n,), dtype)
        xs = [to_tiles(x, plan)[0] for x in (a, b, c)[:count]]
        args = (*xs, s) if s is not None else tuple(xs)
        before = skernel.LAUNCHES[op]
        got = getattr(skernel, f"{op}2d")(*args, brows=plan.block_rows)
        assert skernel.LAUNCHES[op] == before + 1
        want = skernel.plain(op, xs, s)
        if dtype == torch.float32 and op != "triad":
            exact(got, want)
        else:
            torch.testing.assert_close(got, want, **tol(dtype))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_triad_kernel_matches_plain(n, dtype):
    b, c, d = sops.random_vectors(n, 3, dtype, seed=n + 1)
    out = api.launch("triad", b, c, d)
    torch.testing.assert_close(out, tkernel.plain(b, c, d), **tol(dtype))


@pytest.mark.parametrize("phases", [(0, 0, 0), (1, 2, 3), (16, 32, 48),
                                    (4, 8, 12), (3, 0, 5)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_phased_triad_reads_unaligned_bases(phases, dtype):
    n = 100_003
    b, c, d = sops.random_vectors(n, 3, dtype, seed=7)
    out = tops.vector_triad_phased(b, c, d, phases=phases)
    torch.testing.assert_close(out, tkernel.plain(b, c, d), **tol(dtype))


@pytest.mark.parametrize("shape", [(34, 130), (66, 257), (3, 3), (2, 5),
                                   (1030, 1000)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_jacobi_kernel_matches_plain(shape, dtype):
    grid = jops.init_grid(*shape, dtype, seed=3)
    plan = api.plan_for("jacobi", (shape[0] - 2, shape[1]), dtype)
    src = jops.pitched(grid, plan)
    before = jkernel.LAUNCHES["jacobi"]
    got = jkernel.sweep(src, torch.empty_like(src), n_cols=shape[1],
                        brows=plan.block_rows)
    assert jkernel.LAUNCHES["jacobi"] == before + 1
    exact(got, jkernel.plain(src, torch.empty_like(src), shape[1]))
    exact(jops.jacobi_sweeps(grid, 10),
          jops.jacobi_sweeps(grid.cpu(), 10).to(grid.device))


def test_wrappers_refuse_what_the_kernel_does_not_take():
    x = torch.zeros(4, 128, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        skernel.copy2d(x)
    y = torch.zeros(4, 128, device="cuda")
    with pytest.raises(ValueError):
        skernel.add2d(y, torch.zeros(4, 256, device="cuda")[:, :128])
    with pytest.raises(ValueError):
        jkernel.sweep(y, y, n_cols=128)
