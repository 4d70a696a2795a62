"""The split RMSNorm (plain and gated) of rows whose columns are cut into
blocks, as the ranks of a tensor-parallel mesh hold them, on the CPU.

Seeded numpy rows of (64, 256), fp32 and bf16, are cut into 2 and 4 column
blocks.  Each block's stats pass (``api.launch("rmsnorm.sumsq")``, the
kernel's plain version on CPU tensors) gives its rows' sums of squares;
their sum, applied to every block with the whole row's width
(``api.launch("rmsnorm.apply")``), must be the one-pass norm of the whole
row: fp32 rtol 1e-6 / atol 1e-7 (the sums of squares add in another
order), bf16 within one bf16 ulp of the output (one rounding each).  The
whole is held to the JAX package's ``repro.kernels.rmsnorm.ref`` at
``tests/test_kernels.py``'s tolerance (fp32 rtol 1e-5 / atol 1e-6, bf16
2e-2).

The backward through ``models.blocks.SumSquaresFn`` and ``ApplyNormFn``,
the blocks' statistics summed as the ranks sum them, must give the
gradient of x, z and the scale that autograd takes of the fp32 plain math
on the whole row, each within 1e-5 of its largest magnitude (as
``tests/test_torch_tp.py`` holds a leaf: the scale's gradient is a sum over
the rows, whose terms cancel).  That needs the sum in both
directions: each block's statistic gets the gradient of every block's
normalised columns.  With the sum forward only (each block seeing the
other blocks' statistics as constants), the gradient of x misses that
cross-block term, and the test shows it does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import ref as jref
from repro_torch import api, interop
from repro_torch.kernels.rmsnorm import kernel
from repro_torch.models import blocks

DTYPES = ["float32", "bfloat16"]
SHAPE = (64, 256)
EPS = 1e-6


def tol(dtype):
    """tests/test_kernels.py's tolerance."""
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(
        rtol=1e-5, atol=1e-6)


def inputs(dtype, seed):
    """x, z (standard normal) and a scale of 1 + noise, as numpy fp32 and
    as torch tensors of ``dtype``."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(SHAPE).astype(np.float32)
              for _ in range(2)]
    arrays.append(rng.standard_normal(SHAPE[-1:]).astype(np.float32) + 1.0)
    return arrays, [interop.to_torch(a, device="cpu", dtype=dtype)
                    for a in arrays]


def split_norm(x, z, scale, n):
    """The split norm of x (gated by z unless None) over ``n`` column
    blocks, through the registered passes: each block's statistic, their
    sum, each block applied with the whole width."""
    cols = np.array_split(np.arange(x.shape[-1]), n)
    parts = [(x[:, c], None if z is None else z[:, c], scale[c])
             for c in cols]
    if z is None:
        ss = sum(api.launch("rmsnorm.sumsq", xb) for xb, _, _ in parts)
        return torch.cat([api.launch("rmsnorm.apply", xb, sb, ss,
                                     d_total=x.shape[-1], eps=EPS)
                          for xb, _, sb in parts], dim=-1)
    ss = sum(api.launch("rmsnorm.gated.sumsq", xb, zb)
             for xb, zb, _ in parts)
    return torch.cat([api.launch("rmsnorm.gated.apply", xb, zb, sb, ss,
                                 d_total=x.shape[-1], eps=EPS)
                      for xb, zb, sb in parts], dim=-1)


def assert_within_one_ulp(got: torch.Tensor, want: torch.Tensor):
    """bf16 values at most one bf16 ulp of ``want`` apart."""
    g = got.to(torch.float32).numpy()
    w = want.to(torch.float32).numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126)))
                  - 7)
    assert (np.abs(g - w) <= ulp).all(), float(np.max(np.abs(g - w) / ulp))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_split_blocks_give_the_one_pass_norm(n, gated, dtype):
    _, (x, z, scale) = inputs(dtype, n + 10 * gated)
    zz = z if gated else None
    got = split_norm(x, zz, scale, n)
    if gated:
        want = api.launch("rmsnorm.gated", x, z, scale, eps=EPS)
    else:
        want = api.launch("rmsnorm", x, scale, eps=EPS)
    assert got.shape == x.shape and got.dtype == x.dtype
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    else:
        assert_within_one_ulp(got, want)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_split_blocks_match_the_reference(n, gated, dtype):
    arrays, (x, z, scale) = inputs(dtype, 20 + n + 10 * gated)
    jx, jz, js = (jnp.asarray(a).astype(dtype) for a in arrays)
    got = split_norm(x, z if gated else None, scale, n)
    want = (jref.gated_rmsnorm(jx, jz, js, EPS) if gated
            else jref.rmsnorm(jx, js, EPS))
    np.testing.assert_allclose(interop.to_numpy(got),
                               np.asarray(want, np.float32), **tol(dtype))


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_split_passes_match_their_plain_versions(gated, dtype):
    """The registered passes on a padded block: the stats pass against
    ``plain_sumsq``, the apply pass against ``plain(..., ss=, d_total=)``,
    and their refs."""
    _, (x, z, scale) = inputs(dtype, 40 + gated)
    zz = z if gated else None
    name = "rmsnorm.gated" if gated else "rmsnorm"
    args = (x, z) if gated else (x,)
    ss = api.launch(f"{name}.sumsq", *args)
    torch.testing.assert_close(ss, kernel.plain_sumsq(x, x.shape[-1], zz))
    torch.testing.assert_close(ss, api.ref(f"{name}.sumsq", *args),
                               rtol=1e-6, atol=1e-6)
    y = api.launch(f"{name}.apply", *args, scale, 3 * ss, d_total=768,
                   eps=EPS)
    torch.testing.assert_close(y, kernel.plain(x, scale, 256, EPS, zz,
                                               ss=3 * ss, d_total=768))
    torch.testing.assert_close(
        y, api.ref(f"{name}.apply", *args, scale, 3 * ss, d_total=768,
                   eps=EPS), **tol(dtype))


def _whole_grads(x, z, scale, w):
    """The gradient of ``sum(w * norm)`` of the fp32 plain math on the
    whole row, with respect to x, z (gated) and the scale."""
    ins = [t.detach().to(torch.float32).requires_grad_(True)
           for t in (x, z, scale) if t is not None]
    h = ins[0] if z is None else ins[0] * torch.nn.functional.silu(ins[1])
    y = h * torch.rsqrt((h * h).mean(-1, keepdim=True) + EPS) * ins[-1]
    return torch.autograd.grad((y * w).sum(), ins)


def _split_grads(x, z, scale, w, n, cross: bool):
    """The same gradient through ``SumSquaresFn`` and ``ApplyNormFn`` over
    ``n`` column blocks; ``cross`` False sums the statistics forward only
    (each block takes the others' as constants)."""
    ins = [t.detach().requires_grad_(True) for t in (x, z, scale)
           if t is not None]
    xx, zz, ss_ = ins[0], ins[1] if z is not None else None, ins[-1]
    cols = np.array_split(np.arange(x.shape[-1]), n)
    stats = [blocks.SumSquaresFn.apply(
        xx[:, c], None if zz is None else zz[:, c]) for c in cols]
    out = []
    for i, c in enumerate(cols):
        total = sum(stats) if cross else stats[i] + sum(
            s.detach() for j, s in enumerate(stats) if j != i)
        out.append(blocks.ApplyNormFn.apply(
            xx[:, c], None if zz is None else zz[:, c], ss_[c], total,
            x.shape[-1], EPS))
    y = torch.cat(out, dim=-1).to(torch.float32)
    return torch.autograd.grad((y * w).sum(), ins)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("gated", [False, True])
def test_split_backward_is_the_whole_rows(n, gated):
    _, (x, z, scale) = inputs("float32", 60 + n + 10 * gated)
    w = torch.from_numpy(np.random.default_rng(7).standard_normal(
        SHAPE).astype(np.float32))
    zz = z if gated else None
    want = _whole_grads(x, zz, scale, w)
    got = _split_grads(x, zz, scale, w, n, cross=True)
    assert len(got) == len(want) == 2 + gated
    for g, v in zip(got, want):
        torch.testing.assert_close(g, v, rtol=0,
                                   atol=1e-5 * float(v.abs().max()))
    # the statistic summed forward only: x's gradient misses the other
    # blocks' term of sum(dy * g * scale), by far more than rounding
    alone = _split_grads(x, zz, scale, w, n, cross=False)
    assert float((alone[0] - want[0]).abs().max()) > 1e-2
