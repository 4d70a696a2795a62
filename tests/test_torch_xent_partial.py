"""The port's vocab-shard cross-entropy partials (B12) against the JAX
package, on the CPU.

The same numpy logits and labels, made from a seed, go through the
reference's Pallas kernel ``xent_partial_tiled`` (interpret mode on the
CPU, on its own tile-padded layout, as the JAX package's tests run its
kernels) and through the port's ``kernel.xent_partials`` (its plain
version ``plain_partials`` on CPU tensors).  The cases cover the first,
a middle and the last shard of a vocabulary, a ragged global ``logical_v``
that ends inside a shard, a shard wholly past it, labels in another shard,
and the aliasing case of the reference kernel (``kernel.py:88-93``): a
shard whose local width ``vl`` is below its padded width, with a label
whose global index falls in that padding -- it belongs to the next shard
and must not be matched here.

Tolerances: ``m`` is a max and ``ll`` a single logit (or 0), so both are
exact; ``l`` is a sum of fp32 exps in another order, rtol 1e-6.  bf16
logits are rounded alike from the same fp32 numbers and widened exactly on
both sides, so they are held to the same tolerances.  Partials combined
across shards give the whole row's NLL to the fp32 NLL tolerance of
``tests/test_torch_xent.py`` (rtol 1e-5, atol 1e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.xent import kernel as jkernel
from repro.kernels.xent import ref as jref
from repro_torch import interop
from repro_torch.kernels.xent import kernel

L_TOL = dict(rtol=1e-6, atol=0.0)
NLL = dict(rtol=1e-5, atol=1e-6)
DTYPES = ["float32", "bfloat16"]
# (tokens, padded shard width, shard width vl, offset, global logical_v)
CASES = [
    (24, 256, 256, 0, 1024),      # the first shard of four
    (24, 256, 256, 512, 1024),    # a middle shard
    (24, 256, 256, 768, 1000),    # the last shard, logical_v inside it
    (9, 128, 100, 200, 1000),     # local padding past vl: the aliasing case
    (16, 128, 128, 1024, 1000),   # a shard wholly past logical_v
]


def inputs(t, width, vl, off, lv, dtype, seed):
    """Logits (jax, torch; fp32 numbers rounded to ``dtype``) and global
    int32 labels: most in this shard, some in other shards, one at the
    first global column past this shard's ``vl`` columns (inside the local
    padding when vl < width)."""
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal((t, width))).astype(np.float32)
    labels = rng.integers(0, lv, size=t).astype(np.int32)
    inside = off + rng.integers(0, max(min(vl, lv - off), 1), size=t)
    labels[::2] = np.minimum(inside[::2], lv - 1)
    labels[1] = min(off + vl, lv - 1)
    labels[3] = min(off + vl + 5, lv - 1)
    jx = jnp.asarray(x).astype(dtype)
    tx = interop.to_torch(x, device="cpu", dtype=dtype)
    return jx, tx, labels


def reference_partials(jx, labels, off, vl, lv, bt=8, bv=128):
    """The reference's Pallas partial kernel on its padded layout (T and V
    zero-padded to tile multiples, as its ops.py pads)."""
    t, v = jx.shape
    tp, vp = -(-t // bt) * bt, -(-v // bv) * bv
    lg = jnp.pad(jx, ((0, tp - t), (0, vp - v)))
    lb = jnp.pad(jnp.asarray(labels), (0, tp - t))
    m, l, ll = jkernel.xent_partial_tiled(
        lg, lb, jnp.asarray([off], jnp.int32), vl=vl, logical_v=lv, bt=bt,
        bv=bv)
    return tuple(np.asarray(a)[:t] for a in (m, l, ll))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_plain_partials_match_reference_kernel(case, dtype):
    t, width, vl, off, lv = case
    jx, tx, labels = inputs(t, width, vl, off, lv, dtype, seed=sum(case))
    want_m, want_l, want_ll = reference_partials(jx, labels, off, vl, lv)
    m, l, ll = kernel.xent_partials(tx, torch.as_tensor(labels), vl=vl,
                                    off=off, logical_v=lv)
    np.testing.assert_array_equal(interop.to_numpy(m), want_m)
    np.testing.assert_array_equal(interop.to_numpy(ll), want_ll)
    np.testing.assert_allclose(interop.to_numpy(l), want_l, **L_TOL)


def test_aliasing_label_is_not_matched_in_the_padding():
    """A label whose global index lands in this shard's local padding (it
    is the next shard's first column) leaves ll at 0 on both sides; a
    kernel that matched it would fold the padding's value in."""
    t, width, vl, off, lv = 4, 128, 100, 200, 1000
    jx, tx, _ = inputs(t, width, vl, off, lv, "float32", seed=3)
    labels = np.full(t, off + vl + 7, np.int32)       # local column 107
    _, _, want_ll = reference_partials(jx, labels, off, vl, lv)
    _, _, ll = kernel.xent_partials(tx, torch.as_tensor(labels), vl=vl,
                                    off=off, logical_v=lv)
    assert not np.any(want_ll)
    np.testing.assert_array_equal(interop.to_numpy(ll), want_ll)


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("lv", [1024, 1001])
def test_partials_combine_to_the_whole_row_nll(n_shards, lv):
    """The cross-shard log-sum-exp of ``kernels.xent.ops._spmd_xent``
    (pmax of m, psum of the rescaled l and of ll) over the shards' plain
    partials equals the reference's whole-row NLL per token."""
    rng = np.random.default_rng(n_shards + lv)
    t, v = 33, 1024
    x = (3.0 * rng.standard_normal((t, v))).astype(np.float32)
    labels = rng.integers(0, lv, size=t).astype(np.int32)
    want = np.asarray(jref.xent(jnp.asarray(x), jnp.asarray(labels),
                                logical_v=lv))
    vl = v // n_shards
    parts = [kernel.xent_partials(
        torch.from_numpy(x[:, k * vl:(k + 1) * vl].copy()),
        torch.as_tensor(labels), vl=vl, off=k * vl, logical_v=lv)
        for k in range(n_shards)]
    mg = torch.stack([p[0] for p in parts]).amax(0)
    lsum = sum(p[1] * torch.exp(p[0] - mg) for p in parts)
    llsum = sum(p[2] for p in parts)
    nll = torch.log(torch.clamp(lsum, min=1e-30)) + mg - llsum
    np.testing.assert_allclose(nll.numpy(), want, **NLL)


def test_wrapper_checks_and_counts():
    x = torch.zeros(4, 64)
    lab = torch.zeros(4, dtype=torch.int32)
    before = kernel.LAUNCHES["xent.partial"]
    kernel.xent_partials(x, lab, vl=64, off=0, logical_v=64)
    # the plain version on CPU tensors is not a launch of the kernel
    assert kernel.LAUNCHES["xent.partial"] == before
    with pytest.raises(ValueError, match="vl"):
        kernel.xent_partials(x, lab, vl=65, off=0, logical_v=64)
    with pytest.raises(ValueError, match="off"):
        kernel.xent_partials(x, lab, vl=64, off=-1, logical_v=64)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.xent_partials(x.t(), lab, vl=4, off=0, logical_v=64)
    with pytest.raises(ValueError, match="labels"):
        kernel.xent_partials(x, lab[:3], vl=64, off=0, logical_v=64)
    # neither the CPU nor CUDA: the wrapper raises, it does not fall back
    with pytest.raises(ValueError, match="CUDA"):
        kernel.xent_partials(x.to("meta"), lab.to("meta"), vl=64, off=0,
                             logical_v=64)


def test_dead_shard_partials_are_neutral():
    """A shard wholly past logical_v gives (m, l, ll) = (-1e30, 0, 0), which
    the combine leaves out: exp(-1e30 - m) is 0."""
    x = torch.randn(5, 64)
    m, l, ll = kernel.xent_partials(x, torch.zeros(5, dtype=torch.int32),
                                    vl=64, off=128, logical_v=100)
    assert torch.all(m == kernel.MASK)
    assert torch.all(l == 0) and torch.all(ll == 0)
