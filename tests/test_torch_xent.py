"""The port's cross-entropy (B11) against the JAX package, on the CPU.

The same numpy logits and labels, made from a seed, go through the
reference's Pallas kernel ``xent_tiled`` (interpret mode on the CPU),
``repro.api.launch("xent")`` and ``xent_grad``, and through the port's
``kernel.plain``, ``api.launch("xent")`` and ``xent_grad`` (the plain
PyTorch versions on CPU tensors).  Shapes cover a ragged token count, a
logical vocab below the physical width, and labels at 0 and at
``logical_v - 1``.

Tolerances: both sides widen the logits to fp32 before any arithmetic, so
bf16 logits (rounded alike from the same fp32 numbers) are held to the fp32
tolerance too: the NLL to rtol 1e-5 / atol 1e-6 (fp32 exps summed in
another order), the gradient to rtol 1e-5 / atol 1e-9 (its entries are
softmax / T, about 1e-5 here, and each carries one fp32 exp's rounding).
A bf16 gradient is rounded to bf16 on both sides and may differ by one bf16
ulp (rtol 8e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.kernels.xent import kernel as jkernel
from repro.kernels.xent import ops as jops
from repro_torch import api, interop
from repro_torch.core import layout, planner
from repro_torch.kernels import util
from repro_torch.kernels.xent import kernel, ops, ref

NLL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-9)
# (tokens, vocab columns, logical vocab)
CASES = [(37, 501, 501), (64, 512, 480), (5, 1000, 999)]
DTYPES = ["float32", "bfloat16"]


def inputs(t, v, lv, dtype, seed):
    """Logits (numpy fp32 rounded to ``dtype``, jax, torch) and int32 labels
    in [0, lv) with the first at 0 and the last at lv - 1."""
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal((t, v))).astype(np.float32)
    labels = rng.integers(0, lv, size=t).astype(np.int32)
    labels[0], labels[-1] = 0, lv - 1
    jx = jnp.asarray(x).astype(dtype)
    tx = interop.to_torch(x, device="cpu", dtype=dtype)
    return jx, tx, labels


def reference_tiled(jx, labels, lv, bt=8, bv=128):
    """The reference's Pallas kernel on its own padded layout (T and V
    zero-padded to tile multiples, as its ops.py pads), per token."""
    t, v = jx.shape
    tp, vp = -(-t // bt) * bt, -(-v // bv) * bv
    lg = jnp.pad(jx, ((0, tp - t), (0, vp - v)))
    lb = jnp.pad(jnp.asarray(labels), (0, tp - t))
    return np.asarray(jkernel.xent_tiled(lg, lb, logical_v=lv, bt=bt,
                                         bv=bv))[:t]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,v,lv", CASES)
def test_plain_matches_the_tpu_kernel(t, v, lv, dtype):
    jx, tx, labels = inputs(t, v, lv, dtype, 0)
    got = kernel.plain(tx, torch.as_tensor(labels), lv)
    assert got.shape == (t,) and got.dtype == torch.float32
    np.testing.assert_allclose(interop.to_numpy(got),
                               reference_tiled(jx, labels, lv), **NLL)
    # the kernel wrapper takes the plain version on CPU tensors (two calls
    # on the CPU may round differently: held to the same tolerance)
    same = kernel.xent_nll(tx, torch.as_tensor(labels), logical_v=lv)
    np.testing.assert_allclose(interop.to_numpy(same), interop.to_numpy(got),
                               **NLL)


def test_label_outside_the_vocab_follows_the_masked_sum_rule():
    """A label in the padding picks the masked -1e30 (an NLL of about
    1e30); a label past the row picks nothing (NLL = lse), as the TPU
    kernel's iota == label sum does."""
    jx, tx, labels = inputs(8, 256, 200, "float32", 1)
    labels[2], labels[5] = 230, 300
    got = interop.to_numpy(kernel.plain(tx, torch.as_tensor(labels), 200))
    want = reference_tiled(jx, labels, 200)
    np.testing.assert_allclose(got, want, **NLL)
    assert got[2] > 1e29
    lse = np.asarray(jax.scipy.special.logsumexp(jx[5, :200]))
    np.testing.assert_allclose(got[5], lse, **NLL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,v,lv", CASES)
def test_launch_matches_reference(t, v, lv, dtype):
    jx, tx, labels = inputs(t, v, lv, dtype, 2)
    got = api.launch("xent", tx, torch.as_tensor(labels), logical_v=lv)
    want = japi.launch("xent", jx, jnp.asarray(labels), logical_v=lv)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), **NLL)
    np.testing.assert_allclose(
        float(api.ref("xent", tx, torch.as_tensor(labels), logical_v=lv)),
        float(japi.ref("xent", jx, jnp.asarray(labels), logical_v=lv)), **NLL)
    np.testing.assert_allclose(float(ref.xent(tx, torch.as_tensor(labels),
                                              logical_v=lv).mean()),
                               float(got), **NLL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,v,lv", CASES)
def test_grad_matches_reference(t, v, lv, dtype, monkeypatch):
    jx, tx, labels = inputs(t, v, lv, dtype, 3)
    g = 1.7
    want = np.asarray(jops.xent_grad(jx, jnp.asarray(labels), jnp.float32(g),
                                     logical_v=lv), np.float32)
    # a small chunk, so the row-chunk loop runs several times
    monkeypatch.setattr(ops, "GRAD_CHUNK_ELEMS", 7 * v)
    got = ops.xent_grad(tx, torch.as_tensor(labels), torch.tensor(g),
                        logical_v=lv)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    tol = GRAD if dtype == "float32" else dict(rtol=8e-3, atol=1e-9)
    np.testing.assert_allclose(interop.to_numpy(got), want, **tol)
    if lv < v:
        assert not interop.to_numpy(got)[:, lv:].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,v", [(1, 1), (37, 501), (4096, 151936),
                                 (100, 8), (3, 4099)])
def test_col_tiled_plan_invariants(t, v, dtype):
    """The Hopper geometry of a column-tiled plan: nothing padded, rows or
    columns, at any width (the kernel reads a row's ragged head and tail in
    place), a minor unit of one element, a block of whole rows by one pass
    of a CTA's threads, and the traffic of the logits read once plus the
    labels and the NLL, the logical bytes."""
    p = planner.plan_kernel("xent", (t, v), dtype,
                            smem_budget=layout.H100_SMEM_PER_CTA,
                            sm_count=layout.H100_SM_COUNT)
    size = torch.tensor([], dtype=getattr(torch, dtype)).element_size()
    vec = layout.VEC_BYTES // size
    assert p.padded_shape == (t, v)
    assert p.waste_bytes == 0 and p.minor_unit == 1
    assert 1 <= p.block_rows <= t
    assert p.block_cols == min(layout.CTA_THREADS * vec, p.width)
    assert p.grid[0] * p.block_rows >= t
    if t >= layout.CTAS_PER_SM * layout.H100_SM_COUNT:
        assert p.grid[0] >= layout.CTAS_PER_SM * layout.H100_SM_COUNT
    assert p.predicted_hbm_bytes == p.predicted_logical_bytes
    assert p.predicted_logical_bytes == t * v * size + 8 * t
    assert "any width" in p.explain()
    assert "xent" in planner.COL_TILED


def test_main_path_shape_plans_without_a_copy(monkeypatch):
    """(4096, 151936) fp32 keeps its shape in the plan, and
    ``_launch_xent`` hands the caller's storage to the kernel, as it does
    ragged (t, 501) logits, no whole number of 16-B vectors a row."""
    t, v = 64, 151936
    p = api.plan_for("xent", (4096, v), torch.float32)
    assert p.padded_shape == (4096, v) and p.block_rows == 1
    seen = []
    real = kernel.xent_nll

    def spy(logits, labels, **kw):
        seen.append(logits.data_ptr())
        return real(logits, labels, **kw)

    monkeypatch.setattr(kernel, "xent_nll", spy)
    logits = torch.zeros((t, v))
    api.launch("xent", logits, torch.zeros(t, dtype=torch.int32))
    assert seen == [logits.data_ptr()]
    ragged = torch.zeros((t, 501))
    api.launch("xent", ragged, torch.zeros(t, dtype=torch.int32))
    assert seen[-1] == ragged.data_ptr()    # 501 fp32: read in place


def test_autograd_guard():
    """The guard a CUDA wrapper calls before launching: an input that
    requires grad raises with grad mode on, and passes without it."""
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="XentFn"):
        util.refuse_autograd("xent", "repro_torch.models.transformer.XentFn",
                             x)
    with torch.no_grad():
        util.refuse_autograd("xent", "XentFn", x)
    util.refuse_autograd("xent", "XentFn", x.detach(), None)
