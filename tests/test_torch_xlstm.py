"""The port's ssm family (xlstm: mLSTM and sLSTM blocks) against the JAX
package, on the CPU.

Reduced xlstm-1.3b on both sides (``reduce_for_smoke``: 4 layers in the
stages [mlstm 3, slstm 1], d_model 128, 4 heads, mLSTM d_inner 256 in heads
of P = 64), fp32, the weights drawn with numpy (``interop.numpy_params``)
and carried into both packages.  The reference's own ``model.init`` is not
used: it folds Python's salted ``hash`` of each path into the key, so its
weights change from one process to the next (ROADMAP §C).

The reference's fault (ROADMAP §C): its chunkwise mLSTM takes
``exp(dmat)`` over the whole chunk and masks the causal upper triangle
after the exp; above the diagonal the exponent grows with the chunk length,
overflows to inf past about 190 tokens, and the backward multiplies the
masked cotangent 0 by inf.  Its forward stays finite, its gradient at
S = 300 has non-finite leaves.  The port masks the exponent before the exp.
The oracle past the fault is the reference itself with
``repro.models.xlstm.CHUNK`` set to 64 from outside the package (the chunk
form is exact for any chunk length, and every exponent stays small).

Tolerances.  Logits and block outputs ``LOGITS`` (rtol 1e-4, atol 1e-5)
where both sides' fp32 rounding allows it.  Past a few dozen tokens it does
not: against the port run in float64 on the same weights, the reference's
fp32 logits lie 2.3e-5 away at S = 64 and 6.8e-5 at S = 300 (logits of
scale 4.1 and 4.5; the port's lie 3.8e-5 and 6.7e-5 away), so an atol of
1e-5 is below the reference's own rounding.  There the comparison is
``SCALED``: rtol 1e-4 and an atol of 1e-4 of the largest magnitude
(measured: 8.8e-5 at S = 300, 2e-5 of the scale).  Gradients: within 1e-4
of each leaf's scale (measured against the CHUNK = 64 reference: 5.5e-5).
The decode against the forward at S = 300: 2e-3 absolute, the reference's
own decode-consistency tolerance (tests/test_models.py).  The norms'
rounding in bf16: in ulps, as each test states.  The model's forward at
S = 12 and its decode step on dense and paged caches are
tests/test_torch_models.py's xlstm cases; serving's paged = dense and
slot reuse, tests/test_torch_serving.py's; the train step,
tests/test_torch_train.py's.
"""
import contextlib
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.xlstm as jxlstm
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models import build_model as jbuild_model
from repro_torch import interop
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.interop import numpy_params
from repro_torch.models import build_model, xlstm
from repro_torch.models.params import ParamDef, init_params, leaves
from repro_torch.parallel import steps
from repro_torch.serving import ContinuousBatcher, Request
from _torch_mesh import assert_launcher_trains_on_a_mesh, assert_mesh_runs

ARCH = "xlstm-1.3b"
LOGITS = dict(rtol=1e-4, atol=1e-5)
DECODE_ATOL = 2e-3
CPU = dict(device="cpu")


def to_np(t):
    return interop.to_numpy(t)


def assert_scaled(got, want, what=""):
    """``SCALED``: rtol 1e-4, atol 1e-4 of the largest |want|."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()),
                               err_msg=what)


def configs(**changes):
    return (dataclasses.replace(jreduce(jget_config(ARCH)), **changes),
            dataclasses.replace(reduce_for_smoke(get_config(ARCH)), **changes))


def pair(seed=0, true_fan_in=True):
    """(jax model, jax params, port model, port params), the same numpy
    weights: at the port's init stds, or the reference's (``shape[-2]``)."""
    jcfg, cfg = configs()
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    defs = model.param_defs() if true_fan_in else jmodel.param_defs()
    tree = numpy_params(defs, seed, true_fan_in=true_fan_in)
    return (jmodel, jax.tree.map(jnp.asarray, tree), model,
            interop.params_from_jax(tree, cfg, **CPU))


def tokens(s, b=2, seed=1):
    return np.random.default_rng(seed).integers(0, 512, size=(b, s))


def block_pair(kind, seed=0):
    """(jax cfg, port cfg, jax params, port params) of one ``kind``
    ("mlstm" or "slstm") layer at the port's init stds."""
    jcfg, cfg = configs()
    tree = numpy_params(getattr(xlstm, f"{kind}_defs")(cfg), seed,
                        true_fan_in=True)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, tree),
            {k: torch.as_tensor(v) for k, v in tree.items()})


@contextlib.contextmanager
def one_thread():
    """Run a token-by-token loop of small ops (the sLSTM's time steps, a
    decode loop) on one intra-op thread: they are too small to split, and
    the suite runs several workers at once, where split ops wait on each
    other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------


def test_stages_and_trees_match_the_reference():
    jcfg, cfg = configs()
    assert cfg.stages() == jcfg.stages() == [("mlstm", 3), ("slstm", 1)]
    full = get_config(ARCH)
    assert full.stages() == jget_config(ARCH).stages() == (
        [("mlstm", 7), ("slstm", 1)] * 6)
    for n_layers, every in ((7, 3), (6, 3), (5, 0), (9, 2), (1, 4)):
        j, p = configs(n_layers=n_layers, slstm_every=every)
        assert p.stages() == j.stages(), (n_layers, every)
    model = build_model(cfg)
    want = {path: tuple(d.shape) for path, d in
            leaves(jbuild_model(jcfg).param_defs())}
    got = {path: tuple(d.shape) for path, d in leaves(model.param_defs())}
    assert got == want
    assert got[("s00_mlstm", "mlstm", "wq")] == (3, 4, 64, 64)
    assert got[("s01_slstm", "slstm", "wx")] == (1, 128, 4, 128)
    jm = jbuild_model(jcfg)
    for defs, jdefs in ((model.cache_defs(3, 16), jm.cache_defs(3, 16)),
                        (model.paged_cache_defs(3, 16, 7, 4),
                         jm.paged_cache_defs(3, 16, 7, 4))):
        assert ({p: tuple(d.shape) for p, d in leaves(defs)}
                == {p: tuple(d.shape) for p, d in leaves(jdefs)})
    # no attention stage: the paged cache holds no page pool
    paged = model.paged_cache_defs(3, 16, 7, 4)
    assert not any("k" in sub for k, sub in paged.items()
                   if isinstance(sub, dict))


def test_full_width_size_matches_the_reference():
    """xlstm-1.3b at full width: 1,945,057,616 parameters and, at 8 slots,
    5,652,485,408 B of serving state, as the reference counts them."""
    model = build_model(get_config(ARCH))
    n = sum(t.numel() for _, t in leaves(model.abstract_params()))
    jn = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        jbuild_model(jget_config(ARCH)).abstract_params()))
    assert n == jn == 1_945_057_616
    state = sum(d.abstract().nbytes for _, d in
                leaves(model.cache_defs(8, 1024)))
    assert state == 5_652_485_408


def test_params_from_jax_maps_the_xlstm_tree_leaf_for_leaf():
    jcfg, cfg = configs()
    tree = numpy_params(jbuild_model(jcfg).param_defs(), 4)
    params = interop.params_from_jax(tree, cfg, **CPU)
    ref, port = dict(leaves(tree)), dict(leaves(params))
    assert ref.keys() == port.keys()
    for path, arr in ref.items():
        np.testing.assert_array_equal(to_np(port[path]), arr)
    # the conv at its explicit scale 0.5, bf's ones and bi's zeros
    mlstm = tree["s00_mlstm"]["mlstm"]
    assert float(mlstm["conv"].std()) == pytest.approx(0.5, rel=0.05)
    assert float(mlstm["bf"].mean()) == pytest.approx(1.0, abs=0.05)
    assert float(np.abs(mlstm["bi"]).max()) < 0.1
    # at bf16 the gate and recurrence leaves stay fp32
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    params = interop.params_from_jax(tree, bf16, **CPU)
    f32 = {("s00_mlstm", "mlstm", k) for k in ("wi", "wf", "bi", "bf")} | {
        ("s01_slstm", "slstm", k) for k in ("wx", "r", "b")}
    for path, t in leaves(params):
        assert t.dtype == (torch.float32 if path in f32
                           else torch.bfloat16), path


def test_slstm_wx_takes_the_true_fan_in():
    """``wx`` (d, 4, d) is drawn at 1/sqrt(d) at full width, where the
    reference's ``shape[-2]`` rule gives 1/sqrt(4) = 0.5, 22.6x too large
    (ROADMAP §C)."""
    d = get_config(ARCH).d_model
    wx = xlstm.slstm_defs(get_config(ARCH))["wx"]
    jwx = jxlstm.slstm_defs(jget_config(ARCH))["wx"]
    assert wx.fan_in == d == 2048 and jwx.fan_in == 4
    drawn = wx.materialize(torch.Generator().manual_seed(0),
                           torch.device("cpu"))
    assert float(drawn.std()) == pytest.approx(d ** -0.5, rel=0.01)
    # numpy_params keeps the reference's rule unless asked for the port's
    ref_std = numpy_params({"wx": wx}, 0)["wx"].std()
    port_std = numpy_params({"wx": wx}, 0, true_fan_in=True)["wx"].std()
    assert float(ref_std) == pytest.approx(0.5, rel=0.01)
    assert float(port_std) == pytest.approx(d ** -0.5, rel=0.01)
    # the gates' input part on unit-variance rows (ln1's output): std 1 at
    # the port's init, 22.6 at the reference's
    x = torch.randn(64, d, generator=torch.Generator().manual_seed(1))
    for tree, want in ((numpy_params({"wx": wx}, 0), 22.6),
                       (numpy_params({"wx": wx}, 0, true_fan_in=True), 1.0)):
        gx = torch.einsum("bd,dgi->bgi", x, torch.as_tensor(tree["wx"]))
        assert float(gx.std()) == pytest.approx(want, rel=0.05)
    # the other xLSTM weights: block-diagonal fan-in P = shape[-2]
    for name, want in (("wq", 1024), ("wup_x", 2048), ("wi", 4096)):
        assert xlstm.mlstm_defs(get_config(ARCH))[name].fan_in == want
    assert xlstm.slstm_defs(get_config(ARCH))["r"].fan_in == 512


# ---------------------------------------------------------------------------
# the blocks and the whole model against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 12, 64, 300])
def test_mlstm_forward_matches_reference(s):
    jcfg, cfg, jp, p = block_pair("mlstm")
    u = np.random.default_rng(2).standard_normal((2, s, 128)).astype(
        np.float32)
    want = jax.jit(lambda p, x: jxlstm.mlstm_forward(p, x, jcfg))(
        jp, jnp.asarray(u))
    got = to_np(xlstm.mlstm_forward(p, torch.as_tensor(u), cfg))
    if s <= 64:
        np.testing.assert_allclose(got, np.asarray(want), **LOGITS)
    else:
        assert_scaled(got, want)


@pytest.mark.parametrize("s", [1, 12, 300])
def test_slstm_forward_matches_reference(s):
    jcfg, cfg, jp, p = block_pair("slstm")
    u = np.random.default_rng(2).standard_normal((2, s, 128)).astype(
        np.float32)
    want = jax.jit(lambda p, x: jxlstm.slstm_forward(p, x, jcfg))(
        jp, jnp.asarray(u))
    with one_thread():
        got = xlstm.slstm_forward(p, torch.as_tensor(u), cfg)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **LOGITS)


def test_forward_logits_match_reference_at_64():
    """S = 64, one chunk (S = 12 at ``LOGITS`` is
    tests/test_torch_models.py's case of this model)."""
    jmodel, jparams, model, params = pair()
    toks = tokens(64)
    want, _ = jax.jit(jmodel.forward)(jparams, jnp.asarray(toks, jnp.int32))
    with one_thread():
        got, aux = model(params, torch.as_tensor(toks))
    assert got.shape == (2, 64, 512) and float(aux) == 0.0
    assert_scaled(to_np(got), want)


def _state(defs, rng):
    """A random nonzero state for each leaf of a layer's cache defs."""
    return {k: rng.standard_normal(d.shape[1:]).astype(np.float32)
            for k, d in defs.items()}


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_step_matches_reference(kind):
    """One mLSTM or sLSTM layer stepped 5 tokens from a nonzero state,
    against the reference's decode step; the state is written in place."""
    jcfg, cfg, jp, p = block_pair(kind)
    step = getattr(xlstm, f"{kind}_decode_step")
    rng = np.random.default_rng(3)
    jcache = _state(getattr(jxlstm, f"{kind}_cache_defs")(jcfg, 2, 1), rng)
    cache = {k: torch.tensor(v) for k, v in jcache.items()}
    jstep = jax.jit(lambda p, c, u: getattr(jxlstm, f"{kind}_decode_step")(
        p, c, u, jcfg))
    jc = jax.tree.map(jnp.asarray, jcache)
    for t in range(5):
        u = rng.standard_normal((2, 1, 128)).astype(np.float32)
        want, jc = jstep(jp, jc, jnp.asarray(u))
        got, out = step(p, cache, torch.as_tensor(u), cfg)
        assert out is cache
        np.testing.assert_allclose(to_np(got), np.asarray(want), **LOGITS,
                                   err_msg=f"step {t}")
        for k in jc:
            np.testing.assert_allclose(to_np(cache[k]), np.asarray(jc[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_step_keeps_frozen_rows(kind):
    """A row whose ``act`` is 0 keeps the state it had, C of the mLSTM
    included (updated as C * 1 + 0)."""
    _, cfg = configs()
    defs = getattr(xlstm, f"{kind}_defs")(cfg)
    p = init_params(0, defs, **CPU)
    cache = init_params(0, getattr(xlstm, f"{kind}_cache_defs")(cfg, 2, 1),
                        **CPU)
    cache = {k: torch.randn_like(v[0]) for k, v in cache.items()}
    before = {k: v.clone() for k, v in cache.items()}
    getattr(xlstm, f"{kind}_decode_step")(
        p, cache, torch.randn(2, 1, 128), cfg,
        act=torch.tensor([1, 0], dtype=torch.int32))
    for k in cache:
        assert torch.equal(cache[k][1], before[k][1]), k
        assert not torch.equal(cache[k][0], before[k][0]), k


@pytest.fixture(scope="module")
def at_300():
    """At S = 300: the reference's forward (finite), the port's forward
    and the port's token-by-token ``decode_step``."""
    jmodel, jparams, model, params = pair()
    toks = tokens(300)
    want, _ = jax.jit(jmodel.forward)(jparams, jnp.asarray(toks, jnp.int32))
    cache = init_params(0, model.cache_defs(2, 300), **CPU)
    outs = []
    with torch.inference_mode(), one_thread():
        forward, _ = model(params, torch.as_tensor(toks))
        for t in range(300):
            logits, cache = model.decode_step(
                params, cache, torch.as_tensor(toks[:, t:t + 1]))
            outs.append(logits)
    return types.SimpleNamespace(reference=np.asarray(want), forward=forward,
                                 decode=torch.cat(outs, dim=1))


def test_forward_logits_match_reference_at_300(at_300):
    assert np.isfinite(at_300.reference).all()
    assert_scaled(to_np(at_300.forward), at_300.reference)


def test_port_decode_matches_its_own_forward_at_300(at_300):
    """The reference's decode-consistency test (tests/test_models.py), at
    S = 300: across the mLSTM's chunk boundary."""
    err = (at_300.decode - at_300.forward).abs().max()
    assert float(err) < DECODE_ATOL


# ---------------------------------------------------------------------------
# the reference's mLSTM gradient fault
# ---------------------------------------------------------------------------


def test_reference_mlstm_gradient_is_not_finite_at_300_and_the_ports_is():
    """The fault at its source, one mLSTM layer (the reference's init
    stds, fp32, S = 300 across a chunk of 256): the gradient of the sum of
    squares of the reference's ``mlstm_forward`` has non-finite leaves
    (its forward is finite); the port's has none.  Whole-model gradients
    of the port: ``grads_300`` below."""
    jcfg, cfg = configs()
    tree = numpy_params(jxlstm.mlstm_defs(jcfg), 0)
    u = np.random.default_rng(2).standard_normal((2, 300, 128)).astype(
        np.float32)
    out, grads = jax.jit(jax.value_and_grad(
        lambda p, x: jnp.sum(jxlstm.mlstm_forward(p, x, jcfg) ** 2)))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(u))
    assert np.isfinite(float(out))
    bad = {k for k, g in grads.items() if not np.isfinite(g).all()}
    assert {"wi", "wf", "bi", "bf"} <= bad     # the gates, through dmat
    p = {k: torch.tensor(v, requires_grad=True) for k, v in tree.items()}
    torch.sum(xlstm.mlstm_forward(p, torch.as_tensor(u), cfg) ** 2).backward()
    for k, t in p.items():
        assert bool(torch.isfinite(t.grad).all()), k


@pytest.fixture(scope="module")
def grads_300():
    """The loss and gradients at S = 300, the reference's init stds: the
    reference with CHUNK = 64 (its exponents stay small), and the port
    with the chunks rematerialised (True) or kept (False)."""
    jmodel, jparams, model, params = pair(true_fan_in=False)
    toks = tokens(300)
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32),
              "labels": jnp.asarray(toks, jnp.int32)}
    out = types.SimpleNamespace()
    chunk = jxlstm.CHUNK
    jxlstm.CHUNK = 64
    try:   # a new function: jit keeps a trace for each function it wraps
        grad = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss(p, b)))
        out.chunk64 = jax.tree.map(np.asarray, grad(jparams, jbatch))
    finally:
        jxlstm.CHUNK = chunk
    batch = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(toks)}
    out.port = {}
    with one_thread():
        for remat in (False, True):
            m = build_model(dataclasses.replace(model.cfg, remat=remat))
            out.port[remat] = steps.value_and_grad(m, params, batch)
    return out


def test_port_model_gradient_at_300_is_finite(grads_300):
    """Every leaf finite and nonzero somewhere (the masked exponent's
    gradient is 0, not 0 * inf), with the chunks rematerialised or kept."""
    for remat in (False, True):
        loss, grads = grads_300.port[remat]
        assert np.isfinite(float(loss))
        for path, g in leaves(grads):
            assert bool(torch.isfinite(g).all()), path
            assert bool(g.abs().max() > 0), path


def test_port_grads_match_the_reference_at_chunk_64(grads_300):
    """The port's loss and every gradient leaf at S = 300 against the
    reference run with CHUNK = 64: loss rtol 1e-5, each leaf within 1e-4
    of its scale."""
    want_loss, want = grads_300.chunk64
    assert all(np.isfinite(g).all() for _, g in leaves(want))
    loss, got = grads_300.port[False]
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got = dict(leaves(got))
    for path, w in leaves(want):
        np.testing.assert_allclose(
            to_np(got[path]), w, rtol=0,
            atol=1e-4 * float(np.abs(w).max()), err_msg="/".join(path))


def test_remat_on_and_off_give_equal_grads(grads_300):
    on, off = grads_300.port[True], grads_300.port[False]
    np.testing.assert_allclose(float(on[0]), float(off[0]), rtol=1e-6)
    on = dict(leaves(on[1]))
    for path, g in leaves(off[1]):
        np.testing.assert_allclose(to_np(on[path]), to_np(g), rtol=1e-5,
                                   atol=1e-7, err_msg="/".join(path))


# ---------------------------------------------------------------------------
# the norms: B10 inside the mLSTM, B9 inside the sLSTM
# ---------------------------------------------------------------------------


def _ulps(got, want):
    """|got - want| in bf16 ulps of ``want``."""
    w = np.abs(want)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(w, 1e-30))) - 7)
    return np.abs(got - want) / ulp


def _mlstm_out_ref(h, z, gnorm, dtype):
    """The reference's ``_mlstm_out`` (gate, norm, projection) with an
    identity projection, which leaves the norm's output as it is."""
    d = gnorm.shape[0]
    jcfg, _ = configs()
    p = {"gnorm": jnp.asarray(gnorm, dtype), "wo": jnp.eye(d, dtype=dtype)}
    return jxlstm._mlstm_out(p, jnp.asarray(h, jnp.float32),
                             jnp.asarray(z, dtype), jcfg, dtype)


def _slstm_norm_ref(h, gnorm, dtype, eps=1e-6):
    """The reference's inline sLSTM output norm (repro/models/xlstm.py,
    ``slstm_forward``): normalised in fp32, rounded, times ``gnorm``."""
    hf = jnp.asarray(h, jnp.float32)
    return (hf * jax.lax.rsqrt((hf * hf).mean(-1, keepdims=True) + eps)
            ).astype(dtype) * jnp.asarray(gnorm, dtype)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32),
                      np.float64)


@pytest.mark.parametrize("rows", [8, 64])
def test_mlstm_gate_is_b10_against_the_reference_inline_gate_in_bf16(rows):
    """B10's plain version (the port's ``_mlstm_out``) and the reference's
    inline gate and norm on the same inputs in bf16 (the cell output h
    fp32, rounded to bf16 on both sides first), against the exact value
    of the function of the bf16 inputs: B10 within 2 bf16 ulps, the
    reference within 4 (its four roundings), the two within 6 of each
    other."""
    _, cfg = configs()
    d = 4096
    rng = np.random.default_rng(5)
    h = rng.standard_normal((rows, 1, 4, d // 4)).astype(np.float32)
    z = 2 * rng.standard_normal((rows, 1, d)).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    want = np.asarray(_mlstm_out_ref(h, z, g, jnp.bfloat16).astype(
        jnp.float32))[:, 0]
    p = {"gnorm": interop.to_torch(g, dtype="bfloat16", **CPU),
         "wo": torch.eye(d, dtype=torch.bfloat16)}
    got = xlstm._mlstm_out(p, torch.as_tensor(h),
                           interop.to_torch(z, dtype="bfloat16", **CPU), cfg,
                           torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = to_np(got)[:, 0]
    yb, zb, gb = _bf16(h.reshape(rows, d)), _bf16(z[:, 0]), _bf16(g)
    gate = yb * zb / (1 + np.exp(-zb))
    exact = gate / np.sqrt((gate * gate).mean(-1, keepdims=True) + 1e-6) * gb
    assert _ulps(got, exact).max() <= 2
    assert _ulps(want, exact).max() <= 4
    assert _ulps(got, want).max() <= 6


@pytest.mark.parametrize("rows", [8, 64])
def test_slstm_norm_is_b9_against_the_reference_inline_norm_in_bf16(rows):
    """B9's plain version on the fp32 cell output with the scale in fp32,
    rounded once to bf16 (the port's ``_slstm_out``), and the reference's
    inline norm (rounded after the normalisation, then times ``gnorm`` in
    bf16), against the exact value: B9 within 0.5 bf16 ulps (its one
    rounding, 0.5 plus fp32's own error), the reference within 1.5 (two
    roundings), the two within 2 of each other."""
    _, cfg = configs()
    d = 2048
    rng = np.random.default_rng(6)
    h = rng.standard_normal((rows, d)).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    want = np.asarray(_slstm_norm_ref(h, g, jnp.bfloat16).astype(
        jnp.float32))
    p = {"gnorm": interop.to_torch(g, dtype="bfloat16", **CPU),
         "wo": torch.eye(d, dtype=torch.bfloat16)}
    got = xlstm._slstm_out(p, torch.as_tensor(h), cfg, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = to_np(got)
    hd, gb = h.astype(np.float64), _bf16(g)
    exact = hd / np.sqrt((hd * hd).mean(-1, keepdims=True) + 1e-6) * gb
    assert _ulps(got, exact).max() <= 0.5 + 1e-3
    assert _ulps(want, exact).max() <= 1.5
    assert _ulps(got, want).max() <= 2


def test_the_norms_against_the_reference_inline_formulas_in_fp32():
    _, cfg = configs()
    rng = np.random.default_rng(7)
    h = rng.standard_normal((3, 7, 4, 64)).astype(np.float32)
    z = rng.standard_normal((3, 7, 256)).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    want = _mlstm_out_ref(h, z, g, jnp.float32)
    p = {"gnorm": torch.as_tensor(g), "wo": torch.eye(256)}
    got = xlstm._mlstm_out(p, torch.as_tensor(h), torch.as_tensor(z), cfg,
                           torch.float32)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **LOGITS)
    hs = rng.standard_normal((3, 7, 128)).astype(np.float32)
    g = g[:128]
    want = _slstm_norm_ref(hs, g, jnp.float32)
    p = {"gnorm": torch.as_tensor(g), "wo": torch.eye(128)}
    got = xlstm._slstm_out(p, torch.as_tensor(hs), cfg, torch.float32)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **LOGITS)


def test_the_model_launches_b10_an_mlstm_layer_and_b9_an_slstm_layer(
        monkeypatch):
    """Every mLSTM layer's gate and norm goes through
    ``api.launch("rmsnorm.gated")``, every sLSTM output norm, ln1 and the
    final norm through ``api.launch("rmsnorm")``, in the forward and in a
    decode step; the sLSTM's norm on fp32 rows with an fp32 scale."""
    from repro_torch.api import dispatch

    _, _, model, params = pair()
    params = interop.params_from_jax(
        interop.numpy_params(model.param_defs(), 0, true_fan_in=True),
        dataclasses.replace(model.cfg, dtype="bfloat16"), **CPU)
    model = build_model(dataclasses.replace(model.cfg, dtype="bfloat16"))
    seen = []
    launch = dispatch.launch

    def counting(name, *args, **kw):
        seen.append((name, args[0].dtype, args[-1].dtype))
        return launch(name, *args, **kw)

    monkeypatch.setattr(dispatch, "launch", counting)
    with torch.inference_mode():
        model(params, torch.as_tensor(tokens(5)))
        fwd = list(seen)
        seen.clear()
        cache = init_params(0, model.cache_defs(2, 8), **CPU)
        model.decode_step(params, cache, torch.as_tensor(tokens(1)))
    stages = model.cfg.stages()
    n_m = sum(n for kind, n in stages if kind == "mlstm")
    n_s = sum(n for kind, n in stages if kind == "slstm")
    bf16, f32 = torch.bfloat16, torch.float32
    for names in (fwd, seen):
        assert names.count(("rmsnorm.gated", bf16, bf16)) == n_m == 3
        assert names.count(("rmsnorm", f32, f32)) == n_s == 1
        assert names.count(("rmsnorm", bf16, bf16)) == n_m + n_s + 1 == 5
        assert len(names) == 9


# ---------------------------------------------------------------------------
# serving state, the mesh, the launchers
# ---------------------------------------------------------------------------


def test_slot_reset_restores_the_reused_slots_state():
    """A reused slot's mLSTM and sLSTM rows go back to the template along
    their batch axis: c, n, h and conv to zeros, m to -1e30."""
    model = build_model(reduce_for_smoke(get_config(ARCH)))
    params = model.init(0, **CPU)
    b = ContinuousBatcher(model, params, slots=2, max_len=32, **CPU)
    b.run([Request(0, [5, 6, 7], 3), Request(1, [8, 9], 2)])
    stages = {k: v for k, v in b.cache.items() if k.startswith("s")}
    assert set(stages) == {"s00_mlstm", "s01_slstm"}
    for leaf in ("c", "n", "m"):
        assert bool((stages["s00_mlstm"][leaf][:, 1] > -1e30).any())
    with torch.inference_mode():
        b._reset_slot(b.cache, 1)
    for name, stage in stages.items():
        for k, leaf in stage.items():
            fill = -1e30 if k == "m" else 0.0
            assert bool((leaf[:, 1] == fill).all()), (name, k)
            assert bool((leaf[:, 0] != fill).any()), (name, k)


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(1, 512, size=3 + 2 * i).tolist(),
                    max_new_tokens=4 + i) for i in range(n)]


def _clone(reqs):
    return [Request(r.rid, list(r.prompt), r.max_new_tokens) for r in reqs]


def test_chunked_prefill_keeps_the_frozen_rows_state():
    """Chunked prefill changes no token: rows that advance fewer tokens
    than the chunk keep their mLSTM and sLSTM state through the masked
    micro-steps, on the paged and the dense cache."""
    model = build_model(reduce_for_smoke(get_config(ARCH)))
    params = model.init(0, **CPU)
    reqs = _requests(4)
    with one_thread():
        one = ContinuousBatcher(model, params, slots=2, max_len=40, **CPU)
        want = one.run(_clone(reqs))
        for kv in ("paged", "dense"):
            chunked = ContinuousBatcher(model, params, slots=2, max_len=40,
                                        kv_cache=kv, prefill_chunk=4, **CPU)
            assert chunked.run(_clone(reqs)) == want, kv
            assert chunked.ticks < one.ticks


def test_greedy_tokens_equal_across_frameworks():
    """The same weights and requests give the same greedy tokens through
    the reference's batcher and the port's (paged, chunked prefill), after
    asserting a top-2 logit gap of at least 1e-3 at every decision."""
    from repro.serving import ContinuousBatcher as JBatcher
    from repro.serving import Request as JRequest

    jmodel, jparams, model, params = pair(11)
    reqs = _requests(3, seed=5)
    with one_thread():
        got = ContinuousBatcher(model, params, slots=2, max_len=24,
                                kv_cache="paged", prefill_chunk=4,
                                **CPU).run(_clone(reqs))
    for r in reqs:
        seq = r.prompt + got[r.rid]
        logits, _ = model(params, torch.as_tensor([seq[:-1]]))
        top2 = torch.topk(logits[0, len(r.prompt) - 1:], 2, dim=-1).values
        gap = float((top2[:, 0] - top2[:, 1]).min())
        assert gap >= 1e-3, f"request {r.rid}: top-2 gap {gap} too small"
    want = JBatcher(jmodel, jparams, slots=2, max_len=24).run(
        [JRequest(r.rid, list(r.prompt), r.max_new_tokens) for r in reqs])
    assert got == want


def test_a_mesh_with_a_model_axis_refuses_the_ssm_family(tmp_path):
    """The ssm family on a mesh (ROADMAP A11.5): the masked loss and a
    decode step run, under the flash-decoding rules too (the family has no
    KV cache to cut; ``_torch_mesh.assert_mesh_runs``;
    tests/test_torch_serve_mesh.py serves it on three meshes); the vocab-
    parallel training on a model axis runs (tests/test_torch_mesh_families.py
    holds it to the reference), and so does FSDP (tests/test_torch_fsdp.py)."""
    _, cfg = configs()
    assert_mesh_runs(cfg)
    assert_launcher_trains_on_a_mesh(ARCH, "1x2", tmp_path)


def test_serve_launcher_runs_the_xlstm(capsys):
    from repro_torch.launch import serve

    res = serve.main(["--arch", ARCH, "--mesh", "host", "--device", "cpu",
                      "--requests", "3", "--slots", "2", "--max-len", "32",
                      "--prompt-len", "3", "8", "--gen", "2", "5"])
    assert res["requests"] == 3
    out = capsys.readouterr().out
    assert "plan[rmsnorm] logical=(2, 128)" in out
    assert "plan[rmsnorm.gated] logical=(2, 256)" in out
    assert "xlstm-1.3b on cpu: 3 requests" in out


def test_cache_defs_declare_the_batch_axis_of_every_state_leaf():
    """The scheduler resets a slot along each leaf's declared batch axis:
    every mLSTM and sLSTM state leaf declares one, after its layer axis."""
    _, cfg = configs()
    for defs in (xlstm.mlstm_cache_defs(cfg, 3, 2),
                 xlstm.slstm_cache_defs(cfg, 3, 2)):
        for name, d in defs.items():
            assert isinstance(d, ParamDef)
            assert d.axes[:2] == ("layers", "batch"), name
            assert d.shape[:2] == (2, 3), name


def test_a_near_tie_of_the_mlstm_floor_flips_its_gradient():
    """ROADMAP §C Open 2: the xlstm-1.3b (1, 2) mesh's step-0 gradient norm
    at 2 x 512 tokens lay 2.5e-4 from one device's on the card, where both
    losses agree, because one element of layer 5's second chunk sat 1.87e-5
    (relative) from the tie of the mLSTM's floor ``max(|q . n|,
    exp(-m))`` (``xlstm._chunk``; the reference's
    ``src/repro/models/xlstm.py:148`` takes the same max), and the two
    runs' roundings (4.8e-5 of a layer's output) put it on either side
    (``scripts/xlstm_norm_gap.py``).  The function is continuous there and
    its gradient is not: with ``|den_i|`` a relative 1e-9 above and below
    ``exp(-m_i)`` in fp64, the chunk's output moves by about 1e-9 while
    the gradient of its inputs jumps by exactly ``|g_i . h_i| * ||grad(log
    |den_i| + m_i)||`` (g the output's cotangent), the bound a flip puts on
    the gradient's change, whatever the device."""
    rng = np.random.default_rng(0)
    b, l, h, p, i = 1, 8, 1, 4, 5
    f64 = dict(dtype=torch.float64)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, l, h, p)))
               for _ in range(3))
    li = torch.from_numpy(rng.standard_normal((b, l, h)))
    bc = torch.cumsum(torch.nn.functional.logsigmoid(
        torch.from_numpy(2 + rng.standard_normal((b, l, h)))), dim=1)
    c0, n0 = torch.zeros((b, h, p, p), **f64), torch.zeros((b, h, p), **f64)
    m0 = torch.full((b, h), -1e30, **f64)
    causal = torch.ones((l, l), dtype=torch.bool).tril()
    g = torch.from_numpy(rng.standard_normal((b, l, h, p)))

    def den_and_m(qq, kk, ll, bb):
        u = torch.maximum(m0[:, None], torch.cummax(ll - bb, dim=1).values)
        m = bb + u
        w = torch.exp(torch.where(causal[None, :, :, None],
                                  bb[:, :, None] - bb[:, None] + ll[:, None]
                                  - m[:, :, None], float("-inf")))
        return torch.einsum("bihp,bihp->bih", qq,
                            torch.einsum("bijh,bjhp->bihp", w, kk)), m

    den, m = den_and_m(q, k, li, bc)
    # q_i scaled so that |den_i| = exp(-m_i) (1 + s 1e-9): m is q's free
    tie = torch.exp(-m[0, i, 0]) / den[0, i, 0].abs()
    runs = []
    for s in (1, -1):
        qs = q.clone()
        qs[0, i] = q[0, i] * tie * (1 + s * 1e-9)
        ins = [t.clone().requires_grad_(True) for t in (qs, k, v, li, bc)]
        out = xlstm._chunk(c0, n0, m0, ins[0], ins[1], ins[2], ins[3],
                           ins[4], causal)[3]
        runs.append((out.detach(), torch.autograd.grad(out, ins, g), ins))
    (h_up, g_up, ins), (h_dn, g_dn, _) = runs
    jump = torch.sqrt(sum(((a - c) ** 2).sum() for a, c in zip(g_up, g_dn)))
    scale = torch.sqrt(sum((a ** 2).sum() for a in g_up))
    assert float((h_up - h_dn).abs().max() / h_up.abs().max()) < 1e-8
    assert float(jump / scale) > 1e-2
    d, mm = den_and_m(ins[0], ins[1], ins[3], ins[4])
    grads = torch.autograd.grad(torch.log(d[0, i, 0].abs()) + mm[0, i, 0],
                                ins, allow_unused=True,
                                materialize_grads=True)
    bound = abs(float((g[0, i, 0] * h_up[0, i, 0]).sum())) * float(
        torch.sqrt(sum((a ** 2).sum() for a in grads)))
    assert float(jump) == pytest.approx(bound, rel=1e-5)
