"""The port's hybrid family (zamba2: Mamba2 + a shared attention block)
against the JAX package, on the CPU.

Reduced zamba2-1.2b on both sides (``reduce_for_smoke``: 4 mamba layers in
two stages of 2, two applications of the shared block, d_model 128,
d_inner 256, 8 SSM heads of 32, state 16), fp32, the weights drawn with
numpy (``interop.numpy_params``) and carried into both packages.

Weights.  The whole-model parity tests draw the port's init stds
(``true_fan_in=True``, ROADMAP §C).  At the reference's ``shape[-2]``
fan-in the shared block's ``wq`` and ``wk`` have std 0.5 on a 128-wide
input, its attention scores a std near 30, and the logits so
ill-conditioned that fp32 reordering alone moves them: at S = 12 the port
(fp32) lies 2.7e-4 and the reference (fp32) 1.7e-4 from the port run in
float64 on the same weights, logits of scale 4.  At the true fan-ins both
agree to 1e-5 relative.  The Mamba2 block alone is well conditioned at
either init and is held at the reference's.

The reference's fault (ROADMAP §C): its chunked SSD takes
``exp(cum_i - cum_j)`` over the whole chunk and masks the causal upper
triangle afterwards, as a product; past about 110 tokens the exponent
overflows, inf * 0 is NaN, and its forward is NaN from S = 128 on.  The
port masks the exponent before the exp.  The fault does not depend on the
attention init (dt comes from ``wdt``, whose fan-in both rules agree on):
the NaN test runs at both inits.  The reference's own ``model.init`` is
not used: it folds Python's salted ``hash`` of each path into the key, so
its weights change from one process to the next.

At S = 300, past a chunk boundary, the port's forward lies 1.2e-4 from the
reference's token-by-token decode at the port's init stds (measured; both
within 1e-4 of the port run in float64).  At the reference's fan-in the
same comparison gives 1.9e-3, the ill-conditioning above (the port's fp32
forward lies 1.9e-3 from its float64 run, the reference's decode 7.7e-4).

Tolerances: logits ``LOGITS`` (rtol 1e-4, atol 1e-5); the forward at
S = 300 against token-by-token decoding 2e-3 absolute, the reference's own
decode-consistency tolerance (tests/test_models.py); the gated norm as
each test states.
"""
import contextlib
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models import build_model as jbuild_model
from repro.models import mamba2 as jmamba2
from repro.models.params import init_params as jinit_params
from repro_torch import api, interop
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.interop import numpy_params
from repro_torch.models import blocks, build_model, mamba2
from repro_torch.models.params import init_params, leaves
from repro_torch.parallel import steps
from repro_torch.serving import ContinuousBatcher, Request
from _torch_mesh import assert_launcher_trains_on_a_mesh, assert_mesh_runs

ARCH = "zamba2-1.2b"
LOGITS = dict(rtol=1e-4, atol=1e-5)
DECODE_ATOL = 2e-3
CPU = dict(device="cpu")


def to_np(t):
    return interop.to_numpy(t)


def configs(**changes):
    return (dataclasses.replace(jreduce(jget_config(ARCH)), **changes),
            dataclasses.replace(reduce_for_smoke(get_config(ARCH)), **changes))


def pair(seed=0, **changes):
    """(jax model, jax params, port model, port params), the same numpy
    weights at the port's init stds (the module docstring says why)."""
    jcfg, cfg = configs(**changes)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    tree = numpy_params(model.param_defs(), seed, true_fan_in=True)
    return (jmodel, jax.tree.map(jnp.asarray, tree), model,
            interop.params_from_jax(tree, cfg, **CPU))


def reference_fan_in_pair(seed=0):
    """As ``pair``, at the reference's init stds (``shape[-2]`` fan-in)."""
    jcfg, cfg = configs()
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    tree = numpy_params(jmodel.param_defs(), seed)
    return (jmodel, jax.tree.map(jnp.asarray, tree), model,
            interop.params_from_jax(tree, cfg, **CPU))


def tokens(s, b=2, seed=1):
    return np.random.default_rng(seed).integers(0, 512, size=(b, s))


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------


def test_stages_and_trees_match_the_reference():
    jcfg, cfg = configs()
    assert cfg.stages() == jcfg.stages() == [
        ("mamba", 2), ("shared_attn", 1), ("mamba", 2), ("shared_attn", 1)]
    full = get_config(ARCH)
    assert full.stages() == jget_config(ARCH).stages() == (
        [("mamba", 6), ("shared_attn", 1)] * 6 + [("mamba", 2)])
    for n_layers, period in ((7, 3), (6, 3), (5, 0)):
        changes = dict(n_layers=n_layers, shared_attn_period=period)
        j, p = configs(**changes)
        assert p.stages() == j.stages(), changes
    model = build_model(cfg)
    want = {path: tuple(d.shape) for path, d in
            leaves(jbuild_model(jcfg).param_defs())}
    got = {path: tuple(d.shape) for path, d in leaves(model.param_defs())}
    assert got == want
    assert "shared_attn" in model.param_defs()     # one subtree, unstacked
    assert got[("shared_attn", "win")] == (256, 128)
    assert got[("s00_mamba", "mamba", "wz")] == (2, 128, 256)
    for batch, max_len in ((3, 16),):
        jdefs = jbuild_model(jcfg).cache_defs(batch, max_len)
        defs = model.cache_defs(batch, max_len)
        assert ({p: tuple(d.shape) for p, d in leaves(defs)}
                == {p: tuple(d.shape) for p, d in leaves(jdefs)})


def test_full_width_size_matches_the_reference():
    """zamba2-1.2b at full width: 1,178,862,464 parameters, as the
    reference's ``abstract_params`` counts them."""
    model = build_model(get_config(ARCH))
    n = sum(t.numel() for _, t in leaves(model.abstract_params()))
    jn = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        jbuild_model(jget_config(ARCH)).abstract_params()))
    assert n == jn == 1_178_862_464


def test_params_from_jax_maps_the_hybrid_tree_leaf_for_leaf():
    jcfg, cfg = configs()
    tree = numpy_params(jbuild_model(jcfg).param_defs(), 4)
    params = interop.params_from_jax(tree, cfg, **CPU)
    ref, port = dict(leaves(tree)), dict(leaves(params))
    assert ref.keys() == port.keys()
    for path, arr in ref.items():
        np.testing.assert_array_equal(to_np(port[path]), arr)
    # the conv weights at their explicit scale 0.5, the others at fan-in
    conv = ref[("s00_mamba", "mamba", "conv_x")]
    assert float(conv.std()) == pytest.approx(0.5, rel=0.05)
    assert float(ref[("shared_attn", "win")].std()) == pytest.approx(
        1 / 16, rel=0.05)
    broken = numpy_params(jbuild_model(jcfg).param_defs(), 4)
    broken["shared_attn"]["win"] = np.zeros((128, 128), np.float32)
    with pytest.raises(ValueError, match="win"):
        interop.params_from_jax(broken, cfg, **CPU)


# ---------------------------------------------------------------------------
# the Mamba2 block and the whole model against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 12, 64])
def test_mamba_forward_matches_reference(s):
    jcfg, cfg = configs()
    tree = numpy_params(jmamba2.mamba_defs(jcfg), 0)
    u = np.random.default_rng(2).standard_normal((2, s, 128)).astype(
        np.float32)
    want = jax.jit(lambda p, x: jmamba2.mamba_forward(p, x, jcfg))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(u))
    got = mamba2.mamba_forward({k: torch.as_tensor(v) for k, v in tree.items()},
                               torch.as_tensor(u), cfg)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **LOGITS)


@pytest.mark.parametrize("s", [12, 32])
def test_forward_logits_match_reference(s):
    jmodel, jparams, model, params = pair()
    toks = tokens(s)
    want, _ = jax.jit(jmodel.forward)(jparams, jnp.asarray(toks, jnp.int32))
    got, aux = model(params, torch.as_tensor(toks))
    assert got.shape == (2, s, 512) and float(aux) == 0.0
    np.testing.assert_allclose(to_np(got), np.asarray(want), **LOGITS)


def test_mamba_decode_step_matches_reference():
    """One Mamba2 layer stepped 5 tokens from a nonzero conv and SSM state,
    against the reference's ``mamba_decode_step``."""
    jcfg, cfg = configs()
    tree = numpy_params(jmamba2.mamba_defs(jcfg), 0)
    rng = np.random.default_rng(3)
    jcache = {k: rng.standard_normal(d.shape[1:]).astype(np.float32)
              for k, d in jmamba2.mamba_cache_defs(jcfg, 2, 1).items()}
    cache = {k: torch.tensor(v) for k, v in jcache.items()}
    jp = jax.tree.map(jnp.asarray, tree)
    p = {k: torch.as_tensor(v) for k, v in tree.items()}
    jstep = jax.jit(lambda p, c, u: jmamba2.mamba_decode_step(p, c, u, jcfg))
    jc = jax.tree.map(jnp.asarray, jcache)
    for t in range(5):
        u = rng.standard_normal((2, 1, 128)).astype(np.float32)
        want, jc = jstep(jp, jc, jnp.asarray(u))
        got, out = mamba2.mamba_decode_step(p, cache, torch.as_tensor(u), cfg)
        assert out is cache                      # written in place
        np.testing.assert_allclose(to_np(got), np.asarray(want), **LOGITS,
                                   err_msg=f"step {t}")
        for k in jc:
            np.testing.assert_allclose(to_np(cache[k]), np.asarray(jc[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_mamba_decode_step_keeps_frozen_rows():
    """A row whose ``act`` is 0 writes back the state it found."""
    _, cfg = configs()
    p = init_params(0, mamba2.mamba_defs(cfg), **CPU)
    cache = init_params(0, mamba2.mamba_cache_defs(cfg, 2, 1), **CPU)
    cache = {k: torch.randn_like(v[0]) for k, v in cache.items()}
    before = {k: v.clone() for k, v in cache.items()}
    mamba2.mamba_decode_step(p, cache, torch.randn(2, 1, 128), cfg,
                             act=torch.tensor([1, 0], dtype=torch.int32))
    for k in cache:
        assert torch.equal(cache[k][1], before[k][1]), k
        assert not torch.equal(cache[k][0], before[k][0]), k


def _paged_caches(jmodel, model, batch, max_len, page_len):
    mp = -(-max_len // page_len)
    n_pages = 1 + batch * mp
    jcache = jinit_params(jax.random.PRNGKey(0), jmodel.paged_cache_defs(
        batch, max_len, n_pages, page_len))
    cache = init_params(0, model.paged_cache_defs(batch, max_len, n_pages,
                                                  page_len), **CPU)
    table = 1 + np.arange(batch * mp, dtype=np.int32).reshape(batch, mp)
    jcache["pages"] = jnp.asarray(table)
    cache["pages"] = torch.as_tensor(table)
    return jcache, cache


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_decode_step_logits_match_reference(cache):
    jmodel, jparams, model, params = pair()
    batch, max_len = 2, 16
    if cache == "paged":
        jc, tc = _paged_caches(jmodel, model, batch, max_len, page_len=4)
    else:
        jc = jinit_params(jax.random.PRNGKey(0),
                          jmodel.cache_defs(batch, max_len))
        tc = init_params(0, model.cache_defs(batch, max_len), **CPU)
    start = np.array([0, 3], np.int32)
    jc["idx"], tc["idx"] = jnp.asarray(start), torch.as_tensor(start)
    feed = np.random.default_rng(3).integers(0, 512, size=(6, batch, 1))
    jstep = jax.jit(jmodel.decode_step)
    for t, tok in enumerate(feed):
        want, jc = jstep(jparams, jc, jnp.asarray(tok, jnp.int32))
        got, tc = model.decode_step(params, tc, torch.as_tensor(tok))
        np.testing.assert_allclose(to_np(got), np.asarray(want), **LOGITS,
                                   err_msg=f"{cache} step {t}")
    np.testing.assert_allclose(to_np(tc["s00_mamba"]["ssm"]),
                               np.asarray(jc["s00_mamba"]["ssm"]),
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the reference's SSD fault, and the port past a chunk boundary
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("init", ["reference", "port"])
@pytest.mark.parametrize("s", [64, 128, 300])
def test_reference_forward_is_nan_past_110_tokens_and_the_port_is_finite(
        s, init):
    """ROADMAP §C's table: the reference's logits are finite at S = 64 and
    NaN at S = 128 and past a chunk (S = 300, two chunks of 256); the
    port's are finite at every S."""
    jmodel, jparams, model, params = (
        reference_fan_in_pair() if init == "reference" else pair())
    toks = tokens(s, b=1)
    want, _ = jax.jit(jmodel.forward)(jparams, jnp.asarray(toks, jnp.int32))
    got, _ = model(params, torch.as_tensor(toks))
    assert bool(torch.isfinite(got).all())
    want = np.asarray(want)
    if s < 110:
        assert np.isfinite(want).all()
    else:
        assert np.isnan(want).all()


@contextlib.contextmanager
def one_thread():
    """Run a token-by-token loop of small ops on one intra-op thread: they
    are too small to split, and the suite runs several workers on the
    machine's cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def port_decode(model, params, toks):
    """The port's token-by-token ``decode_step`` over ``toks`` (B, S)."""
    b, s = toks.shape
    cache = init_params(0, model.cache_defs(b, s), **CPU)
    outs = []
    with torch.inference_mode(), one_thread():
        for t in range(s):
            logits, cache = model.decode_step(
                params, cache, torch.as_tensor(toks[:, t:t + 1]))
            outs.append(logits)
    return torch.cat(outs, dim=1)


@pytest.fixture(scope="module")
def decode_300():
    """At S = 300: the reference's own token-by-token ``decode_step``
    (which never forms the chunk's decay and stays finite), the port's
    forward and the port's token-by-token ``decode_step``."""
    jmodel, jparams, model, params = pair()
    toks = tokens(300)
    cache = jinit_params(jax.random.PRNGKey(3), jmodel.cache_defs(2, 300))
    step = jax.jit(jmodel.decode_step)
    outs = []
    for t in range(300):
        logits, cache = step(jparams, cache,
                             jnp.asarray(toks[:, t:t + 1], jnp.int32))
        outs.append(np.asarray(logits))
    forward, _ = model(params, torch.as_tensor(toks))
    return types.SimpleNamespace(
        reference_decode=np.concatenate(outs, axis=1), forward=forward,
        decode=port_decode(model, params, toks))


def test_port_forward_matches_reference_decode_at_300(decode_300):
    want = decode_300.reference_decode
    assert np.isfinite(want).all()
    assert bool(torch.isfinite(decode_300.forward).all())
    np.testing.assert_allclose(to_np(decode_300.forward), want, rtol=0,
                               atol=DECODE_ATOL)


def test_port_decode_matches_reference_decode_at_300(decode_300):
    np.testing.assert_allclose(to_np(decode_300.decode),
                               decode_300.reference_decode, rtol=0,
                               atol=DECODE_ATOL)


def test_port_decode_matches_its_own_forward_at_300(decode_300):
    """The reference's decode-consistency test (tests/test_models.py), at
    S = 300: across a chunk boundary, where the reference cannot run it."""
    err = (decode_300.decode - decode_300.forward).abs().max()
    assert float(err) < DECODE_ATOL


@pytest.fixture(scope="module")
def grads_300():
    """The loss and gradients at S = 300, the reference's init stds, with
    the chunks rematerialised (True) or kept (False)."""
    _, _, model, params = reference_fan_in_pair()
    toks = torch.as_tensor(tokens(300))
    out = {}
    with one_thread():
        for remat in (False, True):
            m = build_model(dataclasses.replace(model.cfg, remat=remat))
            out[remat] = steps.value_and_grad(
                m, params, {"tokens": toks, "labels": toks})
    return out


@pytest.mark.parametrize("remat", [False, True])
def test_loss_gradient_at_300_is_finite(remat, grads_300):
    """The loss gradient across a chunk boundary: every leaf finite and
    nonzero somewhere (the masked exponent's gradient is 0, not 0 * inf),
    with the chunks rematerialised or kept."""
    loss, grads = grads_300[remat]
    assert np.isfinite(float(loss))
    for path, g in leaves(grads):
        assert bool(torch.isfinite(g).all()), path
        assert bool(g.abs().max() > 0), path


def test_remat_on_and_off_give_equal_grads_past_a_chunk(grads_300):
    np.testing.assert_allclose(float(grads_300[True][0]),
                               float(grads_300[False][0]), rtol=1e-6)
    on, off = dict(leaves(grads_300[True][1])), dict(leaves(
        grads_300[False][1]))
    for path, g in off.items():
        np.testing.assert_allclose(to_np(on[path]), to_np(g), rtol=1e-5,
                                   atol=1e-7, err_msg="/".join(path))


# ---------------------------------------------------------------------------
# the gated norm: B10 inside the model
# ---------------------------------------------------------------------------


def _inline_gate(y, z, gnorm, eps):
    """The reference's inline gate and norm (repro/models/mamba2.py)."""
    y = y * jax.nn.silu(z)
    yf = y.astype(jnp.float32)
    return (yf * jax.lax.rsqrt((yf * yf).mean(-1, keepdims=True) + eps)
            ).astype(y.dtype) * gnorm


def _ulps(got, want):
    """|got - want| in bf16 ulps of ``want`` (the spacing of bf16 values
    at |want|: 2**(floor(log2|want|) - 7))."""
    w = np.abs(want)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(w, 1e-30))) - 7)
    return np.abs(got - want) / ulp


@pytest.mark.parametrize("shape", [(8, 4096), (64, 256)])
def test_gated_kernel_against_the_reference_inline_gate_in_bf16(shape):
    """B10's plain version and the reference's inline formula on the same
    bf16 inputs.  B10 rounds twice (the gate, then the output); the
    reference four times (silu(z), the product, the normalised value, the
    product with the scale).  Held to the exact value of the function of
    the bf16 inputs (float64): B10 within 2 bf16 ulps (its gate's rounding
    carries into up to 1 ulp of the output, its own rounding half of one),
    the reference's formula within 4, and the two within 6 of each other,
    the sum (measured: 1.5, 3.7 and 4.0)."""
    rng = np.random.default_rng(5)
    y = rng.standard_normal(shape).astype(np.float32)
    z = 2 * rng.standard_normal(shape).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(shape[-1:])).astype(np.float32)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (y, z, g)]
    want = np.asarray(_inline_gate(*jb, 1e-6).astype(jnp.float32))
    tb = [interop.to_torch(a, dtype="bfloat16", **CPU) for a in jb]
    got = api.launch("rmsnorm.gated", *tb, eps=1e-6)
    assert got.dtype == torch.bfloat16
    got = to_np(got)
    yb, zb, gb = (np.asarray(a.astype(jnp.float32), np.float64) for a in jb)
    gate = yb * zb / (1 + np.exp(-zb))
    exact = gate / np.sqrt((gate * gate).mean(-1, keepdims=True) + 1e-6) * gb
    assert _ulps(got, exact).max() <= 2
    assert _ulps(want, exact).max() <= 4
    assert _ulps(got, want).max() <= 6


def test_gated_kernel_against_the_reference_inline_gate_in_fp32():
    rng = np.random.default_rng(6)
    y, z = (rng.standard_normal((3, 7, 256)).astype(np.float32)
            for _ in range(2))
    g = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    want = _inline_gate(jnp.asarray(y), jnp.asarray(z), jnp.asarray(g), 1e-6)
    got = api.launch("rmsnorm.gated", torch.as_tensor(y), torch.as_tensor(z),
                     torch.as_tensor(g), eps=1e-6)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **LOGITS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 7, 96), (16, 256)])
def test_gated_rmsnorm_fn_grads_match_autograd_through_the_plain_version(
        shape, dtype):
    """``GatedRMSNormFn``'s gradients against autograd through the plain
    gated function in fp32 (``kernels.rmsnorm.ref.gated_rmsnorm`` on fp32
    copies), cast to each input's dtype: fp32 rtol 1e-5 / atol 1e-6; bf16
    inputs give their gradients in bf16, to one bf16 rounding (rtol 1e-2)."""
    from repro_torch.kernels.rmsnorm import ref

    rng = np.random.default_rng(0)
    x, z, g = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    s = (rng.standard_normal(shape[-1:]) * 0.1 + 1).astype(np.float32)
    ins = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in (x, z, s)]
    y = blocks.GatedRMSNormFn.apply(*ins, 1e-6)
    y.backward(torch.tensor(g, dtype=dtype))
    f32 = [t.detach().to(torch.float32).requires_grad_(True) for t in ins]
    want = ref.gated_rmsnorm(*f32, 1e-6)
    want.backward(torch.tensor(g, dtype=dtype).to(torch.float32))
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 else dict(
        rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(to_np(y), to_np(want.to(dtype)), **tol)
    for got, w in zip(ins, f32):
        assert got.grad.dtype == dtype
        np.testing.assert_allclose(to_np(got.grad), to_np(w.grad.to(dtype)),
                                   **tol)


def test_apply_gated_norm_takes_the_function_only_under_autograd():
    _, cfg = configs()
    y, z = torch.randn(2, 5, 256), torch.randn(2, 5, 256)
    scale = torch.ones(256, requires_grad=True)
    out = blocks.apply_gated_norm(scale, y, z, cfg)
    assert type(out.grad_fn).__name__ == "GatedRMSNormFnBackward"
    with torch.no_grad():
        assert blocks.apply_gated_norm(scale, y, z, cfg).grad_fn is None
    assert blocks.apply_gated_norm(torch.ones(256), y, z, cfg).grad_fn is None


def test_the_model_launches_the_gated_norm_once_a_mamba_layer(monkeypatch):
    """Every Mamba2 layer's gate and norm goes through
    ``api.launch("rmsnorm.gated")``, in the forward and in a decode step,
    and every ln1/ln2/final norm through ``api.launch("rmsnorm")``."""
    from repro_torch.api import dispatch

    _, _, model, params = pair()
    seen = []
    launch = dispatch.launch

    def counting(name, *args, **kw):
        seen.append(name)
        return launch(name, *args, **kw)

    monkeypatch.setattr(dispatch, "launch", counting)
    with torch.inference_mode():
        model(params, torch.as_tensor(tokens(5)))
        fwd = list(seen)
        seen.clear()
        cache = init_params(0, model.cache_defs(2, 8), **CPU)
        model.decode_step(params, cache, torch.as_tensor(tokens(1)))
    mamba = sum(n for kind, n in model.cfg.stages() if kind == "mamba")
    shared = sum(kind == "shared_attn" for kind, _ in model.cfg.stages())
    for names in (fwd, seen):
        assert names.count("rmsnorm.gated") == mamba == 4
        assert names.count("rmsnorm") == mamba + 2 * shared + 1 == 9


# ---------------------------------------------------------------------------
# serving state, the mesh, the launchers
# ---------------------------------------------------------------------------


def test_slot_reset_zeroes_the_reused_slots_ssm_and_conv_rows():
    model = build_model(reduce_for_smoke(get_config(ARCH)))
    params = model.init(0, **CPU)
    b = ContinuousBatcher(model, params, slots=2, max_len=32, **CPU)
    b.run([Request(0, [5, 6, 7], 3), Request(1, [8, 9], 2)])
    mamba = b.cache["s00_mamba"]
    assert all(bool(mamba[k].abs().sum() > 0) for k in mamba)
    with torch.inference_mode():
        b._reset_slot(b.cache, 1)
    for k, leaf in mamba.items():
        assert bool((leaf[:, 1] == 0).all()), k
        assert bool(leaf[:, 0].abs().sum() > 0), k


def test_a_mesh_with_a_model_axis_refuses_the_hybrid(tmp_path):
    """The hybrid on a mesh (ROADMAP A11.5): the masked loss, a decode step
    and a cut of the shared block's cache positions run, and a cache length
    that cut does not divide is refused (``_torch_mesh.assert_mesh_runs``;
    tests/test_torch_serve_mesh.py serves it on three meshes); the vocab-
    parallel training on a model axis runs (tests/test_torch_mesh_families.py
    holds it to the reference), and so does FSDP (tests/test_torch_fsdp.py)."""
    _, cfg = configs()
    assert_mesh_runs(cfg)
    assert_launcher_trains_on_a_mesh(ARCH, "1x2", tmp_path)


def test_serve_launcher_defaults_to_the_hybrid(capsys):
    from repro_torch.launch import serve

    assert serve.parse_args([]).arch == ARCH
    res = serve.main(["--mesh", "host", "--device", "cpu", "--requests", "3",
                      "--slots", "2", "--max-len", "32", "--prompt-len", "3",
                      "8", "--gen", "2", "5"])
    assert res["requests"] == 3
    out = capsys.readouterr().out
    assert "plan[rmsnorm.gated] logical=(2, 256)" in out
    assert "zamba2-1.2b on cpu: 3 requests" in out


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(1, 512, size=3 + 2 * i).tolist(),
                    max_new_tokens=4 + i) for i in range(n)]


def _clone(reqs):
    return [Request(r.rid, list(r.prompt), r.max_new_tokens) for r in reqs]


def test_chunked_prefill_keeps_the_frozen_rows_ssm_state():
    """Chunked prefill is a scheduling lever, not a numerics change, for
    the hybrid too: rows that advance fewer tokens than the chunk keep
    their conv and SSM state through the masked micro-steps, on the paged
    and the dense cache."""
    model = build_model(reduce_for_smoke(get_config(ARCH)))
    params = model.init(0, **CPU)
    reqs = _requests(4)
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
