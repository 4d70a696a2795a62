"""The port's moe family (qwen3-moe-30b-a3b, grok-1-314b) against the JAX
package, on the CPU.

Reduced configs on both sides, fp32: ``reduce_for_smoke`` (8 experts of
d_ff 128, d_model 128, 4 layers, capacity factor 4.0), whose qwen3-moe
keeps its top-8 and so routes every token to every expert, and ``TOP2``,
the same with top-2 of 8, where routing picks and capacity drops.  The
weights are drawn with numpy (``interop.numpy_params`` at the port's init
stds) and carried into both packages, the expert permutation ``perm`` as
the reference's int32 skew table on both sides (``cfg=``).  The reference's
own ``model.init`` is not used: it folds Python's salted ``hash`` of each
path into the key (ROADMAP §C).

Tolerances.  ``apply_moe``: output rtol 1e-5 / atol 1e-6 and aux rtol 1e-5
(the routing and the dispatch are exact; the products and the combine sum
in other orders); at capacity factor 1.0 the kept mask must be the
reference's exactly.  Logits ``LOGITS`` (rtol 1e-4 / atol 1e-5), aux rtol
1e-5.  Decode against forward: 2e-3 absolute at capacity factor 8 (no
drops), the reference's own tolerance (tests/test_models.py).  Gradients
of ``lm_loss + aux``: every leaf within 1e-4 of its scale (the largest
|reference| of the leaf).  The bf16 combine: in bf16 ulps of the exact
value, as the test states.  Routing is discontinuous: a near-tie in the
router may flip an expert between frameworks, so every routed comparison
here first asserts that the top-k and the (k+1)-th probability of each
token are apart by at least 1e-6.
"""
import contextlib
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend import core as jcore

import repro.core.sharding_skew as jskew
from repro.configs import get_config as jget_config
from repro.configs import get_schedule as jget_schedule
from repro.configs import reduce_for_smoke as jreduce
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe
from repro.models.params import init_params as jinit_params
from repro.parallel import steps as jsteps
from repro_torch import interop
from repro_torch.configs import get_config, get_schedule, reduce_for_smoke
from repro_torch.core import sharding_skew as skew
from repro_torch.interop import numpy_params
from repro_torch.models import build_model, moe, transformer
from repro_torch.models import params as params_lib
from repro_torch.models.config import PORTED_FAMILIES
from repro_torch.models.params import ParamDef, init_params, leaves
from repro_torch.parallel import steps
from repro_torch.serving import ContinuousBatcher, Request

ARCH = "qwen3-moe-30b-a3b"
GROK = "grok-1-314b"
TOP2 = dict(top_k=2)
LOGITS = dict(rtol=1e-4, atol=1e-5)
MOE = dict(rtol=1e-5, atol=1e-6)
DECODE_ATOL = 2e-3
CPU = dict(device="cpu")


def to_np(t):
    return interop.to_numpy(t)


def configs(arch=ARCH, **changes):
    return (dataclasses.replace(jreduce(jget_config(arch)), **changes),
            dataclasses.replace(reduce_for_smoke(get_config(arch)), **changes))


def pair(arch=ARCH, seed=0, **changes):
    """(jax model, jax params, port model, port params): the same numpy
    weights at the port's init stds, the same perm tables."""
    jcfg, cfg = configs(arch, **changes)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    tree = numpy_params(model.param_defs(), seed, true_fan_in=True, cfg=cfg)
    return (jmodel, jax.tree.map(jnp.asarray, tree), model,
            interop.params_from_jax(tree, cfg, **CPU))


def layer_pair(seed=0, layer=3, **changes):
    """(jax cfg, port cfg, numpy tree) of one MoE layer, its perm the
    skew table's row ``layer``."""
    jcfg, cfg = configs(**changes)
    tree = numpy_params(moe.moe_defs(cfg), seed)
    tree["perm"] = moe.make_perms(cfg, layer + 1, 16)[layer]
    return jcfg, cfg, tree


def port_layer(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def rows(b, s, d=128, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def tokens(s, b=2, seed=1):
    return np.random.default_rng(seed).integers(0, 512, size=(b, s))


def assert_clear_routing(p, x, cfg):
    """Every token's k-th and (k+1)-th router probabilities at least 1e-6
    apart, so fp32 rounding cannot flip an expert between frameworks."""
    if cfg.top_k == cfg.n_experts:
        return
    xf = torch.as_tensor(x).reshape(-1, cfg.d_model)
    probs = torch.softmax(xf @ torch.as_tensor(p["router"]), dim=-1)
    top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
    gap = float((top[:, -2] - top[:, -1]).min())
    assert gap >= 1e-6, f"a near-tie in the router: gap {gap}"


def reference_keep(jtree, x, jcfg, cap):
    """The reference's kept mask (G, tg*k) as its ``apply_moe`` computes
    it (``keep = pos < cap``, src/repro/models/moe.py): the value of the
    one ``lt`` of its jaxpr against the literal capacity, found by
    evaluating the jaxpr equation by equation."""
    closed = jax.make_jaxpr(lambda p, x: jmoe.apply_moe(p, x, jcfg))(
        jtree, x)
    env = dict(zip(closed.jaxpr.invars, jax.tree.leaves((jtree, x))))
    env.update(zip(closed.jaxpr.constvars, closed.consts))
    found = []
    for eqn in closed.jaxpr.eqns:
        vals = [v.val if isinstance(v, jcore.Literal) else env[v]
                for v in eqn.invars]
        sub, params = eqn.primitive.get_bind_params(eqn.params)
        out = eqn.primitive.bind(*sub, *vals, **params)
        outs = out if eqn.primitive.multiple_results else [out]
        env.update(zip(eqn.outvars, outs))
        if (eqn.primitive.name == "lt"
                and isinstance(eqn.invars[1], jcore.Literal)
                and int(eqn.invars[1].val) == cap):
            found.append(np.asarray(outs[0]))
    assert len(found) == 1, len(found)
    return found[0]


@contextlib.contextmanager
def one_thread():
    """Run a token-by-token loop of small ops on one intra-op thread: the
    suite runs several workers at once, where split ops wait on each
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


@pytest.mark.parametrize("arch", [ARCH, GROK])
def test_configs_stages_and_trees_match_the_reference(arch):
    assert "moe" in PORTED_FAMILIES
    full, jfull = get_config(arch), jget_config(arch)
    for f in dataclasses.fields(full):
        assert getattr(full, f.name) == getattr(jfull, f.name), f.name
    assert get_schedule(arch) == jget_schedule(arch) == "cosine"
    jcfg, cfg = configs(arch)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert (cfg.n_experts, cfg.moe_d_ff, cfg.capacity_factor) == (8, 128, 4.0)
    assert cfg.stages() == jcfg.stages() == [("moe", 4)]
    assert full.stages() == jfull.stages()
    model, jmodel = build_model(cfg), jbuild_model(jcfg)
    want = {p: tuple(d.shape) for p, d in leaves(jmodel.param_defs())}
    got = {p: tuple(d.shape) for p, d in leaves(model.param_defs())}
    assert got == want
    perm = dict(leaves(model.param_defs()))[("s00_moe", "moe", "perm")]
    assert perm.shape == (4, 8) and perm.dtype == torch.int32
    for defs, jdefs in ((model.cache_defs(3, 16), jmodel.cache_defs(3, 16)),
                        (model.paged_cache_defs(3, 16, 7, 4),
                         jmodel.paged_cache_defs(3, 16, 7, 4))):
        assert ({p: tuple(d.shape) for p, d in leaves(defs)}
                == {p: tuple(d.shape) for p, d in leaves(jdefs)})


def test_full_width_sizes_match_the_reference():
    """qwen3-moe-30b-a3b: 30,532,122,624 weights, 61,089,411,072 B (bf16,
    the router fp32), beside 48 x 128 int32 perm entries; grok-1-314b as
    the reference counts it."""
    for arch in (ARCH, GROK):
        model = build_model(get_config(arch))
        n = sum(t.numel() for _, t in leaves(model.abstract_params()))
        jn = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
            jbuild_model(jget_config(arch)).abstract_params()))
        assert n == jn, arch
    model = build_model(get_config(ARCH))
    abstract = model.abstract_params()
    weights = [t for _, t in leaves(abstract) if t.is_floating_point()]
    assert sum(t.numel() for t in weights) == 30_532_122_624
    assert sum(t.numel() * t.element_size() for t in weights) == (
        61_089_411_072)
    perm = abstract["s00_moe"]["moe"]["perm"]
    assert perm.shape == (48, 128) and perm.dtype == torch.int32


def test_skew_module_matches_the_reference():
    loads = np.random.default_rng(0).exponential(size=64)
    for e, dev, layer in ((128, 16, 0), (128, 16, 5), (8, 16, 3), (8, 4, 7)):
        np.testing.assert_array_equal(skew.skewed_expert_map(e, dev, layer),
                                      jskew.skewed_expert_map(e, dev, layer))
        perm = skew.expert_permutation(e, dev, layer)
        np.testing.assert_array_equal(perm,
                                      jskew.expert_permutation(e, dev, layer))
        np.testing.assert_array_equal(skew.inverse_permutation(perm),
                                      jskew.inverse_permutation(perm))
        assert skew.inverse_permutation(perm)[perm].tolist() == list(range(e))
    dmap = skew.skewed_expert_map(64, 8, 3)
    assert skew.placement_imbalance(loads, dmap, 8) == (
        jskew.placement_imbalance(loads, dmap, 8))
    assert skew.layer_skew_gain(loads, 8, 6) == jskew.layer_skew_gain(
        loads, 8, 6)
    with pytest.raises(ValueError):
        skew.skewed_expert_map(0, 4, 0)


@pytest.mark.parametrize("arch,shards", [(ARCH, 16), (GROK, 1)])
def test_make_perms_and_init_write_the_reference_tables(arch, shards):
    full, jfull = get_config(arch), jget_config(arch)
    assert transformer.expert_shards(full) == shards
    got = moe.make_perms(full, full.n_layers, shards)
    want = jmoe.make_perms(jfull, jfull.n_layers, shards)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if shards == 1:     # expert_tp: identity tables
        assert (got == np.arange(full.n_experts)).all()
    else:               # one device step a layer
        assert len({tuple(r) for r in got}) == shards
    off = dataclasses.replace(full, skewed_experts=False)
    assert (moe.make_perms(off, 3, 16) == np.arange(full.n_experts)).all()
    # model.init writes them into each MoE stage's perm, int32
    jcfg, cfg = configs(arch)
    params = build_model(cfg).init(0, **CPU)
    perm = params["s00_moe"]["moe"]["perm"]
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(
        perm.numpy(), jmoe.make_perms(jcfg, cfg.n_layers, shards))


def test_capacity_is_the_references_rounded_to_eight():
    for cf, tokens_, k, e in ((1.25, 8, 8, 128), (1.25, 2048, 8, 128),
                              (16.0, 8, 8, 128), (1.0, 64, 2, 8),
                              (4.0, 2, 8, 8), (1.25, 16, 2, 8)):
        cfg = dataclasses.replace(get_config(ARCH), capacity_factor=cf,
                                  top_k=k, n_experts=e)
        want = int(np.ceil(cf * tokens_ * k / e))
        want += (-want) % 8
        assert moe.capacity(cfg, tokens_) == want
    full = get_config(ARCH)
    # a decode step of 8 slots: an expert can get at most 8 assignments
    assert moe.capacity(full, 8) == 8
    assert moe.capacity(full, 2048) == 160


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf,groups,top", [(1.0, 1, 2), (1.0, 2, 2),
                                           (8.0, 1, 2), (8.0, 2, 2),
                                           (4.0, 1, 8)])
def test_apply_moe_matches_reference(cf, groups, top):
    jcfg, cfg, tree = layer_pair(capacity_factor=cf, moe_groups=groups,
                                 top_k=top)
    x = rows(2, 32)
    p = port_layer(tree)
    assert_clear_routing(tree, x, cfg)
    jtree = jax.tree.map(jnp.asarray, tree)
    want, waux = jmoe.apply_moe(jtree, jnp.asarray(x), jcfg)
    got, aux = moe.apply_moe(p, torch.as_tensor(x), cfg)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **MOE)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)
    *_, keep, cap = moe.route(p, torch.as_tensor(x).reshape(64, 128), cfg)
    assert keep.shape == (groups, 64 // groups * top)
    jkeep = reference_keep(jtree, jnp.asarray(x), jcfg, cap)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    if cf == 1.0:
        assert not bool(keep.all()), "capacity factor 1.0 dropped nothing"
    else:
        assert bool(keep.all())


def test_skew_permutation_is_output_invariant():
    """The permutation relabels expert storage only: experts stored in the
    skew table's order give the identity table's output bit for bit, and
    the reference's skewed output to its tolerance."""
    jcfg, cfg, tree = layer_pair(capacity_factor=8.0, **TOP2)
    x = torch.as_tensor(rows(2, 8))
    ident = port_layer(tree)
    ident["perm"] = torch.arange(8, dtype=torch.int32)
    out_id, aux_id = moe.apply_moe(ident, x, cfg)
    perm = skew.expert_permutation(8, 4, 3)
    skewed = dict(ident)
    for w in ("wi", "wg", "wo"):
        skewed[w] = ident[w][torch.as_tensor(perm)]
    skewed["perm"] = torch.as_tensor(perm.astype(np.int32))
    out_skew, aux_skew = moe.apply_moe(skewed, x, cfg)
    assert torch.equal(out_skew, out_id) and torch.equal(aux_skew, aux_id)
    jtree = jax.tree.map(jnp.asarray, {k: to_np(v) for k, v in skewed.items()})
    want, _ = jmoe.apply_moe(jtree, jnp.asarray(x.numpy()), jcfg)
    np.testing.assert_allclose(to_np(out_skew), np.asarray(want), **MOE)


def test_dispatch_and_combine_write_each_cell_once():
    """Every kept (expert, rank) cell has exactly one source assignment and
    the ranks of an expert are 0, 1, 2, ... in token order, so the
    dispatch is a gather and the combine needs no atomics."""
    _, cfg, tree = layer_pair(capacity_factor=1.0, **TOP2)
    x = torch.as_tensor(rows(2, 32)).reshape(64, 128)
    _, _, _, slot, pos, keep, cap = moe.route(port_layer(tree), x, cfg)
    cells = (slot * cap + pos)[keep]
    assert cells.unique().numel() == cells.numel()
    for s in range(8):
        ranks = pos[0][slot[0] == s]
        assert ranks.tolist() == list(range(ranks.numel()))
        assert bool((keep[0][slot[0] == s] == (ranks < cap)).all())


def test_bf16_combine_rounds_once():
    """The combine in bf16, 8 picks of 128-wide rows: the port sums a
    token's rounded products at once and rounds the sum once, the
    reference's scatter-add (src/repro/models/moe.py ``combine_group``,
    ``zeros.at[token_of].add(gathered)``) rounds after each of its k - 1
    adds.  Against the exact sum of the rounded products (float64): the
    port within 0.5 bf16 ulps of the exact value; in ulps of the sum of
    the products' magnitudes (the scale every partial sum stays under) the
    reference within (k - 1) / 2 = 3.5 and the two within 4 of each other
    (measured on these inputs: 0.5, 1.88 and 2.0).  The signed products
    cancel, so ulps of the exact value alone would not bound the
    reference's roundings."""
    t, k, d = 64, 8, 128
    rng = np.random.default_rng(7)
    y = rng.standard_normal((t * k, d)).astype(np.float32)
    w = rng.dirichlet(np.ones(k), size=t).reshape(-1).astype(np.float32)
    yb = torch.as_tensor(y).to(torch.bfloat16)
    wb = torch.as_tensor(w).to(torch.bfloat16)
    prod = (yb * wb[:, None]).to(torch.float64).numpy()
    exact = prod.reshape(t, k, d).sum(1)
    got = moe.combine(yb[None], wb[None], k)[0].to(torch.float32).numpy()
    token_of = jnp.repeat(jnp.arange(t), k)
    gathered = (jnp.asarray(y, jnp.bfloat16)
                * jnp.asarray(w, jnp.bfloat16)[:, None])
    ref = np.asarray(jnp.zeros((t, d), jnp.bfloat16).at[token_of].add(
        gathered).astype(jnp.float32))

    def ulps(a, b, scale):
        mag = np.maximum(scale, 1e-30)
        return np.abs(a - b) / 2.0 ** (np.floor(np.log2(mag)) - 7)

    mags = np.abs(prod).reshape(t, k, d).sum(1)
    assert ulps(got, exact, np.abs(exact)).max() <= 0.5
    assert ulps(ref, exact, mags).max() <= (k - 1) / 2
    assert ulps(got, ref, mags).max() <= 4.0


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("changes", [{}, dict(TOP2, capacity_factor=1.25)],
                         ids=["top8of8", "top2"])
def test_forward_logits_and_aux_match_reference(changes):
    jmodel, jparams, model, params = pair(**changes)
    toks = tokens(12)
    want, waux = jax.jit(jmodel.forward)(jparams, jnp.asarray(toks, jnp.int32))
    got, aux = model(params, torch.as_tensor(toks))
    assert got.shape == (2, 12, 512) and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(want), **LOGITS)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)
    # four layers' aux, each about its floor router_aux_weight * E * sum(1/E^2)*E
    assert 4 * 0.01 * 0.99 < float(aux) < 4 * 0.01 * 2


@pytest.mark.parametrize("changes", [dict(capacity_factor=8.0),
                                     dict(TOP2, capacity_factor=8.0)],
                         ids=["top8of8", "top2"])
def test_decode_matches_forward_at_cf_8(changes):
    """Token by token through the decode step equals the forward at
    capacity factor 8, where nothing drops (the reference's own check)."""
    _, _, model, params = pair(**changes)
    toks = torch.as_tensor(tokens(10))
    with torch.no_grad():
        want, _ = model(params, toks)
    cache = init_params(0, model.cache_defs(2, 10), **CPU)
    outs = []
    with one_thread(), torch.no_grad():
        for t in range(10):
            lg, cache = model.decode_step(params, cache, toks[:, t:t + 1])
            outs.append(lg[:, 0])
    err = float((torch.stack(outs, 1) - want).abs().max())
    assert err < DECODE_ATOL, err


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_decode_step_logits_match_reference(cache):
    jmodel, jparams, model, params = pair(**TOP2, capacity_factor=1.25)
    batch, max_len = 2, 16
    if cache == "paged":
        mp, page_len = 4, 4
        n_pages = 1 + batch * mp
        jc = jinit_params(jax.random.PRNGKey(0), jmodel.paged_cache_defs(
            batch, max_len, n_pages, page_len))
        tc = init_params(0, model.paged_cache_defs(batch, max_len, n_pages,
                                                   page_len), **CPU)
        table = 1 + np.arange(batch * mp, dtype=np.int32).reshape(batch, mp)
        jc["pages"], tc["pages"] = jnp.asarray(table), torch.as_tensor(table)
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


def _batch_axes(defs):
    """Each cache leaf's batch axis (-1: none), for either package's defs."""
    return jax.tree.map(
        lambda d: d.axes.index("batch") if "batch" in d.axes else -1, defs,
        is_leaf=lambda d: hasattr(d, "axes"))


def test_chunk_tick_with_dead_rows_matches_reference():
    """One chunked-prefill tick of 4 rows advancing 3, 0, 1 and 4 tokens:
    the frozen rows (dead at their micro-steps, fed token 0) route through
    the MoE as the reference's do.  Next tokens equal, the KV caches and
    indices to the logits' tolerance."""
    jmodel, jparams, model, params = pair(**TOP2, capacity_factor=1.25)
    b, c, max_len = 4, 4, 16
    defs, jdefs = model.cache_defs(b, max_len), jmodel.cache_defs(b, max_len)
    tc = init_params(0, defs, **CPU)
    jc = jinit_params(jax.random.PRNGKey(0), jdefs)
    start = np.array([2, 5, 0, 1], np.int32)
    tc["idx"], jc["idx"] = torch.as_tensor(start), jnp.asarray(start)
    feed = np.random.default_rng(4).integers(1, 512, size=(b, c)).astype(
        np.int32)
    nvalid = np.array([3, 0, 1, 4], np.int32)
    feed[np.arange(c)[None, :] >= nvalid[:, None]] = 0
    jstep = jax.jit(jsteps.make_chunk_step(jmodel, _batch_axes(jdefs)))
    want_tok, jc = jstep(jparams, jc, jnp.asarray(feed), jnp.asarray(nvalid))
    step = steps.make_chunk_step(model, _batch_axes(defs))
    with one_thread():
        got_tok, tc = step(params, tc, torch.as_tensor(feed),
                           torch.as_tensor(nvalid))
    live = nvalid > 0
    np.testing.assert_array_equal(to_np(got_tok)[live],
                                  np.asarray(want_tok)[live])
    np.testing.assert_array_equal(to_np(tc["idx"]), np.asarray(jc["idx"]))
    for kv in ("k", "v"):
        np.testing.assert_allclose(to_np(tc["s00_moe"][kv]),
                                   np.asarray(jc["s00_moe"][kv]), **LOGITS)


def _dead_row_drops(slots, monkeypatch, cf=1.25):
    """Live assignments a chunk tick of the TOP2 model at ``slots`` rows
    drops because dead rows ranked ahead of them: each MoE call's kept
    mask against the ranks among the live assignments alone."""
    _, _, model, params = pair(**TOP2, capacity_factor=cf)
    rng = np.random.default_rng(9)
    nvalid = rng.integers(0, 5, size=slots).astype(np.int32)
    nvalid[0] = 4
    feed = rng.integers(1, 512, size=(slots, 4)).astype(np.int32)
    feed[np.arange(4)[None, :] >= nvalid[:, None]] = 0
    calls, route = [], moe.route

    def spy(p, xf, cfg):
        out = route(p, xf, cfg)
        calls.append(out)
        return out

    monkeypatch.setattr(moe, "route", spy)
    defs = model.cache_defs(slots, 16)
    cache = init_params(0, defs, **CPU)
    with one_thread():
        steps.make_chunk_step(model, _batch_axes(defs))(
            params, cache, torch.as_tensor(feed), torch.as_tensor(nvalid))
    dropped = dropped_live = 0
    k, e = model.cfg.top_k, model.cfg.n_experts
    for i, (_, _, _, slot, pos, keep, cap) in enumerate(calls):
        step_ = i // model.cfg.n_layers
        live = torch.as_tensor(step_ < nvalid).repeat_interleave(k)[None]
        live_rank = moe._ranks(torch.where(live, slot, e), e + 1)
        dropped += int((~keep).sum())
        dropped_live += int((live & ~keep & (live_rank < cap)).sum())
    return len(calls), dropped, dropped_live


def test_dead_rows_take_capacity_in_a_chunk_tick(monkeypatch):
    """A chunk tick is C micro decode steps of B rows (both packages), so
    an MoE call sees T = B rows, dead ones included, with capacity
    ``capacity(cfg, B)``.  At 8 slots the capacity is 8 >= T and nothing
    drops; past 8 slots the dead rows (fed token 0) rank ahead of live
    assignments of the same expert and push some past the capacity: of
    the tick's 16 MoE calls (4 micro-steps of 4 layers), dropped
    assignments and live ones dropped because of dead rows (ROADMAP §C)."""
    assert _dead_row_drops(8, monkeypatch) == (16, 0, 0)
    assert _dead_row_drops(16, monkeypatch) == (16, 6, 5)
    assert _dead_row_drops(64, monkeypatch) == (16, 34, 16)


@pytest.mark.parametrize("changes", [{}, dict(TOP2, capacity_factor=1.25)],
                         ids=["top8of8", "top2"])
def test_loss_and_grads_match_reference(changes):
    """``lm_loss + aux`` and every gradient leaf (the perm has none) against
    ``jax.value_and_grad(model.loss, allow_int=True)``: loss rtol 1e-5,
    each leaf within 1e-4 of its scale."""
    jmodel, jparams, model, params = pair(**changes)
    toks = tokens(16, b=2, seed=2)
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32),
              "labels": jnp.asarray(np.roll(toks, -1, 1), jnp.int32)}
    batch = {"tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(np.roll(toks, -1, 1))}
    want, want_g = jax.jit(jax.value_and_grad(jmodel.loss, allow_int=True))(
        jparams, jbatch)
    loss, grads = steps.value_and_grad(model, params, batch)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    got = dict(leaves(grads))
    for path, w in leaves(jax.tree.map(np.asarray, want_g)):
        if path[-1] == "perm":
            assert got[path] is None
            continue
        assert bool(got[path].abs().max() > 0), path
        np.testing.assert_allclose(to_np(got[path]), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg="/".join(path))


# ---------------------------------------------------------------------------
# grok-1-314b, carried as a config
# ---------------------------------------------------------------------------


def test_grok_reduced_forward_and_decode_match_reference():
    """The reduced grok (top-2 of 8, gelu, attention and logit softcap 30,
    identity perms): forward logits and aux, then three decode steps."""
    jmodel, jparams, model, params = pair(GROK)
    assert model.cfg.top_k == 2 and model.cfg.act == "gelu"
    toks = tokens(12)
    want, waux = jax.jit(jmodel.forward)(jparams, jnp.asarray(toks, jnp.int32))
    got, aux = model(params, torch.as_tensor(toks))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **LOGITS)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)
    assert float(to_np(got).max()) <= 30.0
    jc = jinit_params(jax.random.PRNGKey(0), jmodel.cache_defs(2, 8))
    tc = init_params(0, model.cache_defs(2, 8), **CPU)
    jstep = jax.jit(jmodel.decode_step)
    for t in range(3):
        tok = toks[:, t:t + 1]
        want, jc = jstep(jparams, jc, jnp.asarray(tok, jnp.int32))
        got, tc = model.decode_step(params, tc, torch.as_tensor(tok))
        np.testing.assert_allclose(to_np(got), np.asarray(want), **LOGITS,
                                   err_msg=f"step {t}")


# ---------------------------------------------------------------------------
# init, interop, serving, meshes
# ---------------------------------------------------------------------------


def test_large_leaves_are_drawn_slice_by_slice(monkeypatch):
    """A leaf over ``WHOLE_DRAW_LIMIT`` elements is drawn one leading-axis
    slice at a time into its own dtype; a leaf at or under it keeps the
    values of one whole draw.  Every leaf of the dense, hybrid and ssm
    configs is under the limit; qwen3-moe's stacked experts are over."""
    for arch in ("qwen3-4b", "qwen2-0.5b", "minicpm-2b", "qwen3-14b",
                 "zamba2-1.2b", "xlstm-1.3b"):
        defs = build_model(get_config(arch)).param_defs()
        assert max(d.abstract().numel() for _, d in leaves(defs)) <= (
            params_lib.WHOLE_DRAW_LIMIT), arch
    moe_defs = dict(leaves(build_model(get_config(ARCH)).param_defs()))
    assert moe_defs[("s00_moe", "moe", "wi")].abstract().numel() > (
        params_lib.WHOLE_DRAW_LIMIT)
    d = ParamDef((3, 4, 8), ("layers", "embed", "mlp"), dtype=torch.bfloat16)
    whole = d.materialize(torch.Generator().manual_seed(5),
                          torch.device("cpu"))
    monkeypatch.setattr(params_lib, "WHOLE_DRAW_LIMIT", 95)
    sliced = d.materialize(torch.Generator().manual_seed(5),
                           torch.device("cpu"))
    gen = torch.Generator().manual_seed(5)
    want = torch.stack([(torch.randn((4, 8), generator=gen) / 4 ** 0.5)
                        .to(torch.bfloat16) for _ in range(3)])
    assert sliced.dtype == torch.bfloat16 and torch.equal(sliced, want)
    monkeypatch.setattr(params_lib, "WHOLE_DRAW_LIMIT", 96)
    assert torch.equal(d.materialize(torch.Generator().manual_seed(5),
                                     torch.device("cpu")), whole)


def test_numpy_params_and_params_from_jax_keep_the_perm_int32():
    jcfg, cfg = configs()
    tree = numpy_params(build_model(cfg).param_defs(), 0, cfg=cfg)
    perm = tree["s00_moe"]["moe"]["perm"]
    assert perm.dtype == np.int32
    np.testing.assert_array_equal(perm, jmoe.make_perms(jcfg, 4, 16))
    bare = numpy_params(jbuild_model(jcfg).param_defs(), 0)
    assert bare["s00_moe"]["moe"]["perm"].dtype == np.int32
    assert not bare["s00_moe"]["moe"]["perm"].any()
    # the floating leaves are the same draws with or without the table
    for (path, a), (_, b) in zip(leaves(tree), leaves(bare)):
        if path[-1] != "perm":
            np.testing.assert_array_equal(a, b)
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    params = interop.params_from_jax(tree, bf16, dtype=torch.bfloat16, **CPU)
    got = params["s00_moe"]["moe"]
    assert got["perm"].dtype == torch.int32
    np.testing.assert_array_equal(got["perm"].numpy(), perm)
    assert got["wi"].dtype == torch.bfloat16


def test_serving_paged_equals_dense_and_isolated_at_cf_16():
    """The TOP2 model at capacity factor 16 (>= E / k, so cap >= T and
    nothing drops): paged = dense, and each request alone gives its
    batched tokens."""
    _, cfg = configs(**TOP2, capacity_factor=16.0)
    model = build_model(cfg)
    params = model.init(0, **CPU)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(1, 512, size=3 + 2 * i).tolist(), 3 + i)
            for i in range(4)]

    def run(kv, subset):
        b = ContinuousBatcher(model, params, slots=2, max_len=32, kv_cache=kv,
                              prefill_chunk=4, **CPU)
        return b.run([Request(r.rid, list(r.prompt), r.max_new_tokens)
                      for r in subset])

    with one_thread():
        dense = run("dense", reqs)
        assert run("paged", reqs) == dense
        for r in reqs[:2]:
            assert run("paged", [r])[r.rid] == dense[r.rid]


def test_a_mesh_of_more_than_one_rank_refuses_the_moe_family():
    from repro_torch.launch import train as train_launch
    from repro_torch.models.transformer import require_mesh_ported

    _, cfg = configs()
    model = build_model(cfg)
    for sizes in ({"data": 2, "model": 1}, {"data": 1, "model": 2}):
        mesh = types.SimpleNamespace(size=2, axis_sizes=sizes)
        with pytest.raises(NotImplementedError, match="moe family .* A11"):
            steps.make_grad_fn(model, mesh=mesh)
    with pytest.raises(NotImplementedError, match="A11"):
        train_launch.main(["--arch", ARCH, "--mesh", "2x1", "--device",
                           "cpu", "--steps", "1"])
    require_mesh_ported(cfg, {"data": 1, "model": 1})


def test_serve_launcher_runs_the_moe(capsys):
    from repro_torch.launch import serve

    res = serve.main(["--arch", ARCH, "--mesh", "host", "--device", "cpu",
                      "--requests", "3", "--slots", "2", "--max-len", "32",
                      "--prompt-len", "3", "8", "--gen", "2", "5"])
    assert res["requests"] == 3
    out = capsys.readouterr().out
    assert "plan[rmsnorm] logical=(2, 128)" in out
    assert "qwen3-moe-30b-a3b on cpu: 3 requests" in out
