"""Flash decoding (a KV cache cut over its positions, "cache_seq") and the
masked loss on a mesh of ranks (ROADMAP A11.5), on gloo meshes of ranks on
the CPU, against one device and the JAX reference.

Each case is a reduced fp32 model (``reduce_for_smoke`` on both sides, cut
to two layers) with the same numpy weights (``interop.numpy_params`` at the
port's true fan-ins, the MoE's perm tables from ``cfg=``):

  * on (1, 4) under ``rules.decode_rules`` (the flash-decoding override
    ``{"cache_seq": ("model",), "kv_heads": None}``: 2 KV heads do not
    divide 4), the reduced qwen2-0.5b (4 heads over 2 KV heads: a rank's
    one query head, every KV head, a quarter of the positions; q gathered
    over the heads' ranks) over 32 teacher-forced tokens, and the reduced
    vlm, moe and hybrid with their KV heads replaced by 2 over 8 tokens:
    each step's logits, gathered over the vocab ranks, within the fp32
    ``tol`` of tests/test_kernels.py's rtol and an atol of 1e-5 of their
    largest magnitude of one device's and of the reference's
    ``decode_step`` (the hybrid at tests/test_torch_hybrid.py's
    ``LOGITS``); the first steps find ranks whose positions all lie past
    the write index, and every logit is finite;
  * four ragged requests through ``ContinuousBatcher(mesh=)`` (two slots
    of 32 positions, 8 a rank, chunked prefill whose spans straddle two
    ranks), paged and dense: paged tokens equal dense tokens bit for bit
    (the paged view takes the dense cache's split of the positions and
    the same combine), the ranks agree, and every token agrees with one
    device's up to the first decision whose one-device top-2 gap is below
    the logits' bound;
  * a chunk step on (1, 4) whose rows write 5 positions across three
    ranks' blocks of 2: the tokens and write indices equal one device's,
    and the ranks' cache blocks put back together equal one device's
    cache (each position written by the rank that owns it alone);
  * the query heads cut with the KV heads whole and the positions whole
    (``make_rules()`` on (1, 4): the KV heads' fallback): each rank's
    query heads read their group's KV heads, no combine;
  * the long-context cut ``{"batch": None, "cache_seq": ("data",)}``
    (``make_rules(shard_cache_seq=True)``) on (2, 1) and, with the heads
    and KV heads on "model", on (2, 2);
  * the masked loss on (2, 2) (its rows over "data", the vocab over
    "model"): the loss and every gradient leaf against one device's
    masked loss and the reference's, for a random, an all-zeros and an
    all-ones mask; the all-ones mask gives the unmasked loss;
  * a ``max_len`` that the positions' cut does not divide raises
    ``NotImplementedError`` naming A11 before any collective.

Each mesh shape is spawned once, all at once (``launch.mesh_checks``; a
rank imports nothing of JAX).
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models import build_model as jbuild_model
from repro.models.params import init_params as jinit_params
from repro_torch import api, interop
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.interop import numpy_params
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import mesh_checks, serve
from repro_torch.models import build_model
from repro_torch.models.params import init_params, leaves, map_tree
from repro_torch.parallel import rules, specs, steps
from repro_torch.serving import Request

from _torch_mesh import AXES, Ranks, assemble

CPU = torch.device("cpu")
REF = dict(rtol=1e-5, atol=1e-6)          # tests/test_kernels.py's fp32 tol
SCALED = 1e-5                             # the atol, over the logits' scale
REF_LOGITS = {"hybrid": dict(rtol=1e-4, atol=1e-5)}
MOE = dict(top_k=2, capacity_factor=1.0, moe_groups=1)
KV2 = dict(n_kv_heads=2)
# case -> (arch, config changes on both sides, teacher-forced steps)
CASES = {
    "dense": ("qwen2-0.5b", {}, 32),
    "vlm": ("pixtral-12b", KV2, 8),
    "moe": ("qwen3-moe-30b-a3b", {**MOE, **KV2}, 8),
    "hybrid": ("zamba2-1.2b", KV2, 8),
}
SLOTS, MAX_LEN, CHUNK, STREAMS = 2, 32, 4, 4
FLASH = (1, 4)
# the long-context decode cell's cut (the reference's shard_cache_seq)
LONG = rules.make_rules(shard_cache_seq=True, overrides={"batch": None})
MASKS = ("random", "zeros", "ones")
LEAF = 1e-5                               # a leaf's atol, over its scale


def configs(case):
    arch, changes, _ = CASES[case]
    changes = dict(n_layers=2, **changes)
    return (dataclasses.replace(jreduce(jget_config(arch)), **changes),
            dataclasses.replace(reduce_for_smoke(get_config(arch)),
                                **changes))


def requests(cfg):
    rng = np.random.default_rng(0)
    return [Request(i, rng.integers(1, cfg.vocab_size,
                                    size=3 + 2 * i).tolist(), 4 + i)
            for i in range(4)]


def top2_gap(logits: torch.Tensor) -> torch.Tensor:
    top = torch.topk(logits, 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def masks():
    rng = np.random.default_rng(4)
    shape = (4, 8)
    return {"random": (rng.random(shape) < 0.6).astype(np.float32),
            "zeros": np.zeros(shape, np.float32),
            "ones": np.ones(shape, np.float32)}


MASK_DATA = dict(seq_len=8, global_batch=4)


@pytest.fixture(scope="module")
def one_device():
    """Per case: the numpy weights, the replay's streams and the port's
    one-device replay logits, served streams (paged) and each request's
    decision logits (its own stream teacher-forced) for the top-2 gaps."""
    out = {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for case in CASES:
            cfg = configs(case)[1]
            model = build_model(cfg)
            tree = numpy_params(model.param_defs(), 0, true_fan_in=True,
                                cfg=cfg)
            host = interop.params_from_jax(tree, cfg, device="cpu")
            streams = np.random.default_rng(1).integers(
                1, cfg.vocab_size, size=(STREAMS, CASES[case][2])).astype(
                np.int32)
            res = {"cfg": cfg, "tree": tree, "host": host,
                   "streams": streams, "replay": serve.teacher_forced_logits(
                       model, host, torch.from_numpy(streams))}
            got = serve.serve_requests(
                model, host, requests(cfg), kv_cache="paged", slots=SLOTS,
                max_len=MAX_LEN, prefill_chunk=CHUNK,
                device=CPU)["completed"]
            res["completed"] = got
            res["gaps"] = {}
            for r in requests(cfg):
                seq = torch.tensor([r.prompt + got[r.rid][:-1]],
                                   dtype=torch.int32)
                logits = serve.teacher_forced_logits(model, host, seq)[:, 0]
                res["gaps"][r.rid] = (top2_gap(logits[len(r.prompt) - 1:]),
                                      float(logits.abs().max()))
            out[case] = res
    finally:
        torch.set_num_threads(n)
    return out


@pytest.fixture(scope="module")
def reference(one_device):
    """Per case: the reference's one-device ``decode_step`` over the
    replay's streams."""
    out = {}
    for case in CASES:
        jcfg, _ = configs(case)
        jmodel = jbuild_model(jcfg)
        one = one_device[case]
        params = jax.tree.map(jnp.asarray, one["tree"])
        steps_ = one["streams"].shape[1]
        cache = jinit_params(jax.random.PRNGKey(0),
                             jmodel.cache_defs(STREAMS, steps_))
        step = jax.jit(jmodel.decode_step)
        logits = []
        for t in range(steps_):
            lg, cache = step(params, cache,
                             jnp.asarray(one["streams"][:, t:t + 1]))
            logits.append(np.asarray(lg[:, -1]))
        out[case] = np.stack(logits)
    return out


def serve_job(one, rules_=None, kv_caches=("paged", "dense")):
    return ("serve", dict(cfg=one["cfg"], tree=one["tree"], rules=rules_,
                          kv_caches=kv_caches, reqs=requests(one["cfg"]),
                          slots=SLOTS, max_len=MAX_LEN,
                          prefill_chunk=CHUNK, replay=one["streams"]))


CHUNK_JOB = dict(tokens=np.random.default_rng(3).integers(
    1, 512, (2, 5)).astype(np.int32), nvalid=np.array([5, 3], np.int32),
    max_len=8)


@pytest.fixture(scope="module")
def meshes(one_device):
    """``run(shape)``: (1, 4), (2, 1) and (2, 2) spawned once each, all at
    once in the background, their jobs named."""
    dense = one_device["dense"]
    data = DataConfig(vocab_size=dense["cfg"].vocab_size,
                      d_model=dense["cfg"].d_model, **MASK_DATA)
    grads = dict(cfg=dense["cfg"], seed=0, data_cfg=data,
                 tree=dense["tree"])
    jobs = {
        FLASH: [(c, serve_job(one_device[c])) for c in CASES] + [
            ("heads only", serve_job(dense, rules.make_rules())),
            ("chunk", ("chunk", dict(cfg=dense["cfg"], tree=dense["tree"],
                                     **CHUNK_JOB)))],
        (2, 1): [("long", serve_job(dense, LONG))],
        (2, 2): [("long", serve_job(dense, LONG, kv_caches=())),
                 ("unmasked", ("seeded_grads", grads))] + [
            (k, ("seeded_grads", dict(grads, mask=m)))
            for k, m in masks().items()],
    }

    def spawn(shape):
        ranks = mesh_lib.spawn(mesh_checks.run, shape, AXES, device="cpu",
                               args=([j for _, j in jobs[shape]],))
        return {name: [r[i] for r in ranks]
                for i, (name, _) in enumerate(jobs[shape])}

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        runs = {shape: pool.submit(spawn, shape) for shape in jobs}
        yield lambda shape: runs[shape].result()


def assert_replay(ranks, one, ref=None, family=None):
    want = one["replay"].numpy()
    scale = float(np.abs(want).max())
    for r in ranks:
        got = r["replay"].numpy()
        assert got.shape == want.shape
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=REF["rtol"],
                                   atol=SCALED * scale)
        if ref is not None:
            np.testing.assert_allclose(
                got, ref, **REF_LOGITS.get(
                    family, dict(rtol=REF["rtol"], atol=SCALED * scale)))


def assert_served(ranks, one):
    """Paged equals dense on every rank, the ranks agree, and each stream
    equals one device's up to its first near-tie."""
    first = ranks[0]["runs"]
    for r in ranks:
        runs = r["runs"]
        assert runs["paged"]["completed"] == runs["dense"]["completed"]
        assert runs["paged"]["completed"] == first["paged"]["completed"]
        got = runs["paged"]["completed"]
        assert sorted(got) == sorted(one["completed"])
        for rid, want in one["completed"].items():
            gaps, scale = one["gaps"][rid]
            for j, (a, b) in enumerate(zip(got[rid], want)):
                if a != b:
                    assert float(gaps[j]) < SCALED * scale, (rid, j)
                    break
            else:
                assert len(got[rid]) == len(want)


@pytest.mark.parametrize("case", list(CASES))
def test_flash_decode_matches_one_device_and_the_reference(
        case, meshes, one_device, reference):
    """Each step's logits on (1, 4), the cache's positions cut four ways,
    against one device and the reference; the first 8 steps of the
    32-token dense replay (2 of the 8 steps of the others) leave ranks
    whose positions all lie past the write index, and nothing is NaN."""
    one = one_device[case]
    table = rules.decode_rules(one["cfg"], dict(zip(AXES, FLASH)))
    assert table["cache_seq"] == ("model",) and table["kv_heads"] is None
    assert_replay(meshes(FLASH)[case], one, reference[case],
                  one["cfg"].family)


@pytest.mark.parametrize("case", list(CASES))
def test_flash_batcher_paged_equals_dense_and_one_device(case, meshes,
                                                         one_device):
    assert_served(meshes(FLASH)[case], one_device[case])


def test_chunk_step_spans_that_straddle_the_ranks(meshes, one_device):
    """Rows writing 5 and 3 positions from 0 into blocks of 2 a rank: the
    next tokens and write indices equal one device's, and the ranks'
    blocks put back together equal one device's cache, each position
    written once, the rest still zero."""
    one = one_device["dense"]
    cfg = one["cfg"]
    model = build_model(cfg)
    defs = model.cache_defs(2, CHUNK_JOB["max_len"])
    cache = init_params(0, defs, device="cpu")
    step = steps.make_chunk_step(
        model, map_tree(lambda d: d.axes.index("batch"), defs))
    with torch.inference_mode():
        nxt, cache = step(one["host"], cache,
                          torch.from_numpy(CHUNK_JOB["tokens"]),
                          torch.from_numpy(CHUNK_JOB["nvalid"]))
    ranks = meshes(FLASH)["chunk"]
    table = rules.restrict_to_mesh(rules.decode_rules(cfg, dict(
        zip(AXES, FLASH))), dict(zip(AXES, FLASH)))
    cs = specs.cache_specs(defs, table, dict(zip(AXES, FLASH)))
    for r in ranks:
        assert torch.equal(r["next"], nxt)
        assert r["idx"].tolist() == [5, 3]
        assert r["cache"]["s00_dense"]["k"].shape[3] == 2
    for name in ("k", "v"):
        got = assemble([r["cache"]["s00_dense"][name].numpy()
                        for r in ranks], cs["s00_dense"][name], FLASH)
        want = cache["s00_dense"][name].numpy()
        np.testing.assert_allclose(got, want, rtol=REF["rtol"],
                                   atol=SCALED * float(np.abs(want).max()))
        assert not got[:, 0, :, 5:].any() and not got[:, 1, :, 3:].any()


def test_query_heads_cut_with_the_kv_heads_whole(meshes, one_device):
    """``make_rules()`` on (1, 4): 2 KV heads stay whole (they do not
    divide 4), the positions are not cut, each rank's query head reads
    its group's KV head: one device's logits and streams, paged equal to
    dense."""
    one = one_device["dense"]
    ranks = meshes(FLASH)["heads only"]
    assert_replay(ranks, one)
    assert_served(ranks, one)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_long_context_cut_over_the_data_axis(shape, meshes, one_device):
    """``{"batch": None, "cache_seq": ("data",)}``: every data rank holds
    every slot and its half of the positions; on (2, 2) the heads and KV
    heads are cut over "model" beside it."""
    one = one_device["dense"]
    ranks = meshes(shape)["long"]
    assert_replay(ranks, one)
    if shape == (2, 1):
        assert_served(ranks, one)


@pytest.fixture(scope="module")
def masked_one_device(one_device):
    """Per mask: the port's one-device loss and gradients and the
    reference's, on the dense case's weights and batch 0."""
    dense = one_device["dense"]
    cfg = dense["cfg"]
    jcfg = configs("dense")[0]
    model, jmodel = build_model(cfg), jbuild_model(jcfg)
    data = DataConfig(vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                      **MASK_DATA)
    batch = make_batch(data, 0, device="cpu")
    params = jax.tree.map(jnp.asarray, dense["tree"])
    out = {}
    for kind, m in masks().items():
        b = dict(batch, mask=torch.from_numpy(m))
        loss, grads = steps.value_and_grad(model, dense["host"], b)
        jb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
        jloss, jgrads = jax.value_and_grad(jmodel.loss)(params, jb)
        out[kind] = (float(loss), grads, float(jloss), jgrads)
    out["unmasked"] = float(steps.value_and_grad(model, dense["host"],
                                                 batch)[0])
    return out


@pytest.mark.parametrize("kind", MASKS)
def test_masked_loss_on_2x2_matches_one_device_and_the_reference(
        kind, meshes, masked_one_device):
    loss, grads, jloss, jgrads = masked_one_device[kind]
    assert loss == pytest.approx(jloss, rel=1e-5, abs=1e-6)
    ranks = meshes((2, 2))[kind]
    for r in ranks:
        assert r["loss0"] == pytest.approx(loss, rel=1e-5, abs=1e-7)
    for path, g in leaves(grads):
        want = g.numpy()
        scale = float(np.abs(want).max())
        jg = jgrads
        for k in path:
            jg = jg[k]
        np.testing.assert_allclose(want, np.asarray(jg), rtol=0,
                                   atol=LEAF * scale + 1e-12)
        spec_ = ranks[0]["specs"]
        for k in path:
            spec_ = spec_[k]
        got = assemble([_pick(r["grads0"], path).numpy() for r in ranks],
                       spec_, (2, 2))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=LEAF * scale + 1e-12)
        if kind == "zeros":
            assert not got.any() and not want.any()
    if kind == "ones":
        unmasked = meshes((2, 2))["unmasked"]
        for r, u in zip(ranks, unmasked):
            assert r["loss0"] == pytest.approx(u["loss0"], rel=1e-6)
        assert loss == pytest.approx(masked_one_device["unmasked"], rel=1e-6)
    if kind == "zeros":
        assert all(r["loss0"] == 0.0 for r in ranks) and loss == 0.0


def _pick(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_a_max_len_the_cut_does_not_divide_raises_before_any_collective():
    """30 positions over a model axis of 4: the cache's specs refuse it
    naming A11 (``Ranks`` has no collectives); so do they a cut of the
    positions over "data" that holds only because 3 slots do not divide
    the data ranks (the batch's rule takes "data" first)."""
    cfg = configs("dense")[1]
    model = build_model(cfg)
    mesh = Ranks(FLASH)
    table = rules.decode_rules(cfg, mesh.axis_sizes)
    with api.plan_context(mesh=mesh), rules.use_rules(table, mesh):
        with pytest.raises(NotImplementedError,
                           match="30 positions .* 4 ways.* A11"):
            serve.mesh_cache(model, model.cache_defs(2, 30), CPU)
    rules.require_ported(cfg.family, mesh, table)
    sizes = {"data": 2, "model": 1}
    with pytest.raises(NotImplementedError, match="3 slots .* A11"):
        specs.cache_specs(model.cache_defs(3, 8),
                          rules.make_rules(shard_cache_seq=True), sizes)
