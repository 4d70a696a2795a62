"""Decoding and serving on a mesh of ranks (ROADMAP A11.5), on gloo meshes
of ranks on the CPU, against one device and the JAX reference.

Each case is a reduced fp32 model (``reduce_for_smoke`` on both sides, cut
to two layers) with the same numpy weights (``interop.numpy_params`` at the
port's true fan-ins, the MoE's perm tables from ``cfg=``), served under
``rules.decode_rules(cfg, mesh)`` (the reference's decode-cell rules) on
(2, 1), (1, 2) and (2, 2): the dense (qwen2-0.5b, GQA 4 heads over 2 KV
heads, QKV bias), vlm, moe (top-2 of 8 at capacity factor 1, where
assignments drop, ranked over the global batch), hybrid (two Mamba2 layers
and the shared block), ssm (an mLSTM and an sLSTM) and encdec families,
and qwen3-14b and qwen3-moe under FSDP's rules (``make_rules(fsdp=True,
...)``: "embed" cut over "data") on the meshes with a data axis.  Each mesh
shape is spawned once for every case (``launch.mesh_checks.serve``; a rank
imports nothing of JAX).  Held:

  * a teacher-forced replay of 6 decode steps of 4 token streams: each
    step's logits, gathered over the vocab ranks, within the fp32 ``tol``
    of tests/test_kernels.py's rtol and an atol of 1e-5 of their largest
    magnitude of the port's one-device decode (a tensor-parallel sum
    reorders fp32 additions, which moves a logit by a few ulps of the
    logits' scale: up to 4.1e-6 at a scale of 4.1, measured, so an
    elementwise atol of 1e-6 does not hold near zero), and of the
    reference's one-device ``decode_step`` at the same tolerance (the
    hybrid at tests/test_torch_hybrid.py's ``LOGITS``: its one-device
    port differs from the reference by operation order, ROADMAP §C);
  * four ragged requests through the continuous batcher (two slots, slot
    reuse, chunked prefill, paged and dense): paged tokens equal dense
    tokens bit for bit on every rank and the ranks agree; on (2, 1) every
    request's tokens equal one device's; on a model axis every token
    agrees up to the first decision whose one-device top-2 gap is below
    the logits' bound (none did at these seeds: the test reports the
    smallest gap it met);
  * the encoder-decoder's static batch (``serve.serve_static``, its rows
    over "data") equal to one device's;
  * uneven chunked rows on (2, 2): one rank's rows run 5 micro-steps, the
    other's 2, and the step runs the global rows' longest count, which the
    caller passes (the batcher holds it), with no hang (the MoE's capacity
    ranking makes a collective every micro-step); not told the count, the
    step raises before any collective;
  * three slots over two data ranks (every data rank holds every slot);
  * the greedy token across the vocab ranks breaks ties to the lowest
    global column, as ``torch.argmax`` does on one device;
  * ``launch.serve --mesh 2x2 --device cpu``;
  * the flash-decoding override ``decode_rules`` gives the reduced
    qwen2-0.5b's 2 KV heads on a model axis of 4 passes the guard and cuts
    the cache's positions (tests/test_torch_flash_decode.py runs it); a
    cache length that cut does not divide raises ``NotImplementedError``
    naming A11 before any collective;
  * the batcher plans under its mesh (the reference's
    tests/test_api.py::TestCallSiteMeshThreading batcher tests).
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
from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch import lowering as jlowering
from repro.models import build_model as jbuild_model
from repro.models.params import init_params as jinit_params
from repro_torch import api, interop
from repro_torch.configs import ARCHS, get_config, reduce_for_smoke
from repro_torch.core import planner
from repro_torch.interop import numpy_params
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import mesh_checks, serve
from repro_torch.models import build_model
from repro_torch.models.params import init_params, leaves, map_tree
from repro_torch.parallel import rules, specs, steps
from repro_torch.serving import ContinuousBatcher, Request

from _torch_mesh import AXES, Ranks

CPU = torch.device("cpu")
REF = dict(rtol=1e-5, atol=1e-6)          # tests/test_kernels.py's fp32 tol
SCALED = 1e-5                             # the atol, over the logits' scale
# the reference's tolerance where the one-device port already differs from
# it by operation order (tests/test_torch_hybrid.py's LOGITS)
REF_LOGITS = {"hybrid": dict(rtol=1e-4, atol=1e-5)}
MOE = dict(top_k=2, capacity_factor=1.0, moe_groups=1)
# case -> (arch, config changes on both sides, FSDP's rules)
CASES = {
    "dense": ("qwen2-0.5b", {}, False),
    "vlm": ("pixtral-12b", {}, False),
    "moe": ("qwen3-moe-30b-a3b", MOE, False),
    "hybrid": ("zamba2-1.2b", {}, False),
    "ssm": ("xlstm-1.3b", dict(slstm_every=2), False),
    "encdec": ("whisper-tiny", {}, False),
    "fsdp-dense": ("qwen3-14b", {}, True),
    "fsdp-moe": ("qwen3-moe-30b-a3b", MOE, True),
}
SHAPES = ((2, 1), (1, 2), (2, 2))
RUNS = [(c, s) for c in CASES for s in SHAPES
        if not (CASES[c][2] and s[0] == 1)]
SLOTS, MAX_LEN, CHUNK, STREAMS, STEPS, GEN = 2, 32, 4, 4, 6, 4


def ids(run):
    case, (d, m) = run
    return f"{case}-{d}x{m}"


def configs(case):
    arch, changes, _ = CASES[case]
    changes = dict(n_layers=2, **changes)
    return (dataclasses.replace(jreduce(jget_config(arch)), **changes),
            dataclasses.replace(reduce_for_smoke(get_config(arch)),
                                **changes))


def case_rules(case, cfg):
    return (rules.make_rules(fsdp=True, expert_tp=cfg.expert_tp)
            if CASES[case][2] else None)


def requests(cfg):
    rng = np.random.default_rng(0)
    return [Request(i, rng.integers(1, cfg.vocab_size,
                                    size=3 + 2 * i).tolist(), 4 + i)
            for i in range(4)]


def inputs(cfg):
    """The replay's streams (and an encoder-decoder's frames), seeded."""
    rng = np.random.default_rng(1)
    streams = rng.integers(1, cfg.vocab_size,
                           size=(STREAMS, STEPS)).astype(np.int32)
    frames = (rng.standard_normal((STREAMS, cfg.n_frames, cfg.d_model))
              .astype(np.float32) if cfg.family == "encdec" else None)
    return streams, frames


def top2_gap(logits: torch.Tensor) -> torch.Tensor:
    top = torch.topk(logits, 2, dim=-1).values
    return top[..., 0] - top[..., 1]


@pytest.fixture(scope="module")
def one_device():
    """Per case: the numpy weights, the port's one-device replay logits,
    served streams (paged) or static tokens, and each request's decision
    logits (its own stream teacher-forced) for the top-2 gaps."""
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
            streams, frames = inputs(cfg)
            fr = None if frames is None else torch.from_numpy(frames)
            res = {"cfg": cfg, "tree": tree, "streams": streams,
                   "frames": frames, "replay": serve.teacher_forced_logits(
                       model, host, torch.from_numpy(streams), frames=fr)}
            if cfg.family == "encdec":
                res["static"] = serve.serve_static(
                    model, host, fr, torch.from_numpy(streams), GEN)
            else:
                got = serve.serve_requests(
                    model, host, requests(cfg), kv_cache="paged",
                    slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK,
                    device=CPU)["completed"]
                res["completed"] = got
                res["gaps"] = {}
                for r in requests(cfg):
                    seq = torch.tensor([r.prompt + got[r.rid][:-1]],
                                       dtype=torch.int32)
                    logits = serve.teacher_forced_logits(
                        model, host, seq)[:, 0]
                    res["gaps"][r.rid] = (
                        top2_gap(logits[len(r.prompt) - 1:]),
                        float(logits.abs().max()))
            out[case] = res
    finally:
        torch.set_num_threads(n)
    return out


@pytest.fixture(scope="module")
def reference(one_device):
    """Per case: the reference's one-device ``decode_step`` over the same
    streams (after ``prefill_cross`` for the encoder-decoder)."""
    out = {}
    for case in CASES:
        jcfg, _ = configs(case)
        jmodel = jbuild_model(jcfg)
        one = one_device[case]
        params = jax.tree.map(jnp.asarray, one["tree"])
        cache = jinit_params(jax.random.PRNGKey(0),
                             jmodel.cache_defs(STREAMS, STEPS))
        if one["frames"] is not None:
            cache["cross_k"], cache["cross_v"] = jmodel.prefill_cross(
                params, jnp.asarray(one["frames"]))
        step = jax.jit(jmodel.decode_step)
        logits = []
        for t in range(STEPS):
            lg, cache = step(params, cache,
                             jnp.asarray(one["streams"][:, t:t + 1]))
            logits.append(np.asarray(lg[:, -1]))
        out[case] = np.stack(logits)
    return out


@pytest.fixture(scope="module")
def meshes(one_device):
    """``run(shape)``: each mesh shape spawned once, all at once in the
    background, every case on it as a ``serve`` job; on (2, 1) also three
    slots over the two data ranks, on (1, 2) the greedy token's ties, on
    (2, 2) the uneven chunk step."""
    tie = np.random.default_rng(2).standard_normal((3, 512)).astype(
        np.float32)
    tie[0, [10, 300]] = 9.0     # a tie across the two vocab shards
    tie[1, [256, 257]] = 9.0    # inside the second
    tie[2, [255, 256]] = 9.0    # across the boundary

    def spawn(shape):
        names = [c for c, s in RUNS if s == shape]
        jobs = []
        for c in names:
            one = one_device[c]
            cfg = one["cfg"]
            kw = dict(cfg=cfg, tree=one["tree"], rules=case_rules(c, cfg),
                      replay=one["streams"], frames=one["frames"])
            if cfg.family == "encdec":
                kw.update(gen=GEN)
            else:
                kw.update(reqs=requests(cfg), slots=SLOTS, max_len=MAX_LEN,
                          prefill_chunk=CHUNK)
            jobs.append(("serve", kw))
        moe = one_device["moe"]
        if shape == (2, 1):
            jobs.append(("serve", dict(
                cfg=moe["cfg"], tree=moe["tree"],
                reqs=requests(moe["cfg"]), slots=3, max_len=MAX_LEN,
                prefill_chunk=CHUNK)))
        if shape == (1, 2):
            jobs.append(("greedy", dict(cfg=moe["cfg"], logits=tie)))
        if shape == (2, 2):
            rng = np.random.default_rng(3)
            jobs.append(("chunk", dict(
                cfg=moe["cfg"], tree=moe["tree"],
                tokens=rng.integers(1, 512, (4, 5)).astype(np.int32),
                nvalid=np.array([5, 0, 1, 2], np.int32))))
        ranks = mesh_lib.spawn(mesh_checks.run, shape, AXES, device="cpu",
                               args=(jobs,))
        out = {c: [r[i] for r in ranks] for i, c in enumerate(names)}
        out["extra"] = [r[-1] for r in ranks]
        out["jobs"] = jobs
        return out

    with concurrent.futures.ThreadPoolExecutor(len(SHAPES)) as pool:
        runs = {shape: pool.submit(spawn, shape) for shape in SHAPES}
        yield lambda shape: runs[shape].result()


@pytest.mark.parametrize("run", RUNS, ids=ids)
def test_decode_logits_match_one_device_and_the_reference(
        run, meshes, one_device, reference):
    case, shape = run
    want = one_device[case]["replay"].numpy()
    scale = float(np.abs(want).max())
    ref = REF_LOGITS.get(one_device[case]["cfg"].family)
    for r in meshes(shape)[case]:
        got = r["replay"].numpy()
        assert got.shape == (STEPS, STREAMS, one_device[case]["cfg"]
                             .vocab_size)
        np.testing.assert_allclose(got, want, rtol=REF["rtol"],
                                   atol=SCALED * scale)
        np.testing.assert_allclose(
            got, reference[case],
            **(ref or dict(rtol=REF["rtol"], atol=SCALED * scale)))


@pytest.mark.parametrize("run", RUNS, ids=ids)
def test_served_tokens_match_one_device(run, meshes, one_device):
    case, shape = run
    one = one_device[case]
    ranks = meshes(shape)[case]
    if one["cfg"].family == "encdec":
        for r in ranks:
            assert torch.equal(r["runs"]["static"]["out"], one["static"])
        return
    smallest = np.inf
    for r in ranks:
        got = r["runs"]["paged"]["completed"]
        assert sorted(got) == sorted(one["completed"])
        for rid, want in one["completed"].items():
            gaps, scale = one["gaps"][rid]
            bound = SCALED * scale
            for j, (a, b) in enumerate(zip(got[rid], want)):
                smallest = min(smallest, float(gaps[j]))
                if a != b:
                    # only on a model axis, and only at a near-tie
                    assert shape[1] > 1, (case, rid, j)
                    assert float(gaps[j]) < bound, (case, rid, j,
                                                    float(gaps[j]), bound)
                    break
            else:
                assert len(got[rid]) == len(want)
    assert smallest > 0, f"{case}: smallest top-2 gap {smallest}"


@pytest.mark.parametrize("run", RUNS, ids=ids)
def test_paged_equals_dense_and_the_ranks_agree(run, meshes):
    case, shape = run
    ranks = meshes(shape)[case]
    first = ranks[0]["runs"]
    for r in ranks:
        for kv, res in r["runs"].items():
            if kv == "static":
                assert torch.equal(res["out"], first[kv]["out"])
                continue
            assert res["completed"] == first[kv]["completed"]
        if "paged" in r["runs"]:
            assert (r["runs"]["paged"]["completed"]
                    == r["runs"]["dense"]["completed"])
            assert r["runs"]["paged"]["page_len"] == 16


def test_uneven_chunk_rows_on_2x2_take_the_data_ranks_longest(meshes):
    """One data rank's rows advance 5 and 0 tokens, the other's 1 and 2:
    every rank runs 5 micro-steps, the count it is given (the MoE ranks
    capacity over the global batch each one, a collective), and the
    tokens and write indices equal one device's chunk step.  Without the
    count, the step raises on every rank before any collective."""
    got = meshes((2, 2))["extra"]
    job = meshes((2, 2))["jobs"][-1][1]
    one = one_device_chunk(job)
    for r in got:
        assert "needs steps=" in r["refused"]
        assert torch.equal(r["next"], one[0])
        assert r["idx"].tolist() == [5, 0, 1, 2] == one[1].tolist()


def one_device_chunk(job):
    cfg = job["cfg"]
    model = build_model(cfg)
    params = interop.params_from_jax(job["tree"], cfg, device="cpu")
    defs = model.cache_defs(*job["tokens"].shape)
    cache = init_params(0, defs, device="cpu")
    step = steps.make_chunk_step(
        model, map_tree(lambda d: d.axes.index("batch"), defs))
    with torch.inference_mode():
        nxt, cache = step(params, cache, torch.from_numpy(job["tokens"]),
                          torch.from_numpy(job["nvalid"]))
    return nxt, cache["idx"]


def test_slots_that_do_not_divide_the_data_ranks(meshes, one_device):
    """Three slots on two data ranks: every data rank holds every slot,
    and the streams equal one device's, paged and dense."""
    moe = one_device["moe"]
    want = serve.serve_requests(
        build_model(moe["cfg"]),
        interop.params_from_jax(moe["tree"], moe["cfg"], device="cpu"),
        requests(moe["cfg"]), kv_cache="paged", slots=3, max_len=MAX_LEN,
        prefill_chunk=CHUNK, device=CPU)["completed"]
    for r in meshes((2, 1))["extra"]:
        assert r["runs"]["paged"]["completed"] == want
        assert r["runs"]["dense"]["completed"] == want


def test_greedy_ties_go_to_the_lowest_global_column(meshes):
    """A tie across the vocab shards, inside one and at their boundary:
    the lowest global column wins, as ``torch.argmax`` gives on one
    device, in one all-gather."""
    for r in meshes((1, 2))["extra"]:
        assert r["tokens"].tolist() == [10, 256, 255]
        assert r["calls"] == 1


def test_serve_launcher_on_a_2x2_mesh_of_the_cpu():
    """``launch.serve --mesh 2x2 --device cpu``: four ranks serve the
    reduced qwen3-4b's requests paged and dense, every rank the same
    streams, equal to the one-device launcher's."""
    argv = ["--arch", "qwen3-4b", "--device", "cpu", "--requests", "3",
            "--slots", "2", "--max-len", "32", "--prompt-len", "3", "8",
            "--gen", "2", "5"]
    one = serve.main(argv + ["--mesh", "host"])
    res = serve.main(argv + ["--mesh", "2x2", "--kv-cache", "both"])
    assert len(res["ranks"]) == 4
    assert res["requests"] == 3
    for r in res["ranks"]:
        assert r["runs"]["paged"]["completed"] == one["completed"]
        assert r["runs"]["dense"]["completed"] == one["completed"]
        assert r["runs"]["paged"]["comm"]["calls"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_rules_are_the_reference_decode_cell_rules(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for m in (1, 2, 4, 16):
        assert rules.decode_rules(cfg, {"data": 2, "model": m}) == (
            jlowering.cell_rules(jcfg, JSHAPES["decode_32k"],
                                 multi_pod=False, tp=m))


def test_cache_specs_cut_the_rows_and_the_heads():
    """On (2, 2): the dense KV cache on "batch" and "kv_heads", the paged
    pool on "kv_heads" alone (no batch axis: whole over "data"), the page
    table and ``act`` on "batch", the Mamba2, mLSTM and sLSTM state on
    "batch" and their heads or columns, the encoder-decoder's cross K/V on
    "batch" and "kv_heads"."""
    sizes = {"data": 2, "model": 2}
    table = rules.decode_rules(configs("dense")[1], sizes)
    got = {}
    for case in ("dense", "hybrid", "ssm", "encdec"):
        model = build_model(configs(case)[1])
        for name, defs in (("dense", model.cache_defs(4, 8)),
                           ("paged", getattr(model, "paged_cache_defs",
                                             lambda *a: {})(4, 8, 5, 4))):
            cs = specs.cache_specs(defs, table, sizes)
            got.update({(case, name, "/".join(p)): s
                        for p, s in leaves(cs)})
    want = {
        ("dense", "dense", "idx"): ("data",),
        ("dense", "dense", "s00_dense/k"): (None, "data", "model"),
        ("dense", "paged", "s00_dense/v"): (None, None, None, "model"),
        ("dense", "paged", "pages"): ("data",),
        ("dense", "paged", "act"): ("data",),
        ("hybrid", "dense", "s00_mamba/conv_x"): (None, "data", None,
                                                  "model"),
        ("hybrid", "dense", "s00_mamba/conv_bc"): (None, "data"),
        ("hybrid", "dense", "s00_mamba/ssm"): (None, "data", "model"),
        ("hybrid", "paged", "s01_shared_attn/k"): (None, None, None,
                                                   "model"),
        ("ssm", "dense", "s00_mlstm/c"): (None, "data", "model"),
        ("ssm", "dense", "s00_mlstm/conv"): (None, "data", None, "model"),
        ("ssm", "dense", "s01_slstm/h"): (None, "data", "model"),
        ("encdec", "dense", "cross_k"): (None, "data", None, "model"),
        ("encdec", "dense", "self/v"): (None, "data", "model"),
    }
    for key, s in want.items():
        assert got[key] == s, key


def test_flash_decoding_and_a_whole_kv_head_cut_raise_before_any_collective():
    """The reduced qwen2-0.5b (4 heads, 2 KV heads) on a model axis of 4:
    ``decode_rules`` gives the flash-decoding override, which runs since
    flash decoding is ported (tests/test_torch_flash_decode.py serves it):
    the rules pass ``require_ported``, a rank's dense cache holds a quarter
    of the positions of every KV head, and a cache whose length the cut
    does not divide raises ``NotImplementedError`` naming A11 before any
    collective.  With the KV heads left whole under the launchers' rules
    instead, a decode step's query heads are a rank's and its cache keeps
    every KV head (no raise).  ``Ranks`` has no collectives."""
    cfg = configs("dense")[1]
    model = build_model(cfg)
    mesh = Ranks((1, 4))
    table = rules.decode_rules(cfg, mesh.axis_sizes)
    assert table["cache_seq"] == ("model",) and table["kv_heads"] is None
    rules.require_ported(cfg.family, mesh, table)
    cs = specs.cache_specs(model.cache_defs(2, 8), table, mesh.axis_sizes)
    assert cs["s00_dense"]["k"] == (None, "data", None, "model")
    with api.plan_context(mesh=mesh), rules.use_rules(table, mesh):
        with pytest.raises(NotImplementedError,
                           match="6 positions .* 4 ways.* A11"):
            serve.mesh_cache(model, model.cache_defs(2, 6), CPU)
    with api.plan_context(mesh=mesh), \
            rules.use_rules(rules.make_rules(), mesh):
        from repro_torch.models import blocks

        assert blocks.decode_parallel(cfg)[1] == ("model",)
        assert blocks.cache_seq_parallel(cfg) == (None, ())


def test_decode_tick_steps_every_slot_outside_the_schedule():
    """``ContinuousBatcher.decode_tick`` (the tick ``launch.serve``
    profiles): one decode step of every slot fed token 1, the tokens and
    cache of ``make_decode_step`` on a fresh cache, no request moved and
    nothing counted."""
    cfg = configs("dense")[1]
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    b = ContinuousBatcher(model, params, slots=SLOTS, max_len=MAX_LEN,
                          device="cpu")
    cache = init_params(0, model.cache_defs(SLOTS, MAX_LEN), device="cpu")
    with torch.inference_mode():
        want, cache = steps.make_decode_step(model)(
            params, cache, torch.ones((SLOTS, 1), dtype=torch.int32))
    got = b.decode_tick()
    assert torch.equal(got, want)
    assert torch.equal(b.cache["idx"], cache["idx"])
    assert b.cache["idx"].tolist() == [1] * SLOTS
    assert (b.ticks, b.micro_steps, b.busy) == (0, 0, False)


class TestBatcherPlansUnderMesh:
    """The reference's batcher tests of
    tests/test_api.py::TestCallSiteMeshThreading against the port's
    ``ContinuousBatcher(mesh=)``: its plans are keyed by the mesh (a
    one-rank ``launch.mesh.Mesh``, which places nothing), and a batcher
    built before its context plans under it."""

    MESH_KEY = (("model", 1),)

    def _model(self):
        from repro_torch.models.config import ModelConfig

        cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=64,
                          n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=32,
                          dtype="float32", remat=False)
        return build_model(cfg)

    def _mesh_keys_for(self, kernel):
        return [k for k in planner.plan_cache_keys()
                if k[0] == kernel and k[3] == self.MESH_KEY]

    def test_batcher_asks_registry_under_mesh_and_packs_slots(self):
        planner.clear_plan_cache()
        model = self._model()
        params = model.init(0, device="cpu")
        b = ContinuousBatcher(model, params, slots=3, max_len=8,
                              mesh=mesh_lib.Mesh((1,), ("model",)),
                              device="cpu")
        assert b.decode_plan is not None
        assert b.decode_plan.mesh == self.MESH_KEY
        assert self._mesh_keys_for("rmsnorm")
        # slots packed to the planned rows
        assert b.padded_slots == b.decode_plan.rows
        assert b.padded_slots >= b.slots
        # cache batch axis follows the physical slot count
        assert b.padded_slots in b.cache["idx"].shape
        # admission records decode/prefill plans per batch shape
        b.submit([Request(rid=0, prompt=[1, 2], max_new_tokens=2),
                  Request(rid=1, prompt=[3], max_new_tokens=2)])
        assert ("prefill", 2) in b.plans
        assert b.plans[("prefill", 2)].mesh == self.MESH_KEY
        # once a slot moves to decode, the next tick records the decode
        # plan for that batch shape too (no new admission required)
        b.slot_req[0].fed = len(b.slot_req[0].prompt)
        b._note_admitted_plans()
        assert ("decode", 1) in b.plans
        assert b.plans[("decode", 1)].mesh == self.MESH_KEY

    def test_batcher_constructed_before_context_plans_under_mesh(self):
        """Construct-then-context: admitted-batch plans resolve the
        ambient mesh at call time, not a stale None snapshot from
        __init__."""
        planner.clear_plan_cache()
        model = self._model()
        b = ContinuousBatcher(model, model.init(0, device="cpu"), slots=2,
                              max_len=8, device="cpu")
        with api.plan_context(mesh=mesh_lib.Mesh((1,), ("model",))):
            b.submit([Request(rid=0, prompt=[1, 2], max_new_tokens=2)])
        assert b.plans[("prefill", 1)].mesh == self.MESH_KEY
