"""FSDP ("embed" cut over the batch's mesh axes, ROADMAP A11.5) on gloo
meshes of ranks on the CPU, against one device and the JAX reference.

Each case is a reduced fp32 model (``reduce_for_smoke`` on both sides, cut
to two layers, remat on, so each layer's recomputation gathers its weights
again) with the same numpy weights (``interop.numpy_params`` at the port's
true fan-ins, the MoE's perm tables from ``cfg=``) and the same global
batch, trained under FSDP's rules, ``make_rules(fsdp=True,
expert_tp=cfg.expert_tp)`` (the reduced configs' ``fsdp`` is off, as the
reference's): every "embed" dim of the parameters and their AdamW state
cut over "data", and on (2, 2) the heads, MLP and experts over "model" as
well.  Seven configs, all six families: qwen3-14b (dense, qk-norm),
pixtral-12b (vlm), qwen3-moe-30b-a3b (top-2 of 8 at capacity factor 1.0,
``moe_groups`` 1), grok-1-314b (``expert_tp``), zamba2-1.2b (hybrid: its
shared block's ``win`` cut on its first dim only), xlstm-1.3b (ssm, an
mLSTM and an sLSTM) and whisper-tiny (encdec), each on (2, 1) and (2, 2),
each mesh shape spawned once (``launch.mesh_checks``; a rank imports
nothing of JAX).

The step-0 loss, the global gradient norm and every gradient leaf, put
back together from the ranks' blocks, against the port on one device (the
loss and the norm rtol 1e-6, each leaf within 1e-5 of its largest
magnitude: a leaf summed twice over "data" would be off by a factor of 2)
and against the reference's one-device ``value_and_grad`` (the fp32 ``tol``
of ``tests/test_kernels.py``); each rank's "embed" dims halved; the leaves
no rule cuts bit-equal on every rank after an AdamW step; the init leaf by
leaf equal to the init whole then cut, bit for bit; a (2, 1) FSDP
checkpoint restored on one device bit for bit and a one-device one
restored into the mesh; the save, gathered leaf by leaf, writing the
arrays of the whole gathered state; a checkpoint taken mid-run, its write
pending while the next donated step runs, restoring the state at its
step bit for bit; ``Mesh.reduce_scatter`` on gloo equal
to ``all_reduce`` then this rank's block.
"""
import concurrent.futures
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.data import pipeline as jpipeline
from repro.models import build_model as jbuild_model
from repro_torch import interop
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data import pipeline
from repro_torch.interop import numpy_params
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import mesh_checks
from repro_torch.models import build_model
from repro_torch.models.params import leaves, map_leaves
from repro_torch.optim import adamw, schedules
from repro_torch.parallel import rules, specs, steps
from repro_torch.runtime.trainer import Trainer, TrainerConfig

from _torch_mesh import AXES, Ranks, assemble, assemble_tree

LR = 1e-3
SCHEDULE = ("cosine", LR, 0, 10)
ONE = dict(loss=1e-6, leaf=1e-5)          # against the port on one device
REF = dict(rtol=1e-5, atol=1e-6)          # tests/test_kernels.py's fp32 tol
# the hybrid's gradients against the reference: the rtol of its parity
# tests, as tests/test_torch_tp.py holds them (its Mamba2 and gated norm
# differ from the reference's in operation order, ROADMAP §C)
REF_GRADS = {"hybrid": dict(rtol=1e-4, atol=1e-6)}
# case -> (arch, config changes on both sides)
CASES = {
    "dense": ("qwen3-14b", {}),
    "vlm": ("pixtral-12b", {}),
    "moe": ("qwen3-moe-30b-a3b",
            dict(top_k=2, capacity_factor=1.0, moe_groups=1)),
    "grok": ("grok-1-314b", {}),
    "hybrid": ("zamba2-1.2b", {}),
    "ssm": ("xlstm-1.3b", dict(slstm_every=2)),
    "encdec": ("whisper-tiny", {}),
}
SHAPES = ((2, 1), (2, 2))
RUNS = [(case, shape) for shape in SHAPES for case in CASES]
IDS = [f"{case}-{d}x{m}" for case, (d, m) in RUNS]
# a reduce-scatter's input on every rank of (2, 2): (ranks, 4, 6, 2)
RS_SEED = 7


def configs(case):
    arch, changes = CASES[case]
    changes = dict(n_layers=2, remat=True, **changes)
    return (dataclasses.replace(jreduce(jget_config(arch)), **changes),
            dataclasses.replace(reduce_for_smoke(get_config(arch)),
                                **changes))


def fsdp_rules(cfg):
    return rules.make_rules(fsdp=True, expert_tp=cfg.expert_tp)


def data_kw(cfg) -> dict:
    return dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
                seed=3, n_img_tokens=cfg.n_img_tokens,
                n_frames=cfg.n_frames if cfg.family == "encdec" else 0,
                d_model=cfg.d_model)


def data_cfg(cfg):
    return pipeline.DataConfig(**data_kw(cfg))


def pick(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def param_specs(cfg, shape):
    sizes = dict(zip(AXES, shape))
    return specs.param_specs(build_model(cfg).param_defs(),
                             rules.restrict_to_mesh(fsdp_rules(cfg), sizes),
                             sizes)


def state_specs(cfg, shape):
    sizes = dict(zip(AXES, shape))
    return specs.state_specs(build_model(cfg).param_defs(),
                             rules.restrict_to_mesh(fsdp_rules(cfg), sizes),
                             master=True, axis_sizes=sizes)


@pytest.fixture(scope="module")
def one_device():
    """Per case: the numpy train state and the port's one-device step-0
    loss, gradients and norm."""
    out = {}
    for case in CASES:
        cfg = configs(case)[1]
        model = build_model(cfg)
        tree = numpy_params(model.param_defs(), 0, true_fan_in=True, cfg=cfg)
        data = data_cfg(cfg)
        host = interop.params_from_jax(tree, cfg, device="cpu")
        loss, grads = steps.value_and_grad(
            model, host, pipeline.make_batch(data, 0, device="cpu"))
        out[case] = {
            "cfg": cfg, "data": data, "tree": tree,
            "state": map_leaves(interop.to_numpy, {
                "params": host,
                "opt": adamw.init_state(host, adamw.AdamWConfig())}),
            "loss": float(loss), "grads": grads,
            "norm": float(adamw.global_norm(grads))}
    return out


@pytest.fixture(scope="module")
def reference(one_device):
    """Per case: the reference's one-device step-0 loss and gradients."""
    out = {}
    for case in CASES:
        jcfg, cfg = configs(case)
        loss, grads = jax.jit(jax.value_and_grad(
            jbuild_model(jcfg).loss, allow_int=True))(
            jax.tree.map(jnp.asarray, one_device[case]["tree"]),
            jpipeline.make_batch(jpipeline.DataConfig(**data_kw(cfg)), 0))
        out[case] = {"loss": float(loss),
                     "grads": {path: np.asarray(g) for path, g in leaves(grads)
                               if np.issubdtype(np.asarray(g).dtype,
                                                np.floating)}}
    return out


def _trainer(cfg, directory, n_steps):
    return Trainer(build_model(cfg), data_cfg(cfg), adamw.AdamWConfig(),
                   schedules.make_schedule(SCHEDULE[0], peak=LR, warmup=0,
                                           total=SCHEDULE[3]),
                   TrainerConfig(n_steps=n_steps, ckpt_every=max(n_steps, 1),
                                 ckpt_dir=str(directory), keep=1),
                   device="cpu")


@pytest.fixture(scope="module")
def single_ckpt(tmp_path_factory):
    """A one-device checkpoint of the reduced qwen3-14b after one step."""
    root = tmp_path_factory.mktemp("fsdp_ckpt")
    cfg = configs("dense")[1]
    trainer = _trainer(cfg, root / "single", 1)
    trainer.train(1)
    return {"root": root, "single": trainer, "cfg": cfg}


@pytest.fixture(scope="module")
def meshes(one_device, single_ckpt):
    """``run(shape)``: each mesh shape spawned once, both at once in the
    background (the reference's steps run meanwhile), every case as a
    ``train`` job under FSDP's rules (one AdamW step) and a
    ``reduce_scatter`` job; on (2, 1) also the checkpoint round trip (an
    FSDP ``Trainer`` restoring the one-device checkpoint, then two steps of
    its own, saved) and a ``mid_run_save`` (two steps, a checkpoint after
    each)."""
    rng = np.random.default_rng(RS_SEED)
    xs = {shape: rng.standard_normal((shape[0] * shape[1], 4, 6, 2)).astype(
        np.float32) for shape in SHAPES}

    def spawn(shape):
        jobs = [("train", dict(cfg=one_device[c]["cfg"],
                               state=one_device[c]["state"],
                               data_cfg=one_device[c]["data"], steps_run=1,
                               schedule=SCHEDULE,
                               rules=fsdp_rules(one_device[c]["cfg"])))
                for c in CASES]
        jobs.append(("reduce_scatter", dict(xs=xs[shape])))
        if shape == (2, 1):
            root, cfg = single_ckpt["root"], single_ckpt["cfg"]
            jobs.append(("trainer", dict(
                cfg=cfg, data_cfg=data_cfg(cfg),
                restore_dir=str(root / "single"), save_dir=str(root / "mesh"),
                steps_run=2, schedule=SCHEDULE, rules=fsdp_rules(cfg))))
            jobs.append(("mid_run_save", dict(
                cfg=cfg, data_cfg=data_cfg(cfg), save_dir=str(root / "mid"),
                schedule=SCHEDULE, rules=fsdp_rules(cfg))))
        ranks = mesh_lib.spawn(mesh_checks.run, shape, AXES, device="cpu",
                               args=(jobs,))
        out = {c: [r[i] for r in ranks] for i, c in enumerate(CASES)}
        out["reduce_scatter"] = ([r[len(CASES)] for r in ranks], xs[shape])
        if shape == (2, 1):
            out["trainer"] = [r[-2] for r in ranks]
            out["mid_run"] = [r[-1] for r in ranks]
        return out

    with concurrent.futures.ThreadPoolExecutor(len(SHAPES)) as pool:
        runs = {shape: pool.submit(spawn, shape) for shape in SHAPES}
        yield lambda shape: runs[shape].result()


@pytest.mark.parametrize("case,shape", RUNS, ids=IDS)
def test_fsdp_loss_and_norm_match_one_device_and_the_reference(
        case, shape, meshes, one_device, reference):
    want = one_device[case]
    for r in meshes(shape)[case]:
        np.testing.assert_allclose(r["loss0"], want["loss"], rtol=ONE["loss"])
        np.testing.assert_allclose(r["gnorm0"], want["norm"],
                                   rtol=ONE["loss"])
        np.testing.assert_allclose(r["loss0"], reference[case]["loss"],
                                   **REF)


@pytest.mark.parametrize("case,shape", RUNS, ids=IDS)
def test_fsdp_grads_match_one_device_and_the_reference(
        case, shape, meshes, one_device, reference):
    """Every gradient leaf, the FSDP-cut ones summed over "data" once by
    their gather's backward (a reduce-scatter) and no more."""
    ranks, want = meshes(shape)[case], one_device[case]
    n = 0
    for path, g in leaves(want["grads"]):
        if g is None:
            continue
        g, name = interop.to_numpy(g), "/".join(path)
        got = assemble([pick(r["grads0"], path) for r in ranks],
                       pick(ranks[0]["specs"]["params"], path), shape)
        scale = float(np.abs(g).max())
        assert scale > 0, name
        np.testing.assert_allclose(got, g, rtol=0, atol=ONE["leaf"] * scale,
                                   err_msg=name)
        np.testing.assert_allclose(got, reference[case]["grads"][path],
                                   err_msg=name,
                                   **REF_GRADS.get(case, REF))
        n += 1
    assert n == len(reference[case]["grads"])


@pytest.mark.parametrize("case,shape", RUNS, ids=IDS)
def test_fsdp_halves_every_embed_dim_on_data(case, shape, meshes,
                                             one_device):
    """Each rank holds half of every parameter's "embed" dim (its first,
    where a leaf has two: the shared block's ``win``), and so do its AdamW
    moments and master copy; the dims the rules cut over "model" are the
    tensor-parallel cut.  No leaf with an "embed" dim is left whole."""
    cfg = one_device[case]["cfg"]
    d, m = shape
    state = meshes(shape)[case][0]["state"]
    defs = build_model(cfg).param_defs()
    pspecs = param_specs(cfg, shape)
    n_embed = 0
    for path, dfn in leaves(defs):
        s = rules.dim_axes(pick(pspecs, path), len(dfn.shape))
        if "embed" in dfn.axes:
            first = dfn.axes.index("embed")
            assert s[first] == ("data",), (case, path)
            n_embed += 1
        want = tuple(n // rules.spec_size(a, dict(zip(AXES, shape)))
                     for n, a in zip(dfn.shape, s))
        for part in (("params",), ("opt", "m"), ("opt", "v"),
                     ("opt", "master")):
            if not dfn.dtype.is_floating_point and part != ("params",):
                continue
            got = tuple(pick(state, part + path).shape)
            assert got == want, (case, part + path, got, want)
    assert n_embed >= 5
    assert tuple(state["params"]["embed"].shape) == (cfg.vocab_size // m,
                                                     cfg.d_model // d)


@pytest.mark.parametrize("case,shape", RUNS, ids=IDS)
def test_unsharded_leaves_are_bit_equal_on_every_rank(case, shape, meshes,
                                                      one_device):
    """After an AdamW step every leaf no rule cuts -- the norms' scales,
    the perms, the step, the leaves with no "embed" dim that "model" does
    not cut -- holds the same bits on every rank; every leaf with an
    "embed" dim, with its moments and master copy, is cut."""
    ranks, cfg = meshes(shape)[case], one_device[case]["cfg"]
    sharded = {p for p in specs.sharded_paths(ranks[0]["specs"],
                                              dict(zip(AXES, shape)))}
    defs = build_model(cfg).param_defs()
    for path, dfn in leaves(defs):
        if "embed" in dfn.axes:
            for part in (("params",), ("opt", "m"), ("opt", "v"),
                         ("opt", "master")):
                assert part + path in sharded, (case, part + path)
    assert set(ranks[0]["digests"]) | {"/".join(p) for p in sharded} == {
        "/".join(p) for p, _ in leaves(ranks[0]["state"])}
    assert ranks[0]["digests"]
    for r in ranks[1:]:
        assert r["digests"] == ranks[0]["digests"]
        assert r["losses"] == ranks[0]["losses"]


@pytest.mark.parametrize("case", CASES)
def test_init_leaf_by_leaf_equals_init_whole_then_cut(case):
    """``init_train_state(cut=)`` draws each leaf whole and cuts it before
    the next: every rank's blocks of the parameters, moments and master
    copy equal, bit for bit, the whole state's cut, on (2, 2) under FSDP's
    rules."""
    cfg = dataclasses.replace(configs(case)[1], dtype="bfloat16")
    model = build_model(cfg)
    sizes = dict(zip(AXES, (2, 2)))
    table = rules.restrict_to_mesh(fsdp_rules(cfg), sizes)
    opt = adamw.AdamWConfig()
    spec_tree = specs.state_specs(model.param_defs(), table, master=True,
                                  axis_sizes=sizes)
    whole = steps.init_train_state(model, opt, 5, device="cpu")
    for rank in range(4):
        want = specs.shard_tree(whole, spec_tree, sizes, rank)
        got = steps.init_train_state(
            model, opt, 5, device="cpu",
            cut=lambda path, t, r=rank: specs.shard_leaf(
                t, pick(spec_tree["params"], path), sizes, r))
        for path, t in leaves(want):
            g = pick(got, path)
            assert g.dtype == t.dtype and g.shape == t.shape, path
            assert torch.equal(g, t), (case, rank, path)


def test_fsdp_checkpoint_restores_on_one_device_bit_for_bit(single_ckpt,
                                                            meshes):
    cfg, root = single_ckpt["cfg"], single_ckpt["root"]
    ranks = meshes((2, 1))["trainer"]
    step, state = _trainer(cfg, root / "mesh", 2).init_or_restore(0)
    assert step == 2
    spec_tree = state_specs(cfg, (2, 1))
    whole = assemble_tree([r["final"] for r in ranks], spec_tree, (2, 1))
    for path, got in leaves(state):
        want = pick(whole, path)
        assert interop.to_numpy(got).dtype == want.dtype
        np.testing.assert_array_equal(interop.to_numpy(got), want,
                                      err_msg="/".join(path))


def test_one_device_checkpoint_restores_into_the_fsdp_mesh(single_ckpt,
                                                           meshes):
    ranks = meshes((2, 1))["trainer"]
    cfg = single_ckpt["cfg"]
    assert all(r["restored_step"] == 1 for r in ranks)
    spec_tree = state_specs(cfg, (2, 1))
    whole = assemble_tree([r["restored"] for r in ranks], spec_tree, (2, 1))
    for path, want in leaves(single_ckpt["single"].state):
        np.testing.assert_array_equal(pick(whole, path),
                                      interop.to_numpy(want))
    assert tuple(ranks[0]["restored"]["params"]["s00_dense"]["mlp"][
        "wi"].shape) == (2, cfg.d_model // 2, cfg.d_ff)


def test_fsdp_save_writes_the_whole_gathered_state(single_ckpt, meshes):
    """The save gathers leaf by leaf and only rank 0 keeps and writes what
    it gathers: its files hold the arrays the gather of the whole state
    gives (the ranks' final blocks put back together), every key, dtype
    and bit, in the one-device layout."""
    cfg, root = single_ckpt["cfg"], single_ckpt["root"]
    ranks = meshes((2, 1))["trainer"]
    spec_tree = state_specs(cfg, (2, 1))
    whole = assemble_tree([r["final"] for r in ranks], spec_tree, (2, 1))
    want = {"/".join(p): np.asarray(a) for p, a in leaves(whole)}
    steps_dir = sorted(os.listdir(root / "mesh"))
    assert steps_dir == ["step_00000002"]
    files = sorted(os.listdir(root / "mesh" / steps_dir[0]))
    assert files == ["meta.json", "shard_0.npz"]
    with np.load(root / "mesh" / steps_dir[0] / "shard_0.npz") as z:
        assert sorted(z.files) == sorted(want)
        for k in z.files:
            assert z[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(z[k], want[k], err_msg=k)


def test_mid_run_fsdp_checkpoint_restores_the_state_at_its_step(
        single_ckpt, meshes):
    """A (2, 1) FSDP run checkpoints after each of two steps, the first
    checkpoint's write held until the second step, donated, has written
    into the state: restored on one device, the step-1 checkpoint holds the
    state the ranks held at step 1 bit for bit, the leaves no rule cuts
    (which rank 0 writes from its own copy) as well as the gathered ones."""
    cfg, root = single_ckpt["cfg"], single_ckpt["root"]
    ranks = meshes((2, 1))["mid_run"]
    spec_tree = state_specs(cfg, (2, 1))
    at_1 = assemble_tree([r["step1"] for r in ranks], spec_tree, (2, 1))
    ckpt = CheckpointManager(str(root / "mid"))
    assert ckpt.all_steps() == [1, 2]
    got = ckpt.restore(1, steps.init_train_state(
        build_model(cfg), adamw.AdamWConfig(), 0, device="cpu"))
    assert {p for p, _ in leaves(got)} == {p for p, _ in leaves(at_1)}
    for path, t in leaves(got):
        want = pick(at_1, path)
        assert interop.to_numpy(t).dtype == want.dtype, path
        np.testing.assert_array_equal(interop.to_numpy(t), want,
                                      err_msg="/".join(path))


@pytest.mark.parametrize("shape", SHAPES, ids=["2x1", "2x2"])
def test_reduce_scatter_on_gloo_is_all_reduce_then_this_ranks_block(
        shape, meshes):
    """``Mesh.reduce_scatter`` over each set of axes, along each dim that
    splits, equals the sum over the ranks of the axes cut to this rank's
    block (``all_reduce`` then the block), and counts the whole input's
    bytes, as its all-reduce sends them over gloo."""
    got, xs = meshes(shape)["reduce_scatter"]
    for rank, out in enumerate(got):
        coords = dict(zip(AXES, np.unravel_index(rank, shape)))
        assert out["transport"] == "all_reduce, then this rank's block"
        assert len(out["cases"]) == (3 if shape == (2, 1) else 7)
        for (axes, dim), (block, nbytes) in out["cases"].items():
            same = [r for r in range(len(got)) if all(
                np.unravel_index(r, shape)[i] == coords[a]
                for i, a in enumerate(AXES) if a not in axes)]
            total = xs[same].sum(axis=0)
            n = int(np.prod([shape[AXES.index(a)] for a in axes]))
            idx = 0
            for a in axes:
                idx = idx * shape[AXES.index(a)] + int(coords[a])
            step = total.shape[dim] // n
            want = np.take(total, range(idx * step, (idx + 1) * step),
                           axis=dim)
            np.testing.assert_allclose(interop.to_numpy(block), want,
                                       rtol=1e-6, atol=1e-6)
            assert nbytes == xs[0].nbytes


@pytest.mark.parametrize("over", [("model",), ("data", "model")],
                         ids=["model", "data+model"])
def test_embed_off_the_batch_axes_is_refused(over):
    """FSDP runs over the batch's mesh axes only: "embed" cut over another
    axis of more than one rank raises naming A11 (on (2, 2); on (2, 1) the
    model axis cuts nothing), and FSDP's own rules pass the guard for every
    family on (2, 1) and (2, 2)."""
    with pytest.raises(NotImplementedError, match="FSDP .* A11"):
        rules.require_ported("dense", Ranks((2, 2)), rules.make_rules(
            fsdp=True, overrides={"embed": over}))
    rules.require_ported("dense", Ranks((2, 1)), rules.make_rules(
        fsdp=True, overrides={"embed": over}))
    for shape in SHAPES:
        for case in CASES:
            cfg = configs(case)[1]
            rules.require_ported(cfg.family, Ranks(shape), fsdp_rules(cfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_donated_update_gives_the_same_bits(dtype, monkeypatch):
    """``apply_updates(donate=True)``, which the mesh ``Trainer``'s step
    takes so that it holds one train state, writes into the input state's
    tensors a chunk at a time (here chunks smaller than the leaves) the same
    bits the update without donation returns."""
    cfg = dataclasses.replace(configs("dense")[1], dtype=dtype)
    model = build_model(cfg)
    opt = adamw.AdamWConfig()
    state = steps.init_train_state(model, opt, 3, device="cpu")
    batch = pipeline.make_batch(data_cfg(cfg), 0, device="cpu")
    _, grads = steps.value_and_grad(model, state["params"], batch)
    monkeypatch.setattr(adamw, "DONATE_CHUNK", 1000)
    for _ in range(2):
        want_p, want_opt, _ = adamw.apply_updates(
            state["params"], grads, state["opt"], 1e-3, opt)
        got_p, got_opt, _ = adamw.apply_updates(
            state["params"], grads, state["opt"], 1e-3, opt, donate=True)
        for path, t in leaves({"params": want_p, "opt": want_opt}):
            g = pick({"params": got_p, "opt": got_opt}, path)
            assert g.dtype == t.dtype and torch.equal(g, t), path
        assert got_p["embed"] is state["params"]["embed"]
        state = {"params": got_p, "opt": got_opt}
