"""The moe, vlm, encdec, hybrid and ssm families trained on a mesh of ranks
against the JAX package's one-device step, on the CPU.

Reduced configs (``reduce_for_smoke`` on both sides), fp32, the same numpy
weights (``interop.numpy_params`` at the port's true fan-ins, the MoE's
perm tables from ``cfg=``) and the same global batch (``data.pipeline``:
16 tokens x 4 rows, the vlm's 8 image embeddings and the encdec's 16
frames a row).  The MoE runs top-2 of 8 at capacity factor 1.0, where the
capacity drops assignments, so a rank that ranked its own tokens alone
would keep others than one device; at ``moe_groups`` 1 (every config's,
with remat on) and 2.

Meshes: (2, 1) and (1, 2) over gloo, each spawned once for the module with
every family as a job (``launch.mesh_checks``; a rank imports nothing of
JAX), the MoE at ``moe_groups`` 2 on (2, 1) only.  Each family runs under
its launchers' rules (``rules.launcher_rules``): on (1, 2) every family's
layers are tensor-parallel (heads, MLP, experts and the recurrent blocks'
columns and heads cut by rank).  On each mesh the step-0
loss and every gradient leaf, put back together from the ranks' blocks,
against the reference's ``jax.value_and_grad(model.loss)``; the global
norm; the loss after one AdamW update against the port's one-device step;
the leaves that are not sharded bit-equal on every rank.  One MoE layer on
the (2, 1) mesh: the kept mask and ranks of the ranks' assignments equal
one device's exactly, and the load-balance loss's router gradient, summed
over the ranks as the train step sums it, equals one device's.

Tolerances are ``tests/test_torch_spmd.py``'s: the loss rtol 1e-5, each
gradient leaf rtol 1e-4 with an atol of 1e-2 of its largest magnitude, the
norm rtol 5e-3, the loss after the update rtol 2e-3.
"""
import dataclasses
import math

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
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data import pipeline
from repro_torch.interop import numpy_params
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import mesh_checks
from repro_torch.models import build_model, moe
from repro_torch.models.params import leaves, map_leaves
from repro_torch.optim import adamw, schedules
from repro_torch.parallel import rules, specs, steps

from _torch_mesh import CUT

AXES = ("data", "model")
LR = 1e-3
SCHEDULE = ("cosine", LR, 0, 10)
MOE = dict(top_k=2, capacity_factor=1.0)
# family -> (arch, config changes on both sides)
FAMILIES = {
    "moe": ("qwen3-moe-30b-a3b", dict(MOE, moe_groups=1, remat=True)),
    "moe-g2": ("qwen3-moe-30b-a3b", dict(MOE, moe_groups=2)),
    "vlm": ("pixtral-12b", {}),
    "encdec": ("whisper-tiny", {}),
    "hybrid": ("zamba2-1.2b", {}),
    "ssm": ("xlstm-1.3b", {}),
}
MESH_FAMILIES = {(2, 1): list(FAMILIES),
                 (1, 2): [f for f in FAMILIES if f != "moe-g2"]}
CASES = [(shape, fam) for shape, fams in MESH_FAMILIES.items()
         for fam in fams]
IDS = [f"{d}x{m}-{fam}" for (d, m), fam in CASES]


def configs(family):
    arch, changes = FAMILIES[family]
    return (dataclasses.replace(jreduce(jget_config(arch)), **changes),
            dataclasses.replace(reduce_for_smoke(get_config(arch)),
                                **changes))


def data_cfgs(cfg):
    kw = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=3,
              n_img_tokens=cfg.n_img_tokens,
              n_frames=cfg.n_frames if cfg.family == "encdec" else 0,
              d_model=cfg.d_model)
    return jpipeline.DataConfig(**kw), pipeline.DataConfig(**kw)


def pick(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def assemble(blocks, spec_, shape):
    """The global array of the ranks' ``blocks`` (rank order) under
    ``spec_`` on a (data, model) mesh of ``shape`` with one axis of more
    than one rank; ranks that hold the same block hold the same bits."""
    blocks = [interop.to_numpy(b) for b in blocks]
    sizes = dict(zip(AXES, shape))
    cut = [d for d, axes in enumerate(rules.dim_axes(spec_, blocks[0].ndim))
           if rules.spec_size(axes, sizes) > 1]
    if not cut:
        for b in blocks[1:]:
            np.testing.assert_array_equal(b, blocks[0])
        return blocks[0]
    (dim,) = cut
    return np.concatenate(blocks, axis=dim)


@pytest.fixture(scope="module")
def reference():
    """Per family: the numpy train state, the reference's step-0 loss,
    gradients and global norm, and the port's one-device loss after one
    AdamW update."""
    out = {}
    for family in FAMILIES:
        jcfg, cfg = configs(family)
        jmodel, model = jbuild_model(jcfg), build_model(cfg)
        tree = numpy_params(model.param_defs(), 0, true_fan_in=True, cfg=cfg)
        jdata, data = data_cfgs(cfg)
        loss0, grads0 = jax.jit(jax.value_and_grad(
            jmodel.loss, allow_int=True))(jax.tree.map(jnp.asarray, tree),
                                          jpipeline.make_batch(jdata, 0))
        grads0 = {path: np.asarray(g) for path, g in leaves(grads0)
                  if np.issubdtype(np.asarray(g).dtype, np.floating)}
        host = interop.params_from_jax(tree, cfg, device="cpu")
        state = {"params": host, "opt": adamw.init_state(host,
                                                         adamw.AdamWConfig())}
        step = steps.make_train_step(
            model, adamw.AdamWConfig(),
            schedules.make_schedule(SCHEDULE[0], peak=LR, warmup=0,
                                    total=SCHEDULE[3]))
        losses = []
        for i in range(2):
            state, metrics = step(state, pipeline.make_batch(data, i,
                                                             device="cpu"))
            losses.append(float(metrics["loss"]))
        out[family] = {
            "cfg": cfg, "data": data,
            "state": map_leaves(interop.to_numpy, {
                "params": host,
                "opt": adamw.init_state(host, adamw.AdamWConfig())}),
            "loss0": float(loss0), "grads0": grads0,
            "gnorm0": math.sqrt(sum(float(np.sum(np.square(
                g.astype(np.float64)))) for g in grads0.values())),
            "losses": losses}
    return out


def moe_layer_inputs():
    """One MoE layer of the top-2 config at ``moe_groups`` 1 (its perm the
    skew table's row 3) and (4, 16, d) rows."""
    _, cfg = configs("moe")
    tree = numpy_params(moe.moe_defs(cfg), 2)
    tree["perm"] = moe.make_perms(cfg, 4, 16)[3]
    x = np.random.default_rng(5).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32)
    return cfg, tree, x


@pytest.fixture(scope="module")
def mesh_runs(reference):
    """``run(shape)``: one spawn of the mesh a module, every family's
    ``train`` job (two steps), and on (2, 1) one MoE layer."""
    runs = {}

    def run(shape):
        if shape in runs:
            return runs[shape]
        fams = MESH_FAMILIES[shape]
        jobs = [("train", dict(cfg=reference[f]["cfg"],
                               state=reference[f]["state"],
                               data_cfg=reference[f]["data"], steps_run=2,
                               schedule=SCHEDULE)) for f in fams]
        if shape[0] > 1:
            cfg, tree, x = moe_layer_inputs()
            jobs.append(("moe_layer", dict(cfg=cfg, tree=tree, x=x)))
        ranks = mesh_lib.spawn(mesh_checks.run, shape, AXES, device="cpu",
                               args=(jobs,))
        runs[shape] = {
            "shape": shape,
            "train": {f: [r[i] for r in ranks] for i, f in enumerate(fams)},
            "moe_layer": [r[-1] for r in ranks] if shape[0] > 1 else None}
        return runs[shape]

    return run


@pytest.fixture
def mesh_run(request, mesh_runs):
    return mesh_runs(request.param)


@pytest.mark.parametrize("mesh_run,family", CASES, ids=IDS,
                         indirect=["mesh_run"])
def test_mesh_loss_matches_the_reference(mesh_run, reference, family):
    ranks = mesh_run["train"][family]
    want = reference[family]
    for r in ranks:
        np.testing.assert_allclose(r["loss0"], want["loss0"], rtol=1e-5)
        assert r["loss0"] == ranks[0]["loss0"]
        assert r["losses"][0] == r["loss0"]


@pytest.mark.parametrize("mesh_run,family", CASES, ids=IDS,
                         indirect=["mesh_run"])
def test_mesh_grads_match_the_reference(mesh_run, reference, family):
    ranks, shape = mesh_run["train"][family], mesh_run["shape"]
    want = reference[family]
    for r in ranks:
        np.testing.assert_allclose(r["gnorm0"], want["gnorm0"], rtol=5e-3)
    spec_tree = ranks[0]["specs"]["params"]
    for path, w in want["grads0"].items():
        got = assemble([pick(r["grads0"], path) for r in ranks],
                       pick(spec_tree, path), shape)
        assert got.shape == w.shape, path
        np.testing.assert_allclose(
            got, w, rtol=1e-4, atol=1e-2 * max(float(np.abs(w).max()), 1e-30),
            err_msg="/".join(path))


@pytest.mark.parametrize("mesh_run,family", CASES, ids=IDS,
                         indirect=["mesh_run"])
def test_mesh_loss_after_an_update_matches_one_device(mesh_run, reference,
                                                      family):
    ranks = mesh_run["train"][family]
    want = reference[family]["losses"]
    for r in ranks:
        np.testing.assert_allclose(r["losses"][1], want[1], rtol=2e-3)
        assert r["losses"] == ranks[0]["losses"]


@pytest.mark.parametrize("mesh_run,family", CASES, ids=IDS,
                         indirect=["mesh_run"])
def test_unsharded_leaves_are_bit_equal_on_every_rank(mesh_run, family):
    ranks, shape = mesh_run["train"][family], mesh_run["shape"]
    sizes = dict(zip(AXES, shape))
    sharded = {"/".join(p) for p in specs.sharded_paths(ranks[0]["specs"],
                                                        sizes)}
    # on a model axis the embedding (and an untied head), every attention,
    # MLP and expert weight and bias, and the recurrent blocks' columns and
    # heads shard, with their moments and master copies
    cut = {"/".join(p) for p, _ in leaves(ranks[0]["state"]["params"])
           if p[-1] in CUT}
    assert sharded == ({f"{part}/{p}" for p in cut for part in (
        "params", "opt/m", "opt/v", "opt/master")} if shape[1] > 1
        else set())
    assert set(ranks[0]["digests"]) | sharded == {
        "/".join(p) for p, _ in leaves(ranks[0]["state"])}
    for r in ranks[1:]:
        assert r["digests"] == ranks[0]["digests"]


def _one_device_moe_layer():
    cfg, tree, x = moe_layer_inputs()
    p = {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}
    router = p["router"].requires_grad_(True)
    *_, slot, pos, keep, cap = moe.route(p, torch.from_numpy(x).reshape(
        -1, cfg.d_model), cfg)
    out, aux = moe.apply_moe(p, torch.from_numpy(x), cfg)
    (grad,) = torch.autograd.grad(aux, [router])
    return {"slot": slot, "pos": pos, "keep": keep, "cap": cap,
            "out": out.detach(),
            "aux": float(aux.detach()), "router_grad": grad}


@pytest.mark.parametrize("mesh_run", [(2, 1)], ids=["2x1"], indirect=True)
def test_moe_ranks_assignments_over_the_global_batch(mesh_run):
    """``moe_groups`` 1 on two data ranks: each rank all-gathers the slot
    ids in token order and keeps its own assignments' global ranks, so the
    kept mask is one device's exactly, with the global capacity; at
    capacity factor 1.0 it drops, and a rank ranking its own tokens alone
    would keep others."""
    one = _one_device_moe_layer()
    ranks = mesh_run["moe_layer"]
    assert all(r["cap"] == one["cap"] for r in ranks)
    keep = torch.cat([r["keep"] for r in ranks], dim=1)
    pos = torch.cat([r["pos"] for r in ranks], dim=1)
    assert torch.equal(keep, one["keep"]) and torch.equal(pos, one["pos"])
    assert not bool(one["keep"].all()), "capacity factor 1.0 dropped nothing"
    cfg, tree, _ = moe_layer_inputs()
    p = {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}
    alone = []
    for r in range(2):
        x = torch.from_numpy(moe_layer_inputs()[2][2 * r:2 * r + 2])
        slot = moe.route(p, x.reshape(-1, cfg.d_model), cfg)[3]
        alone.append(moe._ranks(slot, cfg.n_experts) < one["cap"])
    assert not torch.equal(torch.cat(alone, dim=1), one["keep"])
    out = torch.cat([r["out"] for r in ranks], dim=0)
    np.testing.assert_allclose(out.numpy(), one["out"].numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("mesh_run", [(2, 1)], ids=["2x1"], indirect=True)
def test_moe_rank_buffers_hold_only_their_own_cells(mesh_run):
    """A rank's expert buffer has as many rows an expert as its longest run
    of kept assignments to one expert, counted here from one device's kept
    mask (rounded up to 8, at most the capacity), not the global
    capacity's."""
    one = _one_device_moe_layer()
    cfg = moe_layer_inputs()[0]
    n = one["slot"].shape[1] // 2
    for r, got in enumerate(mesh_run["moe_layer"]):
        mine = slice(r * n, (r + 1) * n)
        runs = torch.zeros(cfg.n_experts, dtype=torch.int64).scatter_add_(
            0, one["slot"][0, mine][one["keep"][0, mine]],
            torch.ones(n, dtype=torch.int64)[one["keep"][0, mine]])
        longest = int(runs.max())
        assert got["cells"] == min(max(-(-longest // 8) * 8, 8), one["cap"])


def test_own_cells_shift_a_ranks_runs_to_zero():
    """Two ranks of 32 assignments each, slots 0-3 in turn: the group's
    ranks of rank 1's assignments to a slot are 8-15; shifted they are
    0-7, and a buffer of 8 rows an expert holds what 16 held.  At a
    capacity of 12 rank 1 keeps ranks 8-11 alone, still in 8 rows."""
    e = 4
    group = torch.arange(64).remainder(e)[None]
    pos = moe._ranks(group, e)
    for cap, kept in ((16, 8), (12, 4)):
        keep = pos < cap
        for r in range(2):
            mine = slice(32 * r, 32 * (r + 1))
            local, cells = moe.own_cells(group[:, mine], pos[:, mine],
                                         keep[:, mine], e, cap)
            assert torch.equal(local, pos[:, mine] - 8 * r)
            assert cells == 8
            assert int(keep[:, mine].sum()) == (32 if r == 0 else kept * e)


@pytest.mark.parametrize("mesh_run", [(2, 1)], ids=["2x1"], indirect=True)
def test_moe_aux_gradient_is_counted_once_over_the_data_ranks(mesh_run):
    """Every rank holds the global load-balance loss; its router gradient
    is the rank's share, and the shares summed over the data ranks (as
    ``steps`` sums every leaf) are one device's gradient, not twice it."""
    one = _one_device_moe_layer()
    ranks = mesh_run["moe_layer"]
    for r in ranks:
        np.testing.assert_allclose(r["aux"], one["aux"], rtol=1e-6)
    total = sum(r["router_grad"] for r in ranks)
    want = one["router_grad"]
    scale = float(want.abs().max())
    assert scale > 0
    np.testing.assert_allclose(total.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6 * scale)
    assert not torch.allclose(ranks[0]["router_grad"], want, rtol=1e-2)


@pytest.mark.parametrize("family", ["vlm", "encdec"])
def test_a_ranks_images_and_frames_are_rows_of_the_global_batch(family):
    """On a (2, 2) mesh each rank's ``img_embeds``/``frames`` are its rows
    of the global batch bit for bit, by the rows of its tokens, and the
    global batch is the reference's."""
    jdata, data = data_cfgs(configs(family)[1])
    key = "img_embeds" if family == "vlm" else "frames"
    full = pipeline.make_batch(data, 2, device="cpu")
    np.testing.assert_array_equal(
        full[key].numpy(), np.asarray(jpipeline.make_batch(jdata, 2)[key]))
    sizes = {"data": 2, "model": 2}
    for rank in range(4):
        mine = specs.shard_leaf(np.arange(data.global_batch), ("data",),
                                sizes, rank=rank)
        got = pipeline.make_batch(data, 2, specs.NamedSharding(
            _MappingMesh(sizes, rank), ("data",)), device="cpu")
        for k in ("tokens", "labels", key):
            assert torch.equal(got[k], full[k][mine]), k
        assert got[key].shape[0] == data.global_batch // 2


class _MappingMesh:
    """A mapping mesh seen from one rank, enough for ``shard_leaf``."""

    def __init__(self, sizes, rank):
        self.axis_names, self.shape = tuple(sizes), tuple(sizes.values())
        self.coords = tuple(int(c) for c in np.unravel_index(rank, self.shape))
        self.device = torch.device("cpu")
