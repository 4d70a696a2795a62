"""The port's SPMD path over ``torch.distributed`` against the JAX package,
on the CPU.

Two halves.  The declarations and rules run in this process, mirroring
``tests/test_spmd_launch.py``'s single-device half: every kernel declares
a ``Partitioning``, the cross-entropy declares its vocab-parallel layout
with a ``SCALAR`` mean, templates expand, the registry refuses what the
reference refuses, the rules and their divisibility fallback give the
reference's specs and reasons, the planner's local plans price the same
collective bytes, and the mesh padding of the configs is the reference's.

Then meshes of ranks: (1, 2), (2, 1) and (2, 2) over gloo, each spawned
once for the module (``launch.mesh.spawn``; the rank functions live in
``repro_torch.launch.mesh_checks``, so a rank imports nothing of JAX).  On
each mesh:

  * ``api.launch("xent")`` (the vocab-parallel shard body with the B12
    partials, plain on the CPU) against the reference's single-device
    ``api.ref("xent")``, and the vocab-parallel ``xent_grad``, put back
    together from the ranks' blocks, against the reference's ``xent_grad``
    (the jnp vjp); a vocab of 1111 that does not split falls back to whole
    shards with its logged reason;
  * the reference's own SPMD path, run in a subprocess on 4 forced host
    devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``), gives
    the same loss and gradient on the same mesh;
  * reduced qwen2-0.5b from the same numpy weights, under the launchers'
    rules (``rules.launcher_rules``: on a model axis the vocab, the heads,
    the KV heads and the MLP shard, tensor parallelism): the loss, every
    gradient leaf and the norm of the first step against the reference's
    single-device ``value_and_grad``, and three AdamW steps against its
    trajectory, with ``tests/test_torch_train.py``'s tolerances; every leaf
    that is not sharded holds the same bits on every rank;
  * a single-device checkpoint restores into the mesh ``Trainer`` as each
    rank's blocks, and the mesh ``Trainer``'s checkpoint restores into a
    single-device ``Trainer`` bit for bit;
  * at the port's own init stds (the true attention fan-ins), the fp32
    step's loss, norm and gradients against the one-device port to rtol
    1e-6 and 1e-5 of a leaf's scale, from carried weights and from
    ``mesh_checks.seeded_grads`` (each rank draws ``model.init``), the job
    of ``chip_smoke.py``'s full-width gate.

Tolerances: the cross-entropy as in ``tests/test_torch_xent.py`` (loss
rtol 1e-5, gradient rtol 1e-5 / atol 1e-9); the model step as in
``tests/test_torch_train.py`` (loss rtol 1e-5; the norm rtol 5e-3; later
losses rtol 2e-3; parameters atol 2 lr a step), but each gradient leaf
against the reference at rtol 1e-4 with an atol of 1e-2 of its largest
magnitude, the gate ``chip_smoke.py`` holds the card's gradients to against
the CPU's: a mesh sums the head's dx over two vocab shards and the data
ranks' gradients in another order than one device, and the reduced
qwen2-0.5b, ill-conditioned at these weights (``tests/test_torch_train.py``),
amplifies that reordering to 1.6e-3 of the embedding gradient's scale (the
(1, 2) mesh).  The mesh's arithmetic itself is held tighter with float64
weights: its gradients equal the one-device port's to 1e-5 of each leaf's
scale (the logits and the loss are fp32 on both).
"""
import dataclasses
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api import spmd as jspmd
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.data import pipeline as jpipeline
from repro.kernels.xent import ops as jops
from repro.models import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.optim import schedules as jschedules
from repro.parallel import rules as jrules
from repro.parallel import steps as jsteps
from repro_torch import api, interop
from repro_torch.api import spmd
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import planner
from repro_torch.core.autotune import StreamSignature
from repro_torch.data import pipeline
from repro_torch.interop import numpy_params
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import mesh_checks
from repro_torch.models import build_model
from repro_torch.models.params import leaves, map_leaves
from repro_torch.optim import adamw, schedules
from repro_torch.parallel import rules, specs, steps
from repro_torch.runtime.trainer import Trainer, TrainerConfig

from _torch_mesh import assemble, assemble_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(1, 2), (2, 1), (2, 2)]
AXES = ("data", "model")
XENT = dict(rtol=1e-5, atol=1e-6)
XENT_GRAD = dict(rtol=1e-5, atol=1e-9)
LR = 1e-3
OPT = dict(weight_decay=0.1, clip_norm=1.0)
SCHEDULE = ("cosine", LR, 0, 10)
STEPS = 3
# (tokens, vocab, logical vocab): sharded over any model axis here, and a
# vocab that does not split in two
XENT_CASE = (16, 512, 500)
FALLBACK_CASE = (16, 1111, 1111)
# a vocab whose shards are odd (501 columns on a two-way model axis, no
# whole number of 16-B vectors at either dtype; the whole 1002 on one), the
# logical vocab ending inside the last shard's ragged tail
ODD_CASE = (16, 1002, 1001)
ODD_DTYPES = ["float32", "bfloat16"]
# the reduced config with this vocab, padded for a two-way model axis by the
# layout policy (``padded_for_mesh``, what ``launch.train --mesh DxM`` does
# by default): 500 logical columns in 512, the limit inside the last shard
PADDED_VOCAB = 500
# the parameter leaves a model axis cuts in the reduced qwen2-0.5b
TP_LEAVES = ("embed", "wq", "wk", "wv", "wo", "bq", "bk", "bv", "wi", "wg")


def xent_inputs(t, v, seed):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal((t, v))).astype(np.float32)
    labels = rng.integers(0, v - 12, size=t).astype(np.int32)
    return x, labels




def data_cfgs(vocab=512):
    kw = dict(vocab_size=vocab, seq_len=16, global_batch=4, seed=3)
    return jpipeline.DataConfig(**kw), pipeline.DataConfig(**kw)


def pick(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# declarations, gating, rules and the planner (this process)
# ---------------------------------------------------------------------------

class TestDeclarations:
    def test_every_registered_kernel_declares_partitioning(self):
        for name in api.list_kernels():
            assert isinstance(api.resolve(name).partitioning,
                              api.Partitioning), name

    def test_declarations_equal_the_reference(self):
        """Every kernel the reference registers declares its partitioning;
        the split norm's passes, which the reference has no counterpart of
        (its norm's row is never cut over ranks), declare a rank's block of
        rows cut over "mlp"."""
        split = {"rmsnorm.sumsq", "rmsnorm.gated.sumsq", "rmsnorm.apply",
                 "rmsnorm.gated.apply"}
        assert split <= set(api.list_kernels())
        for name in api.list_kernels():
            got = api.resolve(name).partitioning
            if name in split:
                with pytest.raises(KeyError):
                    japi.get_kernel(name)
                assert got.in_axes[0] == ("batch", ..., "mlp"), name
                continue
            want = japi.get_kernel(name).partitioning
            assert got.in_axes == want.in_axes, name
            assert got.out_axes == want.out_axes, name
            assert got.reduce == want.reduce, name

    def test_xent_declares_vocab_parallel(self):
        entry = api.resolve("xent")
        assert entry.partitioning.in_axes[0] == ("batch", "vocab")
        assert entry.partitioning.out_axes == spmd.SCALAR
        assert entry.partitioning.reduce == "mean"
        assert entry.spmd_body is not None

    def test_stencils_carry_their_halo_bodies(self):
        """The stencils' registrations carry the halo-exchange shard bodies
        (tests/test_torch_halo.py runs them) and the reference's
        partitioning: Jacobi's rows and LBM's X planes over "batch"."""
        from repro_torch.kernels.jacobi import ops as jacobi_ops
        from repro_torch.kernels.lbm import ops as lbm_ops

        bodies = {"jacobi": jacobi_ops._spmd_jacobi,
                  "lbm.soa": lbm_ops._spmd_lbm_soa,
                  "lbm.ivjk": lbm_ops._spmd_lbm_ivjk}
        for name, body in bodies.items():
            got = api.resolve(name)
            want = japi.get_kernel(name)
            assert got.spmd_body is body, name
            assert want.spmd_body is not None, name
            assert got.partitioning == spmd.Partitioning(
                in_axes=want.partitioning.in_axes,
                out_axes=want.partitioning.out_axes), name
        assert api.resolve("jacobi").partitioning.in_axes == (
            ("batch", None),)
        assert api.resolve("lbm.soa").partitioning.in_axes == (
            (None, "batch", None, None),)

    def test_template_expansion(self):
        for template, ndim in [(("batch", ..., None), 2),
                               (("batch", ..., None), 4), ((...,), 3),
                               (("batch",), 1)]:
            assert spmd._expand(template, ndim) == jspmd._expand(template,
                                                                 ndim)
        with pytest.raises(ValueError, match="rank"):
            spmd._expand(("batch", ..., None), 1)
        with pytest.raises(ValueError, match="rank"):
            spmd._expand(("batch", None), 3)

    def test_scalar_out_requires_reduce(self):
        with pytest.raises(ValueError, match="cross-shard reduce"):
            api.Partitioning(in_axes=(("batch", None),), out_axes=spmd.SCALAR)
        with pytest.raises(ValueError, match="only applies to SCALAR"):
            api.Partitioning(in_axes=(("batch",),), out_axes=("batch",),
                             reduce="mean")
        with pytest.raises(ValueError, match="reduce must be one of"):
            api.Partitioning(in_axes=(("batch",),), out_axes=spmd.SCALAR,
                             reduce="max")

    def test_registry_rejects_orphan_spmd_body(self):
        with pytest.raises(TypeError, match="spmd_body without"):
            @api.register_kernel("stream.bad_spmd_body",
                                 signature=StreamSignature(1, 1),
                                 ref=lambda a: a,
                                 plan_args=lambda a: (a.shape, a.dtype),
                                 spmd_body=lambda ctx, a: a)
            def _bad(plan, a):
                return a
        assert "stream.bad_spmd_body" not in planner.FAMILIES

    def test_registry_rejects_non_partitioning(self):
        with pytest.raises(TypeError, match="must be a"):
            @api.register_kernel("stream.bad_part",
                                 signature=StreamSignature(1, 1),
                                 ref=lambda a: a,
                                 plan_args=lambda a: (a.shape, a.dtype),
                                 partitioning={"in_axes": ()})
            def _bad(plan, a):
                return a


class _TwoRanks:
    """A stand-in for a two-rank ``Mesh`` (nothing here is launched)."""

    size = 2
    axis_names = AXES
    shape = (1, 2)
    axis_sizes = dict(zip(AXES, shape))

    def group(self, axes):
        raise AssertionError("no collective in a gating test")


class TestGating:
    def test_no_context_mesh_means_no_spmd(self):
        assert spmd.spmd_mesh() is None

    def test_mapping_mesh_plans_but_does_not_place(self):
        with api.plan_context(mesh={"data": 2, "model": 4}):
            assert spmd.spmd_mesh() is None

    def test_single_rank_mesh_is_not_spmd(self):
        with api.plan_context(mesh=mesh_lib.make_test_mesh((1, 1))):
            assert spmd.spmd_mesh() is None

    def test_spmd_false_opts_out(self):
        mesh = _TwoRanks()
        with api.plan_context(mesh=mesh):
            assert spmd.spmd_mesh() is mesh
            with api.plan_context(spmd=False):
                assert spmd.spmd_mesh() is None

    def test_rules_mesh_routes_too(self):
        mesh = _TwoRanks()
        with rules.use_rules(rules.DEFAULT_RULES, mesh):
            assert spmd.spmd_mesh() is mesh


class TestRules:
    @pytest.mark.parametrize("kw", [{}, {"multi_pod": True}, {"fsdp": True},
                                    {"expert_tp": True},
                                    {"shard_cache_seq": True},
                                    {"overrides": {"heads": None}}])
    def test_make_rules_equal_the_reference(self, kw):
        assert rules.make_rules(**kw) == jrules.make_rules(**kw)

    def test_make_rules_takes_the_references_arguments_alone(self):
        """``make_rules`` takes the reference's keyword arguments and no
        others (the port's own ``tensor_parallel`` option is gone)."""
        import inspect
        got = inspect.signature(rules.make_rules).parameters
        want = inspect.signature(jrules.make_rules).parameters
        assert list(got) == list(want)
        assert all(p.kind is inspect.Parameter.KEYWORD_ONLY
                   for p in got.values())
        with pytest.raises(TypeError):
            rules.make_rules(tensor_parallel=False)

    @pytest.mark.parametrize("sizes", [{"data": 2, "model": 4},
                                       {"data": 1, "model": 2},
                                       {"data": 2, "model": 1}])
    def test_spec_report_and_fallbacks_equal_the_reference(self, sizes):
        table = rules.restrict_to_mesh(rules.DEFAULT_RULES, sizes)
        jmesh = dict(sizes)
        jtable = {k: v for k, v in table.items()}
        assert table == jrules.restrict_to_mesh(
            jrules.DEFAULT_RULES, _JaxMeshNames(jmesh))
        for axes, shape in [(("batch", "vocab"), (8, 1111)),
                            (("batch", "vocab"), (8, 512)),
                            (("batch", "heads", "vocab"), (6, 14, 1000)),
                            (("vocab", "embed"), (151936, 896)),
                            (("batch", "batch"), (8, 8))]:
            got, got_fb = rules.spec_report(*axes, rules=table, shape=shape,
                                            axis_sizes=sizes)
            want, want_fb = jrules.spec_report(*axes, rules=jtable,
                                               shape=shape, axis_sizes=sizes)
            assert got == tuple(want), (axes, shape)
            assert got_fb == want_fb, (axes, shape)
        fb = rules.spec_report("batch", "vocab", rules=table, shape=(8, 1111),
                               axis_sizes=sizes)[1]
        assert any("not divisible" in r for r in fb) == (sizes["model"] > 1)


class _JaxMeshNames:
    """The reference's ``restrict_to_mesh`` reads only ``axis_names``."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)


class TestPlanner:
    @pytest.mark.parametrize("sizes", [{"data": 2, "model": 4},
                                       {"data": 1, "model": 2},
                                       {"data": 2, "model": 1}])
    @pytest.mark.parametrize("shape", [(32, 512), (4096, 75968), (7, 1000)])
    def test_comm_bytes_equal_the_reference(self, sizes, shape):
        with api.plan_context(mesh=sizes):
            got = api.plan_for("xent", shape, torch.float32, local=True)
        with japi.plan_context(mesh=sizes):
            want = japi.plan_for("xent", shape, jnp.float32, local=True)
        assert got.local and got.mesh == want.mesh
        assert got.predicted_comm_bytes == want.predicted_comm_bytes
        assert want.predicted_comm_bytes > 0
        # a global plan communicates nothing, on both sides
        assert api.plan_for("xent", shape, torch.float32).predicted_comm_bytes \
            == 0

    def test_local_plans_pad_nothing_global_plans_pad_to_equal_shards(self):
        with api.plan_context(mesh={"data": 2, "model": 4}):
            local = api.plan_for("xent", (32, 1001), torch.float32,
                                 local=True)
            glob = api.plan_for("xent", (32, 1001), torch.float32)
        assert local.padded_shape == (32, 1001)       # read in place
        assert glob.padded_shape == (32, 1004)        # 4 equal shards
        assert "local shard plan for mesh" in local.explain()
        assert "comm 0B" in api.explain("xent", (32, 512), torch.float32)
        with api.plan_context(mesh={"data": 2, "model": 4}):
            text = api.plan_for("xent", (32, 512), torch.float32,
                                local=True).explain()
        assert "comm 580B" in text

    def test_invalidate_mesh_plans(self):
        mesh = {"data": 2, "model": 2}
        with api.plan_context(mesh=mesh):
            api.plan_for("xent", (8, 64), torch.float32, local=True)
            api.plan_for("xent", (8, 64), torch.float32)
        api.plan_for("xent", (8, 64), torch.float32)
        assert planner.invalidate_mesh_plans(mesh) == 2
        assert planner.invalidate_mesh_plans(mesh) == 0
        assert planner.invalidate_mesh_plans(None) == 0


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-4b"])
@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_padded_for_mesh_equals_the_reference(arch, tp):
    got, got_changes = get_config(arch).padded_for_mesh(tp)
    want, want_changes = jget_config(arch).padded_for_mesh(tp)
    assert got_changes == want_changes
    for f in ("vocab_size", "vocab_logical", "d_ff", "n_heads", "n_kv_heads",
              "head_dim"):
        assert getattr(got, f) == getattr(want, f), f


def test_sharded_batch_is_the_global_batch_rows():
    _, cfg = data_cfgs()
    full = pipeline.make_batch(cfg, 2, device="cpu")
    for r in range(4):
        mesh = {"data": 2, "model": 2}
        rows = specs.shard_leaf(np.arange(cfg.global_batch), ("data",), mesh,
                                rank=r)
        sharding = specs.NamedSharding(_MappingMesh(mesh, r), ("data",))
        got = pipeline.make_batch(cfg, 2, sharding, device="cpu")
        for k in ("tokens", "labels"):
            assert torch.equal(got[k], full[k][rows])


class _MappingMesh:
    """A mapping mesh seen from one rank, enough for ``shard_leaf``."""

    def __init__(self, sizes, rank):
        self.axis_names, self.shape = tuple(sizes), tuple(sizes.values())
        self.coords = tuple(int(c) for c in np.unravel_index(rank, self.shape))
        self.device = torch.device("cpu")


def test_train_state_cut_by_rank_puts_back_together():
    cfg = reduce_for_smoke(get_config("qwen2-0.5b"))
    jmodel = jbuild_model(jreduce(jget_config("qwen2-0.5b")))
    tree = numpy_params(jmodel.param_defs(), 1)
    state = {"params": tree, "opt": jax.tree.map(
        np.asarray, jadamw.init_state(jax.tree.map(jnp.asarray, tree),
                                      jadamw.AdamWConfig()))}
    mesh = {"data": 1, "model": 2}
    blocks = [interop.train_state_from_jax(state, cfg, device="cpu",
                                           mesh=mesh, rank=r)
              for r in range(2)]
    assert tuple(blocks[0]["params"]["embed"].shape) == (256, 128)
    assert tuple(blocks[0]["params"]["s00_dense"]["attn"]["wq"].shape) == (
        4, 128, 2, 32)
    table = rules.restrict_to_mesh(rules.launcher_rules(cfg), mesh)
    spec_tree = specs.state_specs(build_model(cfg).param_defs(), table,
                                  master=True, axis_sizes=mesh)
    whole = assemble_tree(blocks, spec_tree, (1, 2))
    for path, want in leaves(jax.tree.map(np.asarray, state)):
        np.testing.assert_array_equal(pick(whole, path), want)


# ---------------------------------------------------------------------------
# meshes of ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    """The reference's single-device results for every mesh check."""
    out = {}
    x, labels = xent_inputs(*XENT_CASE[:2], seed=7)
    lv = XENT_CASE[2]
    jx, jl = jnp.asarray(x), jnp.asarray(labels)
    out["xent"] = (float(japi.ref("xent", jx, jl, logical_v=lv)),
                   np.asarray(jops.xent_grad(jx, jl, 1.0, logical_v=lv)))
    fx, fl = xent_inputs(*FALLBACK_CASE[:2], seed=8)
    out["fallback"] = float(japi.ref("xent", jnp.asarray(fx),
                                     jnp.asarray(fl)))
    out["inputs"] = (x, labels, fx, fl)
    ox, ol = xent_inputs(*ODD_CASE[:2], seed=9)
    out["odd"] = {dtype: float(japi.launch(
        "xent", jnp.asarray(ox).astype(dtype), jnp.asarray(ol),
        logical_v=ODD_CASE[2])) for dtype in ODD_DTYPES}
    out["odd_inputs"] = (ox, ol)

    jcfg = jreduce(jget_config("qwen2-0.5b"))
    jmodel = jbuild_model(jcfg)
    tree = numpy_params(jmodel.param_defs(), 0)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": jparams,
              "opt": jadamw.init_state(jparams, jadamw.AdamWConfig(**OPT))}
    out["state"] = jax.tree.map(np.asarray, jstate)
    jdata, _ = data_cfgs()
    loss0, grads0 = jax.jit(jax.value_and_grad(jmodel.loss, allow_int=True))(
        jparams, jpipeline.make_batch(jdata, 0))
    out["loss0"], out["grads0"] = float(loss0), jax.tree.map(np.asarray,
                                                             grads0)
    jstep = jax.jit(jsteps.make_train_step(
        jmodel, jadamw.AdamWConfig(**OPT),
        jschedules.make_schedule(SCHEDULE[0], peak=LR, warmup=0,
                                 total=SCHEDULE[3])))
    traj = []
    for i in range(STEPS):
        jstate, m = jstep(jstate, jpipeline.make_batch(jdata, i))
        traj.append((float(m["loss"]), float(m["grad_norm"])))
    out["trajectory"] = traj
    out["params"] = jax.tree.map(np.asarray, jstate["params"])

    pcfg, _ = dataclasses.replace(
        jcfg, vocab_size=PADDED_VOCAB).padded_for_mesh(2)
    pmodel = jbuild_model(pcfg)
    pparams = jax.tree.map(jnp.asarray,
                           numpy_params(pmodel.param_defs(), 1))
    pdata, _ = data_cfgs(PADDED_VOCAB)
    ploss, pgrads = jax.jit(jax.value_and_grad(pmodel.loss, allow_int=True))(
        pparams, jpipeline.make_batch(pdata, 0))
    pgrads = jax.tree.map(np.asarray, pgrads)
    out["padded"] = {
        "state": jax.tree.map(np.asarray, {
            "params": pparams,
            "opt": jadamw.init_state(pparams, jadamw.AdamWConfig(**OPT))}),
        "loss0": float(ploss), "grads0": pgrads,
        "gnorm0": math.sqrt(sum(float(np.sum(np.square(g.astype(np.float64))))
                                for _, g in leaves(pgrads)))}
    return out


_SUBPROCESS = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro import api
from repro.data import pipeline
from repro.kernels.xent import ops
z = np.load(sys.argv[1])
x, labels, lv = jnp.asarray(z["x"]), jnp.asarray(z["labels"]), int(z["lv"])
out = {}
for d, m in [(1, 2), (2, 1), (2, 2)]:
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:d * m]).reshape(d, m),
                             ("data", "model"))
    with api.plan_context(mesh=mesh):
        out[f"loss_{d}x{m}"] = np.asarray(
            api.launch("xent", x, labels, logical_v=lv))
        out[f"grad_{d}x{m}"] = np.asarray(
            ops.xent_grad(x, labels, 1.0, logical_v=lv))
cfg = pipeline.DataConfig(vocab_size=512, seq_len=16, global_batch=4, seed=3)
mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1),
                         ("data", "model"))
sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data", None))
out["batch_sharded"] = np.asarray(pipeline.make_batch(cfg, 0, sh)["tokens"])
out["batch_full"] = np.asarray(pipeline.make_batch(cfg, 0)["tokens"])
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def reference_spmd(reference, tmp_path_factory):
    """The reference's own SPMD path (shard_map over 4 forced host
    devices) on the same inputs, run in a subprocess."""
    d = tmp_path_factory.mktemp("jax_spmd")
    x, labels, _, _ = reference["inputs"]
    np.savez(d / "in.npz", x=x, labels=labels, lv=XENT_CASE[2])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", _SUBPROCESS, str(d / "in.npz"),
                    str(d / "out.npz")], env=env, check=True, timeout=300,
                   cwd=ROOT)
    with np.load(d / "out.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module", params=MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def mesh_run(request, reference, tmp_path_factory):
    """One spawn of the mesh: every rank runs every check, and the
    single-device side of the checkpoint round trip runs here."""
    shape = request.param
    x, labels, fx, fl = reference["inputs"]
    cfg = reduce_for_smoke(get_config("qwen2-0.5b"))
    _, data = data_cfgs()
    root = tmp_path_factory.mktemp(f"mesh_{shape[0]}x{shape[1]}")
    single = Trainer(build_model(cfg), data, adamw.AdamWConfig(),
                     schedules.make_schedule(SCHEDULE[0], peak=LR, warmup=0,
                                             total=SCHEDULE[3]),
                     TrainerConfig(n_steps=1, ckpt_every=1,
                                   ckpt_dir=str(root / "single"), keep=1),
                     device="cpu")
    single.train(1)
    jobs = [
        ("xent", dict(logits=x, labels=labels, logical_v=XENT_CASE[2])),
        ("xent", dict(logits=fx, labels=fl)),
        ("train", dict(cfg=cfg, state=reference["state"], data_cfg=data,
                       steps_run=STEPS, opt_cfg=adamw.AdamWConfig(**OPT),
                       schedule=SCHEDULE)),
        ("trainer", dict(cfg=cfg, data_cfg=data,
                         restore_dir=str(root / "single"),
                         save_dir=str(root / "mesh"), steps_run=2, seed=0,
                         schedule=SCHEDULE)),
    ]
    state64 = jax.tree.map(lambda a: np.asarray(a, np.float64),
                           reference["state"])
    jobs.append(("train", dict(cfg=dataclasses.replace(cfg, dtype="float64"),
                               state=state64, data_cfg=data, steps_run=0,
                               schedule=SCHEDULE)))
    padded, _ = dataclasses.replace(
        cfg, vocab_size=PADDED_VOCAB).padded_for_mesh(2)
    jobs.append(("train", dict(cfg=padded,
                               state=reference["padded"]["state"],
                               data_cfg=data_cfgs(PADDED_VOCAB)[1],
                               steps_run=1, opt_cfg=adamw.AdamWConfig(**OPT),
                               schedule=SCHEDULE)))
    # the port's own init stds (the true attention fan-ins, ROADMAP §C)
    tree = numpy_params(build_model(cfg).param_defs(), 0, true_fan_in=True)
    host = interop.params_from_jax(tree, cfg, device="cpu")
    well = map_leaves(interop.to_numpy, {
        "params": host, "opt": adamw.init_state(host, adamw.AdamWConfig())})
    jobs.append(("train", dict(cfg=cfg, state=well, data_cfg=data,
                               steps_run=0, schedule=SCHEDULE)))
    jobs.append(("seeded_grads", dict(cfg=cfg, seed=5, data_cfg=data)))
    ox, ol = reference["odd_inputs"]
    jobs += [("xent", dict(logits=ox, labels=ol, logical_v=ODD_CASE[2],
                           dtype=dtype)) for dtype in ODD_DTYPES]
    results = mesh_lib.spawn(mesh_checks.run, shape, AXES, device="cpu",
                             args=(jobs,))
    return {"shape": shape, "ranks": results, "cfg": cfg, "data": data,
            "root": root, "single": single, "state64": state64,
            "well": tree}


def test_xent_loss_matches_reference(mesh_run, reference):
    want, _ = reference["xent"]
    for r in mesh_run["ranks"]:
        np.testing.assert_allclose(r[0]["loss"], want, **XENT)
    d, m = mesh_run["shape"]
    assert mesh_run["ranks"][0][0]["spec"] == ("data", "model")
    assert not mesh_run["ranks"][0][0]["logs"]


def test_xent_grad_matches_reference(mesh_run, reference):
    _, want = reference["xent"]
    blocks = [interop.to_numpy(r[0]["grad"]) for r in mesh_run["ranks"]]
    got = assemble(blocks, mesh_run["ranks"][0][0]["spec"],
                   mesh_run["shape"])
    np.testing.assert_allclose(got, want, **XENT_GRAD)


def test_xent_matches_the_reference_spmd_path(mesh_run, reference_spmd):
    d, m = mesh_run["shape"]
    blocks = [interop.to_numpy(r[0]["grad"]) for r in mesh_run["ranks"]]
    got = assemble(blocks, mesh_run["ranks"][0][0]["spec"], (d, m))
    np.testing.assert_allclose(mesh_run["ranks"][0][0]["loss"],
                               float(reference_spmd[f"loss_{d}x{m}"]), **XENT)
    np.testing.assert_allclose(got, reference_spmd[f"grad_{d}x{m}"],
                               **XENT_GRAD)


def test_nondivisible_vocab_falls_back_with_its_reason(mesh_run, reference):
    d, m = mesh_run["shape"]
    for r in mesh_run["ranks"]:
        np.testing.assert_allclose(r[1]["loss"], reference["fallback"],
                                   **XENT)
        # the vocab stays whole on every rank
        assert r[1]["grad"].shape[1] == 1111
        assert r[1]["spec"] == (("data",) if m > 1 else ("data", "model"))
    logs = mesh_run["ranks"][0][1]["logs"]
    if m > 1:
        assert len(logs) == 1
        assert "dim 1 ('vocab', size 1111) replicated: not divisible" in \
            logs[0]
    else:
        assert not logs


@pytest.mark.parametrize("dtype", ODD_DTYPES)
def test_xent_at_odd_widths_matches_the_reference_launch(mesh_run, reference,
                                                         dtype):
    """``api.launch("xent")`` at a vocab of odd shards, through the
    vocab-parallel shard body (B12 partials on each 501-column shard,
    plain on the CPU, read where they lie) or, on a model axis of one,
    B11 on the whole 1002-column rows, against the reference's
    single-device ``api.launch`` (its Pallas kernel in interpret mode) on
    the same logits in the same dtype; and the port's own single-device
    launch likewise."""
    k = 8 + ODD_DTYPES.index(dtype)
    want = reference["odd"][dtype]
    for r in mesh_run["ranks"]:
        np.testing.assert_allclose(r[k]["loss"], want, **XENT)
        assert r[k]["spec"] == ("data", "model") and not r[k]["logs"]
    ox, ol = reference["odd_inputs"]
    one = api.launch("xent", interop.to_torch(ox, device="cpu", dtype=dtype),
                     torch.from_numpy(ol), logical_v=ODD_CASE[2])
    np.testing.assert_allclose(float(one), want, **XENT)


def test_train_step_loss_and_grads_match_reference(mesh_run, reference):
    ranks = [r[2] for r in mesh_run["ranks"]]
    for r in ranks:
        np.testing.assert_allclose(r["loss0"], reference["loss0"], rtol=1e-5)
        np.testing.assert_allclose(r["gnorm0"],
                                   reference["trajectory"][0][1], rtol=5e-3)
    got = assemble_tree([r["grads0"] for r in ranks],
                        ranks[0]["specs"]["params"], mesh_run["shape"])
    for path, want in leaves(reference["grads0"]):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(
            pick(got, path), want, rtol=1e-4,
            atol=1e-2 * max(float(np.abs(want).max()), 1e-30),
            err_msg="/".join(path))


def test_float64_mesh_grads_equal_the_one_device_port(mesh_run):
    """The same step with float64 weights and activations: the mesh's
    gradients, put back together, against the port's one-device
    ``value_and_grad`` on the same weights and batch."""
    ranks = [r[4] for r in mesh_run["ranks"]]
    cfg64 = dataclasses.replace(mesh_run["cfg"], dtype="float64")
    model = build_model(cfg64)
    params = interop.params_from_jax(mesh_run["state64"]["params"], cfg64,
                                     device="cpu")
    _, data = data_cfgs()
    loss, want = steps.value_and_grad(
        model, params, pipeline.make_batch(data, 0, device="cpu"))
    for r in ranks:
        np.testing.assert_allclose(r["loss0"], float(loss), rtol=1e-6)
    got = assemble_tree([r["grads0"] for r in ranks],
                        ranks[0]["specs"]["params"], mesh_run["shape"])
    for path, w in leaves(want):
        w = interop.to_numpy(w)
        np.testing.assert_allclose(
            pick(got, path), w, rtol=0,
            atol=1e-5 * float(np.abs(w).max()), err_msg="/".join(path))


def test_well_conditioned_mesh_grads_match_one_device(mesh_run):
    """fp32 at the port's init stds (the true attention fan-ins): the
    mesh's loss, norm and gradients, put back together, against the port's
    one-device ``value_and_grad`` on the same weights and batch.  At these
    weights nothing amplifies the mesh's other summation order (two vocab
    shards' dx, the data ranks' gradients), so the fp32 step is held as
    tightly as the float64 one above: the loss and the norm rtol 1e-6,
    each leaf atol 1e-5 of its scale."""
    ranks = [r[6] for r in mesh_run["ranks"]]
    cfg = mesh_run["cfg"]
    model = build_model(cfg)
    params = interop.params_from_jax(mesh_run["well"], cfg, device="cpu")
    _, data = data_cfgs()
    loss, want = steps.value_and_grad(
        model, params, pipeline.make_batch(data, 0, device="cpu"))
    norm = adamw.global_norm(want)
    for r in ranks:
        np.testing.assert_allclose(r["loss0"], float(loss), rtol=1e-6)
        np.testing.assert_allclose(r["gnorm0"], float(norm), rtol=1e-6)
    got = assemble_tree([r["grads0"] for r in ranks],
                        ranks[0]["specs"]["params"], mesh_run["shape"])
    for path, w in leaves(want):
        w = interop.to_numpy(w)
        np.testing.assert_allclose(
            pick(got, path), w, rtol=0,
            atol=1e-5 * float(np.abs(w).max()), err_msg="/".join(path))


def test_seeded_mesh_grads_match_one_device(mesh_run):
    """``mesh_checks.seeded_grads``, the job of ``chip_smoke.py``'s
    full-width gate: each rank draws ``model.init(seed)`` itself and cuts
    its blocks; the loss, the norm and every gradient leaf against the
    one-device port on the same seed, to the tolerances of the
    well-conditioned fp32 check above (the port's init is
    well-conditioned)."""
    ranks = [r[7] for r in mesh_run["ranks"]]
    model = build_model(mesh_run["cfg"])
    _, data = data_cfgs()
    loss, want = steps.value_and_grad(
        model, model.init(5, device="cpu"),
        pipeline.make_batch(data, 0, device="cpu"))
    for r in ranks:
        np.testing.assert_allclose(r["loss0"], float(loss), rtol=1e-6)
        np.testing.assert_allclose(r["gnorm0"],
                                   float(adamw.global_norm(want)), rtol=1e-6)
    got = assemble_tree([r["grads0"] for r in ranks], ranks[0]["specs"],
                        mesh_run["shape"])
    for path, w in leaves(want):
        w = interop.to_numpy(w)
        np.testing.assert_allclose(
            pick(got, path), w, rtol=0,
            atol=1e-5 * float(np.abs(w).max()), err_msg="/".join(path))


def test_padded_vocab_matches_reference(mesh_run, reference):
    """The layout policy's padded vocab, which the launcher's ``--mesh``
    trains by default: the logical limit falls inside the last vocab shard
    (B12's ``logical_v``, ``xent_grad``'s mask at ``lv - off``, the lookup
    of the last shard).  The loss, the norm and every gradient leaf
    against the reference's ``padded_for_mesh`` model, to the tolerances
    of ``test_train_step_loss_and_grads_match_reference``; the padded
    embedding rows get no gradient."""
    want = reference["padded"]
    ranks = [r[5] for r in mesh_run["ranks"]]
    for r in ranks:
        np.testing.assert_allclose(r["loss0"], want["loss0"], rtol=1e-5)
        np.testing.assert_allclose(r["gnorm0"], want["gnorm0"], rtol=5e-3)
        assert math.isfinite(r["losses"][0])
        assert r["digests"] == ranks[0]["digests"]
    got = assemble_tree([r["grads0"] for r in ranks],
                        ranks[0]["specs"]["params"], mesh_run["shape"])
    assert got["embed"].shape[0] == 512
    for path, w in leaves(want["grads0"]):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            pick(got, path), w, rtol=1e-4,
            atol=1e-2 * max(float(np.abs(w).max()), 1e-30),
            err_msg="/".join(path))
    np.testing.assert_array_equal(got["embed"][PADDED_VOCAB:], 0.0)


def test_train_trajectory_matches_reference(mesh_run, reference):
    ranks = [r[2] for r in mesh_run["ranks"]]
    for i, (want, _) in enumerate(reference["trajectory"]):
        for r in ranks:
            np.testing.assert_allclose(r["losses"][i], want,
                                       rtol=1e-5 if i == 0 else 2e-3)
    params = assemble_tree([r["state"]["params"] for r in ranks],
                           ranks[0]["specs"]["params"], mesh_run["shape"])
    for path, want in leaves(reference["params"]):
        np.testing.assert_allclose(pick(params, path), want, rtol=0,
                                   atol=2 * LR * STEPS,
                                   err_msg="/".join(path))


def test_unsharded_leaves_are_bit_equal_on_every_rank(mesh_run):
    ranks = [r[2] for r in mesh_run["ranks"]]
    first = ranks[0]["digests"]
    # everything but, on a model axis, the vocab-sharded embedding and the
    # attention's and MLP's tensor-parallel weights and biases (and their
    # optimizer state)
    sharded = {"/".join(p) for p in specs.sharded_paths(
        ranks[0]["specs"], dict(zip(AXES, mesh_run["shape"])))}
    d, m = mesh_run["shape"]
    cut = {"/".join(p) for p, _ in leaves(ranks[0]["state"]["params"])
           if p[-1] in TP_LEAVES}
    assert len(cut) == 1 + 10
    assert sharded == ({f"{part}/{p}" for p in cut for part in (
        "params", "opt/m", "opt/v", "opt/master")} if m > 1 else set())
    assert set(first) | sharded == {"/".join(p) for p, _ in
                                    leaves(ranks[0]["state"])}
    for r in ranks[1:]:
        assert r["digests"] == first


def test_single_device_checkpoint_restores_into_the_mesh(mesh_run):
    single = mesh_run["single"]
    saved = CheckpointManager(str(mesh_run["root"] / "single")).restore(
        1, single.state)
    ranks = [r[3] for r in mesh_run["ranks"]]
    assert all(r["restored_step"] == 1 for r in ranks)
    spec_tree = mesh_checks_specs(mesh_run)
    whole = assemble_tree([r["restored"] for r in ranks], spec_tree,
                          mesh_run["shape"])
    for path, want in leaves(saved):
        got = pick(whole, path)
        np.testing.assert_array_equal(got, interop.to_numpy(want))


def test_mesh_checkpoint_restores_into_one_device_bit_for_bit(mesh_run):
    cfg, data = mesh_run["cfg"], mesh_run["data"]
    ranks = [r[3] for r in mesh_run["ranks"]]
    one = Trainer(build_model(cfg), data, adamw.AdamWConfig(),
                  schedules.make_schedule(SCHEDULE[0], peak=LR, warmup=0,
                                          total=SCHEDULE[3]),
                  TrainerConfig(n_steps=2, ckpt_dir=str(mesh_run["root"]
                                                        / "mesh")),
                  device="cpu")
    step, state = one.init_or_restore(0)
    assert step == 2
    whole = assemble_tree([r["final"] for r in ranks],
                          mesh_checks_specs(mesh_run), mesh_run["shape"])
    for path, got in leaves(state):
        want = pick(whole, path)
        assert interop.to_numpy(got).dtype == want.dtype
        np.testing.assert_array_equal(interop.to_numpy(got), want,
                                      err_msg="/".join(path))
    # the mesh run trained on the single-device batches: its losses are
    # the one-device Trainer's, to the trajectory tolerance
    solo = Trainer(build_model(cfg), data, adamw.AdamWConfig(),
                   schedules.make_schedule(SCHEDULE[0], peak=LR, warmup=0,
                                           total=SCHEDULE[3]),
                   TrainerConfig(n_steps=2, ckpt_every=2,
                                 ckpt_dir=str(mesh_run["root"] / "solo")),
                   device="cpu").train(0)
    for a, b in zip(ranks[0]["metrics"], solo):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=2e-3)


def mesh_checks_specs(mesh_run):
    cfg = mesh_run["cfg"]
    sizes = dict(zip(AXES, mesh_run["shape"]))
    table = rules.restrict_to_mesh(rules.launcher_rules(cfg), sizes)
    return specs.state_specs(build_model(cfg).param_defs(), table,
                             master=True, axis_sizes=sizes)


def test_reference_sharded_batch_is_not_its_global_batch(reference_spmd):
    """A fault of the reference recorded in ROADMAP §C: its ``make_batch``
    with a data sharding draws each shard's rows by calling the generator
    on the shard's row indices alone, so the data-parallel batch is not the
    single-device batch.  The port's sharded batch is the global batch's
    rows (``test_sharded_batch_is_the_global_batch_rows``)."""
    assert not np.array_equal(reference_spmd["batch_sharded"],
                              reference_spmd["batch_full"])
    _, cfg = data_cfgs()
    np.testing.assert_array_equal(
        pipeline.make_batch(cfg, 0, device="cpu")["tokens"].numpy(),
        reference_spmd["batch_full"])


def test_model_refuses_tensor_parallel_rules():
    """The tensor-parallel rules on a model axis of two: every family runs
    them, the hybrid and ssm families too since their norms run split
    (``blocks.rms_norm_split``), vocab-parallel under them and under their
    launchers' rules; "embed" on the model axis, off the batch's axes,
    raises naming FSDP and ROADMAP A11 for every family."""
    from repro_torch.models import transformer

    for arch in ("qwen2-0.5b", "zamba2-1.2b", "xlstm-1.3b"):
        cfg = reduce_for_smoke(get_config(arch))
        for table in (rules.DEFAULT_RULES, rules.launcher_rules(cfg)):
            with rules.use_rules(table, _TwoRanks()):
                assert transformer.vocab_parallel(cfg)[1] == ("model",)
        with rules.use_rules(rules.make_rules(overrides={
                "embed": ("model",)}), _TwoRanks()):
            with pytest.raises(NotImplementedError, match="FSDP .* A11"):
                transformer.vocab_parallel(cfg)


def test_launcher_parses_meshes():
    from repro_torch.launch import train

    assert train.parse_args(["--mesh", "1x2"]).mesh == "1x2"
    assert mesh_lib.parse_shape("2x2") == (2, 2)
    for bad in ("2", "0x2", "axb"):
        with pytest.raises(ValueError):
            mesh_lib.parse_shape(bad)
    with pytest.raises(ValueError):
        train.parse_args(["--mesh", "pod"])
