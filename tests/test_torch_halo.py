"""The port's Jacobi and LBM halo-exchange shard bodies on meshes of ranks,
against one device and against the JAX package, on the CPU.

Two meshes of gloo ranks, (2, 1) and (4, 1) over ("data", "model"), each
spawned once for the module (``launch.mesh.spawn``; the rank jobs live in
``repro_torch.launch.mesh_checks``, so a rank imports nothing of JAX).  The
grid rows and the lattice's X planes shard over the data axis, so the cuts
give Jacobi stripes of 32, 8, 4 and 2 rows on two ranks and 16, 4, 2 and 1
on four (the reference's ``tests/test_spmd_launch.py`` shapes (64, 34),
(16, 130) and (8, 34), and (4, 34)), and LBM stripes of 16, 4 and 2 planes
on two ranks and 8, 2 and 1 on four.  At every cut:

  * the overlapped body, the blocking body and ``jacobi_sweeps`` equal the
    port's one-device results bit for bit (the blocking body therefore the
    overlapped one), and so does ``api.launch("lbm.soa" | "lbm.ivjk")`` and
    ``lbm_run``, with a mask and across the periodic wrap; a row count that
    does not divide falls back to one device with its logged reason, and
    rows over two mesh axes gather their halos instead of shifting them;
  * the bytes ``Mesh.comm`` counted for a launch equal the local plan's
    ``predicted_comm_bytes``;
  * ``api.spmd.overlap_report``: two Jacobi shifts of one row (34 x 4 B)
    and two LBM shifts of a (5, 1, 8, 8) fp32 slab, overlappable; the
    blocking body's and a stripe of one or two rows' not (the planner
    exposes all of the latter's halo); the cross-entropy's log-sum-exp
    combine not.

The reference's own SPMD path runs once in a subprocess on 4 forced host
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``), its
Pallas kernels in interpret mode, on cases that take each branch of its
bodies (a stripe of more than two rows, two rows and one, both layouts);
the port's mesh results lie within ``tests/test_kernels.py``'s tolerances
of it: Jacobi fp32 rtol 1e-5 / atol 1e-6, one LBM step rtol 2e-5 / atol
1e-7, several steps rtol 2e-4 / atol 1e-6 (both sides sum in fp32 in
other orders).  The planner's comm and exposed-comm numbers equal the
reference's at the reference's shapes when given its two rate constants,
in this process.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import planner as jplanner
from repro_torch import api
from repro_torch.kernels.jacobi import ops as jacobi_ops
from repro_torch.kernels.lbm import ops as lbm_ops
from repro_torch.kernels.lbm import ref as lbm_ref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import mesh_checks
from repro_torch.parallel import rules

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(2, 1), (4, 1)]
JACOBI = [(64, 34), (16, 130), (8, 34), (4, 34)]
RAGGED = (65, 34)
LBM = [(19, 32, 8, 8), (19, 8, 4, 4), (19, 4, 4, 4)]
LAYOUTS = ["soa", "ivjk"]
OMEGA = 1.7
SWEEPS = 3
STEPS = 3
JACOBI_TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=2e-5, atol=1e-7)
MULTI_TOL = dict(rtol=2e-4, atol=1e-6)
# (data ranks, case) the reference runs: each branch of its bodies once
REFERENCE_JACOBI = [(2, (64, 34)), (2, (16, 130)), (4, (8, 34)),
                    (4, (4, 34))]
REFERENCE_LBM = [(2, (19, 32, 8, 8), "soa"), (4, (19, 8, 4, 4), "ivjk"),
                 (4, (19, 4, 4, 4), "soa")]


def key(shape) -> str:
    return "x".join(str(s) for s in shape)


def lattice(shape, seed):
    rng = np.random.default_rng(seed)
    w = lbm_ref.W.astype(np.float32)[:, None, None, None]
    return (w * (1 + 0.05 * (rng.random(shape) - 0.5))).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(22)
    grids = {key(s): rng.random(s).astype(np.float32)
             for s in JACOBI + [RAGGED]}
    lattices = {key(s): lattice(s, i) for i, s in enumerate(LBM)}
    mask = np.random.default_rng(4).random(LBM[0][1:]) < 0.7
    # uniform rest (density 1) plus a marked +x plane at the last X slice
    wrap = np.broadcast_to(lbm_ref.W.astype(np.float32)[:, None, None, None],
                           LBM[0]).copy()
    wrap[lbm_ops._PLUS_X[0], -1] += 1.0
    return {"grids": grids, "lattices": lattices, "mask": mask,
            "wrap": wrap}


def jobs(inputs):
    """Every rank job of a mesh, in order, with its name."""
    out = []
    for s in JACOBI + [RAGGED]:
        out.append((f"jacobi {key(s)}", ("jacobi", dict(
            grid=inputs["grids"][key(s)], sweeps=SWEEPS))))
    two_axes = rules.make_rules(overrides={"batch": ("data", "model")})
    out.append(("jacobi multi-axis", ("jacobi", dict(
        grid=inputs["grids"][key(JACOBI[0])], sweeps=SWEEPS,
        rules=two_axes))))
    out.append(("lbm multi-axis", ("lbm", dict(
        f=inputs["lattices"][key(LBM[0])], omega=OMEGA, layout="ivjk",
        steps=STEPS, rules=two_axes))))
    for s in LBM:
        for layout in LAYOUTS:
            out.append((f"lbm {key(s)} {layout}", ("lbm", dict(
                f=inputs["lattices"][key(s)], omega=OMEGA, layout=layout,
                steps=STEPS if s == LBM[0] else 0))))
    for layout in LAYOUTS:
        out.append((f"lbm masked {layout}", ("lbm", dict(
            f=inputs["lattices"][key(LBM[0])], omega=OMEGA, layout=layout,
            mask=inputs["mask"]))))
    out.append(("lbm wrap", ("lbm", dict(f=inputs["wrap"], omega=0.0,
                                         layout="soa"))))
    rng = np.random.default_rng(7)
    x = (3 * rng.standard_normal((16, 512))).astype(np.float32)
    labels = rng.integers(0, 500, 16).astype(np.int32)
    # the vocab cut over the data axis, so the combine's collectives run
    out.append(("xent", ("overlap", dict(
        logits=x, labels=labels, rules=rules.make_rules(
            overrides={"batch": None, "vocab": ("data",)})))))
    return out


@pytest.fixture(scope="module", params=MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def mesh_run(request, inputs):
    """One spawn of the mesh: every rank runs every job; each job's
    per-rank results by name."""
    named = jobs(inputs)
    ranks = mesh_lib.spawn(mesh_checks.run, request.param, device="cpu",
                           args=([j for _, j in named],))
    return {"shape": request.param,
            "jobs": {name: [r[i] for r in ranks]
                     for i, (name, _) in enumerate(named)}}


_SUBPROCESS = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro import api
from repro.kernels.jacobi import ops as jops
from repro.kernels.lbm import ops as lops
z = np.load(sys.argv[1])
out = {}
meshes = {d: jax.sharding.Mesh(np.asarray(jax.devices()[:d]).reshape(d, 1),
                               ("data", "model")) for d in (2, 4)}
for name in z.files:
    kind, d, case = name.split("_")[:3]
    x = jnp.asarray(z[name])
    with api.plan_context(mesh=meshes[int(d)]):
        if kind == "jacobi":
            out[name] = np.asarray(api.launch("jacobi", x))
            out[name + "_sweeps"] = np.asarray(jops.jacobi_sweeps(x, 3))
        else:
            layout = name.split("_")[3]
            out[name] = np.asarray(api.launch(f"lbm.{layout}", x,
                                              omega=1.7))
            if case == "19x32x8x8":
                out[name + "_run"] = np.asarray(
                    lops.lbm_run(x, 1.7, 3, layout=layout))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def reference(inputs, tmp_path_factory):
    """The reference's SPMD halo bodies (shard_map over forced host
    devices) on the cases of ``REFERENCE_JACOBI`` and ``REFERENCE_LBM``,
    run in a subprocess."""
    d = tmp_path_factory.mktemp("jax_halo")
    arrays = {f"jacobi_{n}_{key(s)}": inputs["grids"][key(s)]
              for n, s in REFERENCE_JACOBI}
    arrays.update({f"lbm_{n}_{key(s)}_{layout}": inputs["lattices"][key(s)]
                   for n, s, layout in REFERENCE_LBM})
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", _SUBPROCESS, str(d / "in.npz"),
                    str(d / "out.npz")], env=env, check=True, timeout=600,
                   cwd=ROOT)
    with np.load(d / "out.npz") as z:
        return {k: z[k] for k in z.files}


def rows(results, field="out", dim=0):
    """The global array of the ranks' stripes, in rank order."""
    return torch.cat([r[field] for r in results], dim=dim)


def one_device_jacobi(grid):
    return api.launch("jacobi", torch.from_numpy(grid))


def one_device_lbm(f, layout, omega=OMEGA, mask=None):
    m = None if mask is None else torch.from_numpy(mask)
    return api.launch(f"lbm.{layout}", torch.from_numpy(f), omega=omega,
                      mask=m)


# ---------------------------------------------------------------------------
# Jacobi
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", JACOBI, ids=key)
def test_jacobi_mesh_equals_one_device(mesh_run, inputs, shape):
    grid = inputs["grids"][key(shape)]
    res = mesh_run["jobs"][f"jacobi {key(shape)}"]
    want = one_device_jacobi(grid)
    assert torch.equal(rows(res), want)
    assert torch.equal(rows(res, "blocking"), want)
    assert torch.equal(rows(res, "sweeps"),
                       jacobi_ops.jacobi_sweeps(torch.from_numpy(grid),
                                                SWEEPS))
    assert res[0]["spec"] == ("data",)
    # the shard body planned its stripe
    n = mesh_run["shape"][0]
    assert (shape[0] // n, shape[1]) in res[0]["cells"]


def test_jacobi_mesh_matches_reference(mesh_run, reference):
    n = mesh_run["shape"][0]
    cases = [s for d, s in REFERENCE_JACOBI if d == n]
    assert cases
    for shape in cases:
        res = mesh_run["jobs"][f"jacobi {key(shape)}"]
        name = f"jacobi_{n}_{key(shape)}"
        np.testing.assert_allclose(rows(res).numpy(), reference[name],
                                   **JACOBI_TOL)
        np.testing.assert_allclose(rows(res, "sweeps").numpy(),
                                   reference[name + "_sweeps"], **JACOBI_TOL)


def test_jacobi_ragged_rows_fall_back_with_logged_reason(mesh_run, inputs):
    res = mesh_run["jobs"][f"jacobi {key(RAGGED)}"]
    grid = inputs["grids"][key(RAGGED)]
    want = one_device_jacobi(grid)
    for r in res:
        assert r["spec"] == ()
        assert torch.equal(r["out"], want)
        assert torch.equal(r["blocking"], want)
        assert r["comm_bytes"] == 0
        assert any("jacobi" in m and "65" in m for m in r["logs"]), r["logs"]


def test_jacobi_rows_over_two_axes_gather_their_halos(mesh_run, inputs):
    grid = inputs["grids"][key(JACOBI[0])]
    res = mesh_run["jobs"]["jacobi multi-axis"]
    assert res[0]["spec"] == (("data", "model"),)
    assert torch.equal(rows(res), one_device_jacobi(grid))
    assert torch.equal(rows(res, "blocking"), one_device_jacobi(grid))
    assert torch.equal(rows(res, "sweeps"), jacobi_ops.jacobi_sweeps(
        torch.from_numpy(grid), SWEEPS))
    (site,) = res[0]["report"].collectives
    assert site.primitive == "all_gather"
    assert site.axes == ("data", "model")


def test_lbm_planes_over_two_axes_gather_their_halos(mesh_run, inputs):
    f = inputs["lattices"][key(LBM[0])]
    res = mesh_run["jobs"]["lbm multi-axis"]
    assert res[0]["spec"] == (None, ("data", "model"))
    assert torch.equal(rows(res, dim=1), one_device_lbm(f, "ivjk"))
    assert torch.equal(rows(res, "run", dim=1), lbm_ops.lbm_run(
        torch.from_numpy(f), OMEGA, STEPS, layout="ivjk"))
    (site,) = res[0]["report"].collectives
    assert site.primitive == "all_gather"
    assert not site.overlappable


@pytest.mark.parametrize("shape", JACOBI, ids=key)
def test_jacobi_comm_bytes_equal_the_prediction(mesh_run, shape):
    for r in mesh_run["jobs"][f"jacobi {key(shape)}"]:
        assert r["comm_bytes"] == r["predicted_comm_bytes"] == \
            2 * shape[1] * 4


def test_jacobi_overlap_report(mesh_run):
    """Two one-row shifts, overlappable; the blocking body's are not; a
    stripe of two rows or one has no interior to hide them behind, and the
    planner exposes all of its halo."""
    for r in mesh_run["jobs"][f"jacobi {key(JACOBI[0])}"]:
        rep = r["report"]
        assert rep.n_kernel_launches >= 1
        assert len(rep.collectives) == 2
        assert rep.all_overlappable
        for c in rep.collectives:
            assert c.primitive == "ppermute"
            assert c.axes == ("data",)
            assert c.result_bytes == 34 * 4
        assert len(r["blocking_report"].collectives) == 2
        assert r["blocking_report"].n_overlappable == 0
    n = mesh_run["shape"][0]
    thin = [s for s in JACOBI if s[0] // n <= 2]
    assert thin
    for s in thin:
        for r in mesh_run["jobs"][f"jacobi {key(s)}"]:
            assert r["report"].n_overlappable == 0
        with api.plan_context(mesh={"data": n}):
            plan = api.plan_for("jacobi", (s[0] // n, s[1]), torch.float32,
                                local=True)
        assert plan.predicted_exposed_comm_bytes(
            hbm_bytes_per_s=1.0, link_bytes_per_s=1.0) == \
            plan.predicted_comm_bytes > 0


# ---------------------------------------------------------------------------
# LBM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", LBM, ids=key)
def test_lbm_mesh_equals_one_device(mesh_run, inputs, shape, layout):
    f = inputs["lattices"][key(shape)]
    res = mesh_run["jobs"][f"lbm {key(shape)} {layout}"]
    assert res[0]["spec"] == (None, "data")
    assert torch.equal(rows(res, dim=1), one_device_lbm(f, layout))
    for r in res:
        assert r["comm_bytes"] == r["predicted_comm_bytes"] == \
            2 * 5 * shape[2] * shape[3] * 4
    xl = shape[1] // mesh_run["shape"][0]
    if xl > 2:     # the shard body planned its interior planes
        assert (19, xl - 2) + shape[2:] in res[0]["cells"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_lbm_run_on_the_mesh_equals_one_device(mesh_run, inputs, layout):
    f = inputs["lattices"][key(LBM[0])]
    res = mesh_run["jobs"][f"lbm {key(LBM[0])} {layout}"]
    assert torch.equal(rows(res, "run", dim=1), lbm_ops.lbm_run(
        torch.from_numpy(f), OMEGA, STEPS, layout=layout))


def test_lbm_mesh_matches_reference(mesh_run, reference):
    n = mesh_run["shape"][0]
    cases = [(s, layout) for d, s, layout in REFERENCE_LBM if d == n]
    assert cases
    for shape, layout in cases:
        res = mesh_run["jobs"][f"lbm {key(shape)} {layout}"]
        name = f"lbm_{n}_{key(shape)}_{layout}"
        np.testing.assert_allclose(rows(res, dim=1).numpy(), reference[name],
                                   **STEP_TOL)
        if "run" in res[0]:
            np.testing.assert_allclose(rows(res, "run", dim=1).numpy(),
                                       reference[name + "_run"], **MULTI_TOL)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_lbm_masked_launch_equals_one_device(mesh_run, inputs, layout):
    """Each rank takes its own X planes of the global mask; masked sites
    keep their pre-step values."""
    f = inputs["lattices"][key(LBM[0])]
    res = mesh_run["jobs"][f"lbm masked {layout}"]
    want = one_device_lbm(f, layout, mask=inputs["mask"])
    assert torch.equal(rows(res, dim=1), want)
    kept = torch.from_numpy(~inputs["mask"])[None].expand_as(want)
    assert torch.equal(want[kept], torch.from_numpy(f)[kept])


def test_lbm_periodic_wrap_crosses_the_domain_edge(mesh_run, inputs):
    """The first rank's low halo is the last rank's high plane: at omega 0
    the marked +x plane at x = 31 lands at x = 0."""
    f = inputs["wrap"]
    got = rows(mesh_run["jobs"]["lbm wrap"], dim=1)
    assert torch.equal(got, one_device_lbm(f, "soa", omega=0.0))
    v = lbm_ops._PLUS_X[0]
    w = float(np.float32(lbm_ref.W[v]))
    assert float(got[v, 0].max()) > w + 0.5
    assert float(got[v, -1].max()) < w + 0.5


@pytest.mark.parametrize("layout", LAYOUTS)
def test_lbm_overlap_report(mesh_run, layout):
    """Two (5, 1, 8, 8) fp32 slabs, one each way, overlappable at 16 and
    8 planes a rank; none at 2 planes or 1, where nothing is interior."""
    for r in mesh_run["jobs"][f"lbm {key(LBM[0])} {layout}"]:
        rep = r["report"]
        assert rep.n_kernel_launches >= 1
        assert len(rep.collectives) == 2
        assert rep.all_overlappable
        for c in rep.collectives:
            assert c.primitive == "ppermute"
            assert c.result_bytes == 5 * 8 * 8 * 4
    n = mesh_run["shape"][0]
    for s in LBM:
        if s[1] // n <= 2:
            for r in mesh_run["jobs"][f"lbm {key(s)} {layout}"]:
                assert r["report"].n_overlappable == 0


def test_xent_combine_is_not_overlappable(mesh_run):
    for r in mesh_run["jobs"]["xent"]:
        rep = r["report"]
        assert rep.n_kernel_launches >= 1           # B12, before the combine
        assert rep.collectives
        assert rep.n_overlappable == 0
        assert {c.primitive for c in rep.collectives} == {"all_reduce"}


# ---------------------------------------------------------------------------
# The planner's comm and exposed-comm model (this process)
# ---------------------------------------------------------------------------

PLANS = [
    ("jacobi", (32, 258), {"data": 8}),        # fully hidden
    ("jacobi", (8, 258), {"data": 8}),         # partly hidden
    ("jacobi", (2, 258), {"data": 8}),         # no interior
    ("jacobi", (32, 258), {"data": 1, "model": 8}),   # unsharded rows
    ("lbm.soa", (19, 4, 8, 8), {"data": 8}),
    ("lbm.ivjk", (19, 4, 8, 8), {"data": 8}),
    ("lbm.soa", (19, 32, 64, 64), {"data": 2}),
    ("lbm.soa", (19, 32, 8, 8), {"data": 1, "model": 8}),
    ("xent", (32, 512), {"data": 2, "model": 4}),     # no halo: all exposed
]


@pytest.mark.parametrize("kernel,shape,mesh", PLANS, ids=[
    f"{k}-{key(s)}-" + "-".join(f"{a}{n}" for a, n in m.items())
    for k, s, m in PLANS])
def test_comm_and_exposed_bytes_equal_the_reference(kernel, shape, mesh):
    """Given the reference's two rate constants (a TPU's), the port's
    exposed term is the reference's number."""
    with api.plan_context(mesh=mesh):
        got = api.plan_for(kernel, shape, torch.float32, local=True)
    with japi.plan_context(mesh=mesh):
        want = japi.plan_for(kernel, shape, jnp.float32, local=True)
    assert got.predicted_comm_bytes == want.predicted_comm_bytes
    assert got.predicted_exposed_comm_bytes(
        hbm_bytes_per_s=jplanner._HBM_BW,
        link_bytes_per_s=jplanner._ICI_BW) == \
        want.predicted_exposed_comm_bytes


def test_exposed_bytes_cases_and_rates():
    """Partly and fully hidden, the cross-entropy all exposed, and no
    answer without measured rates."""
    with api.plan_context(mesh={"data": 8}):
        thin = api.plan_for("jacobi", (8, 258), torch.float32, local=True)
        tall = api.plan_for("jacobi", (32, 258), torch.float32, local=True)
    rates = dict(hbm_bytes_per_s=819e9, link_bytes_per_s=50e9)
    total = 2 * 258 * 4
    assert thin.predicted_comm_bytes == tall.predicted_comm_bytes == total
    assert 0 < thin.predicted_exposed_comm_bytes(**rates) < total
    assert tall.predicted_exposed_comm_bytes(**rates) == 0
    # a link as fast as memory hides the thin stripe's halo too
    assert thin.predicted_exposed_comm_bytes(
        hbm_bytes_per_s=1.0, link_bytes_per_s=1.0) == 0
    with api.plan_context(mesh={"data": 2, "model": 4}):
        xent = api.plan_for("xent", (32, 512), torch.float32, local=True)
    assert xent.predicted_exposed_comm_bytes(**rates) == \
        xent.predicted_comm_bytes > 0
    for kw in ({}, {"hbm_bytes_per_s": 1.0}, {"link_bytes_per_s": 1.0}):
        with pytest.raises(ValueError, match="measured"):
            thin.predicted_exposed_comm_bytes(**kw)
