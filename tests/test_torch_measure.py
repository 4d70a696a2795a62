"""The port's ``measure/`` (ROADMAP A7.2-A7.5) on the CPU, against the JAX
package's ``repro.measure`` where the two share a record.

  * **cells**: every registry kernel has a cell in ``CASES`` and
    ``CARD_CASES`` and a family envelope; at ``CASES`` the eleven kernels
    the reference has take the reference's operands (``args_for``: shapes,
    dtypes, scalars) and plan the same ``predicted_logical_bytes``;
  * **bytes**: ``predicted_hbm_bytes`` equals the bytes of the operands the
    kernel reads plus the result it writes at the planned shape, for every
    registry kernel (the split norm's four passes counted wrongly before
    their ``MAJOR_STREAMS`` / ``MINOR_STREAM_BYTES`` entries);
  * **the hbm check** with an injected timer (the card's is CUDA events):
    a ratio inside the family's envelope is ok, one below 0.95 fails, and
    the failing ``ValidationEvent`` makes both packages' ``obs.report
    --fail-on-validation`` exit 1;
  * **reports**: ``write_report`` merges the same records as the
    reference's does;
  * **sweep and profile**: a sweep with an injected timer keeps the
    fastest geometry, deterministically, the analytic plan on a tie; its
    profile round-trips through ``load_profile`` and
    ``PlanContext.from_profile`` (the override's output equal to the
    analytic plan's, its ``PlanEvent`` an override from the file), other
    shapes fall through to the planner; drift raises under ``strict``
    after a ``ProfileDriftEvent``; a newer version and the other
    package's profile are refused;
  * **launchers**: ``--plan-profile`` on ``launch.train`` and
    ``launch.serve`` at a reduced config: every plan of the profiled cells
    an override;
  * **the CLIs**: without a card the timed paths exit 2; ``--device cpu``
    runs the untimed parts.

The comm census runs as a job of ``tests/test_torch_spmd.py``'s mesh
spawns (``mesh_checks.measure_comm``).
"""
import itertools
import json
import types

import pytest
import torch

from repro import api as japi
from repro.measure import profile as jprofile
from repro.measure import validate as jvalidate
from repro.obs import report as jreport
from repro_torch import api, obs
from repro_torch.api.context import use_context
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.planner import dtype_name
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.measure import profile, sweep, validate
from repro_torch.obs import report

SHIPPED = [k for k in api.list_kernels()
           if api.resolve(k).body.__module__.startswith("repro_torch.")]
SHARED = sorted(jvalidate.CASES)
# a cell whose knobs give three geometries (block rows 1, 2 and 4)
SWEEP = ("rmsnorm", (2048, 256), "bfloat16")
RATE = 3.35e12          # the H100 data sheet's bytes/s, for injected timers


def timer_of(values):
    """An injected timer: runs the body once, returns the next value."""
    it = iter(values)

    def timer(fn):
        fn()
        return next(it)

    return timer


def test_every_registry_kernel_has_cells_and_an_envelope():
    assert len(SHIPPED) == 15
    for k in SHIPPED:
        assert k in validate.CASES and k in validate.CARD_CASES, k
        assert k.split(".")[0] in validate.TOLERANCES, k
    assert set(SHARED) <= set(SHIPPED)
    assert validate.COMM_CASES == jvalidate.COMM_CASES
    assert {k: (t.lo, t.hi) for k, t in validate.COMM_TOLERANCES.items()} \
        == {k: (t.lo, t.hi) for k, t in jvalidate.COMM_TOLERANCES.items()}


# the result a kernel writes: a row statistic / per-token NLL, else an array
# of the planned shape
ROW_RESULT = {"rmsnorm.sumsq", "rmsnorm.gated.sumsq", "xent"}


@pytest.mark.parametrize("kernel", SHIPPED)
def test_predicted_hbm_bytes_are_the_operand_bytes(kernel):
    """Each operand the kernel reads once at the planned shape -- an array
    like x at the padded footprint, the scale at the padded width, a row
    vector (the fp32 statistic, the int32 labels) at the padded rows -- and
    its result written once."""
    shape, dtype = validate.CASES[kernel]
    args, scalars = validate.args_for(kernel, shape, dtype)
    plan = api.plan_for(kernel, *api.resolve(kernel).plan_args(*args,
                                                               **scalars))
    major = plan.padded_elems * plan.elem_bytes
    rows = plan.padded_shape[0]
    want = rows * 4 if kernel in ROW_RESULT else major
    for a in args:
        if a.shape == args[0].shape:
            want += major
        elif a.ndim == 1 and a.shape[0] == args[0].shape[-1]:
            want += plan.width * a.element_size()
        else:
            want += rows * a.element_size()
    assert plan.predicted_hbm_bytes == want, plan.explain()


@pytest.mark.parametrize("kernel,shape,dtype,nbytes", [
    ("rmsnorm.apply", (2048, 1024), "float32", 16_789_504),
    ("rmsnorm.gated.apply", (2048, 2048), "bfloat16", 25_178_112),
    ("rmsnorm.sumsq", (2048, 1024), "float32", 8_396_800),
    ("rmsnorm.gated.sumsq", (2048, 2048), "bfloat16", 16_785_408),
])
def test_split_norm_bytes_at_the_main_path_cells(kernel, shape, dtype,
                                                 nbytes):
    """The cells PERF.md's kernel table times: 16,789,504 B for the fp32
    apply pass where the parent's planner charged 25,165,824."""
    assert api.plan_for(kernel, shape, dtype).predicted_hbm_bytes == nbytes


@pytest.mark.parametrize("kernel", SHARED)
def test_args_and_logical_bytes_match_the_reference(kernel):
    shape, dtype = validate.CASES[kernel]
    assert (shape, dtype) == jvalidate.CASES[kernel]
    args, scalars = validate.args_for(kernel, shape, dtype)
    jargs, jscalars = jvalidate.args_for(kernel, shape, dtype)
    assert [(tuple(a.shape), dtype_name(a.dtype)) for a in args] == [
        (tuple(a.shape), a.dtype.name) for a in jargs]
    assert scalars == jscalars
    assert (api.plan_for(kernel, shape, dtype).predicted_logical_bytes
            == japi.plan_for(kernel, shape, dtype).predicted_logical_bytes)


def test_site_wire_bytes_convert_the_recorded_input():
    """The port's trace records a collective's input, the reference's its
    result: the same collective is priced the same by both formulas."""
    sizes = {"data": 4, "model": 2}
    b = 4096.0
    site = lambda prim, nbytes, axes=("data",): types.SimpleNamespace(
        primitive=prim, axes=axes, result_bytes=nbytes)
    for port, ref, result in [("all_reduce", "psum", b),
                              ("all_gather", "all_gather", 4 * b),
                              ("reduce_scatter", "reduce_scatter", b / 4),
                              ("ppermute", "ppermute", b)]:
        assert validate._site_wire_bytes(site(port, b), sizes) == \
            jvalidate._site_wire_bytes(site(ref, result), sizes), port


@pytest.mark.parametrize("kernel", SHIPPED)
def test_hbm_check_with_an_injected_timer(kernel):
    """The registered body runs once (the plain path on the CPU) under an
    injected timer: 1.5x the bound is ok in every family's envelope, and
    the record carries the plan and the L2 flag."""
    shape, dtype = validate.CASES[kernel]
    args, scalars = validate.args_for(kernel, shape, dtype)
    plan = api.plan_for(kernel, *api.resolve(kernel).plan_args(*args,
                                                               **scalars))
    bound_ms = plan.predicted_hbm_bytes / RATE * 1e3
    ring = obs.RingBufferSink()
    with obs.session(ring):
        r = validate.validate_kernel(kernel, device="cpu",
                                     timer=timer_of([1.5 * bound_ms]),
                                     bytes_per_s=RATE)
    assert r["status"] == "ok" and r["ratio"] == pytest.approx(1.5)
    assert r["measured"]["bound_ms"] == pytest.approx(bound_ms)
    assert r["measured"]["under_l2"]
    assert r["plan"]["padded_shape"] == list(plan.padded_shape)
    (ev,) = ring.events("validation")
    assert (ev.kernel, ev.check, ev.status) == (kernel, "hbm", "ok")


def test_failing_validation_fails_both_reports(tmp_path):
    """A body faster than the data sheet allows (ratio 0.5 < 0.95) fails,
    and its event fails either package's report."""
    path = tmp_path / "v.jsonl"
    plan = api.plan_for("triad", (50000,), "float32")
    with obs.session(obs.JsonlSink(path)):
        r = validate.validate_kernel(
            "triad", device="cpu", bytes_per_s=RATE,
            timer=timer_of([0.5 * plan.predicted_hbm_bytes / RATE * 1e3]))
    assert r["status"] == "fail"
    assert report.main(["--fail-on-validation", str(path)]) == 1
    assert jreport.main(["--fail-on-validation", str(path)]) == 1
    ok = tmp_path / "ok.jsonl"
    with obs.session(obs.JsonlSink(ok)):
        validate.validate_kernel(
            "triad", device="cpu", bytes_per_s=RATE,
            timer=timer_of([1.1 * plan.predicted_hbm_bytes / RATE * 1e3]))
    assert report.main(["--fail-on-validation", str(ok)]) == 0
    assert jreport.main(["--fail-on-validation", str(ok)]) == 0


def test_untimed_records_and_the_timer_contract():
    r = validate.validate_kernel("rmsnorm.apply", device="cpu")
    assert r["status"] == "untimed" and r["ratio"] is None
    assert r["predicted"]["hbm_bytes"] == api.plan_for(
        "rmsnorm.apply", (300, 1111), "float32").predicted_hbm_bytes
    with pytest.raises(ValueError, match="bytes_per_s"):
        validate.validate_kernel("triad", device="cpu",
                                 timer=timer_of([1.0]))


def test_write_report_merges_as_the_reference(tmp_path):
    recs = [validate.validate_kernel(k, device="cpu")
            for k in ("triad", "jacobi")]
    comm = {"kernel": "xent", "family": "xent", "check": "comm",
            "shape": [64, 4096], "dtype": "float32",
            "mesh": {"data": 2, "model": 1}, "status": "ok"}
    updated = dict(recs[0], status="fail")
    port, ref = tmp_path / "port.json", tmp_path / "ref.json"
    port.touch()               # a zero-size file is "nothing here yet"
    for batch in (recs, [updated, comm, dict(comm, mesh={"data": 1,
                                                        "model": 2})]):
        validate.write_report(batch, str(port), backend="cpu")
        jvalidate.write_report(batch, str(ref))
    pdoc, rdoc = json.loads(port.read_text()), json.loads(ref.read_text())
    assert pdoc["records"] == rdoc["records"]
    assert len(pdoc["records"]) == 4 and pdoc["records"][0]["status"] == "fail"
    assert (pdoc["format"], rdoc["format"]) == ("repro_torch.validation",
                                                "repro.validation")


# ---- sweep and profile ----------------------------------------------------

def test_sweep_keeps_the_fastest_deterministically():
    a = sweep.sweep_cell(*SWEEP, device="cpu", timer=timer_of([3.0, 1.0, 2.0]))
    b = sweep.sweep_cell(*SWEEP, device="cpu", timer=timer_of([3.0, 1.0, 2.0]))
    assert len(a.candidates) == 3 and a.changed
    assert a.best.measured["ms"] == min(c.measured["ms"]
                                        for c in a.candidates) == 1.0
    assert a.best.knobs == b.best.knobs
    assert a.best.plan.block_shape == b.best.plan.block_shape
    assert a.best.plan.provenance == "sweep"
    # a tie keeps the analytic plan, timed or untimed
    tie = sweep.sweep_cell(*SWEEP, device="cpu", timer=timer_of([1.0] * 3))
    untimed = sweep.sweep_cell(*SWEEP, device="cpu")
    assert not tie.changed and not untimed.changed
    assert all(c.measured["ms"] is None for c in untimed.candidates)
    assert untimed.default_plan == api.plan_for(*SWEEP)


def test_profile_round_trips_through_from_profile(tmp_path):
    kernel, shape, dtype = SWEEP
    res = sweep.sweep_cell(*SWEEP, device="cpu",
                           timer=timer_of([3.0, 1.0, 2.0]))
    path = str(tmp_path / "profile.json")
    profile.save_profile(path, [res.entry()], backend="cpu")
    overrides = profile.load_profile(path)
    assert list(overrides) == [profile.profile_key(kernel, shape, dtype)]
    ctx = api.PlanContext.from_profile(path)
    p = api.plan_for(kernel, shape, dtype, ctx=ctx)
    assert (p.padded_shape, p.block_shape) == (res.best.plan.padded_shape,
                                               res.best.plan.block_shape)
    assert p.provenance == f"profile:{path}" and path in p.explain()
    args, scalars = validate.args_for(kernel, shape, dtype, device="cpu")
    want = api.launch(kernel, *args, **scalars)
    ring = obs.RingBufferSink()
    with obs.session(ring), use_context(ctx):
        got = api.launch(kernel, *args, **scalars)
        other = api.plan_for(kernel, (64, 128), dtype)
    assert torch.equal(got, want)
    (ev,) = [e for e in ring.events("plan") if e.shape == shape]
    assert (ev.cache, ev.source) == ("override", f"profile:{path}")
    assert other.provenance == "analytic"
    assert api.plan_for(kernel, shape, dtype).provenance == "analytic"


def test_profile_drift_versions_and_formats(tmp_path):
    kernel, shape, dtype = SWEEP
    plan = api.plan_for(kernel, shape, dtype)
    entry = profile.entry_from_plan(
        plan, {"smem_budget": 1 << 16, "sm_count": 132})
    entry["expect"]["block_shape"] = [3, 256]      # the planner "drifted"
    stale = str(tmp_path / "stale.json")
    profile.save_profile(stale, [entry])
    ring = obs.RingBufferSink()
    with obs.session(ring), pytest.raises(ValueError, match="planner drift"):
        profile.load_profile(stale)
    (ev,) = ring.events("profile_drift")
    assert ev.path == stale and "block_shape" in ev.detail
    with pytest.warns(UserWarning, match="entry skipped"):
        assert profile.load_profile(stale, strict=False) == {}
    newer = tmp_path / "newer.json"
    newer.write_text(json.dumps({"format": profile.PROFILE_FORMAT,
                                 "version": profile.PROFILE_VERSION + 1,
                                 "entries": []}))
    with pytest.raises(ValueError, match="newer than supported"):
        profile.load_profile(str(newer))
    with pytest.raises(ValueError, match="profile knobs missing"):
        profile.entry_from_plan(plan, {"sublanes": 8, "vmem_budget": 1})
    # each package refuses the other's profile, naming the format
    ours, theirs = str(tmp_path / "ours.json"), str(tmp_path / "theirs.json")
    profile.save_profile(ours, [])
    jprofile.save_profile(theirs, [])
    with pytest.raises(ValueError, match="repro_torch.plan_profile"):
        jprofile.load_profile(ours)
    with pytest.raises(ValueError, match="a repro.plan_profile profile"):
        profile.load_profile(theirs)


def test_audit_profile_reports_every_problem(tmp_path):
    kernel, shape, dtype = SWEEP
    good = profile.entry_from_plan(api.plan_for(kernel, shape, dtype),
                                   {"smem_budget": 232448, "sm_count": 132})
    stale = json.loads(json.dumps(good))
    stale["expect"]["padded_shape"] = [1, 1]
    orphan = dict(good, kernel="nope")
    invalid = dict(good, dtype="float99")
    path = str(tmp_path / "p.json")
    profile.save_profile(path, [good, stale, orphan, invalid])
    assert [i["kind"] for i in profile.audit_profile(path)] == [
        "stale", "orphan", "invalid"]
    theirs = str(tmp_path / "theirs.json")
    jprofile.save_profile(theirs, [])
    assert [i["kind"] for i in profile.audit_profile(theirs)] == ["invalid"]


# ---- the launchers --------------------------------------------------------

def _profile_of(cells, path) -> str:
    """A profile pinning each (kernel, shape, dtype) of ``cells`` at its
    analytic plan under the default knobs."""
    knobs = sweep.candidate_knobs()[0]
    profile.save_profile(path, [profile.entry_from_plan(
        api.plan_for(*c), knobs, source="test") for c in cells])
    return path


@pytest.mark.parametrize("launcher", ["train", "serve"])
def test_plan_profile_on_the_launchers(launcher, tmp_path):
    """A reduced run streams its norm cells; the same run with a profile of
    them (``--plan-profile``) streams each of their plans as an override
    from the file."""
    if launcher == "train":
        main = train_launch.main
        argv = ["--arch", "qwen2-0.5b", "--mesh", "host", "--device", "cpu",
                "--steps", "1", "--seq-len", "16", "--global-batch", "2",
                "--ckpt-dir", str(tmp_path / "ckpt")]
    else:
        main = serve_launch.main
        argv = ["--arch", "qwen2-0.5b", "--mesh", "host", "--device", "cpu",
                "--requests", "2", "--slots", "2", "--max-len", "32",
                "--prompt-len", "4", "6", "--gen", "2", "3"]
    first = obs.RingBufferSink()
    with obs.session(first):
        main(argv)
    cells = sorted({(e.kernel, e.shape, e.dtype)
                    for e in first.events("plan") if e.kernel == "rmsnorm"})
    assert cells
    path = _profile_of(cells, str(tmp_path / "profile.json"))
    if launcher == "train":
        argv[argv.index("--ckpt-dir") + 1] = str(tmp_path / "ckpt2")
    ring = obs.RingBufferSink()
    with obs.session(ring):
        main(argv + ["--plan-profile", path])
    pinned = [e for e in ring.events("plan") if e.kernel == "rmsnorm"]
    assert len(pinned) == len([e for e in first.events("plan")
                               if e.kernel == "rmsnorm"])
    assert {(e.cache, e.source) for e in pinned} == {
        ("override", f"profile:{path}")}


def test_plan_profile_scope_without_a_profile_keeps_outer_pins():
    plan = api.plan_for(*SWEEP)
    pinned = {profile.profile_key(*SWEEP): plan}
    with api.plan_context(plan_overrides=pinned):
        with train_launch.plan_profile_scope(None):
            assert api.current_context().plan_overrides == pinned


# ---- the CLIs ---------------------------------------------------------------

def test_validate_and_sweep_clis(tmp_path, capsys):
    if not torch.cuda.is_available():
        assert validate.main(["--all"]) == 2
        assert sweep.main(["--all"]) == 2
        assert "no CUDA device" in capsys.readouterr().err
    out = tmp_path / "v.json"
    assert validate.main(["--family", "rmsnorm", "--device", "cpu",
                          "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["format"] == validate.VALIDATION_FORMAT
    assert doc["backend"] == "cpu"
    assert sorted(r["kernel"] for r in doc["records"]) == [
        k for k in SHIPPED if k.startswith("rmsnorm")]
    assert {r["status"] for r in doc["records"]} == {"untimed"}
    prof = tmp_path / "p.json"
    assert sweep.main(["--cell", "rmsnorm:2048,256:bfloat16", "--cell",
                       "rmsnorm:4096,128:float32", "--mesh", "1x2",
                       "--device", "cpu", "--out", str(prof)]) == 0
    entries = json.loads(prof.read_text())["entries"]
    assert [e["local"] for e in entries] == [True, True]
    assert entries[0]["mesh"] == [["data", 1], ["model", 2]]
    assert len(profile.load_profile(str(prof))) == 2
    with pytest.raises(SystemExit):
        validate.main(["--exposed", "--device", "cpu"])
    cfg = reduce_for_smoke(get_config("qwen2-0.5b"))
    assert validate.args_for("rmsnorm.apply", (4, cfg.d_model),
                             "float32")[1]["d_total"] == cfg.d_model


def test_sweep_knobs_divide_the_budget_and_halve_the_sms():
    knobs = sweep.candidate_knobs(api.PlanContext(smem_budget=1 << 16,
                                                  sm_count=132))
    assert {k["smem_budget"] for k in knobs} == {
        (1 << 16) // d for d in sweep.BUDGET_DIVIDERS}
    assert {k["sm_count"] for k in knobs} == {132, 66}
    assert len(knobs) == len(list(itertools.product(
        sweep.BUDGET_DIVIDERS, (132, 66))))
