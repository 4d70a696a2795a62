"""The port's observability bus (``repro_torch.obs``) against the JAX
package's (``repro.obs``), on the CPU.

Ports of tests/test_obs.py's bus tests (events, sinks, session semantics,
the zero-cost default, the report CLI), run against ``repro_torch``, and
then the two packages side by side:

  * **records**: each of the sixteen event classes, built with the same
    fields in both packages, gives the same ``to_record()`` (keys in the
    same order) apart from ``ts``; the two reports render the same summary
    from one mixed stream and read each other's files;
  * **plans**: the same ``api.launch`` / ``plan_for`` sequence, the
    planner caches cleared first, gives the same ``cache`` values (miss,
    hit, override) in both;
  * **batcher**: reduced Qwen3-4B from the same numpy weights
    (``interop.params_from_jax``), the same requests, ``page_len`` 8 and
    ``n_pages`` 4 (tight enough to preempt) give equal admission,
    preemption, tick and page-pool streams in the compared fields, and a
    ``max_ticks`` run equal ``request_abandoned`` records;
  * **trainer**: reduced Qwen2-0.5B at the true fan-ins (the
    well-conditioned weights of tests/test_torch_train.py) with a
    ``fail_injector`` gives the reference's ``train_step`` steps, its
    ``checkpoint`` (step, action) pairs and its ``degraded``
    (``transient_retry``) records, the losses within that file's
    trajectory tolerance (rtol 2e-3; they agree to about 1e-7 here);
  * **mesh**: ``launch.train --mesh 1x2 --obs-jsonl`` (one gloo spawn):
    rank 0 alone streams, and its trainer stream equals a one-device
    run's in the compared fields.

Fields not compared, by design: ``ts`` (wall clock); ``step_s`` (wall
time); ``BatcherTickEvent.padded_slots`` and ``pad_slots`` (the port's
planner has row unit 1, so ``padded_slots == slots``, where the reference
pads to a sublane tile: 8 for 2 slots); ``PlanEvent`` records of a model
run (the port is eager and plans at every launch, the reference at trace
time, so their counts differ; a ``PlanEvent`` on a mesh carries the rank's
local shape).  ``PagePoolEvent.page_len`` is compared because both
batchers are given it.
"""
import dataclasses
import json
import logging
import subprocess
import sys
import threading
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import obs as jobs
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core.planner import clear_plan_cache as jclear_plan_cache
from repro.data import pipeline as jpipeline
from repro.models import build_model as jbuild_model
from repro.obs import report as jreport
from repro.optim import adamw as jadamw
from repro.optim import schedules as jschedules
from repro.parallel import steps as jsteps
from repro.runtime import trainer as jtrainer
from repro.serving import ContinuousBatcher as JBatcher
from repro.serving import Request as JRequest
from repro_torch import api, interop, obs
from repro_torch.api import dispatch
from repro_torch.api import registry as registry_lib
from repro_torch.api import spmd
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.planner import clear_plan_cache
from repro_torch.data import pipeline
from repro_torch.interop import numpy_params
from repro_torch.launch import train as train_launch
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import leaves as interop_leaves
from repro_torch.obs import bus, events, report
from repro_torch.obs import sinks as sinks_mod
from repro_torch.optim import adamw, schedules
from repro_torch.parallel import steps
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.serving import ContinuousBatcher, Request

ROOT = Path(__file__).resolve().parents[1]
CPU = dict(device="cpu")
# fields of a record that differ between the packages by design
NOT_COMPARED = ("ts", "step_s", "padded_slots", "pad_slots")
# the trajectory tolerance of tests/test_torch_train.py
LOSS_RTOL = 2e-3


@pytest.fixture(autouse=True)
def _clean_bus():
    bus.reset_default_sinks()
    yield
    bus.reset_default_sinks()


def compared(record: dict) -> dict:
    return {k: v for k, v in record.items() if k not in NOT_COMPARED}


def records(ring, kinds=None) -> list[dict]:
    """A ring's events as records in the compared fields, ``plan`` left
    out unless ``kinds`` names it."""
    return [compared(e.to_record()) for e in ring.events()
            if (e.kind in kinds if kinds else e.kind != "plan")]


# ---------------------------------------------------------------------------
# events
# ---------------------------------------------------------------------------
# one instance's fields of every event class, the same in both packages
FIELDS = {
    "Event": {},
    "PlanEvent": dict(kernel="rmsnorm", shape=(8, 128), dtype="float32",
                      cache="miss", source="analytic", local=True,
                      mesh=(("data", 2), ("model", 1))),
    "SpmdFallbackEvent": dict(kernel="xent", mesh=(("data", 2),),
                              reasons=("vocab not divisible",)),
    "SpmdOverrideShadowEvent": dict(kernel="xent", mesh=(("data", 2),),
                                    global_shape=(8, 32),
                                    cells=("('xent', (8, 32))",)),
    "ValidationEvent": dict(kernel="stream.copy", family="stream",
                            check="hbm", predicted_bytes=100.0,
                            measured_bytes=110.0, ratio=1.1, status="ok",
                            mesh=(("data", 8),)),
    "TrainStepEvent": dict(step=3, loss=2.5, grad_norm=0.75, step_s=0.125),
    "CheckpointEvent": dict(step=4, action="save"),
    "AdmissionEvent": dict(rid=7, slot=1, queue_depth=3),
    "BatcherTickEvent": dict(tick=2, n_prefill=1, n_decode=1, slots=4,
                             padded_slots=8, free_slots=2, pad_slots=4,
                             queue_depth=5),
    "PagePoolEvent": dict(tick=2, used_pages=3, free_pages=1, live_pages=4,
                          page_len=16),
    "PreemptionEvent": dict(rid=1, slot=0, reason="decode_pressure",
                            pages_freed=2, queue_depth=1),
    "RequestAbandonedEvent": dict(rid=2, stage="prefill", fed=5,
                                  generated=0),
    "ProfileDriftEvent": dict(path="p.json", cell="rmsnorm (8, 128)",
                              detail="block_shape moved"),
    "MeshChangeEvent": dict(old_mesh=(("data", 4), ("model", 2)),
                            new_mesh=(("data", 3), ("model", 2)),
                            failed_ids=(7,), retired_ids=(6,), step=12),
    "ResumeEvent": dict(step=10, mesh=(("data", 3), ("model", 2)),
                        batch_chunks=(2, 1, 1), invalidated_plans=5,
                        spec_fallbacks=("batch 5 on data=3",)),
    "DegradedEvent": dict(reason="straggler", detail="step 2.0s", step=3),
}


def test_the_classes_are_the_reference_s():
    assert set(FIELDS) == {"Event", *(c.__name__ for c in
                                      events.EVENT_KINDS.values())}
    assert len(FIELDS) == 16
    assert ({k: c.__name__ for k, c in events.EVENT_KINDS.items()}
            == {k: c.__name__ for k, c in jobs.EVENT_KINDS.items()})


@pytest.mark.parametrize("name", FIELDS)
def test_records_equal_the_reference_s(name):
    """Same fields, same record: keys in the same order, JSON-equal."""
    ts = 1234.5
    mine = getattr(obs, name)(**FIELDS[name], ts=ts).to_record()
    theirs = getattr(jobs, name)(**FIELDS[name], ts=ts).to_record()
    assert list(mine) == list(theirs)
    assert mine == theirs
    assert json.loads(json.dumps(mine)) == json.loads(json.dumps(theirs))


class TestEvents:
    def test_to_record_shape(self):
        ev = events.PlanEvent(kernel="rmsnorm", shape=(8, 128),
                              dtype="float32", cache="miss",
                              mesh=(("data", 2),))
        rec = ev.to_record()
        assert list(rec)[:2] == ["kind", "ts"]
        assert rec["kind"] == "plan"
        assert rec["shape"] == [8, 128]          # tuples -> lists
        assert rec["mesh"] == [["data", 2]]
        json.dumps(rec)                          # JSON-safe end to end

    def test_events_are_frozen(self):
        ev = events.TrainStepEvent(step=1, loss=2.0, grad_norm=0.5)
        with pytest.raises(dataclasses.FrozenInstanceError):
            ev.loss = 3.0

    def test_kind_registry_is_complete(self):
        kinds = {"plan", "spmd_fallback", "spmd_override_shadow",
                 "validation", "train_step", "checkpoint", "admission",
                 "batcher_tick", "page_pool", "preemption",
                 "request_abandoned", "profile_drift",
                 "mesh_change", "resume", "degraded"}
        assert set(events.EVENT_KINDS) == kinds
        for kind, cls in events.EVENT_KINDS.items():
            assert cls.kind == kind


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------
class TestSinks:
    def test_ring_buffer_wraparound_keeps_counts(self):
        ring = obs.RingBufferSink(capacity=2)
        for i in range(5):
            ring.emit(events.TrainStepEvent(step=i, loss=0.0, grad_norm=0.0))
        assert len(ring) == 2                      # buffer truncated...
        assert ring.counts() == {"train_step": 5}  # ...counts are not
        assert [e.step for e in ring.events("train_step")] == [3, 4]
        assert ring.events("plan") == []

    @pytest.mark.parametrize("append", [False, True])
    def test_jsonl_sink_lazy_open_roundtrip_and_append(self, tmp_path,
                                                      append):
        path = tmp_path / "events.jsonl"
        path.write_text(json.dumps({"kind": "checkpoint", "step": 1,
                                    "action": "save"}) + "\n")
        sink = obs.JsonlSink(path, append=append)
        assert len(path.read_text().splitlines()) == 1  # no I/O yet
        sink.emit(events.CheckpointEvent(step=3, action="save"))
        sink.emit(events.CheckpointEvent(step=4, action="save"))
        sink.close()
        recs = [json.loads(x) for x in path.read_text().splitlines()]
        assert [r["step"] for r in recs] == ([1, 3, 4] if append else [3, 4])
        assert sink.emitted == 2

    def test_jsonl_sink_does_not_close_borrowed_file(self, tmp_path):
        f = open(tmp_path / "borrowed.jsonl", "w")
        try:
            sink = obs.JsonlSink(f)
            sink.emit(events.CheckpointEvent(step=1, action="save"))
            sink.close()
            assert not f.closed                    # caller owns the handle
        finally:
            f.close()

    def test_logging_sink(self, caplog):
        sink = obs.LoggingSink("repro_torch.obs.test", level=logging.WARNING)
        with caplog.at_level(logging.WARNING, logger="repro_torch.obs.test"):
            sink.emit(events.AdmissionEvent(rid=7, slot=1, queue_depth=3))
        assert "admission" in caplog.text
        assert "rid=7" in caplog.text

    def test_logging_sink_defaults_to_the_port_s_logger(self, caplog):
        with caplog.at_level(logging.INFO, logger="repro_torch.obs.events"):
            obs.LoggingSink().emit(events.CheckpointEvent(step=2,
                                                          action="save"))
        assert [r.name for r in caplog.records] == ["repro_torch.obs.events"]


# ---------------------------------------------------------------------------
# bus / session semantics
# ---------------------------------------------------------------------------
class TestBus:
    def test_disabled_by_default(self):
        assert not obs.enabled()
        assert all(isinstance(s, obs.NullSink) for s in bus.current_sinks())

    def test_session_enables_and_restores(self):
        ring = obs.RingBufferSink()
        with obs.session(ring):
            assert obs.enabled()
            obs.emit(events.CheckpointEvent(step=1, action="save"))
        assert not obs.enabled()
        obs.emit(events.CheckpointEvent(step=2, action="save"))  # dropped
        assert ring.counts() == {"checkpoint": 1}

    def test_nested_sessions_inherit(self):
        outer, inner = obs.RingBufferSink(), obs.RingBufferSink()
        with obs.session(outer):
            with obs.session(inner):                # inherits outer
                obs.emit(events.CheckpointEvent(step=1, action="save"))
            obs.emit(events.CheckpointEvent(step=2, action="save"))
        assert outer.counts() == {"checkpoint": 2}
        assert inner.counts() == {"checkpoint": 1}

    def test_inherit_false_isolates(self):
        outer, inner = obs.RingBufferSink(), obs.RingBufferSink()
        with obs.session(outer):
            with obs.session(inner, inherit=False):
                obs.emit(events.CheckpointEvent(step=1, action="save"))
        assert outer.counts() == {}
        assert inner.counts() == {"checkpoint": 1}

    def test_empty_isolated_session_is_disabled(self):
        with obs.session(obs.RingBufferSink()):
            with obs.session(inherit=False):
                assert not obs.enabled()

    def test_sessions_are_thread_local(self):
        seen = {}

        def probe():
            seen["enabled"] = obs.enabled()
            seen["sinks"] = bus.current_sinks()

        with obs.session(obs.RingBufferSink()):
            t = threading.Thread(target=probe)
            t.start()
            t.join()
        assert seen["enabled"] is False            # other thread: default
        assert all(isinstance(s, obs.NullSink) for s in seen["sinks"])

    def test_default_sinks_are_process_wide(self):
        ring = obs.RingBufferSink()
        bus.set_default_sinks(ring)
        try:
            assert obs.enabled()
            hit = {}

            def probe():
                if obs.enabled():
                    obs.emit(events.CheckpointEvent(step=9, action="save"))
                hit["done"] = True

            t = threading.Thread(target=probe)
            t.start()
            t.join()
            assert hit["done"]
            assert ring.counts() == {"checkpoint": 1}
        finally:
            bus.reset_default_sinks()
        assert not obs.enabled()

    def test_failing_sink_never_raises_and_others_still_deliver(self, caplog):
        class Boom(obs.Sink):
            def emit(self, event):
                raise RuntimeError("boom")

        ring = obs.RingBufferSink()
        with caplog.at_level(logging.ERROR, logger="repro_torch.obs"):
            with obs.session(Boom(), ring):
                obs.emit(events.CheckpointEvent(step=1, action="save"))
        assert ring.counts() == {"checkpoint": 1}
        assert "obs sink 'Boom' failed" in caplog.text

    def test_non_sink_rejected(self):
        with pytest.raises(TypeError):
            with obs.session(object()):
                pass
        with pytest.raises(TypeError):
            bus.set_default_sinks(object())

    def test_the_two_buses_are_apart(self):
        """A session of one package does not reach the other's bus."""
        with obs.session(obs.RingBufferSink()):
            assert obs.enabled() and not jobs.enabled()
        with jobs.session(jobs.RingBufferSink()):
            assert jobs.enabled() and not obs.enabled()


# ---------------------------------------------------------------------------
# the zero-cost default: no sink call from a launch, a batcher run or a
# trainer run (counted, not timed)
# ---------------------------------------------------------------------------
class _EchoModel:
    """The tiniest decode-able model: the fed token is the argmax.
    ``d_model=0`` skips batch planning and an empty cache makes slot
    resets trivial (tests/test_torch_serving.py's)."""

    def __init__(self, vocab: int = 16):
        self.vocab = vocab
        self.cfg = types.SimpleNamespace(d_model=0, adtype=torch.float32)

    def cache_defs(self, slots, max_len):
        return {}

    def decode_step(self, params, cache, tokens):
        logits = torch.nn.functional.one_hot(tokens[:, 0].long(), self.vocab)
        return logits[:, None, :].float(), cache


def _tiny_trainer(ckpt_dir, n_steps=3, ckpt_every=2):
    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=64,
                      n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=32,
                      dtype="float32", remat=False)
    return Trainer(
        build_model(cfg),
        pipeline.DataConfig(vocab_size=32, seq_len=16, global_batch=4),
        adamw.AdamWConfig(master=False),
        schedules.make_schedule("cosine", peak=3e-3, warmup=2, total=n_steps),
        TrainerConfig(n_steps=n_steps, ckpt_every=ckpt_every,
                      ckpt_dir=str(ckpt_dir), backoff_base_s=0.0), **CPU)


def _run_launch(tmp_path):
    x = torch.ones(90_016)
    torch.testing.assert_close(api.launch("stream.scale", x, s=2.0), x * 2)
    api.plan_for("rmsnorm", (90_017, 128), "float32")


def _run_batcher(tmp_path):
    b = ContinuousBatcher(_EchoModel(), {}, slots=1, max_len=8, **CPU)
    assert b.run([Request(rid=0, prompt=[2], max_new_tokens=1)]) == {0: [2]}


def _run_trainer(tmp_path):
    assert len(_tiny_trainer(tmp_path).train(0)) == 3


@pytest.mark.parametrize("run", [_run_launch, _run_batcher, _run_trainer],
                         ids=["launch", "batcher", "trainer"])
def test_default_makes_zero_sink_calls(run, tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(sinks_mod.NullSink, "emit",
                        lambda self, e: calls.append(e))
    run(tmp_path)
    assert calls == []                         # nothing even constructed


# ---------------------------------------------------------------------------
# plan events
# ---------------------------------------------------------------------------
class TestPlanEvents:
    def test_miss_then_hit_with_provenance(self):
        n = 90_018
        ring = obs.RingBufferSink()
        with obs.session(ring):
            api.plan_for("stream.copy", (n,), "float32")
            api.plan_for("stream.copy", (n,), "float32")
        evs = ring.events("plan")
        assert [e.cache for e in evs] == ["miss", "hit"]
        assert all(e.kernel == "stream.copy" for e in evs)
        assert all(e.source == "analytic" for e in evs)
        assert evs[0].shape == (n,)

    def test_override_event_carries_pin_provenance(self):
        n = 90_019
        base = dataclasses.replace(api.plan_for("stream.copy", (n,),
                                                "float32"),
                                   provenance="profile:p.json")
        ring = obs.RingBufferSink()
        cell = ("stream.copy", (n,), "float32")
        with api.plan_context(plan_overrides={cell: base}), obs.session(ring):
            got = api.plan_for("stream.copy", (n,), "float32")
        assert got is base
        (ev,) = ring.events("plan")
        assert ev.cache == "override"
        assert ev.source == "profile:p.json"

    def test_launch_emits_plan_event(self):
        n = 90_020
        ring = obs.RingBufferSink()
        with obs.session(ring):
            api.launch("stream.scale", torch.ones(n), s=1.5)
        evs = ring.events("plan")
        assert [(e.kernel, e.shape, e.cache) for e in evs] == [
            ("stream.scale", (n,), "miss")]


def test_plan_cache_sequence_equals_the_reference_s():
    """The same launches and plan queries, the planner caches cleared
    first: the same kernel, logical shape and cache value a resolution,
    override included."""
    x = np.arange(2000, dtype=np.float32)
    a = np.ones((8, 128), np.float32)
    cell = ("stream.copy", (512,), "float32")

    def sequence(api_, asarray, session, ring, clear):
        clear()
        with session(ring):
            api_.launch("stream.scale", asarray(x), s=2.0)
            api_.launch("stream.scale", asarray(x), s=2.0)
            api_.plan_for("rmsnorm", (64, 256), "float32")
            api_.plan_for("rmsnorm", (64, 256), "float32")
            api_.launch("rmsnorm", asarray(a), asarray(np.ones(128,
                                                               np.float32)))
            api_.launch("triad", asarray(x), asarray(x), asarray(x))
            pin = api_.plan_for(*cell)
            with api_.plan_context(plan_overrides={cell: pin}):
                api_.plan_for(*cell)
                api_.plan_for("stream.copy", (1024,), "float32")
        return [(e.kernel, tuple(e.shape), e.dtype, e.cache, e.source,
                 e.local, e.mesh) for e in ring.events("plan")]

    mine = sequence(api, torch.from_numpy, obs.session, obs.RingBufferSink(),
                    clear_plan_cache)
    theirs = sequence(japi, jnp.asarray, jobs.session, jobs.RingBufferSink(),
                      jclear_plan_cache)
    assert mine == theirs
    assert [m[3] for m in mine] == ["miss", "hit", "miss", "hit", "miss",
                                    "miss", "miss", "override", "miss"]


def test_a_backward_on_another_thread_streams_to_the_forward_s_sinks():
    """On the card autograd runs the backward (remat's recomputation, the
    loss's ``xent_grad``) on its device thread, which has no session of
    its own: the forward's sinks are re-entered there, so the stream is
    the same wherever the backward runs (here a thread stands in)."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                              remat=True)
    model = build_model(cfg)
    params = model.init(0, **CPU)
    for leaf in (t for _, t in interop_leaves(params)):
        leaf.requires_grad_(True)
    batch = pipeline.make_batch(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=8, global_batch=2), 0, **CPU)

    def plans(backward_on_a_thread: bool):
        ring = obs.RingBufferSink()
        with obs.session(ring):
            loss = model.loss(params, batch)
            forward = len(ring.events("plan"))
            if backward_on_a_thread:
                t = threading.Thread(target=loss.backward)
                t.start()
                t.join()
            else:
                loss.backward()
        return forward, [(e.kernel, e.shape) for e in ring.events("plan")]

    here, there = plans(False), plans(True)
    assert here == there
    forward, kernels = here
    # each layer's two norms again in the recomputation (one device's
    # xent_grad plans nothing)
    assert len(kernels) == forward + 2 * cfg.n_layers
    assert {k for k, _ in kernels[forward:]} == {"rmsnorm"}


# ---------------------------------------------------------------------------
# SPMD events
# ---------------------------------------------------------------------------
def _fake_mesh(shape):
    return types.SimpleNamespace(axis_names=("data", "model"), shape=shape,
                                 axis_sizes=dict(zip(("data", "model"),
                                                     shape)),
                                 size=int(np.prod(shape)))


def test_fallback_event_per_occurrence():
    entry = types.SimpleNamespace(name="xent")
    mesh = _fake_mesh((5, 1))
    ring = obs.RingBufferSink()
    reasons = ["vocab axis 16 not divisible by model=1"]
    with obs.session(ring):
        spmd._log_fallbacks(entry, mesh, ((8, 16),), reasons)
        spmd._log_fallbacks(entry, mesh, ((8, 16),), reasons)
        spmd._log_fallbacks(entry, mesh, ((8, 16),), [])   # no fallback
    evs = ring.events("spmd_fallback")
    assert len(evs) == 2                       # events never dedup
    assert evs[0].kernel == "xent"
    assert evs[0].mesh == (("data", 5), ("model", 1))
    assert evs[0].reasons == tuple(reasons)


def test_shadowed_override_event_per_occurrence():
    """A pin keyed at the global shape of an SPMD launch: an event each
    time, the warning once.  On (7, 1) a stream's rank holds 1/7 of it."""
    n = 90_021
    entry = registry_lib.resolve("stream.copy")
    cell = ("stream.copy", (7 * n,), "float32")
    base = api.plan_for(*cell)
    ring = obs.RingBufferSink()
    with api.plan_context(plan_overrides={cell: base}), obs.session(ring):
        with pytest.warns(RuntimeWarning, match="inert"):
            dispatch._warn_spmd_shadowed_overrides(
                entry, _fake_mesh((7, 1)), (torch.zeros(n),), {})
        dispatch._warn_spmd_shadowed_overrides(
            entry, _fake_mesh((7, 1)), (torch.zeros(n),), {})
    evs = ring.events("spmd_override_shadow")
    assert len(evs) == 2
    assert evs[0].kernel == "stream.copy"
    assert evs[0].global_shape == (7 * n,)
    assert evs[0].cells == (str(cell),)
    assert evs[0].mesh == (("data", 7), ("model", 1))


# ---------------------------------------------------------------------------
# the batcher against the reference's
# ---------------------------------------------------------------------------
SPEC = [(0, [7, 8, 9], 20), (1, list(range(1, 11)), 4), (2, [5, 6], 6)]
TIGHT = dict(slots=2, max_len=32, kv_cache="paged", page_len=8, n_pages=4)


@pytest.fixture(scope="module")
def serving_pair():
    jmodel = jbuild_model(jreduce(jget_config("qwen3-4b")))
    model = build_model(reduce_for_smoke(get_config("qwen3-4b")))
    tree = numpy_params(jmodel.param_defs(), 11)
    return ((jmodel, jax.tree.map(jnp.asarray, tree)),
            (model, interop.params_from_jax(tree, model.cfg, **CPU)))


def _serve(serving_pair, port: bool, *, fault=None, **run_kw):
    """One run of SPEC through either batcher under a session; returns
    (batcher, ring, completed or the TruncatedRun)."""
    (jm, jp), (m, p) = serving_pair
    if port:
        b, ring, make, sess = (ContinuousBatcher(m, p, **TIGHT, **CPU),
                               obs.RingBufferSink(), Request, obs.session)
    else:
        b, ring, make, sess = (JBatcher(jm, jp, **TIGHT),
                               jobs.RingBufferSink(), JRequest, jobs.session)
    with sess(ring):
        try:
            out = b.run([make(r, list(pr), n) for r, pr, n in SPEC],
                        fault_injector=fault, **run_kw)
        except RuntimeError as e:
            out = e
    return b, ring, out


@pytest.fixture(scope="module")
def served(serving_pair):
    return {port: _serve(serving_pair, port) for port in (True, False)}


def test_batcher_stream_equals_the_reference_s(served):
    (b, ring, out), (jb, jring, jout) = served[True], served[False]
    assert out == jout
    mine, theirs = records(ring), records(jring)
    assert mine == theirs
    counts = {k: sum(r["kind"] == k for r in mine) for k in
              ("admission", "preemption", "batcher_tick", "page_pool")}
    assert counts == {"admission": 4, "preemption": 1,
                      "batcher_tick": b.ticks, "page_pool": b.ticks}
    assert b.ticks == jb.ticks


def test_batcher_tick_fields_and_the_page_pool(served):
    b, ring, _ = served[True]
    ticks = ring.events("batcher_tick")
    assert [t.tick for t in ticks] == list(range(1, b.ticks + 1))
    for t in ticks:
        assert (t.slots, t.padded_slots, t.pad_slots) == (2, 2, 0)
        assert t.n_prefill + t.n_decode + t.free_slots == t.slots
    # the reference pads 2 slots to its sublane tile; the port does not
    jticks = served[False][1].events("batcher_tick")
    assert {(t.padded_slots, t.pad_slots) for t in jticks} == {(8, 6)}
    for p in ring.events("page_pool"):
        assert p.used_pages + p.free_pages == p.live_pages == 3
        assert p.page_len == 8


def test_preemption_records_are_the_preemption_log(served):
    b, ring, _ = served[True]
    got = [(e.rid, e.reason) for e in ring.events("preemption")]
    assert got == b.preemption_log == [(1, "decode_pressure")]


@pytest.mark.parametrize("on_truncation", ["raise", "return"])
def test_abandoned_requests_equal_the_reference_s(serving_pair,
                                                  on_truncation):
    mine = _serve(serving_pair, True, max_ticks=5,
                  on_truncation=on_truncation)
    theirs = _serve(serving_pair, False, max_ticks=5,
                    on_truncation=on_truncation)
    got = records(mine[1], ("request_abandoned",))
    assert got == records(theirs[1], ("request_abandoned",))
    assert [(r["rid"], r["stage"]) for r in got] == [
        (0, "decode"), (1, "prefill"), (2, "queued")]
    if on_truncation == "raise":
        assert type(mine[2]).__name__ == type(theirs[2]).__name__ == \
            "TruncatedRun"


class _PoolShrinkAt:
    def __init__(self, tick, live_pages):
        self.at, self.live_pages = tick, live_pages

    def tick(self, b, tick):
        if tick == self.at:
            b.shrink_pool(self.live_pages)


def test_pool_shrink_streams_the_reference_s_degraded_event(serving_pair):
    """``shrink_pool`` preempts for replay and reports a ``DegradedEvent``
    (``pool_shrink``), as the reference's does, on a pool of 9 pages cut
    to 3 at tick 12, where one tenant must go."""
    wide = dict(TIGHT, n_pages=9)
    runs = []
    for port in (True, False):
        (jm, jp), (m, p) = serving_pair
        b = (ContinuousBatcher(m, p, **wide, **CPU) if port
             else JBatcher(jm, jp, **wide))
        ring = obs.RingBufferSink() if port else jobs.RingBufferSink()
        make = Request if port else JRequest
        with (obs.session if port else jobs.session)(ring):
            b.run([make(0, [7, 8, 9], 16), make(1, list(range(1, 9)), 6)],
                  fault_injector=_PoolShrinkAt(12, 3))
        runs.append(records(ring))
    mine, theirs = runs
    assert mine == theirs
    (deg,) = [r for r in mine if r["kind"] == "degraded"]
    assert deg["reason"] == "pool_shrink"
    assert deg["detail"] == ("live pages 8 -> 3, 1 tenant(s) preempted for "
                             "replay")
    assert [(r["rid"], r["reason"]) for r in mine
            if r["kind"] == "preemption"] == [(1, "pool_shrink")]


# ---------------------------------------------------------------------------
# the trainer against the reference's
# ---------------------------------------------------------------------------
def _fail_once(at):
    armed = {"on": True}

    def inject(step):
        if step == at and armed["on"]:
            armed["on"] = False
            raise RuntimeError("injected")

    return inject


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Reduced qwen2-0.5b at the true fan-ins from the same numpy weights
    (both trainers start from the same state), 6 steps, a checkpoint every
    2, a transient failure at step 3; each under a session."""
    jcfg, cfg = jreduce(jget_config("qwen2-0.5b")), reduce_for_smoke(
        get_config("qwen2-0.5b"))
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    tree = numpy_params(model.param_defs(), 0, true_fan_in=True)
    jparams = jax.tree.map(jnp.asarray, tree)
    opt = dict(weight_decay=0.1, clip_norm=1.0)
    jstate = {"params": jparams,
              "opt": jadamw.init_state(jparams, jadamw.AdamWConfig(**opt))}
    state = interop.train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                         cfg, **CPU)
    tk = dict(n_steps=6, ckpt_every=2, backoff_base_s=0.0)
    data = dict(vocab_size=512, seq_len=16, global_batch=4, seed=3)
    root = tmp_path_factory.mktemp("obs_trainer")
    mp = pytest.MonkeyPatch()
    mp.setattr(jsteps, "init_train_state", lambda *a, **k: jstate)
    mp.setattr(steps, "init_train_state", lambda *a, **k: state)
    try:
        jt = jtrainer.Trainer(
            jmodel, jpipeline.DataConfig(**data), jadamw.AdamWConfig(**opt),
            jschedules.make_schedule("cosine", peak=1e-3, warmup=0,
                                     total=10),
            jtrainer.TrainerConfig(ckpt_dir=str(root / "jax"), **tk))
        t = Trainer(model, pipeline.DataConfig(**data),
                    adamw.AdamWConfig(**opt),
                    schedules.make_schedule("cosine", peak=1e-3, warmup=0,
                                            total=10),
                    TrainerConfig(ckpt_dir=str(root / "torch"), **tk), **CPU)
        jring, ring = jobs.RingBufferSink(), obs.RingBufferSink()
        with jobs.session(jring):
            jt.train(jax.random.PRNGKey(0), fail_injector=_fail_once(3))
        with obs.session(ring):
            t.train(0, fail_injector=_fail_once(3))
    finally:
        mp.undo()
    return {"mine": ring, "theirs": jring, "trainer": t, "jtrainer": jt}


def test_trainer_stream_equals_the_reference_s(trained):
    mine, theirs = records(trained["mine"]), records(trained["theirs"])
    assert [r["kind"] for r in mine] == [r["kind"] for r in theirs]
    for a, b in zip(mine, theirs):
        if a["kind"] == "train_step":
            assert a["step"] == b["step"]
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL)
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                       rtol=5e-3)
        else:
            assert a == b
    assert [(r["step"], r["action"]) for r in mine
            if r["kind"] == "checkpoint"] == [
        (2, "save"), (2, "restore"), (4, "save"), (6, "save"), (6, "save")]
    assert [(r["reason"], r["step"], r["detail"]) for r in mine
            if r["kind"] == "degraded"] == [
        ("transient_retry", 3, "RuntimeError: injected (retry 1/3)")]
    assert [r["step"] for r in mine if r["kind"] == "train_step"] == [
        0, 1, 2, 2, 3, 4, 5]


def test_train_steps_carry_the_metrics_floats(trained):
    evs = trained["mine"].events("train_step")
    assert [(e.step, e.loss, e.grad_norm, e.step_s) for e in evs] == [
        (m["step"], m["loss"], m["grad_norm"], m["step_s"])
        for m in trained["trainer"].metrics]
    assert all(e.step_s > 0 for e in evs)


def test_straggler_event_equals_the_reference_s(trained):
    ring, jring = obs.RingBufferSink(), jobs.RingBufferSink()
    with obs.session(ring):
        trained["trainer"]._note_straggler(7, 2.0, 0.25, 3)
        trained["trainer"]._note_straggler(8, 0.5, 0.25, 3)     # not one
    with jobs.session(jring):
        trained["jtrainer"]._note_straggler(7, 2.0, 0.25, 3)
    assert records(ring) == records(jring) == [
        {"kind": "degraded", "reason": "straggler",
         "detail": "step 2.000s vs ema 0.250s (threshold x4)", "step": 7}]


def test_restore_event_without_running_steps(tmp_path):
    tr = _tiny_trainer(tmp_path)
    state = steps.init_train_state(tr.model, tr.opt_cfg, 0, **CPU)
    tr.ckpt.save(5, state)
    tr.ckpt.wait()
    ring = obs.RingBufferSink()
    with obs.session(ring):
        step, _ = tr.init_or_restore(0)
    assert step == 5
    (ev,) = ring.events("checkpoint")
    assert (ev.step, ev.action) == (5, "restore")


# ---------------------------------------------------------------------------
# the launcher: one device, and rank 0 alone on a mesh
# ---------------------------------------------------------------------------
def test_on_a_mesh_rank_0_alone_streams_one_device_s_stream(tmp_path):
    """``launch.train --obs-jsonl`` on one device and on a (1, 2) gloo
    mesh (one spawn): rank 0 writes the file, rank 1's bus never listens,
    and the two streams' ``train_step`` steps and losses (rtol 1e-6, the
    tensor-parallel tolerance of tests/test_torch_tp.py) and
    ``checkpoint`` pairs agree.  ``plan`` records are not compared: on the
    mesh they carry a rank's local shapes."""
    argv = ["--arch", "qwen2-0.5b", "--device", "cpu", "--steps", "2",
            "--seq-len", "16", "--global-batch", "4", "--ckpt-every", "1"]
    one = train_launch.main(argv + ["--mesh", "host", "--ckpt-dir",
                                    str(tmp_path / "one"), "--obs-jsonl",
                                    str(tmp_path / "one.jsonl")])
    ranks = train_launch.main(argv + ["--mesh", "1x2", "--baseline",
                                      "--ckpt-dir", str(tmp_path / "mesh"),
                                      "--obs-jsonl",
                                      str(tmp_path / "mesh.jsonl")])
    read = [[json.loads(x) for x in (tmp_path / f"{n}.jsonl").read_text()
             .splitlines()] for n in ("one", "mesh")]
    want, got = ([(r["kind"], r["step"], r.get("action"), r.get("loss"))
                  for r in recs if r["kind"] in ("train_step", "checkpoint")]
                 for recs in read)
    assert [g[:3] for g in got] == [w[:3] for w in want] == [
        ("train_step", 0, None), ("checkpoint", 1, "save"),
        ("train_step", 1, None), ("checkpoint", 2, "save"),
        ("checkpoint", 2, "save")]
    np.testing.assert_allclose([g[3] for g in got if g[3] is not None],
                               [m["loss"] for m in one], rtol=1e-6)
    assert [g[3] for g in got if g[3] is not None] == [
        m["loss"] for m in ranks[0]["metrics"]]
    assert ranks[0]["obs"] == {"enabled": True, "records": len(read[1])}
    assert ranks[1]["obs"] == {"enabled": False, "records": 0}
    assert {r["kind"] for r in read[1]} == {"plan", "train_step",
                                            "checkpoint"}
    assert all(r["mesh"] == [["data", 1], ["model", 2]]
               for r in read[1] if r["kind"] == "plan")


def test_obs_smoke_script_on_the_cpu(tmp_path):
    out = tmp_path / "smoke.jsonl"
    done = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_obs_smoke.py"),
         str(out), "--device", "cpu"], capture_output=True, text=True,
        timeout=300)
    assert done.returncode == 0, done.stderr
    assert "obs smoke ok: 3 event(s)" in done.stdout
    caches = [json.loads(x)["cache"] for x in out.read_text().splitlines()]
    assert caches == ["miss", "hit", "miss"]


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------
def _sample_events(pkg=obs) -> list:
    e = pkg
    return [
        e.PlanEvent(kernel="rmsnorm", shape=(8, 128), dtype="float32",
                    cache="miss"),
        e.PlanEvent(kernel="rmsnorm", shape=(8, 128), dtype="float32",
                    cache="hit"),
        e.PlanEvent(kernel="xent", shape=(8, 32), dtype="float32",
                    cache="hit"),
        e.PlanEvent(kernel="xent", shape=(8, 32), dtype="float32",
                    cache="override", source="profile:p.json"),
        e.SpmdFallbackEvent(kernel="xent", mesh=(("data", 2),),
                            reasons=("vocab not divisible",)),
        e.SpmdOverrideShadowEvent(kernel="xent", mesh=(("data", 2),),
                                  global_shape=(8, 32),
                                  cells=("('xent', (8, 32))",)),
        e.ValidationEvent(kernel="stream.copy", family="stream",
                          check="hbm", predicted_bytes=100.0,
                          measured_bytes=110.0, ratio=1.1, status="ok"),
        e.ValidationEvent(kernel="xent", family="xent", check="comm",
                          predicted_bytes=100.0, measured_bytes=250.0,
                          ratio=2.5, status="fail"),
        e.TrainStepEvent(step=0, loss=3.5, grad_norm=1.0, step_s=0.5),
        e.TrainStepEvent(step=1, loss=3.1, grad_norm=0.9, step_s=0.3),
        e.CheckpointEvent(step=2, action="save"),
        e.CheckpointEvent(step=2, action="restore"),
        e.AdmissionEvent(rid=0, slot=0, queue_depth=4),
        e.BatcherTickEvent(tick=1, n_prefill=1, n_decode=1, slots=4,
                           padded_slots=8, free_slots=2, pad_slots=4,
                           queue_depth=1),
        e.ProfileDriftEvent(path="p.json", cell="rmsnorm (8, 128)",
                            detail="block_shape moved"),
    ]


def _elastic_events(pkg=obs) -> list:
    e = pkg
    return [
        e.MeshChangeEvent(old_mesh=(("data", 4), ("model", 2)),
                          new_mesh=(("data", 3), ("model", 2)),
                          failed_ids=(7,), retired_ids=(6,), step=12),
        e.ResumeEvent(step=10, mesh=(("data", 3), ("model", 2)),
                      batch_chunks=(2, 1, 1), invalidated_plans=5),
        e.DegradedEvent(reason="straggler", step=3,
                        detail="step 2.0s vs ema 0.1s"),
        e.DegradedEvent(reason="transient_retry", step=4),
        e.DegradedEvent(reason="straggler", step=9),
        e.PagePoolEvent(tick=1, used_pages=3, free_pages=1, live_pages=4,
                        page_len=16),
        e.PreemptionEvent(rid=1, slot=0, reason="decode_pressure",
                          pages_freed=2, queue_depth=1),
        e.RequestAbandonedEvent(rid=2, stage="queued", fed=0, generated=0),
    ]


def _write_stream(path: Path, evs, pkg=obs) -> None:
    with pkg.JsonlSink(path) as sink:
        for e in evs:
            sink.emit(e)


class TestReport:
    def test_aggregate_sections(self):
        s = report.aggregate([e.to_record() for e in _sample_events()])
        assert s["events"] == 15
        plan = s["plan"]
        assert (plan["hits"], plan["misses"], plan["overrides"]) == (2, 1, 1)
        assert plan["hit_rate"] == pytest.approx(2 / 3)
        assert plan["sources"]["profile:p.json"] == 1
        assert plan["by_kernel"]["rmsnorm"]["misses"] == 1
        fb = s["spmd_fallbacks"]
        assert fb["total"] == 1
        assert fb["by_site"]["xent@data=2"]["reasons"] == [
            "vocab not divisible"]
        assert s["spmd_override_shadows"]["total"] == 1
        val = s["validation"]
        assert val["stream/hbm"]["worst"] == pytest.approx(1.1)
        assert val["xent/comm"]["fails"] == 1
        tr = s["train"]
        assert tr["steps"] == 2
        assert (tr["first_loss"], tr["last_loss"]) == (3.5, 3.1)
        assert tr["mean_step_s"] == pytest.approx(0.4)
        assert tr["checkpoint_saves"] == tr["checkpoint_restores"] == 1
        ba = s["batcher"]
        assert ba["admissions"] == 1
        assert ba["max_queue_depth"] == 4
        assert ba["mean_waste_frac"] == pytest.approx(6 / 8)
        assert s["profile_drift"]["cells"] == ["rmsnorm (8, 128)"]

    def test_elastic_and_paged_sections_aggregate(self):
        s = report.aggregate([e.to_record() for e in _elastic_events()])
        el = s["elastic"]
        assert el["mesh_changes"] == 1
        assert el["last_mesh"] == "data=3,model=2"
        assert el["resumes"] == 1
        assert el["last_resume_step"] == 10
        assert el["invalidated_plans"] == 5
        assert el["degraded"] == 3
        assert el["degraded_reasons"] == {"straggler": 2,
                                          "transient_retry": 1}
        ba = s["batcher"]
        assert ba["mean_page_util"] == ba["peak_page_util"] == 0.75
        assert ba["preempt_reasons"] == {"decode_pressure": 1}
        assert ba["abandoned"] == 1
        text = report.render(s)
        assert "elastic: 1 mesh change(s)" in text
        assert "data=3,model=2" in text
        assert "mean pool util 75.0%" in text

    def test_render_is_stable_when_empty(self):
        text = report.render(report.aggregate([]))
        for section in ("events: 0", "plan cache:", "spmd fallbacks: 0",
                        "validation: 0", "trainer: 0", "batcher: 0",
                        "profile drift: 0"):
            assert section in text

    def test_cli_text_and_json(self, tmp_path, capsys):
        path = tmp_path / "run.jsonl"
        _write_stream(path, _sample_events())
        assert report.main([str(path)]) == 0
        out = capsys.readouterr().out
        assert "hit rate 66.7%" in out
        assert "xent/comm" in out
        assert report.main([str(path), "--json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["events"] == 15
        assert doc["plan"]["hit_rate"] == pytest.approx(2 / 3)

    def test_cli_fail_on_validation(self, tmp_path, capsys):
        path = tmp_path / "run.jsonl"
        _write_stream(path, _sample_events())
        assert report.main([str(path), "--fail-on-validation"]) == 1
        capsys.readouterr()
        clean = tmp_path / "clean.jsonl"
        _write_stream(clean, [e for e in _sample_events()
                              if getattr(e, "status", "ok") == "ok"])
        assert report.main([str(clean), "--fail-on-validation"]) == 0

    def test_cli_tolerates_malformed_lines(self, tmp_path, capsys):
        path = tmp_path / "torn.jsonl"
        _write_stream(path, _sample_events()[:3])
        with open(path, "a") as f:
            f.write('[1, 2]\n{"kind": "plan", "cache"')   # torn final line
        assert report.main([str(path)]) == 0
        out = capsys.readouterr().out
        assert "2 malformed line(s) skipped" in out
        assert report.main([str(path), "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["malformed_lines"] == 2

    def test_cli_unreadable_input_exits_2(self, tmp_path, capsys):
        assert report.main([str(tmp_path / "absent.jsonl")]) == 2
        assert "error" in capsys.readouterr().err

    def test_cli_merges_multiple_streams(self, tmp_path, capsys):
        a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
        _write_stream(a, _sample_events()[:5])
        _write_stream(b, _sample_events()[5:])
        assert report.main([str(a), str(b), "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["events"] == 15

    def test_module_entry_point(self, tmp_path):
        path = tmp_path / "run.jsonl"
        _write_stream(path, _sample_events())
        done = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.report",
             "--fail-on-validation", str(path)], capture_output=True,
            text=True, timeout=120, env={"PYTHONPATH": str(ROOT / "src")})
        assert done.returncode == 1
        assert done.stdout.startswith("events: 15\n")
        assert "python -m repro_torch.obs.report" in subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.report", "--help"],
            capture_output=True, text=True, timeout=120,
            env={"PYTHONPATH": str(ROOT / "src")}).stdout


@pytest.mark.parametrize("writer", ["repro_torch", "repro"])
def test_the_reports_read_each_other_s_streams(writer, tmp_path, capsys):
    """One mixed stream, written by either package's ``JsonlSink`` from
    its own events: both reports give the same summary and text."""
    pkg = obs if writer == "repro_torch" else jobs
    path = tmp_path / "mixed.jsonl"
    _write_stream(path, _sample_events(pkg) + _elastic_events(pkg), pkg)
    for fmt in ([], ["--json"]):
        outs = []
        for rep in (report, jreport):
            assert rep.main([str(path), *fmt]) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1]
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert report.aggregate(recs) == jreport.aggregate(recs)
    assert report.render(report.aggregate(recs)) == jreport.render(
        jreport.aggregate(recs))
