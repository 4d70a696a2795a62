"""The port's continuous batcher and paged KV cache, on the CPU.

Ports of tests/test_serving.py's ten tests and of the tests of
tests/test_paged_cache.py that do not read the reference's event bus, run
against ``repro_torch``; the tests it parametrizes run the reference's
zamba2-1.2b (the hybrid, whose Mamba2 state is per slot and never paged)
and qwen2-0.5b, and beside them qwen3-4b, minicpm-2b, xlstm-1.3b,
qwen3-moe-30b-a3b and pixtral-12b (all reduced; the reduced MoE routes
top-8 of its 8 experts at capacity factor 4, where nothing drops; the vlm
serves text alone, from position 0, as the reference's batcher does).  The
encoder-decoder is refused by the batcher (tests/test_torch_encdec.py).  Where
the reference reads preemptions or pool saturation from its event bus, the
port's tests read the batcher's ``preemption_log`` and the page pool.  The
reference's tight-pool tests rely on its page length of 8 at these shapes;
the port's default page is 16 positions (``serving.paged_cache``), so those
tests pass ``page_len=8``.

"Batched equals isolated" is held to the port's rule: the request re-run
alone in a batcher of the same slot geometry (its other slots idle).

One test crosses frameworks: the same weights and requests give the same
greedy tokens through ``repro``'s and ``repro_torch``'s batchers.  A greedy
token is only meaningful where the top two logits differ clearly, so the
test first asserts a top-2 gap of at least 1e-3 at every decision.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models import build_model as jbuild_model
from repro.serving import ContinuousBatcher as JBatcher
from repro.serving import Request as JRequest
from repro_torch import interop
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.segmented import PageGeometry
from repro_torch.interop import numpy_params
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.params import ParamDef
from repro_torch.serving import (
    ContinuousBatcher,
    PageManager,
    Request,
    TruncatedRun,
    plan_page_geometry,
)
from repro_torch.serving.paged_cache import ATTN_TILE_ROWS, line_rows

ARCHS = ["qwen2-0.5b", "qwen3-4b", "zamba2-1.2b", "minicpm-2b",
         "xlstm-1.3b", "qwen3-moe-30b-a3b", "pixtral-12b"]
CPU = dict(device="cpu")


def model_and_params(arch, seed=0):
    model = build_model(reduce_for_smoke(get_config(arch)))
    return model, model.init(seed, **CPU)


def batcher(model, params, **kw):
    return ContinuousBatcher(model, params, **CPU, **kw)


def _isolated_run(model, params, prompt, max_new, max_len, slots):
    """The request alone, in a batcher of the same slot geometry."""
    b = batcher(model, params, slots=slots, max_len=max_len)
    return b.run([Request(0, list(prompt), max_new)])[0]


def _ragged_requests(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size,
                                               size=3 + 2 * i).tolist(),
                    max_new_tokens=4 + i)
            for i in range(n)]


def _clone(reqs):
    return [Request(r.rid, list(r.prompt), r.max_new_tokens) for r in reqs]


def _run_tracking_pages(b, reqs):
    """``b.run`` with the page pool's use sampled after every allocation;
    returns (completed, peak used pages)."""
    peak = [0]
    alloc = b.pages.alloc

    def tracked(*args, **kw):
        got = alloc(*args, **kw)
        peak[0] = max(peak[0], b.pages.used_pages)
        return got

    b.pages.alloc = tracked
    return b.run(reqs), peak[0]


# ---------------------------------------------------------------------------
# tests/test_serving.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_equals_isolated_with_slot_reuse(arch):
    model, params = model_and_params(arch)
    reqs = _ragged_requests(model.cfg, 5)
    max_len = 40
    # 5 ragged requests through 2 slots -> guaranteed slot reuse
    got = batcher(model, params, slots=2, max_len=max_len).run(_clone(reqs))
    assert sorted(got) == [0, 1, 2, 3, 4]
    for r in reqs:
        want = _isolated_run(model, params, r.prompt, r.max_new_tokens,
                             max_len, 2)
        assert got[r.rid] == want, (arch, r.rid)


def test_throughput_accounting():
    model, params = model_and_params("qwen2-0.5b")
    reqs = [Request(rid=i, prompt=[1, 2, 3], max_new_tokens=3)
            for i in range(4)]
    b = batcher(model, params, slots=4, max_len=16)
    assert len(b.run(reqs)) == 4
    # 4 slots in parallel: 3 prefill + 2 extra decode ticks = 5 total
    assert b.ticks == 5
    assert b.micro_steps == 5


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_equals_dense(arch):
    """The paged cache is token-identical to dense on the same stream, and
    its pages are the planner's tiles under the Hopper page rule.  An ssm
    model (xlstm) has no attention stage and so no page pool: its pages
    back nothing, and paged = dense checks the scheduler's bookkeeping and
    the ``act`` masking of the recurrent state."""
    model, params = model_and_params(arch)
    reqs = _ragged_requests(model.cfg, 4)
    max_len = 40
    want = batcher(model, params, slots=2, max_len=max_len).run(_clone(reqs))
    paged = batcher(model, params, slots=2, max_len=max_len, kv_cache="paged")
    geom, plan = paged.geometry, paged.page_plan
    assert geom.page_len >= max(plan.block_rows, ATTN_TILE_ROWS)
    kv_width = model.cfg.n_kv_heads * model.cfg.hd
    assert geom.page_len % line_rows(kv_width, 4) == 0
    pools = [paged.cache[k][kv] for k in paged.cache if k.startswith("s")
             and "k" in paged.cache[k] for kv in ("k", "v")]
    attention = any(kind in ("dense", "moe", "shared_attn")
                    for kind, _ in model.cfg.stages())
    assert bool(pools) == attention
    for pool in pools:
        assert tuple(pool.shape[1:3]) == (geom.n_pages, geom.page_len)
    got = paged.run(_clone(reqs))
    assert got == want, arch
    # retirement returned every page to the pool immediately
    assert paged.pages.free_pages == geom.live_pages


def test_chunked_prefill_parity_and_fewer_ticks():
    model, params = model_and_params("qwen2-0.5b")
    reqs = _ragged_requests(model.cfg, 5)
    dense = batcher(model, params, slots=2, max_len=40)
    want = dense.run(_clone(reqs))
    chunked = batcher(model, params, slots=2, max_len=40, kv_cache="paged",
                      prefill_chunk=4)
    assert chunked.run(_clone(reqs)) == want
    # chunked prefill is a scheduling lever: same tokens, fewer ticks
    assert chunked.ticks < dense.ticks


def test_page_pool_exhaustion_backpressure():
    """A pool too small for all requests at once defers admissions instead
    of corrupting state; everything still completes token-identically."""
    model, params = model_and_params("qwen2-0.5b")
    reqs = _ragged_requests(model.cfg, 5)
    want = batcher(model, params, slots=2, max_len=40).run(_clone(reqs))
    tight = batcher(model, params, slots=2, max_len=40, kv_cache="paged",
                    page_len=8, n_pages=5)
    got, peak = _run_tracking_pages(tight, _clone(reqs))
    assert got == want
    assert tight.pages.free_pages == tight.geometry.live_pages
    # the pool saturated at some point (else the test is vacuous)
    assert peak == tight.geometry.live_pages


def test_preemption_decode_priority_and_replay():
    """Decode pressure evicts a prefilling slot (never the decoder), the
    victim replays after requeue, and the output stream is unchanged."""
    model, params = model_and_params("qwen2-0.5b")
    # rid 0: short prompt, long decode -- grows to 3 pages.  rid 1: long
    # prompt -- still prefilling when rid 0 needs its second page, with
    # only 3 live pages between them.
    reqs = [Request(rid=0, prompt=[7, 8, 9], max_new_tokens=20),
            Request(rid=1, prompt=list(range(1, 11)), max_new_tokens=4)]
    want = batcher(model, params, slots=2, max_len=32).run(_clone(reqs))
    paged = batcher(model, params, slots=2, max_len=32, kv_cache="paged",
                    page_len=8, n_pages=4)
    clones = _clone(reqs)
    got = paged.run(clones)
    log = paged.preemption_log
    assert log, "tight pool never preempted"
    assert all(reason == "decode_pressure" for _, reason in log)
    assert {rid for rid, _ in log} == {1}          # the prefilling victim
    assert clones[1].preemptions >= 1 and clones[0].preemptions == 0
    assert got == want                             # replay is invisible


class _PoolShrinkAt:
    """Shrinks the batcher's page pool at one tick (the reference's
    ``runtime.faults.PoolShrink``, whose port waits for ROADMAP A12)."""

    def __init__(self, tick, live_pages):
        self.at, self.live_pages, self.log = tick, live_pages, []

    def tick(self, b, tick):
        if tick == self.at:
            b.shrink_pool(self.live_pages)
            self.log.append(("pool_shrink", tick))


def test_pool_shrink_degrades_gracefully(caplog):
    """Losing page capacity mid-stream shrinks the live pool via the
    preemption-by-replay path; the batcher keeps serving at reduced
    capacity and the stream is token-identical to the dense reference."""
    model, params = model_and_params("qwen2-0.5b")
    reqs = [Request(rid=0, prompt=[7, 8, 9], max_new_tokens=16),
            Request(rid=1, prompt=list(range(1, 9)), max_new_tokens=6)]
    want = batcher(model, params, slots=2, max_len=32).run(_clone(reqs))
    paged = batcher(model, params, slots=2, max_len=32, kv_cache="paged",
                    page_len=8, n_pages=9)
    before = paged.pages.live_pages
    inj = _PoolShrinkAt(4, 3)
    with caplog.at_level("WARNING", logger="repro_torch.serving"):
        got = paged.run(_clone(reqs), fault_injector=inj)
    assert inj.log == [("pool_shrink", 4)]
    assert paged.pages.live_pages == 3 < before
    assert got == want                          # degradation is invisible
    shrunk = [r for r in caplog.records if "page pool shrunk" in r.message]
    assert len(shrunk) == 1 and f"{before} -> 3" in shrunk[0].getMessage()
    # post-shrink accounting stays consistent on the shrunken pool
    assert paged.pages.free_pages == paged.pages.live_pages == 3


def test_pool_shrink_requires_paged_cache():
    model, params = model_and_params("qwen2-0.5b")
    b = batcher(model, params, slots=2, max_len=16)
    with pytest.raises(RuntimeError, match="paged"):
        b.shrink_pool(3)


def test_max_len_equals_padded_slots_end_to_end():
    """Regression: with max_len == padded_slots a shape-guessed slot reset
    would clobber every tenant's KV rows on re-admission.  The port packs no
    rows (padded_slots == slots), so the fixture takes 8 slots."""
    model, params = model_and_params("qwen2-0.5b")
    b = batcher(model, params, slots=8, max_len=8)
    assert b.padded_slots == 8 == b.max_len, "fixture drifted"
    reqs = [Request(rid=i, prompt=[3 + i, 4 + i], max_new_tokens=3)
            for i in range(12)]           # 12 requests, 8 slots: reuse
    got = b.run(_clone(reqs))
    for r in reqs:
        assert got[r.rid] == _isolated_run(model, params, r.prompt, 3, 8, 8)


def test_eos_early_stop():
    model, params = model_and_params("qwen2-0.5b")
    # the model's first greedy token as EOS -> stops after 1 token
    eos = _isolated_run(model, params, [5, 6, 7], 1, 16, 2)[0]
    b = batcher(model, params, slots=2, max_len=16, eos_id=eos)
    out = b.run([Request(rid=0, prompt=[5, 6, 7], max_new_tokens=8)])
    assert out[0][-1] == eos
    assert len(out[0]) < 8


# ---------------------------------------------------------------------------
# tests/test_paged_cache.py (the tests that do not read the event bus)
# ---------------------------------------------------------------------------


class TestPageGeometry:
    def test_arithmetic(self):
        g = PageGeometry(page_len=8, n_pages=5)
        assert g.live_pages == 4
        assert [g.pages_for(n) for n in (0, 1, 8, 9, 16)] == [0, 1, 1, 2, 2]
        assert g.page_of(13) == 1 and g.offset_of(13) == 5
        assert g.pages_for(-3) == 0

    def test_alloc_order_is_bank_skewed(self):
        order = PageGeometry(page_len=8, n_pages=9, banks=4).alloc_order()
        assert sorted(order) == list(range(1, 9))        # null page excluded
        assert [p % 4 for p in order[:4]] == sorted({p % 4 for p in order[:4]})

    def test_validation(self):
        with pytest.raises(ValueError):
            PageGeometry(page_len=0, n_pages=4)
        with pytest.raises(ValueError):
            PageGeometry(page_len=8, n_pages=1)     # null page only
        with pytest.raises(ValueError):
            PageGeometry(page_len=8, n_pages=4, banks=0)


class TestPageManager:
    def test_alloc_is_all_or_nothing(self):
        pm = PageManager(PageGeometry(page_len=4, n_pages=4), n_slots=2)
        assert pm.free_pages == 3
        got = pm.alloc(0, upto_pos=7)                # 2 pages
        assert len(got) == 2 and pm.free_pages == 1
        assert [lp for lp, _ in got] == [0, 1]
        assert pm.alloc(1, upto_pos=4) is None       # needs 2, 1 left
        assert pm.free_pages == 1 and pm.slot_pages(1) == ()
        assert pm.alloc(0, upto_pos=6) == []

    def test_release_returns_everything(self):
        pm = PageManager(PageGeometry(page_len=4, n_pages=6, banks=2),
                         n_slots=2)
        pm.alloc(0, upto_pos=11)
        assert pm.used_pages == 3
        assert len(pm.release(0)) == 3
        assert pm.free_pages == 5 and pm.slot_pages(0) == ()

    def test_needed_tracks_coverage(self):
        pm = PageManager(PageGeometry(page_len=4, n_pages=8), n_slots=1)
        assert pm.needed(0, upto_pos=0) == 1
        pm.alloc(0, upto_pos=0)
        assert pm.needed(0, upto_pos=3) == 0
        assert pm.needed(0, upto_pos=4) == 1


class TestPlanPageGeometry:
    def _cfg(self, kv=2, hd=16, dtype=torch.float32):
        return types.SimpleNamespace(n_kv_heads=kv, hd=hd, adtype=dtype)

    def test_page_len_is_planner_tile(self):
        geom, plan = plan_page_geometry(self._cfg(), max_len=64, slots=2)
        assert geom.page_len == max(plan.block_rows, ATTN_TILE_ROWS)
        assert geom.n_pages == 1 + 2 * (-(-64 // geom.page_len))
        # full-width Qwen3-4B: the 128 KiB budget gives 16-row pages
        geom, plan = plan_page_geometry(self._cfg(8, 128, torch.bfloat16),
                                        max_len=1024, slots=8)
        assert geom.page_len == plan.block_rows == 16
        assert geom.n_pages == 1 + 8 * 64

    def test_explicit_page_len_must_be_tile_aligned(self):
        geom, _ = plan_page_geometry(self._cfg(), max_len=64, page_len=2 * 8)
        assert geom.page_len == 16
        # a 32-B KV row needs 4 rows to fill a 128-B line
        assert line_rows(8, 4) == 4
        geom, _ = plan_page_geometry(self._cfg(1, 8), max_len=64, page_len=8)
        assert geom.page_len == 8
        with pytest.raises(ValueError, match="128-B lines"):
            plan_page_geometry(self._cfg(1, 8), max_len=64, page_len=6)
        with pytest.raises(ValueError, match="row unit"):
            plan_page_geometry(self._cfg(), max_len=64, page_len=0)


class _EchoModel:
    """Echoes the fed token as the greedy output; empty cache tree."""

    def __init__(self, vocab: int = 16):
        self.vocab = vocab
        self.cfg = types.SimpleNamespace(d_model=0, adtype=torch.float32)

    def cache_defs(self, slots, max_len):
        return {}

    def decode_step(self, params, cache, tokens):
        logits = torch.nn.functional.one_hot(tokens[:, 0].long(), self.vocab)
        return logits[:, None, :].float(), cache


class _AxisModel(_EchoModel):
    """Echo model whose cache leaf carries its batch axis last, after a
    ``max_len``-sized axis -- the layout that breaks a shape-guessed reset
    whenever ``max_len == padded_slots``."""

    def cache_defs(self, slots, max_len):
        return {
            "idx": ParamDef((slots,), ("batch",), init="zeros",
                            dtype=torch.int32),
            "state": ParamDef((2, max_len, slots),
                              ("layers", "cache_seq", "batch"),
                              init="zeros", dtype=torch.float32),
        }

    def decode_step(self, params, cache, tokens):
        logits, _ = super().decode_step(params, cache, tokens)
        return logits, {"idx": cache["idx"] + 1, "state": cache["state"] + 1.0}


class TestResetSlotRegression:
    def test_reset_follows_declared_batch_axis(self):
        b = ContinuousBatcher(_AxisModel(), {}, slots=4, max_len=4, **CPU)
        assert b.padded_slots == b.max_len
        b.cache = {"idx": torch.full((4,), 7, dtype=torch.int32),
                   "state": torch.ones((2, 4, 4))}
        out = b._reset_slot(b.cache, 1)
        state = out["state"].numpy()
        assert np.all(state[:, :, 1] == 0.0)              # the reset tenant
        assert np.all(np.delete(state, 1, axis=2) == 1.0)  # untouched
        idx = out["idx"].numpy()
        assert idx[1] == 0 and np.all(np.delete(idx, 1) == 7)

    def test_end_to_end_isolation_with_reuse(self):
        b = ContinuousBatcher(_AxisModel(), {}, slots=4, max_len=4, **CPU)
        out = b.run([Request(rid=i, prompt=[i + 1], max_new_tokens=2)
                     for i in range(6)])
        for i in range(6):
            assert out[i] == [i + 1, i + 1]      # echo: prompt token twice


class TestRequestRegressions:
    def test_done_returns_bool(self):
        req = Request(rid=0, prompt=[1, 2], max_new_tokens=4)
        assert req.done(3) is False
        assert req.done(None) is False
        req.generated = [3]
        assert req.done(3) is True
        req.generated = [9] * 4
        assert req.done(None) is True

    def test_empty_prompt_rejected_at_submit(self):
        b = ContinuousBatcher(_EchoModel(), {}, slots=1, max_len=8, **CPU)
        with pytest.raises(ValueError, match="empty prompt"):
            b.submit([Request(rid=0, prompt=[], max_new_tokens=2)])
        assert not b.busy

    def test_run_rejects_unknown_truncation_mode(self):
        b = ContinuousBatcher(_EchoModel(), {}, slots=1, max_len=8, **CPU)
        with pytest.raises(ValueError, match="on_truncation"):
            b.run([], on_truncation="warn")


class TestTruncationRegression:
    def _reqs(self, n):
        return [Request(rid=i, prompt=[1, 2, 3], max_new_tokens=4)
                for i in range(n)]

    def test_run_raises_with_partial_results(self):
        b = ContinuousBatcher(_EchoModel(), {}, slots=1, max_len=16, **CPU)
        with pytest.raises(TruncatedRun) as ei:
            b.run(self._reqs(3), max_ticks=8)
        assert sorted(ei.value.completed) == [0]
        assert sorted(r.rid for r in ei.value.abandoned) == [1, 2]

    def test_return_mode_is_opt_in_and_checkable(self):
        b = ContinuousBatcher(_EchoModel(), {}, slots=1, max_len=16, **CPU)
        out = b.run(self._reqs(3), max_ticks=8, on_truncation="return")
        assert sorted(out) == [0]
        assert b.busy

    def test_complete_run_does_not_raise(self):
        b = ContinuousBatcher(_EchoModel(), {}, slots=2, max_len=16, **CPU)
        assert sorted(b.run(self._reqs(2))) == [0, 1]
        assert not b.busy


# ---------------------------------------------------------------------------
# across frameworks, entry points
# ---------------------------------------------------------------------------




def test_greedy_tokens_equal_across_frameworks():
    jmodel = jbuild_model(jreduce(jget_config("qwen3-4b")))
    model = build_model(reduce_for_smoke(get_config("qwen3-4b")))
    tree = numpy_params(jmodel.param_defs(), 11)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = interop.params_from_jax(tree, model.cfg, **CPU)
    reqs = _ragged_requests(model.cfg, 3, seed=5)
    max_len = 24
    got = batcher(model, params, slots=2, max_len=max_len, kv_cache="paged",
                  prefill_chunk=4).run(_clone(reqs))
    # the top-2 gap at every greedy decision, replayed through the port
    for r in reqs:
        seq = r.prompt + got[r.rid]
        logits, _ = model(params, torch.as_tensor([seq[:-1]]))
        top2 = torch.topk(logits[0, len(r.prompt) - 1:], 2, dim=-1).values
        gap = float((top2[:, 0] - top2[:, 1]).min())
        assert gap >= 1e-3, f"request {r.rid}: top-2 gap {gap} too small"
    jbatch = JBatcher(jmodel, jparams, slots=2, max_len=max_len)
    want = jbatch.run([JRequest(r.rid, list(r.prompt), r.max_new_tokens)
                       for r in reqs])
    assert got == want


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model, params = model_and_params("qwen2-0.5b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatcher(model, params, slots=2, max_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.params_from_jax({}, model.cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--mesh", "host"])


def test_serve_launcher_runs_on_the_cpu(capsys):
    res = serve.main(["--mesh", "host", "--device", "cpu", "--arch",
                      "qwen2-0.5b", "--requests", "3", "--slots", "2",
                      "--max-len", "32", "--prompt-len", "3", "8", "--gen",
                      "2", "5"])
    assert res["requests"] == 3
    assert res["tokens"] == sum(len(v) for v in res["completed"].values())
    out = capsys.readouterr().out
    assert "3 requests" in out and "tok/s" in out and "page 16" in out
