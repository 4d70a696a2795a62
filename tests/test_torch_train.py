"""The port's training path against the JAX package, on the CPU.

The RMSNorm and cross-entropy ``autograd.Function``s, ``lm_loss``, the
loss and gradient of reduced qwen2-0.5b, qwen3-4b, zamba2-1.2b (the hybrid,
through the chunked SSD and the gated norm's ``GatedRMSNormFn``) and
minicpm-2b (its muP-style scales), one AdamW step, a
3-step trajectory and gradient accumulation, all from the same numpy
weights and batches on both sides (the two frameworks' generators differ).
The JAX side runs as its own tests run it, on one CPU device, so its
RMSNorm and cross-entropy are Pallas kernels in interpret mode; the port's
are the kernels' plain versions on CPU tensors.  Then the substrate:
AdamW, the schedules, the data pipeline and the trainer's fault tolerance,
the ports of tests/test_substrate.py's tests.

Tolerances, fp32 throughout:
  * RMSNorm and cross-entropy values and gradients: rtol 1e-5 with an atol
    of 1e-6 (values) or 1e-9 (cross-entropy gradients, whose entries are
    softmax / T); both sides compute the same fp32 math in other orders.
  * A model's loss rtol 1e-5; every gradient leaf rtol 1e-4 with an atol
    of 1e-3 times the leaf's largest magnitude.  A gradient sums many fp32
    products through four layers, and cancellation leaves errors relative
    to the leaf's scale, not to each entry.  The reduced qwen2-0.5b at
    these weights is ill-conditioned: its 0.02-std embeddings enter a
    residual stream that grows to about 100, so the first norm amplifies
    the input gradient some 50 times (embedding gradients reach 119).  Both
    frameworks' fp32 gradients lie 2.3e-3 (port) and 2.8e-3 (JAX) of the
    leaf's scale from the port's run with float64 weights and activations,
    and 5e-4 from each other; qwen3-4b's agree to 1e-6.  The global
    gradient norm, which sums those differences, is held to rtol 5e-3.
  * Parameters after AdamW steps: atol of 2 ``lr`` per step taken.  At a
    near-zero gradient entry Adam's first update is about +-lr whatever
    its size, so an fp32 difference in a tiny gradient can move a
    parameter by up to 2 lr; the schedules have no warmup here, because
    the reference's first step under warmup has lr 0.  The losses after the
    first step inherit those differences, which the ill-conditioned reduced
    qwen2-0.5b amplifies: its step-2 loss differs by 8e-4 relative, its
    gradient norms by 15 % (rtol 2e-3 on the losses; the norm is compared
    at the first step only).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.data import pipeline as jpipeline
from repro.models import blocks as jblocks
from repro.models import build_model as jbuild_model
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.optim import schedules as jschedules
from repro.parallel import steps as jsteps
from repro_torch import interop
from repro_torch.configs import get_config, get_schedule, reduce_for_smoke
from repro_torch.data import pipeline
from repro_torch.interop import numpy_params
from repro_torch.models import blocks, build_model, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import leaves
from repro_torch.optim import adamw, schedules
from repro_torch.parallel import steps
from repro_torch.runtime.faults import DeviceLossError
from repro_torch.runtime.trainer import Trainer, TrainerConfig

ARCHS = ["qwen2-0.5b", "qwen3-4b", "zamba2-1.2b", "minicpm-2b",
         "xlstm-1.3b"]
FP32 = dict(rtol=1e-5, atol=1e-6)
XENT_GRAD = dict(rtol=1e-5, atol=1e-9)
LR = 1e-3


def to_np(t):
    return interop.to_numpy(t)




def pair(arch, seed=0, true_fan_in=False, **changes):
    """(jax model, jax params, port model, port params) for a reduced
    ``arch`` with the same numpy weights: at the reference's init stds, or
    with ``true_fan_in`` at the port's (ROADMAP §C)."""
    jcfg = dataclasses.replace(jreduce(jget_config(arch)), **changes)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)), **changes)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    defs = model.param_defs() if true_fan_in else jmodel.param_defs()
    tree = numpy_params(defs, seed, true_fan_in=true_fan_in)
    return (jmodel, jax.tree.map(jnp.asarray, tree), model,
            interop.params_from_jax(tree, cfg, device="cpu"))


def batches(vocab, step, batch=4, seq=16):
    cfg = pipeline.DataConfig(vocab_size=vocab, seq_len=seq,
                              global_batch=batch, seed=3)
    jcfg = jpipeline.DataConfig(vocab_size=vocab, seq_len=seq,
                                global_batch=batch, seed=3)
    return (jpipeline.make_batch(jcfg, step),
            pipeline.make_batch(cfg, step, device="cpu"))


def assert_grads_close(got: dict, want: dict, what: str) -> None:
    g = dict(leaves(got))
    w = dict(leaves(want))
    assert g.keys() == w.keys()
    for path, ref in w.items():
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(
            to_np(g[path]), ref, rtol=1e-4,
            atol=1e-3 * max(float(np.abs(ref).max()), 1e-30),
            err_msg=f"{what}: {'/'.join(path)}")


# ---------------------------------------------------------------------------
# the autograd Functions and the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 7, 96), (16, 128)])
def test_rmsnorm_fn_grads_match_jax_vjp(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    s = (rng.standard_normal(shape[-1:]) * 0.1 + 1).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    want_y, vjp = jax.vjp(lambda a, b: jblocks._rms_fused(a, b, 1e-6),
                          jnp.asarray(x), jnp.asarray(s))
    want_gx, want_gs = vjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    ts = torch.tensor(s, requires_grad=True)
    y = blocks.RMSNormFn.apply(tx, ts, 1e-6)
    y.backward(torch.tensor(g))
    np.testing.assert_allclose(to_np(y), np.asarray(want_y), **FP32)
    np.testing.assert_allclose(to_np(tx.grad), np.asarray(want_gx), **FP32)
    np.testing.assert_allclose(to_np(ts.grad), np.asarray(want_gs), **FP32)


def test_apply_norm_takes_the_function_only_under_autograd():
    cfg = reduce_for_smoke(get_config("qwen2-0.5b"))
    x = torch.randn(2, 5, 128)
    p = {"scale": torch.ones(128, requires_grad=True)}
    y = blocks.apply_norm(p, x, cfg)
    assert type(y.grad_fn).__name__ == "RMSNormFnBackward"
    with torch.no_grad():
        assert blocks.apply_norm(p, x, cfg).grad_fn is None
    assert blocks.apply_norm({"scale": torch.ones(128)}, x, cfg).grad_fn is None
    # bf16 inputs: the gradients come back in each input's dtype
    xb = x.to(torch.bfloat16).requires_grad_(True)
    sb = torch.ones(128, dtype=torch.bfloat16, requires_grad=True)
    blocks.RMSNormFn.apply(xb, sb, 1e-6).float().sum().backward()
    assert xb.grad.dtype == sb.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_and_grad_match_reference(masked):
    jcfg = jreduce(jget_config("qwen2-0.5b"))
    cfg = reduce_for_smoke(get_config("qwen2-0.5b"))
    rng = np.random.default_rng(1)
    logits = (2 * rng.standard_normal((2, 9, 512))).astype(np.float32)
    labels = rng.integers(0, 512, size=(2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) < 0.7).astype(np.float32) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    want, want_g = jax.value_and_grad(
        lambda l: jtransformer.lm_loss(l, jnp.asarray(labels), jcfg, jmask))(
        jnp.asarray(logits))
    tl = torch.tensor(logits, requires_grad=True)
    got = transformer.lm_loss(tl, torch.as_tensor(labels), cfg,
                              None if mask is None else torch.as_tensor(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **FP32)
    np.testing.assert_allclose(to_np(tl.grad), np.asarray(want_g), **XENT_GRAD)
    if not masked:
        assert type(got.grad_fn).__name__ == "XentFnBackward"
        np.testing.assert_allclose(
            float(transformer._xent_ref(tl.detach().reshape(-1, 512),
                                        torch.as_tensor(labels).reshape(-1),
                                        512)),
            float(want), **FP32)


def test_remat_on_and_off_give_equal_grads():
    """Recomputing a layer in the backward pass reruns the same fp32 ops on
    the same inputs; the CPU's vectorised sums may round differently from
    run to run, hence rtol 1e-6 rather than bit equality."""
    _, _, model, params = pair("qwen2-0.5b")
    remat = build_model(dataclasses.replace(model.cfg, remat=True))
    _, batch = batches(512, 0)
    loss0, g0 = steps.value_and_grad(model, params, batch)
    loss1, g1 = steps.value_and_grad(remat, params, batch)
    np.testing.assert_allclose(float(loss1), float(loss0), rtol=1e-6)
    for (path, a), (_, b) in zip(leaves(g0), leaves(g1)):
        np.testing.assert_allclose(to_np(b), to_np(a), rtol=1e-6, atol=1e-9,
                                   err_msg="/".join(path))


def test_layers_unbind_each_stage_once():
    _, _, model, params = pair("qwen2-0.5b")
    stage = params["s00_dense"]
    got = transformer.layers(stage)
    assert len(got) == model.cfg.n_layers
    for i, lp in enumerate(got):
        for path, t in leaves(lp):
            src = stage
            for k in path:
                src = src[k]
            assert torch.equal(t, src[i]) and t._base is not None


# ---------------------------------------------------------------------------
# the step against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_match_reference(arch):
    jmodel, jparams, model, params = pair(arch)
    jbatch, batch = batches(512, 1)
    want, want_g = jax.jit(jax.value_and_grad(jmodel.loss, allow_int=True))(
        jparams, jbatch)
    np.testing.assert_allclose(float(model.loss(params, batch)), float(want),
                               rtol=1e-5)
    got, got_g = steps.value_and_grad(model, params, batch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert_grads_close(got_g, want_g, arch)
    # every leaf gets a nonzero gradient: the norms' scales included
    for path, g in leaves(got_g):
        assert bool(g.abs().max() > 0), path


def _states(jmodel, jparams, model, opt):
    jstate = {"params": jparams,
              "opt": jadamw.init_state(jparams, jadamw.AdamWConfig(**opt))}
    state = interop.train_state_from_jax(
        jax.tree.map(np.asarray, jstate), model.cfg, device="cpu")
    return jstate, state


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_and_trajectory_match_reference(arch):
    jmodel, jparams, model, params = pair(arch)
    opt = dict(weight_decay=0.1, clip_norm=1.0)
    jstate, state = _states(jmodel, jparams, model, opt)
    jstep = jax.jit(jsteps.make_train_step(
        jmodel, jadamw.AdamWConfig(**opt),
        jschedules.make_schedule("cosine", peak=LR, warmup=0, total=10)))
    step = steps.make_train_step(
        model, adamw.AdamWConfig(**opt),
        schedules.make_schedule("cosine", peak=LR, warmup=0, total=10))
    for i in range(3):
        jbatch, batch = batches(512, i)
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if i == 0 else 2e-3,
                                   err_msg=f"{arch} step {i}")
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
        if i == 0:
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=5e-3)
        for path, want in leaves(jax.tree.map(np.asarray, jstate["params"])):
            got = state["params"]
            for k in path:
                got = got[k]
            np.testing.assert_allclose(
                to_np(got), want, rtol=0, atol=2 * LR * (i + 1),
                err_msg=f"{arch} step {i}: {'/'.join(path)}")
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 3


def test_well_conditioned_train_step_matches_reference():
    """Reduced qwen2-0.5b at the true attention fan-ins (the port's init
    stds), where the reference's ill-conditioning is gone: the loss, every
    gradient leaf and three AdamW steps against the reference, to what
    fp32 reordering leaves at these weights.  Measured on the CPU: the loss
    7.6e-8 relative, the worst leaf 1.6e-6 of its scale, the norm 2.8e-7,
    the parameters 3.3e-5 after each step (an Adam update at an entry
    whose gradient is near ``eps`` follows the gradient's last bits).
    Held to loss and norm rtol 1e-6, each leaf atol 1e-5 of its scale,
    the parameters atol lr / 10."""
    jmodel, jparams, model, params = pair("qwen2-0.5b", true_fan_in=True)
    jbatch, batch = batches(512, 1)
    want, want_g = jax.jit(jax.value_and_grad(jmodel.loss, allow_int=True))(
        jparams, jbatch)
    got, got_g = steps.value_and_grad(model, params, batch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    w = dict(leaves(want_g))
    for path, g in leaves(got_g):
        ref = np.asarray(w[path], np.float32)
        np.testing.assert_allclose(
            to_np(g), ref, rtol=0, atol=1e-5 * float(np.abs(ref).max()),
            err_msg="/".join(path))

    opt = dict(weight_decay=0.1, clip_norm=1.0)
    jstate, state = _states(jmodel, jparams, model, opt)
    jstep = jax.jit(jsteps.make_train_step(
        jmodel, jadamw.AdamWConfig(**opt),
        jschedules.make_schedule("cosine", peak=LR, warmup=0, total=10)))
    step = steps.make_train_step(
        model, adamw.AdamWConfig(**opt),
        schedules.make_schedule("cosine", peak=LR, warmup=0, total=10))
    for i in range(3):
        jbatch, batch = batches(512, i)
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, batch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-6, err_msg=f"step {i} {key}")
        for path, want in leaves(jax.tree.map(np.asarray, jstate["params"])):
            got = state["params"]
            for k in path:
                got = got[k]
            np.testing.assert_allclose(
                to_np(got), want, rtol=0, atol=LR / 10,
                err_msg=f"step {i}: {'/'.join(path)}")


def test_microbatches_match_reference():
    jmodel, jparams, model, params = pair("qwen2-0.5b")
    opt = dict(clip_norm=1e9)
    jstate, state = _states(jmodel, jparams, model, opt)
    sched = dict(peak=LR, warmup=0, total=10)
    jstep = jax.jit(jsteps.make_train_step(
        jmodel, jadamw.AdamWConfig(**opt),
        jschedules.make_schedule("cosine", **sched), microbatches=2))
    step = steps.make_train_step(
        model, adamw.AdamWConfig(**opt),
        schedules.make_schedule("cosine", **sched), microbatches=2)
    jbatch, batch = batches(512, 0)
    jstate, jm = jstep(jstate, jbatch)
    state, m = step(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=5e-3)
    for path, want in leaves(jax.tree.map(np.asarray, jstate["params"])):
        got = state["params"]
        for k in path:
            got = got[k]
        np.testing.assert_allclose(to_np(got), want, rtol=0, atol=2 * LR,
                                   err_msg="/".join(path))
    # accumulating over two halves is the full batch's gradient
    _, full = steps.value_and_grad(model, params, batch)
    mloss = steps.make_eval_step(model)(params, batch)
    np.testing.assert_allclose(float(m["loss"]), float(mloss), rtol=1e-5)
    assert all(g.dtype == torch.float32 for _, g in leaves(full))


# ---------------------------------------------------------------------------
# substrate: optimizer, schedules, data
# ---------------------------------------------------------------------------

class TestAdamW:
    def test_converges_on_quadratic(self):
        params = {"w": torch.tensor([5.0, -3.0]), "perm": torch.arange(2)}
        cfg = adamw.AdamWConfig(weight_decay=0.0, master=True)
        state = adamw.init_state(params, cfg)
        for _ in range(200):
            g = {"w": 2 * params["w"], "perm": None}
            params, state, _ = adamw.apply_updates(params, g, state, 0.1, cfg)
        assert float((params["w"] ** 2).sum()) < 1e-3
        assert params["perm"].tolist() == [0, 1]

    def test_clipping(self):
        params = {"w": torch.ones(4)}
        cfg = adamw.AdamWConfig(clip_norm=1.0, master=False)
        state = adamw.init_state(params, cfg)
        g = {"w": torch.full((4,), 100.0)}
        _, _, metrics = adamw.apply_updates(params, g, state, 0.1, cfg)
        assert float(metrics["grad_norm"]) == pytest.approx(200.0)

    def test_master_dtype(self):
        params = {"w": torch.ones(4, dtype=torch.bfloat16)}
        cfg = adamw.AdamWConfig(master=True)
        state = adamw.init_state(params, cfg)
        assert state["master"]["w"].dtype == torch.float32

    @pytest.mark.parametrize("master", [True, False])
    def test_updates_match_reference(self, master):
        """Three updates of a bf16 tree with a perm leaf, the same numpy
        gradients on both sides: the fp32 master, the moments and the bf16
        parameters agree (parameters to one bf16 rounding)."""
        rng = np.random.default_rng(4)
        tree = {"a": rng.standard_normal((5, 3)).astype(np.float32),
                "b": {"c": rng.standard_normal(7).astype(np.float32)}}
        cfg = dict(master=master, clip_norm=0.5)
        jp = {"a": jnp.asarray(tree["a"], jnp.bfloat16),
              "b": {"c": jnp.asarray(tree["b"]["c"], jnp.bfloat16),
                    "perm": jnp.arange(3)}}
        tp = {"a": interop.to_torch(tree["a"], device="cpu", dtype="bfloat16"),
              "b": {"c": interop.to_torch(tree["b"]["c"], device="cpu",
                                          dtype="bfloat16"),
                    "perm": torch.arange(3)}}
        js = jadamw.init_state(jp, jadamw.AdamWConfig(**cfg))
        ts = adamw.init_state(tp, adamw.AdamWConfig(**cfg))
        for i in range(3):
            g = {"a": rng.standard_normal((5, 3)).astype(np.float32),
                 "c": rng.standard_normal(7).astype(np.float32)}
            jg = {"a": jnp.asarray(g["a"], jnp.bfloat16),
                  "b": {"c": jnp.asarray(g["c"], jnp.bfloat16),
                        "perm": np.zeros(3, jax.dtypes.float0)}}
            tg = {"a": interop.to_torch(g["a"], device="cpu", dtype="bfloat16"),
                  "b": {"c": interop.to_torch(g["c"], device="cpu",
                                              dtype="bfloat16"),
                        "perm": None}}
            lr = 0.01 * (i + 1)
            jp, js, jm = jadamw.apply_updates(jp, jg, js, lr,
                                              jadamw.AdamWConfig(**cfg))
            tp, ts, tm = adamw.apply_updates(tp, tg, ts, lr,
                                             adamw.AdamWConfig(**cfg))
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-6)
        for key in ("m", "v") + (("master",) if master else ()):
            for path, want in leaves(jax.tree.map(np.asarray, js[key])):
                got = ts[key]
                for k in path:
                    got = got[k]
                np.testing.assert_allclose(to_np(got), want, rtol=1e-5,
                                           atol=1e-7, err_msg=f"{key} {path}")
        for path, want in leaves(jax.tree.map(
                lambda a: np.asarray(a, np.float32), jp)):
            got = tp
            for k in path:
                got = got[k]
            np.testing.assert_allclose(to_np(got), want, rtol=8e-3, atol=0,
                                       err_msg=str(path))
        assert tp["b"]["perm"].tolist() == [0, 1, 2]
        assert int(ts["step"]) == int(js["step"]) == 3


class TestSchedules:
    @pytest.mark.parametrize("kind", ["cosine", "wsd"])
    def test_match_reference(self, kind):
        kw = dict(peak=3e-4, warmup=10, total=100)
        f = schedules.make_schedule(kind, **kw)
        jf = jschedules.make_schedule(kind, **kw)
        got = [float(f(s)) for s in range(0, 110)]
        want = [float(jf(s)) for s in range(0, 110)]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        # a tensor step (the optimizer state's) gives the same
        assert float(f(torch.tensor(37, dtype=torch.int32))) == got[37]

    def test_wsd_phases(self):
        f = lambda s: float(schedules.wsd(s, peak=1.0, warmup=10, total=100))
        assert f(0) == 0.0
        assert f(5) == pytest.approx(0.5)
        assert f(50) == pytest.approx(1.0)     # stable plateau
        assert f(95) < 1.0                      # decay phase
        assert f(100) == pytest.approx(0.01, rel=0.2)

    def test_cosine_monotone_after_warmup(self):
        f = lambda s: float(schedules.warmup_cosine(s, peak=1.0, warmup=10,
                                                    total=100))
        vals = [f(s) for s in range(10, 100, 5)]
        assert all(a >= b - 1e-9 for a, b in zip(vals, vals[1:]))

    def test_registry(self):
        assert callable(schedules.make_schedule("wsd"))
        assert callable(schedules.make_schedule("cosine"))
        with pytest.raises(ValueError):
            schedules.make_schedule("nope")
        assert get_schedule("qwen2-0.5b") == get_schedule("qwen3-4b") == "cosine"


class TestData:
    @pytest.mark.parametrize("step", range(4))
    def test_batches_bit_identical_to_reference(self, step):
        cfg = pipeline.DataConfig(vocab_size=151936, seq_len=64,
                                  global_batch=3, seed=11)
        jcfg = jpipeline.DataConfig(vocab_size=151936, seq_len=64,
                                    global_batch=3, seed=11)
        got = pipeline.make_batch(cfg, step, device="cpu")
        want = jpipeline.make_batch(jcfg, step)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        stream = pipeline.stream(cfg, step, device="cpu")
        assert torch.equal(next(stream)["tokens"], got["tokens"])

    def test_deterministic_across_restart(self):
        cfg = pipeline.DataConfig(vocab_size=100, seq_len=16, global_batch=4,
                                  seed=7)
        assert torch.equal(pipeline.make_batch(cfg, 3, device="cpu")["tokens"],
                           pipeline.make_batch(cfg, 3, device="cpu")["tokens"])

    def test_steps_differ(self):
        cfg = pipeline.DataConfig(vocab_size=100, seq_len=16, global_batch=4)
        assert not torch.equal(
            pipeline.make_batch(cfg, 0, device="cpu")["tokens"],
            pipeline.make_batch(cfg, 1, device="cpu")["tokens"])

    def test_labels_are_shifted_tokens(self):
        cfg = pipeline.DataConfig(vocab_size=100, seq_len=16, global_batch=2)
        b = pipeline.make_batch(cfg, 0, device="cpu")
        assert b["tokens"].shape == b["labels"].shape == (2, 16)
        assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def tiny_trainer(tmp, n_steps=16, **tkw):
    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=32,
                      n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64,
                      dtype="float32", remat=False)
    return Trainer(
        build_model(cfg),
        pipeline.DataConfig(vocab_size=64, seq_len=16, global_batch=8),
        adamw.AdamWConfig(master=False),
        schedules.make_schedule("cosine", peak=3e-3, warmup=2, total=24),
        TrainerConfig(n_steps=n_steps, ckpt_every=4, ckpt_dir=str(tmp),
                      backoff_base_s=0.0, **tkw),
        device="cpu")


class TestTrainer:
    def test_loss_decreases_and_survives_failure(self, tmp_path):
        tr = tiny_trainer(tmp_path)
        calls = {"armed": True}

        def bomb(step):
            if step == 6 and calls["armed"]:
                calls["armed"] = False
                raise RuntimeError("injected failure")

        ms = tr.train(0, fail_injector=bomb)
        losses = [m["loss"] for m in ms]
        # mean-of-tail vs mean-of-head: robust to per-batch noise
        assert np.mean(losses[-4:]) < np.mean(losses[:4])
        steps_run = [m["step"] for m in ms]
        assert steps_run.count(4) == 2 and 6 in steps_run  # replayed from 4
        assert set(tr.kernel_plans) == {"rmsnorm", "xent"}

    def test_restart_resumes_from_checkpoint(self, tmp_path):
        tr = tiny_trainer(tmp_path)
        tr.train(0)
        tr2 = tiny_trainer(tmp_path, n_steps=18)
        step, state = tr2.init_or_restore(0)
        assert step == 16
        for (path, a), (_, b) in zip(leaves(tr.state), leaves(state)):
            assert torch.equal(a, b), path

    def test_replay_after_restore_is_exact(self, tmp_path):
        """A fresh trainer restored from step 4 replays steps 4..7 with the
        uninterrupted run's losses, bit for bit (the pipeline is a pure
        function of the step, the CPU's ops are deterministic)."""
        full = tiny_trainer(tmp_path / "a", n_steps=8).train(0)
        tr = tiny_trainer(tmp_path / "b", n_steps=4)
        tr.train(0)
        again = tiny_trainer(tmp_path / "b", n_steps=8).train(0)
        assert [m["step"] for m in again] == [4, 5, 6, 7]
        assert [m["loss"] for m in again] == [m["loss"] for m in full[4:]]

    def test_device_loss_is_not_retried(self, tmp_path):
        tr = tiny_trainer(tmp_path)

        def lose(step):
            if step == 2:
                raise DeviceLossError([3], step=step)

        with pytest.raises(DeviceLossError, match=r"\[3\] lost at step 2"):
            tr.train(0, fail_injector=lose)

    def test_retries_are_bounded(self, tmp_path):
        tr = tiny_trainer(tmp_path, max_retries=2)

        def always(step):
            if step == 1:
                raise RuntimeError("always")

        with pytest.raises(RuntimeError, match="always"):
            tr.train(0, fail_injector=always)


# ---------------------------------------------------------------------------
# defaults: CUDA unless the caller asks for the CPU
# ---------------------------------------------------------------------------

def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = pipeline.DataConfig(vocab_size=64, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.make_batch(cfg, 0)
    model = build_model(reduce_for_smoke(get_config("qwen2-0.5b")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model, cfg, adamw.AdamWConfig(),
                schedules.make_schedule("cosine"),
                TrainerConfig(ckpt_dir=str(tmp_path)))
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "1", "--ckpt-dir", str(tmp_path / "c")])


def test_launcher_runs_the_reduced_config_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    metrics = train.main(["--mesh", "host", "--device", "cpu", "--steps", "4",
                          "--seq-len", "16", "--global-batch", "4",
                          "--ckpt-dir", str(tmp_path)])
    assert [m["step"] for m in metrics] == [0, 1, 2, 3]
    assert all(np.isfinite(m["loss"]) for m in metrics)
    out = capsys.readouterr().out
    assert "plan[xent] logical=(64, 512) float32" in out
    assert "done: 4 steps" in out
    # a checkpoint a step (steps // 4), the last three kept
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000003", "step_00000004"]


@pytest.mark.parametrize("arch", ["minicpm-2b", "zamba2-1.2b", "xlstm-1.3b"])
def test_launcher_trains_each_arch_under_its_schedule(arch, tmp_path,
                                                      monkeypatch):
    """``--arch minicpm-2b`` trains under the warmup-stable-decay schedule
    of its config, ``--arch zamba2-1.2b`` (cosine) trains the hybrid
    through the chunked SSD and ``--arch xlstm-1.3b`` (cosine) the ssm
    family through the chunkwise mLSTM and the sLSTM: the launcher asks
    ``make_schedule`` for the arch's kind, and the losses are finite."""
    from repro_torch.launch import train

    kinds = []
    make = schedules.make_schedule

    def recording(kind, **kw):
        kinds.append(kind)
        return make(kind, **kw)

    monkeypatch.setattr(schedules, "make_schedule", recording)
    metrics = train.main(["--arch", arch, "--mesh", "host", "--device", "cpu",
                          "--steps", "2", "--seq-len", "16",
                          "--global-batch", "2", "--ckpt-dir",
                          str(tmp_path)])
    assert kinds == [{"minicpm-2b": "wsd", "zamba2-1.2b": "cosine",
                      "xlstm-1.3b": "cosine"}[arch]]
    assert kinds == [get_schedule(arch)]
    assert [m["step"] for m in metrics] == [0, 1]
    assert all(np.isfinite(m["loss"]) for m in metrics)
