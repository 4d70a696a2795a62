"""The port's encoder-decoder (``repro_torch.models.encdec``, whisper-tiny)
against the JAX package's (``repro.models.encdec``), on the CPU.

Reduced whisper-tiny (``reduce_for_smoke`` on both sides: 2 encoder and 4
decoder layers, d 128, 4 heads, 16 frames, vocab 512), fp32, the same numpy
weights in both packages (``interop.numpy_params`` with the port's true
fan-ins, ``interop.params_from_jax``).  Every leaf is drawn at random,
LayerNorm biases and scales included, so each reaches the logits.  The
encoder also runs at 300 and 600 frames: past both packages' 512-position
attention tile, 600 frames take the online-softmax chunked path with a
partial last tile, non-causal, in the encoder's self-attention and in the
decoder's cross attention.

Tolerances: the encoder's output, the forward logits, the cross K/V and
eight decode steps rtol 1e-5 / atol 1e-5 (both sides compute in fp32 with
other summation orders; the encoder's output at 600 frames to an atol of
1e-5 of its largest magnitude, and to the port's own float64 run at 1e-5,
``test_encode_matches_the_reference``); the port's own decode against its forward 2e-3,
the reference's ``test_decode_consistency``; the loss rtol 1e-5, every
gradient leaf within 1e-4 of its largest magnitude.  The loss runs B11's
plain version on the port's side and the Pallas kernel in interpret mode
on the reference's.  The sinusoid in fp32 to 2e-4 absolute at positions up
to 1,499 (an fp32 ulp of the angle there is 1.2e-4, and the two libraries'
``exp`` and ``sin`` may round the last bit apart; measured 1.22e-4), and
in bf16 to that and one bf16 ulp of the larger of the two values (the
port's bf16 sinusoid equal to its fp32 one rounded once).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_schedule as jget_schedule
from repro.configs import reduce_for_smoke as jreduce
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import build_model as jbuild_model
from repro.models import encdec as jencdec
from repro.models.params import init_params as jinit_params
from repro.models.params import param_count as jparam_count
from repro_torch import interop
from repro_torch.configs import get_config, get_schedule, reduce_for_smoke
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.interop import numpy_params
from repro_torch.launch import serve
from repro_torch.launch import train as train_launcher
from repro_torch.models import EncDecLM, build_model, encdec
from repro_torch.models.params import init_params, leaves, map_leaves
from repro_torch.parallel import steps
from repro_torch.serving import ContinuousBatcher
from _torch_mesh import assert_launcher_trains_on_a_mesh, assert_mesh_runs

ARCH = "whisper-tiny"
CPU = dict(device="cpu")
PARITY = dict(rtol=1e-5, atol=1e-5)


@contextlib.contextmanager
def one_thread():
    """Run a token-by-token loop of small ops on one intra-op thread: they
    are too small to split, and the suite runs several workers on the
    machine's cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def pair(seed=0, **changes):
    """(jax model, jax params, port model, port params) for the reduced
    whisper-tiny with the same numpy weights."""
    jcfg = dataclasses.replace(jreduce(jget_config(ARCH)), **changes)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH)), **changes)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    tree = numpy_params(model.param_defs(), seed, true_fan_in=True)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jmodel, jparams, model, interop.params_from_jax(tree, cfg, **CPU)


def inputs(cfg, b=2, s=12, seed=1):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, cfg.n_frames, cfg.d_model),
                                 dtype=np.float32)
    tokens = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return frames, tokens


def to_np(t):
    return interop.to_numpy(t)


def def_shapes(tree):
    """{path: (shape, dtype name)} of a tree of either package's defs."""
    def name(dt):
        if isinstance(dt, torch.dtype):
            return str(dt).removeprefix("torch.")
        return np.dtype(dt).name

    return {path: (tuple(d.shape), name(d.dtype)) for path, d in leaves(tree)}


def test_configs_trees_and_leaf_shapes_match_the_reference():
    for jcfg, cfg in [(jget_config(ARCH), get_config(ARCH)),
                      (jreduce(jget_config(ARCH)),
                       reduce_for_smoke(get_config(ARCH)))]:
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert cfg.stages() == jcfg.stages() == [("dense", cfg.n_layers)]
        jmodel, model = jbuild_model(jcfg), build_model(cfg)
        assert isinstance(model, EncDecLM)
        want = def_shapes(jmodel.param_defs())
        got = def_shapes(model.param_defs())
        assert got == want
        assert {p for p in got if p[-1] == "bias"} >= {
            ("enc_norm", "bias"), ("final_norm", "bias"),
            ("dec", "lnx", "bias"), ("enc", "ln1", "bias")}
        assert def_shapes(model.cache_defs(3, 20)) == def_shapes(
            jmodel.cache_defs(3, 20))
    reduced = reduce_for_smoke(get_config(ARCH))
    assert (reduced.n_enc_layers, reduced.n_frames) == (2, 16)
    assert get_schedule(ARCH) == jget_schedule(ARCH) == "cosine"


def test_full_width_parameter_count_matches_the_reference():
    full = get_config(ARCH)
    got = sum(int(np.prod(t.shape)) for _, t in
              leaves(build_model(full).abstract_params()))
    want = jparam_count(jbuild_model(jget_config(ARCH)).param_defs())
    assert got == want
    assert 0.03e9 < got < 0.05e9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sinusoid_matches_the_reference(dtype):
    pos = np.stack([np.arange(1500), np.arange(1500)[::-1]]).astype(np.int32)
    got = encdec.sinusoid(torch.as_tensor(pos), 384, getattr(torch, dtype))
    want = np.asarray(jencdec.sinusoid(jnp.asarray(pos), 384,
                                       getattr(jnp, dtype)), np.float32)
    assert got.shape == (2, 1500, 384) and got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(to_np(got), want, rtol=0, atol=2e-4)
        # the first 16 positions' angles are small enough for the
        # parity tolerance
        np.testing.assert_allclose(to_np(got)[0, :16], want[0, :16],
                                   **PARITY)
    else:
        # rounded once from the fp32 sinusoid
        f32 = encdec.sinusoid(torch.as_tensor(pos), 384, torch.float32)
        assert torch.equal(got, f32.to(torch.bfloat16))
        # the fp32 tolerance and one bf16 ulp of the larger magnitude: fp32
        # values apart may round to the two sides of a bf16 boundary
        big = np.maximum(np.abs(to_np(got)), np.abs(want))
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
        assert (np.abs(to_np(got) - want) <= 2e-4 + ulp).all()


@pytest.mark.parametrize("n_frames", [16, 300, 600])
def test_encode_matches_the_reference(n_frames):
    """The encoder's output against the reference's, and against the
    port's own float64 run (PARITY).  At 600 frames (the chunked path) the
    reference's fp32 output lies 2.0e-5 from the float64 run where the
    port's lies 2.8e-6, so the two packages are held to an atol of 1e-5 of
    the output's largest magnitude there (5.1), as
    tests/test_torch_models.py holds the chunked attention."""
    jmodel, jparams, model, params = pair(n_frames=n_frames)
    frames, _ = inputs(model.cfg)
    want = np.asarray(jencdec.encode(jparams, jnp.asarray(frames),
                                     jmodel.cfg))
    got = encdec.encode(params, torch.as_tensor(frames), model.cfg)
    assert got.shape == (2, n_frames, 128)
    cfg64 = dataclasses.replace(model.cfg, dtype="float64")
    exact = encdec.encode(map_leaves(lambda t: t.double(), params),
                          torch.as_tensor(frames).double(), cfg64)
    np.testing.assert_allclose(to_np(got), exact.numpy(), **PARITY)
    atol = PARITY["atol"] * (np.abs(want).max() if n_frames > 512 else 1.0)
    np.testing.assert_allclose(to_np(got), want, rtol=PARITY["rtol"],
                               atol=atol)


@pytest.mark.parametrize("n_frames", [16, 300, 600])
def test_forward_and_prefill_cross_match_the_reference(n_frames):
    jmodel, jparams, model, params = pair(n_frames=n_frames)
    frames, tokens = inputs(model.cfg)
    want, _ = jax.jit(jmodel.forward)(jparams, jnp.asarray(tokens),
                                      jnp.asarray(frames))
    got, aux = model(params, torch.as_tensor(tokens), torch.as_tensor(frames))
    assert got.shape == (2, 12, 512) and got.dtype == torch.float32
    assert float(aux) == 0.0
    np.testing.assert_allclose(to_np(got), np.asarray(want), **PARITY)
    jk, jv = jmodel.prefill_cross(jparams, jnp.asarray(frames))
    k, v = model.prefill_cross(params, torch.as_tensor(frames))
    assert k.shape == v.shape == (4, 2, n_frames, 4, 32)
    np.testing.assert_allclose(to_np(k), np.asarray(jk), **PARITY)
    np.testing.assert_allclose(to_np(v), np.asarray(jv), **PARITY)


def decode(model, params, frames, tokens):
    """The port's ``decode_step`` over ``tokens`` (B, S) after
    ``prefill_cross``; returns the logits of every step (B, S, V)."""
    b, s = tokens.shape
    cache = init_params(0, model.cache_defs(b, s), **CPU)
    outs = []
    with torch.inference_mode(), one_thread():
        cache["cross_k"], cache["cross_v"] = model.prefill_cross(
            params, torch.as_tensor(frames))
        for t in range(s):
            logits, cache = model.decode_step(
                params, cache, torch.as_tensor(tokens[:, t:t + 1]))
            outs.append(logits)
    assert int(cache["idx"][0]) == s
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("n_frames", [16, 300, 600])
def test_decode_steps_match_the_reference_and_the_forward(n_frames):
    """Eight decode steps against the reference's ``decode_step`` step by
    step (rtol 1e-5 / atol 1e-5), and the port's own decode against its
    forward within the reference's decode-consistency 2e-3."""
    jmodel, jparams, model, params = pair(n_frames=n_frames)
    frames, tokens = inputs(model.cfg, s=8)
    got = decode(model, params, frames, tokens)
    jcache = jinit_params(jax.random.PRNGKey(0), jmodel.cache_defs(2, 8))
    jcache["cross_k"], jcache["cross_v"] = jmodel.prefill_cross(
        jparams, jnp.asarray(frames))
    jstep = jax.jit(jmodel.decode_step)
    for t in range(8):
        want, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, t:t + 1]))
        np.testing.assert_allclose(to_np(got[:, t:t + 1]), np.asarray(want),
                                   **PARITY, err_msg=f"step {t}")
    fwd, _ = model(params, torch.as_tensor(tokens), torch.as_tensor(frames))
    assert float((got - fwd).abs().max()) < 2e-3


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_the_reference(remat):
    jmodel, jparams, model, params = pair(remat=remat)
    data = DataConfig(vocab_size=512, seq_len=16, global_batch=2,
                      n_frames=16, d_model=128)
    batch = make_batch(data, 0, **CPU)
    jbatch = {k: jnp.asarray(to_np(v)) for k, v in batch.items()}
    want, jgrads = jax.value_and_grad(jmodel.loss)(jparams, jbatch)
    loss, grads = steps.value_and_grad(model, params, batch)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    jflat = dict(leaves(jax.tree.map(np.asarray, jgrads)))
    flat = dict(leaves(grads))
    assert flat.keys() == jflat.keys()
    for path, w in jflat.items():
        scale = float(np.abs(w).max())
        assert scale > 0, path
        np.testing.assert_allclose(to_np(flat[path]), w, rtol=0,
                                   atol=1e-4 * scale, err_msg=str(path))


def test_pipeline_frames_match_the_reference():
    """The seeded stub frames (``seed * 11 + step``) and the tokens equal
    the reference's bit for bit, for the config the train launcher makes."""
    for step in (0, 3):
        kw = dict(vocab_size=51865, seq_len=8, global_batch=2, seed=5,
                  n_frames=1500, d_model=384)
        got = make_batch(DataConfig(**kw), step, **CPU)
        want = jmake_batch(JDataConfig(**kw), step)
        assert sorted(got) == sorted(want) == ["frames", "labels", "tokens"]
        for k in got:
            np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]))
        assert got["frames"].shape == (2, 1500, 384)


def test_serve_launcher_tokens_equal_the_reference_greedy_decode(capsys):
    """``launch.serve --arch whisper-tiny`` (the static-batch path) gives
    the greedy tokens of the reference's ``decode_step`` on the same numpy
    frames, prompts and weights; every greedy decision has a top-2 gap of
    at least 1e-3 in the port's logits, so the tokens are meaningful."""
    rows, plen, gen = 2, 6, 8
    with one_thread():
        res = serve.main(["--arch", ARCH, "--mesh", "host", "--device", "cpu",
                          "--slots", str(rows), "--prompt-len", "2",
                          str(plen), "--gen", "2", str(gen)])
    assert "static batch of 2 rows" in capsys.readouterr().out
    got = np.array([res["completed"][i] for i in range(rows)])
    assert got.shape == (rows, gen)
    cfg = reduce_for_smoke(get_config(ARCH))
    model = build_model(cfg)
    params = model.init(0, **CPU)
    frames, prompts = serve.static_inputs(cfg, rows, plen, 0)
    seq = np.concatenate([prompts, got[:, :-1]], axis=1)
    logits = decode(model, params, frames, seq)[:, plen - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) >= 1e-3
    jmodel = jbuild_model(jreduce(jget_config(ARCH)))
    jparams = jax.tree.map(lambda t: jnp.asarray(to_np(t)), params)
    jcache = jinit_params(jax.random.PRNGKey(0),
                          jmodel.cache_defs(rows, plen + gen))
    jcache["cross_k"], jcache["cross_v"] = jmodel.prefill_cross(
        jparams, jnp.asarray(frames))
    jstep = jax.jit(jmodel.decode_step)
    for t in range(plen):
        lg, jcache = jstep(jparams, jcache, jnp.asarray(prompts[:, t:t + 1]))
    want = [np.argmax(np.asarray(lg)[:, -1], -1)]
    for _ in range(gen - 1):
        lg, jcache = jstep(jparams, jcache,
                           jnp.asarray(want[-1][:, None].astype(np.int32)))
        want.append(np.argmax(np.asarray(lg)[:, -1], -1))
    np.testing.assert_array_equal(got, np.stack(want, axis=1))


def test_reference_batcher_decodes_an_encdec_model_against_zero_cross_kv():
    """The reference's ``ContinuousBatcher`` never calls ``prefill_cross``
    (ROADMAP §C): with a dense cache it decodes against the all-zero cross
    K/V of ``cache_defs``, the greedy tokens of a decode with no audio at
    all, not those of any frames; with a paged one it fails on the missing
    ``paged_cache_defs``.  The port's batcher refuses the model instead."""
    from repro.serving import ContinuousBatcher as JBatcher
    from repro.serving import Request as JRequest

    jmodel, jparams, _, _ = pair()
    prompt, n_new = [5, 9, 100, 7], 6
    got = JBatcher(jmodel, jparams, slots=2, max_len=16).run(
        [JRequest(0, list(prompt), n_new)])[0]
    frames, _ = inputs(jmodel.cfg, b=1)

    def greedy(cross):
        cache = jinit_params(jax.random.PRNGKey(0), jmodel.cache_defs(1, 16))
        if cross is not None:
            cache["cross_k"], cache["cross_v"] = cross
        for t in prompt:
            lg, cache = jmodel.decode_step(jparams, cache,
                                           jnp.asarray([[t]], jnp.int32))
        toks = []
        for _ in range(n_new):
            toks.append(int(jnp.argmax(lg[0, -1])))
            lg, cache = jmodel.decode_step(
                jparams, cache, jnp.asarray([[toks[-1]]], jnp.int32))
        return toks

    assert got == greedy(None)
    assert got != greedy(jmodel.prefill_cross(jparams, jnp.asarray(frames)))
    with pytest.raises(AttributeError, match="paged_cache_defs"):
        JBatcher(jmodel, jparams, slots=2, max_len=16, kv_cache="paged")


def test_continuous_batcher_refuses_an_encdec_model():
    model = build_model(reduce_for_smoke(get_config(ARCH)))
    params = model.init(0, **CPU)
    with pytest.raises(ValueError, match="static-batch path"):
        ContinuousBatcher(model, params, slots=2, max_len=16, **CPU)
    with pytest.raises(ValueError, match="static-batch path"):
        ContinuousBatcher(model, params, slots=2, max_len=16,
                          kv_cache="paged", **CPU)


def test_train_launcher_runs_whisper_on_the_cpu(tmp_path):
    metrics = train_launcher.main([
        "--arch", ARCH, "--mesh", "host", "--device", "cpu", "--steps", "3",
        "--seq-len", "16", "--global-batch", "2", "--ckpt-dir",
        str(tmp_path)])
    assert [m["step"] for m in metrics] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) for m in metrics)


def test_encdec_on_a_mesh_raises(tmp_path):
    """The encoder-decoder on a mesh (ROADMAP A11.5): the masked loss, a
    decode step and a cut of the self-attention cache's positions run (the
    cross attention's query heads cut, its KV heads whole), and a cache
    length that cut does not divide raises (``_torch_mesh.assert_mesh_runs``;
    tests/test_torch_serve_mesh.py serves it on three meshes); training runs
    with the decoder's lookup and head vocab-parallel and the layers tensor-
    parallel (tests/test_torch_mesh_families.py holds it to the reference),
    and under FSDP (tests/test_torch_fsdp.py)."""
    assert_mesh_runs(reduce_for_smoke(get_config(ARCH)))
    assert_launcher_trains_on_a_mesh(ARCH, "1x2", tmp_path)
