"""The port's VLM family (pixtral-12b: the dense decoder behind a prefix of
image embeddings) against the JAX package's, on the CPU.

Reduced pixtral-12b (``reduce_for_smoke`` on both sides: 4 layers, d 128,
4/4 heads of 32, 8 image tokens, vocab 512; the full config's q width 4096
is not its d 5120), fp32, the same numpy
weights in both packages (``interop.numpy_params`` with the port's true
fan-ins).  The forward takes the prefix through ``prefix_embeds`` and the
loss through the batch's ``img_embeds``, as the reference's ``LM`` does;
at 512 text tokens the 520 positions take the chunked attention path on
both sides.

Tolerances: the logits rtol 1e-5 / atol 1e-5 (fp32 on both sides in other
summation orders; RMSNorm runs as Pallas in interpret mode on the JAX side
and as B9's plain version on the port's); the loss rtol 1e-5, every
gradient leaf within 1e-4 of its largest magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import build_model as jbuild_model
from repro.models.params import param_count as jparam_count
from repro_torch import interop
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.interop import numpy_params
from repro_torch.launch import train as train_launcher
from repro_torch.models import LM, build_model
from repro_torch.models.params import leaves
from repro_torch.parallel import steps
from repro_torch.parallel.steps import make_prefill_step
from _torch_mesh import assert_launcher_trains_on_a_mesh, assert_mesh_runs

ARCH = "pixtral-12b"
CPU = dict(device="cpu")
PARITY = dict(rtol=1e-5, atol=1e-5)


def pair(seed=0, **changes):
    """(jax model, jax params, port model, port params) for the reduced
    pixtral-12b with the same numpy weights."""
    jcfg = dataclasses.replace(jreduce(jget_config(ARCH)), **changes)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH)), **changes)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    tree = numpy_params(model.param_defs(), seed, true_fan_in=True)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jmodel, jparams, model, interop.params_from_jax(tree, cfg, **CPU)


def to_np(t):
    return interop.to_numpy(t)


def test_configs_and_trees_match_the_reference():
    for jcfg, cfg in [(jget_config(ARCH), get_config(ARCH)),
                      (jreduce(jget_config(ARCH)),
                       reduce_for_smoke(get_config(ARCH)))]:
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert cfg.stages() == jcfg.stages() == [("dense", cfg.n_layers)]
        jmodel, model = jbuild_model(jcfg), build_model(cfg)
        assert isinstance(model, LM)
        want = {p: tuple(d.shape) for p, d in leaves(jmodel.param_defs())}
        assert {p: tuple(d.shape)
                for p, d in leaves(model.param_defs())} == want
    full = get_config(ARCH)
    # the q width is not d: no code may assume n_heads * hd == d_model
    assert (full.n_heads * full.hd, full.d_model) == (4096, 5120)
    assert reduce_for_smoke(full).n_img_tokens == 8


def test_full_width_parameter_count_matches_the_reference():
    """12,247,782,400 parameters (272,640,000 a layer, the untied
    embedding and head 671,088,640 each): about 24.5 GB in bf16."""
    full = get_config(ARCH)
    got = sum(int(np.prod(t.shape)) for _, t in
              leaves(build_model(full).abstract_params()))
    assert got == jparam_count(jbuild_model(jget_config(ARCH)).param_defs())
    assert got == 40 * 272_640_000 + 2 * 671_088_640 + 5120
    assert 11.0e9 < got < 13.5e9


def test_the_attention_init_takes_the_true_fan_in_at_pixtral_width():
    """``wo`` (h, hd, d) draws 1/sqrt(h * hd) = 1/sqrt(4096), not
    1/sqrt(d) (ROADMAP §C), at pixtral's attention widths (one layer)."""
    import math

    cfg = dataclasses.replace(get_config(ARCH), n_layers=1, vocab_size=512,
                              d_ff=256, dtype="float32")
    attn = build_model(cfg).init(0, **CPU)["s00_dense"]["attn"]
    assert attn["wo"].shape == (1, 32, 128, 5120)
    for name, fan_in in {"wq": 5120, "wk": 5120, "wo": 4096}.items():
        std = float(attn[name].double().std())
        assert std == pytest.approx(1 / math.sqrt(fan_in), rel=1e-2), name


def test_the_fan_in_gap_lies_inside_the_references_own_sensitivity():
    """Why pixtral's parity weights take the true fan-ins
    (tests/test_torch_models.py ``TRUE_FAN_IN``).  At the reference's
    attention fan-in (``shape[-2]``: wq std 1/sqrt(4) on a 128-wide input)
    the two packages' reduced logits differ by about 6.1e-5, past the
    parity tolerance.  That is the model's conditioning, not a fault of
    the port: one rounding's worth of change to every weight (each scaled
    by 1 + s 2**-24 with random signs s, in float64, rounded back to fp32)
    moves the reference's own logits by more than that gap, 0.9e-4 to
    2.3e-4 over three draws.  At the true fan-ins the same change moves
    them by about 5e-6, and the packages agree within the tolerance (3.2e-6
    apart).  fp32 on the CPU, seed-0 numpy weights, the tokens of
    tests/test_torch_models.py's ``test_forward_logits_match_reference``."""
    jmodel = jbuild_model(jreduce(jget_config(ARCH)))
    model = build_model(reduce_for_smoke(get_config(ARCH)))
    tokens = np.random.default_rng(1).integers(0, 512, size=(2, 12))
    jtokens = jnp.asarray(tokens, jnp.int32)
    forward = jax.jit(jmodel.forward)
    rng = np.random.default_rng(0)

    def nudged(tree):
        return jax.tree.map(lambda w: (w.astype(np.float64) * (
            1 + rng.choice([-1.0, 1.0], size=w.shape) * 2.0 ** -24)).astype(
                w.dtype), tree)

    for true_fan_in in (False, True):
        defs = model.param_defs() if true_fan_in else jmodel.param_defs()
        tree = numpy_params(defs, 0, true_fan_in=true_fan_in)
        want = np.asarray(forward(jax.tree.map(jnp.asarray, tree),
                                  jtokens)[0])
        got, _ = model(interop.params_from_jax(tree, model.cfg, **CPU),
                       torch.as_tensor(tokens))
        gap = float(np.abs(to_np(got) - want).max())
        move = max(float(np.abs(np.asarray(forward(
            jax.tree.map(jnp.asarray, nudged(tree)), jtokens)[0]) - want).max())
            for _ in range(3))
        if true_fan_in:
            np.testing.assert_allclose(to_np(got), want, rtol=1e-4,
                                       atol=1e-5)
        else:
            assert move > gap > 1e-5, (move, gap)


@pytest.mark.parametrize("s", [16, 512])
def test_prefix_forward_matches_the_reference(s):
    jmodel, jparams, model, params = pair()
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 512, size=(2, s)).astype(np.int32)
    img = rng.standard_normal((2, 8, 128), dtype=np.float32)
    want, _ = jax.jit(jmodel.forward)(jparams, jnp.asarray(tokens),
                                      jnp.asarray(img))
    got, aux = model(params, torch.as_tensor(tokens), torch.as_tensor(img))
    assert got.shape == (2, s, 512) and float(aux) == 0.0
    np.testing.assert_allclose(to_np(got), np.asarray(want), **PARITY)
    # the prefix reaches the text's logits
    plain, _ = model(params, torch.as_tensor(tokens))
    assert float((plain - got).abs().max()) > 1e-3
    # the prefill step reads the batch's img_embeds
    last = make_prefill_step(model)(params, {
        "tokens": torch.as_tensor(tokens), "img_embeds": torch.as_tensor(img)})
    assert torch.equal(last, got[:, -1])


def test_prefix_is_cast_to_the_activation_dtype():
    """In bf16 the fp32 prefix is rounded to bf16 before it enters the
    decoder: the same logits as a prefix handed over in bf16."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH)),
                              dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(0, **CPU)
    gen = torch.Generator().manual_seed(2)
    img = torch.randn(1, 8, 128, generator=gen)
    tokens = torch.randint(0, 512, (1, 6), generator=gen)
    with torch.no_grad():
        a, _ = model(params, tokens, img)
        b, _ = model(params, tokens, img.to(torch.bfloat16))
    assert a.dtype == torch.float32 and a.shape == (1, 6, 512)
    assert torch.equal(a, b)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_the_reference(remat):
    jmodel, jparams, model, params = pair(remat=remat)
    data = DataConfig(vocab_size=512, seq_len=16, global_batch=2,
                      n_img_tokens=8, d_model=128)
    batch = make_batch(data, 0, **CPU)
    assert batch["img_embeds"].shape == (2, 8, 128)
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


def test_pipeline_image_embeddings_match_the_reference():
    """The seeded stub image embeddings (``seed * 7 + step``) and the
    tokens equal the reference's bit for bit."""
    for step in (0, 5):
        kw = dict(vocab_size=131072, seq_len=8, global_batch=2, seed=3,
                  n_img_tokens=1024, d_model=64)
        got = make_batch(DataConfig(**kw), step, **CPU)
        want = jmake_batch(JDataConfig(**kw), step)
        assert sorted(got) == sorted(want) == ["img_embeds", "labels",
                                               "tokens"]
        for k in got:
            np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]))


def test_train_launcher_runs_pixtral_on_the_cpu(tmp_path):
    metrics = train_launcher.main([
        "--arch", ARCH, "--mesh", "host", "--device", "cpu", "--steps", "3",
        "--seq-len", "16", "--global-batch", "2", "--ckpt-dir",
        str(tmp_path)])
    assert [m["step"] for m in metrics] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) for m in metrics)


def test_vlm_on_a_mesh_raises(tmp_path):
    """The vlm on a mesh (ROADMAP A11.5): the masked loss, a decode step and
    a cut of the cache's positions run, and a cache length that cut does not
    divide raises (``_torch_mesh.assert_mesh_runs``;
    tests/test_torch_serve_mesh.py serves it on three meshes); training runs,
    a rank on its rows of the image
    embeddings, tensor-parallel on a model axis
    (tests/test_torch_mesh_families.py holds it to the reference), and under
    FSDP (tests/test_torch_fsdp.py)."""
    assert_mesh_runs(reduce_for_smoke(get_config(ARCH)))
    assert_launcher_trains_on_a_mesh(ARCH, "2x1", tmp_path)
