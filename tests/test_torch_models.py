"""The port's model stack against the JAX package, on the CPU.

Reduced qwen3-4b (qk-norm, untied head), qwen2-0.5b (QKV bias, tied
embeddings, GQA), minicpm-2b (tied embeddings, the muP-style embed,
residual and logit scales), zamba2-1.2b (the hybrid: Mamba2 and a shared
attention block) and xlstm-1.3b (the ssm family: mLSTM and sLSTM blocks)
-- ``reduce_for_smoke`` on both sides, fp32.  The weights
are made once with numpy from a seed and carried into both packages
(``interop.params_from_jax`` for the port), since the two frameworks'
generators differ.  Every leaf is drawn at random, biases and norm scales
included, so each parameter reaches the logits.  zamba2's weights take the
port's init stds (``TRUE_FAN_IN``): at the reference's fan-in its shared
attention is so ill-conditioned that fp32 reordering moves the logits by
more than the tolerance (tests/test_torch_hybrid.py measures it); so do
xlstm's, whose fp32 logits at the reference's sLSTM fan-in lie at the
tolerance's edge from each other (tests/test_torch_xlstm.py), and so do
pixtral's, whose reduced logits at the reference's attention fan-in (wq std
1/sqrt(4) = 0.5 against 1/sqrt(128)) differ by up to 6.1e-5 between the
two packages, past the tolerance.  pixtral-12b (the vlm
family: the dense decoder, here without its image prefix, which
tests/test_torch_vlm.py holds) is held beside them; whisper-tiny's config
here, its model in tests/test_torch_encdec.py.  Every family is ported, so
no config raises; an unknown family raises ``ValueError``.
Tolerance: fp32 rtol 1e-4 / atol 1e-5 on the logits; both sides compute in
fp32 with other summation orders, and the RMSNorm runs as Pallas in
interpret mode on the JAX side and as the kernel's plain version on the
port's.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_schedule as jget_schedule
from repro.configs import reduce_for_smoke as jreduce
from repro.models import blocks as jblocks
from repro.models import build_model as jbuild_model
from repro.models.params import init_params as jinit_params
from repro_torch import interop
from repro_torch.configs import get_config, get_schedule, reduce_for_smoke
from repro_torch.interop import numpy_params
from repro_torch.models import blocks, build_model
from repro_torch.models.params import init_params, leaves

ARCHS = ["qwen3-4b", "qwen2-0.5b", "zamba2-1.2b", "minicpm-2b", "xlstm-1.3b",
         "pixtral-12b"]
# archs whose parity weights take the port's init stds (module docstring)
TRUE_FAN_IN = {"zamba2-1.2b", "xlstm-1.3b", "pixtral-12b"}
LOGITS = dict(rtol=1e-4, atol=1e-5)




def pair(arch, seed=0, **changes):
    """(jax model, jax params, port model, port params) for a reduced
    ``arch`` with the same numpy weights."""
    jcfg = dataclasses.replace(jreduce(jget_config(arch)), **changes)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)), **changes)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    if arch in TRUE_FAN_IN:
        tree = numpy_params(model.param_defs(), seed, true_fan_in=True)
    else:
        tree = numpy_params(jmodel.param_defs(), seed)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jmodel, jparams, model, interop.params_from_jax(tree, cfg,
                                                           device="cpu")


def to_np(t):
    return interop.to_numpy(t)


def test_reduced_configs_match_the_reference():
    for arch in [*ARCHS, "qwen3-14b", "whisper-tiny"]:
        jcfg, cfg = jreduce(jget_config(arch)), reduce_for_smoke(get_config(arch))
        for f in dataclasses.fields(cfg):
            want = getattr(jcfg, f.name)
            assert getattr(cfg, f.name) == want, (arch, f.name)
        assert cfg.adtype == torch.float32 and cfg.hd == jcfg.hd
        assert cfg.stages() == jcfg.stages()
    full = get_config("qwen3-4b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.hd, full.d_ff, full.vocab_size) == (36, 2560, 32, 8, 128,
                                                     9728, 151936)
    assert full.adtype == torch.bfloat16
    for arch in [*ARCHS, "qwen3-14b", "whisper-tiny"]:  # full, as data
        jfull, full = jget_config(arch), get_config(arch)
        for f in dataclasses.fields(full):
            assert getattr(full, f.name) == getattr(jfull, f.name), (arch,
                                                                     f.name)
        assert full.stages() == jfull.stages()
        assert get_schedule(arch) == jget_schedule(arch)
    assert get_schedule("minicpm-2b") == "wsd"


def test_every_reference_arch_resolves_and_builds():
    from repro.configs import ARCHS as JARCHS
    from repro_torch.configs import ARCHS as PORT_ARCHS
    from repro_torch.models import EncDecLM, LM

    assert sorted(PORT_ARCHS) == sorted(JARCHS) and len(PORT_ARCHS) == 10
    for arch in PORT_ARCHS:
        model = build_model(reduce_for_smoke(get_config(arch)))
        want = EncDecLM if get_config(arch).family == "encdec" else LM
        assert type(model) is want, arch


@pytest.mark.parametrize("where", ["config", "model"])
def test_an_unknown_family_raises(where):
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                              family="conv")
    with pytest.raises(ValueError, match="unknown model family 'conv'"):
        cfg.stages() if where == "config" else build_model(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    jmodel, jparams, model, params = pair(arch)
    tokens = np.random.default_rng(1).integers(0, 512, size=(2, 12))
    want, _ = jax.jit(jmodel.forward)(jparams, jnp.asarray(tokens, jnp.int32))
    got, aux = model(params, torch.as_tensor(tokens))
    assert got.shape == (2, 12, 512) and got.dtype == torch.float32
    assert float(aux) == 0.0
    np.testing.assert_allclose(to_np(got), np.asarray(want), **LOGITS)


def test_chunked_attention_matches_reference():
    """Past one 512-position tile, attention takes the online-softmax loop
    (``_chunked_gqa``) on both sides.  The output sums terms as large as
    its largest entries, so the absolute tolerance is scaled to them (fp32
    cancellation leaves errors relative to that scale, not to each entry)."""
    jmodel, jparams, model, params = pair("qwen2-0.5b")
    s = blocks.ATTN_BLOCK + 9
    x = np.random.default_rng(2).standard_normal((1, s, 128)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)[None]
    p = {k: v[0] for k, v in params["s00_dense"]["attn"].items()}
    jp = jax.tree.map(lambda a: a[0], jparams["s00_dense"]["attn"])
    got = blocks.attention(p, torch.as_tensor(x), model.cfg,
                           positions=torch.as_tensor(pos))
    want = jblocks.attention(jp, jnp.asarray(x), jmodel.cfg,
                             positions=jnp.asarray(pos))
    want = np.asarray(want)
    np.testing.assert_allclose(to_np(got), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def paged_caches(jmodel, model, batch, max_len, page_len):
    """Paged caches of both packages with each row owning its own pages."""
    mp = -(-max_len // page_len)
    n_pages = 1 + batch * mp
    jcache = jinit_params(jax.random.PRNGKey(0), jmodel.paged_cache_defs(
        batch, max_len, n_pages, page_len))
    cache = init_params(0, model.paged_cache_defs(batch, max_len, n_pages,
                                                  page_len), device="cpu")
    table = 1 + np.arange(batch * mp, dtype=np.int32).reshape(batch, mp)
    jcache["pages"] = jnp.asarray(table)
    cache["pages"] = torch.as_tensor(table)
    return jcache, cache


@pytest.mark.parametrize("arch,cache", [("qwen3-4b", "bhsd"),
                                        ("qwen3-4b", "bshd"),
                                        ("qwen3-4b", "paged"),
                                        ("qwen2-0.5b", "bhsd"),
                                        ("qwen2-0.5b", "paged"),
                                        ("zamba2-1.2b", "bshd"),
                                        ("zamba2-1.2b", "paged"),
                                        ("minicpm-2b", "bhsd"),
                                        ("minicpm-2b", "paged"),
                                        ("xlstm-1.3b", "bhsd"),
                                        ("xlstm-1.3b", "paged"),
                                        ("pixtral-12b", "bhsd"),
                                        ("pixtral-12b", "paged")])
def test_decode_step_logits_match_reference(arch, cache):
    layout = "bshd" if cache == "bshd" else "bhsd"
    jmodel, jparams, model, params = pair(arch, kv_cache_layout=layout)
    batch, max_len = 2, 16
    if cache == "paged":
        jc, tc = paged_caches(jmodel, model, batch, max_len, page_len=4)
    else:
        jc = jinit_params(jax.random.PRNGKey(0),
                          jmodel.cache_defs(batch, max_len))
        tc = init_params(0, model.cache_defs(batch, max_len), device="cpu")
    # rows at different depths: continuous batching's ragged co-residency
    start = np.array([0, 3], np.int32)
    jc["idx"], tc["idx"] = jnp.asarray(start), torch.as_tensor(start)
    feed = np.random.default_rng(3).integers(0, 512, size=(6, batch, 1))
    jstep = jax.jit(jmodel.decode_step)
    for t, tok in enumerate(feed):
        want, jc = jstep(jparams, jc, jnp.asarray(tok, jnp.int32))
        got, tc = model.decode_step(params, tc, torch.as_tensor(tok))
        np.testing.assert_allclose(to_np(got), np.asarray(want), **LOGITS,
                                   err_msg=f"{arch} {cache} step {t}")
        np.testing.assert_array_equal(to_np(tc["idx"]), np.asarray(jc["idx"]))


def test_params_from_jax_maps_every_leaf_exactly_once():
    jmodel, _, model, _ = pair("qwen2-0.5b")
    tree = numpy_params(jmodel.param_defs(), 4)
    params = interop.params_from_jax(tree, model.cfg, device="cpu")
    ref_leaves = dict(leaves(tree))
    port_leaves = dict(leaves(params))
    assert ref_leaves.keys() == port_leaves.keys()
    assert len(port_leaves) == len({id(t) for t in port_leaves.values()})
    for path, arr in ref_leaves.items():
        t = port_leaves[path]
        assert tuple(t.shape) == arr.shape, path
        np.testing.assert_array_equal(to_np(t), arr)
    # a missing, an extra and a reshaped leaf are each refused
    broken = numpy_params(jmodel.param_defs(), 4)
    del broken["final_norm"]["scale"]
    with pytest.raises(ValueError, match="missing"):
        interop.params_from_jax(broken, model.cfg, device="cpu")
    broken = numpy_params(jmodel.param_defs(), 4)
    broken["lm_head"] = np.zeros((128, 512), np.float32)
    with pytest.raises(ValueError, match="lm_head"):
        interop.params_from_jax(broken, model.cfg, device="cpu")
    broken = numpy_params(jmodel.param_defs(), 4)
    broken["embed"] = broken["embed"][:, :64]
    with pytest.raises(ValueError, match="embed"):
        interop.params_from_jax(broken, model.cfg, device="cpu")
    bf16 = interop.params_from_jax(tree, model.cfg, device="cpu",
                                   dtype="bfloat16")
    assert all(t.dtype == torch.bfloat16 for _, t in leaves(bf16))


def test_init_is_seeded_and_stable_across_processes():
    """The port's init draws each leaf from a generator seeded by a CRC-32
    of its path, so it does not depend on Python's salted str hash (the
    reference's ``init_params`` folds ``hash(path)`` into its key)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    model = build_model(reduce_for_smoke(get_config("qwen3-4b")))
    a = model.init(7, device="cpu")
    b = model.init(7, device="cpu")
    c = model.init(8, device="cpu")
    for (path, x), (_, y), (_, z) in zip(leaves(a), leaves(b), leaves(c)):
        assert torch.equal(x, y), path
        if path[-1] in ("wq", "embed"):
            assert not torch.equal(x, z), path
    code = ("from repro_torch.configs import get_config, reduce_for_smoke\n"
            "from repro_torch.models import build_model\n"
            "p = build_model(reduce_for_smoke(get_config('qwen3-4b')))"
            ".init(7, device='cpu')\n"
            "print(float(p['embed'].double().sum()))\n")
    root = Path(__file__).resolve().parents[1]
    sums = {subprocess.run([sys.executable, "-c", code], check=True,
                           capture_output=True, text=True, timeout=120,
                           env={**os.environ, "PYTHONPATH": str(root / "src"),
                                "PYTHONHASHSEED": seed}).stdout
            for seed in ("1", "2")}
    assert sums == {f"{float(a['embed'].double().sum())}\n"}


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-4b"])
def test_attention_init_takes_the_true_fan_in(arch):
    """``model.init`` draws the attention weights at 1/sqrt(fan-in) of
    their true input widths (ROADMAP §C, a deliberate divergence from the
    reference, whose ``shape[-2]`` rule gives ``wq`` 1/sqrt(h), ``wk`` and
    ``wv`` 1/sqrt(kh), ``wo`` 1/sqrt(hd)): 1/sqrt(d) for ``wq``, ``wk``
    and ``wv``, 1/sqrt(h * hd) for ``wo``.  The config's attention widths,
    one layer, a cut vocab and MLP (no attention width); qwen3-4b's
    h * hd = 4096 is not its d = 2560, so ``wo``'s rule shows.  The sample
    std of n normal draws lies within a few 1/sqrt(2n) of the true one; the
    smallest leaf, qwen2-0.5b's ``wk``, has 114,688 draws, so 1 % is over
    four sigma."""
    cfg = dataclasses.replace(get_config(arch), n_layers=1, vocab_size=512,
                              d_ff=256, dtype="float32")
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn = build_model(cfg).init(0, device="cpu")["s00_dense"]["attn"]
    want = {"wq": d, "wk": d, "wv": d, "wo": h * hd}
    for name, fan_in in want.items():
        w = attn[name]
        assert w.shape == {"wq": (1, d, h, hd), "wo": (1, h, hd, d)}.get(
            name, (1, d, kh, hd))
        std = float(w.double().std())
        assert std == pytest.approx(1 / math.sqrt(fan_in), rel=1e-2), name
