"""What the port still refuses on a mesh of ranks, and what it now runs,
for the family tests (``tests/test_torch_{moe,vlm,encdec,hybrid,xlstm}.py``).

``Ranks`` is a mesh as the model's checks see it, without ranks: each
refusal raises before any collective, so no process is spawned for it.
``assemble`` puts the ranks' blocks of a (data, model) mesh back together.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch import api, interop
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import mesh_checks, serve
from repro_torch.launch import train as train_launch
from repro_torch.models import build_model, transformer
from repro_torch.models.params import init_params, map_leaves
from repro_torch.parallel import rules

AXES = ("data", "model")
# the parameter leaves tensor parallelism and the vocab cut: the
# embedding (and an untied head), the attention's, MLP's and experts'
# weights and biases, and the recurrent blocks' columns and heads (the
# Mamba2's, the mLSTM's and the sLSTM's; their B/C group, ``win`` and the
# norms' scales outside the blocks stay whole)
CUT = ("embed", "lm_head", "wq", "wk", "wv", "wo", "bq", "bk", "bv", "wi",
       "wg", "wz", "wx", "wdt", "conv_x", "conv_x_b", "A_log", "D",
       "dt_bias", "gnorm", "wup_x", "wup_z", "conv", "conv_b", "wf", "bi",
       "bf", "r", "b")


def assemble(blocks, spec_, shape):
    """The global array of per-rank ``blocks`` (rank order) laid out by
    ``spec_`` on a (data, model) mesh of ``shape``; ranks that hold the same
    block must hold the same bits."""
    sizes = dict(zip(AXES, shape))
    first = np.asarray(blocks[0])
    dims = rules.dim_axes(spec_, first.ndim)
    full = [first.shape[d] * rules.spec_size(dims[d], sizes)
            for d in range(first.ndim)]
    out = np.full(full, np.nan, dtype=first.dtype) if first.dtype.kind == "f" \
        else np.zeros(full, dtype=first.dtype)
    seen = {}
    for r, b in enumerate(blocks):
        b = np.asarray(b)
        coords = dict(zip(AXES, np.unravel_index(r, shape)))
        where = []
        for d in range(first.ndim):
            idx = 0
            for a in dims[d]:
                idx = idx * sizes[a] + int(coords[a])
            where.append(slice(idx * b.shape[d], (idx + 1) * b.shape[d]))
        key = tuple((s.start, s.stop) for s in where)
        if key in seen:
            np.testing.assert_array_equal(b, seen[key])
        seen[key] = b
        out[tuple(where)] = b
    return out


def assemble_tree(blocks, spec_tree, shape):
    if isinstance(spec_tree, dict):
        return {k: assemble_tree([b[k] for b in blocks], spec_tree[k], shape)
                for k in spec_tree}
    return assemble([interop.to_numpy(b) for b in blocks], spec_tree, shape)


class Ranks:
    axis_names = AXES
    group = None

    def __init__(self, shape=(1, 2)):
        self.shape = shape
        self.size = math.prod(shape)

    @property
    def axis_sizes(self):
        return dict(zip(self.axis_names, self.shape))

    def axis_size(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.axis_sizes[a] for a in axes)

    def index(self, axes):
        """Rank 0's place: a refusal never reads another's."""
        return 0


def assert_mesh_refusals(cfg):
    """On a mesh of two ranks: the masked loss raises
    ``NotImplementedError`` naming ROADMAP A11 under the launchers' rules,
    and so does a decode step whose rules cut the KV cache's positions
    ("cache_seq", flash decoding), both before any collective (no process
    is spawned for them); and a decode step now runs under
    ``rules.decode_rules`` (decoding on a mesh is ported, ROADMAP A11.5):
    two teacher-forced steps on a (1, 2) mesh of gloo ranks on the CPU
    (``launch.mesh_checks.serve``), each step's logits, gathered over the
    vocab ranks, within 1e-5 of their largest magnitude of one device's
    (a tensor-parallel sum reorders fp32 additions;
    tests/test_torch_serve_mesh.py holds every family on three meshes).
    FSDP's rules run since FSDP is ported (``tests/test_torch_fsdp.py``)."""
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=4, global_batch=2,
                      n_img_tokens=cfg.n_img_tokens,
                      n_frames=cfg.n_frames if cfg.family == "encdec" else 0,
                      d_model=cfg.d_model)
    batch = make_batch(data, 0, device="cpu")
    cache = init_params(0, model.cache_defs(2, 8), device="cpu")
    mesh = Ranks((1, 2))
    with api.plan_context(mesh=mesh), \
            rules.use_rules(rules.launcher_rules(cfg), mesh):
        logits = torch.zeros((2, 4, cfg.vocab_size))
        with pytest.raises(NotImplementedError, match="masked loss .* A11"):
            transformer.lm_loss(logits, batch["labels"], cfg,
                                torch.ones((2, 4)))
    flash = rules.make_rules(overrides={"cache_seq": ("model",),
                                        "kv_heads": None})
    with api.plan_context(mesh=mesh), rules.use_rules(flash, mesh):
        with pytest.raises(NotImplementedError,
                           match="'cache_seq' .* flash decoding .* A11"):
            model.decode_step(params, cache, batch["tokens"][:, :1])

    tokens = batch["tokens"][:, :2].to(torch.int32)
    frames = batch.get("frames")
    ranks = mesh_lib.spawn(mesh_checks.run, (1, 2), AXES, device="cpu",
                           args=([("serve", dict(
                               cfg=cfg, tree=map_leaves(interop.to_numpy,
                                                        params),
                               kv_caches=(), replay=tokens.numpy(),
                               frames=(None if frames is None
                                       else frames.numpy())))],))
    with torch.inference_mode():
        want = serve.teacher_forced_logits(model, params, tokens,
                                           frames=frames)
    scale = float(want.abs().max())
    for r in ranks:
        got = r[0]["replay"]
        assert got.shape == want.shape == (2, 2, cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale)


def assert_launcher_trains_on_a_mesh(arch, shape, ckpt_dir):
    """``launch.train --mesh DxM`` on the CPU: one step on every rank, the
    ranks' losses equal and finite."""
    ranks = train_launch.main(["--arch", arch, "--mesh", shape, "--device",
                               "cpu", "--steps", "1", "--seq-len", "16",
                               "--global-batch", "4", "--ckpt-dir",
                               str(ckpt_dir)])
    losses = [[m["loss"] for m in r["metrics"]] for r in ranks]
    assert len(ranks) == math.prod(int(n) for n in shape.split("x"))
    assert all(v == losses[0] for v in losses)
    assert len(losses[0]) == 1 and math.isfinite(losses[0][0])
