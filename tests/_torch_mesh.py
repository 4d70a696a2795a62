"""What the port runs on a mesh of ranks, and what it still refuses, for
the family tests (``tests/test_torch_{moe,vlm,encdec,hybrid,xlstm}.py``).

``Ranks`` is a mesh as the model's checks see it, without ranks: each
refusal raises before any collective, so no process is spawned for it.
``assemble`` puts the ranks' blocks of a (data, model) mesh back together.
"""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import api, interop
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import mesh_checks, serve
from repro_torch.launch import train as train_launch
from repro_torch.models import build_model
from repro_torch.models.params import leaves, map_leaves
from repro_torch.parallel import rules, steps

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


def assert_mesh_runs(cfg):
    """On a mesh of two ranks (ROADMAP A11.5): a KV cache of a length the
    flash-decoding cut does not divide raises ``NotImplementedError``
    naming ROADMAP A11 before any collective (no process is spawned for
    it; a family with no KV cache has nothing to cut); then, on a (1, 2)
    mesh of gloo ranks on the CPU (``launch.mesh_checks``), two
    teacher-forced decode steps under ``rules.decode_rules`` and again
    under the flash-decoding override ``{"cache_seq": ("model",),
    "kv_heads": None}`` (the cache's positions cut over the two ranks, the
    softmax's partials combined), each step's logits, gathered over the
    vocab ranks, within 1e-5 of their largest magnitude of one device's (a
    tensor-parallel sum reorders fp32 additions;
    tests/test_torch_serve_mesh.py and tests/test_torch_flash_decode.py
    hold the families on more meshes), and the masked loss under the
    launchers' rules and its gradient, every leaf within 1e-5 of its
    largest magnitude of one device's.  FSDP's rules run since FSDP is
    ported (``tests/test_torch_fsdp.py``)."""
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=4, global_batch=2,
                      n_img_tokens=cfg.n_img_tokens,
                      n_frames=cfg.n_frames if cfg.family == "encdec" else 0,
                      d_model=cfg.d_model)
    batch = make_batch(data, 0, device="cpu")
    mesh = Ranks((1, 2))
    flash = rules.make_rules(overrides={"cache_seq": ("model",),
                                        "kv_heads": None})
    if cfg.family != "ssm":
        with api.plan_context(mesh=mesh), rules.use_rules(flash, mesh):
            with pytest.raises(NotImplementedError,
                               match="7 positions .* 2 ways.* A11"):
                serve.mesh_cache(model, model.cache_defs(2, 7), "cpu")
    mask = np.array([[1, 0, 1, 1], [0, 1, 1, 0]], np.float32)

    tokens = batch["tokens"][:, :2].to(torch.int32)
    frames = batch.get("frames")
    tree = map_leaves(interop.to_numpy, params)
    serve_kw = dict(cfg=cfg, tree=tree, kv_caches=(), replay=tokens.numpy(),
                    frames=None if frames is None else frames.numpy())
    ranks = mesh_lib.spawn(mesh_checks.run, (1, 2), AXES, device="cpu",
                           args=([("serve", serve_kw),
                                  ("serve", dict(serve_kw, rules=flash)),
                                  ("seeded_grads", dict(
                                      cfg=cfg, seed=0, data_cfg=data,
                                      mask=mask))],))
    with torch.inference_mode():
        want = serve.teacher_forced_logits(model, params, tokens,
                                           frames=frames)
    scale = float(want.abs().max())
    for r in ranks:
        for got in (r[0]["replay"], r[1]["replay"]):
            assert got.shape == want.shape == (2, 2, cfg.vocab_size)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-5 * scale)
    loss, grads = steps.value_and_grad(
        model, params, dict(batch, mask=torch.from_numpy(mask)))
    for r in ranks:
        assert r[2]["loss0"] == pytest.approx(float(loss), rel=1e-5)
    for path, g in leaves(grads):
        if g is None:       # an integer leaf (the MoE's perm tables)
            continue
        spec_, blocks = ranks[0][2]["specs"], [r[2]["grads0"] for r in ranks]
        for k in path:
            spec_, blocks = spec_[k], [b[k] for b in blocks]
        want_g = g.numpy()
        np.testing.assert_allclose(
            assemble([b.numpy() for b in blocks], spec_, (1, 2)), want_g,
            rtol=0, atol=1e-5 * float(np.abs(want_g).max()) + 1e-12)


def assert_launcher_trains_on_a_mesh(arch, shape, ckpt_dir):
    """``launch.train --mesh DxM --obs-jsonl`` on the CPU: one step on every
    rank, the ranks' losses equal and finite; rank 0 alone streams, its
    one ``train_step`` record carrying the step's loss."""
    stream = Path(ckpt_dir) / "obs.jsonl"
    ranks = train_launch.main(["--arch", arch, "--mesh", shape, "--device",
                               "cpu", "--steps", "1", "--seq-len", "16",
                               "--global-batch", "4", "--ckpt-dir",
                               str(ckpt_dir), "--obs-jsonl", str(stream)])
    losses = [[m["loss"] for m in r["metrics"]] for r in ranks]
    assert len(ranks) == math.prod(int(n) for n in shape.split("x"))
    assert all(v == losses[0] for v in losses)
    assert len(losses[0]) == 1 and math.isfinite(losses[0][0])
    records = [json.loads(x) for x in stream.read_text().splitlines()]
    assert [r["loss"] for r in records if r["kind"] == "train_step"] == \
        losses[0]
    assert ranks[0]["obs"] == {"enabled": True, "records": len(records)}
    assert all(r["obs"] == {"enabled": False, "records": 0}
               for r in ranks[1:])
