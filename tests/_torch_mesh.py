"""What the port still refuses on a mesh of ranks, and what it now runs,
for the family tests (``tests/test_torch_{moe,vlm,encdec,hybrid,xlstm}.py``).

``TwoRanks`` is a (1, 2) mesh as the model's checks see it, without ranks:
each refusal raises before any collective, so no process is spawned.
"""
import math

import pytest
import torch

from repro_torch import api
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import train as train_launch
from repro_torch.models import build_model, transformer
from repro_torch.models.params import init_params
from repro_torch.parallel import rules


class TwoRanks:
    axis_names = ("data", "model")
    shape = (1, 2)
    size = 2
    group = None

    @property
    def axis_sizes(self):
        return dict(zip(self.axis_names, self.shape))


def assert_mesh_refusals(cfg):
    """On a mesh of two ranks: the loss under the tensor-parallel rules
    (heads, MLP and experts sharded), a decode step, and the masked loss
    each raise ``NotImplementedError`` naming ROADMAP A11."""
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=4, global_batch=2,
                      n_img_tokens=cfg.n_img_tokens,
                      n_frames=cfg.n_frames if cfg.family == "encdec" else 0,
                      d_model=cfg.d_model)
    batch = make_batch(data, 0, device="cpu")
    cache = init_params(0, model.cache_defs(2, 8), device="cpu")
    mesh = TwoRanks()
    with api.plan_context(mesh=mesh):
        with rules.use_rules(rules.make_rules(), mesh):
            with pytest.raises(NotImplementedError,
                               match="tensor parallelism .* A11"):
                model.loss(params, batch)
        with rules.use_rules(rules.make_rules(tensor_parallel=False), mesh):
            with pytest.raises(NotImplementedError,
                               match="decoding on a mesh .* A11"):
                model.decode_step(params, cache, batch["tokens"][:, :1])
            logits = torch.zeros((2, 4, cfg.vocab_size))
            with pytest.raises(NotImplementedError,
                               match="masked loss .* A11"):
                transformer.lm_loss(logits, batch["labels"], cfg,
                                    torch.ones((2, 4)))


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
