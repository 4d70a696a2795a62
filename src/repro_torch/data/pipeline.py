"""Deterministic synthetic data pipeline.

Counterpart of ``repro.data.pipeline``.  Every batch is a pure function of
(seed, step), so a restarted job regenerates exactly the same stream from
its checkpointed step -- the data-side half of fault tolerance.  The tokens
are made with numpy by the reference's own generator (``_tokens_for``,
copied), so a batch is bit-identical to the reference's for the same
(seed, step), and then moved to the device.

With a ``sharding`` (a ``parallel.specs.NamedSharding`` of the batch) a
rank gets its own rows of the global batch: the rows the spec gives it
along the data axis, cut from the global batch -- the tokens and, by the
same rows, the image embeddings and audio frames -- so a data-parallel run
trains on exactly the single-device run's inputs.  The reference makes
each shard's rows by calling the generator on the shard's row indices
alone, which draws other numbers than the global batch does (ROADMAP §C);
the port does not copy that.

The generator is a tiny LCG-mixed Markov stream (not iid uniform) so the
cross-entropy actually decreases during the example runs.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.kernels.util import resolve_device
from repro_torch.parallel.specs import shard_leaf


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_img_tokens: int = 0
    n_frames: int = 0
    d_model: int = 0


def _tokens_for(cfg: DataConfig, step: int, rows: np.ndarray) -> np.ndarray:
    """Markov-ish tokens for the given global row indices, shape (len(rows), S+1)."""
    rng = np.random.default_rng(np.uint64(cfg.seed * 1_000_003 + step))
    base = rng.integers(0, cfg.vocab_size, size=(len(rows), 1), dtype=np.int64)
    drift = (np.arange(cfg.seq_len + 1, dtype=np.int64) * 7) % 13
    toks = (base + drift[None, :] + rows[:, None] % 5) % cfg.vocab_size
    # inject noise on 10% of positions
    noise = rng.integers(0, cfg.vocab_size, size=toks.shape)
    mask = rng.random(toks.shape) < 0.1
    return np.where(mask, noise, toks).astype(np.int32)


def make_batch(cfg: DataConfig, step: int, sharding=None, *,
               device=None) -> dict:
    """Batch for ``step`` as tensors on ``device`` (CUDA unless named; the
    sharding's mesh device when there is one): int32 ``tokens`` and
    ``labels`` (the tokens shifted by one), and the seeded fp32
    ``img_embeds``/``frames`` when the config asks for them.  Without a
    ``sharding`` the global batch; with one, this rank's rows of each."""
    dev = resolve_device(device if device is not None or sharding is None
                         else sharding.mesh.device)

    def rows(full: np.ndarray) -> torch.Tensor:
        if sharding is not None:
            full = shard_leaf(full, sharding.spec, sharding.mesh)
        return torch.from_numpy(np.ascontiguousarray(full)).to(dev)

    toks = _tokens_for(cfg, step, np.arange(cfg.global_batch))
    batch = {"tokens": rows(toks[:, :-1]), "labels": rows(toks[:, 1:])}
    if cfg.n_img_tokens and cfg.d_model:
        rng = np.random.default_rng(np.uint64(cfg.seed * 7 + step))
        batch["img_embeds"] = rows(rng.standard_normal(
            (cfg.global_batch, cfg.n_img_tokens, cfg.d_model),
            dtype=np.float32))
    if cfg.n_frames and cfg.d_model:
        rng = np.random.default_rng(np.uint64(cfg.seed * 11 + step))
        batch["frames"] = rows(rng.standard_normal(
            (cfg.global_batch, cfg.n_frames, cfg.d_model), dtype=np.float32))
    return batch


def stream(cfg: DataConfig, start_step: int = 0, *,
           device=None) -> Iterator[dict]:
    step = start_step
    while True:
        yield make_batch(cfg, step, device=device)
        step += 1
