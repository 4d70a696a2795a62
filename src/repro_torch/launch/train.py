"""Training launcher of the port: seeded weights, the deterministic data
pipeline, and the fault-tolerant trainer.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --mesh host --device cpu --steps 6

``--mesh host`` reduces the configuration (``configs.reduce_for_smoke``),
as the reference does; ``--mesh device`` runs the full configuration on the
one card, standing in for the reference's ``pod``/``multipod`` meshes until
the SPMD slice (ROADMAP A11).  The run is on CUDA unless ``--device cpu``.
``--layers``/``--d-model`` override the depth and width.  Checkpoints go
under ``--ckpt-dir`` (inside the checkout by default); a complete
checkpoint at or past ``--steps`` restores past the whole run.  Prints the
loss of the first and last steps.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--mesh", choices=["host", "device"], default="host")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--layers", type=int, default=0, help="override n_layers")
    ap.add_argument("--d-model", type=int, default=0, help="override d_model")
    ap.add_argument("--ckpt-dir", default="build/repro_torch_launch_train")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    import torch

    from repro_torch import api
    from repro_torch.configs import get_config, get_schedule, reduce_for_smoke
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels.util import resolve_device
    from repro_torch.models import build_model
    from repro_torch.models.params import leaves
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedules import make_schedule
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    device = resolve_device(args.device)
    # fp32 matmuls in full precision, never TF32 (the reduced configs are fp32)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.mesh == "host":
        cfg = reduce_for_smoke(cfg)
    overrides = {}
    if args.layers:
        overrides["n_layers"] = args.layers
    if args.d_model:
        overrides["d_model"] = args.d_model
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    model = build_model(cfg)
    n_params = sum(t.numel() for _, t in leaves(model.abstract_params()))
    logging.info("arch=%s params=%.1fM mesh=%s device=%s", cfg.name,
                 n_params / 1e6, args.mesh, device)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.global_batch)
    trainer = Trainer(
        model, data, AdamWConfig(),
        make_schedule(get_schedule(args.arch), peak=3e-4, warmup=10,
                      total=args.steps),
        TrainerConfig(n_steps=args.steps, ckpt_every=max(args.steps // 4, 1),
                      ckpt_dir=args.ckpt_dir, log_every=5),
        microbatches=args.microbatches, device=device)
    print(api.explain("xent", (args.global_batch * args.seq_len,
                               cfg.vocab_size), torch.float32))
    metrics = trainer.train(args.seed)
    if metrics:
        print(f"done: {len(metrics)} steps, "
              f"loss {metrics[0]['loss']:.3f} -> {metrics[-1]['loss']:.3f}")
    else:
        print(f"done: 0 steps (checkpoint in {args.ckpt_dir} already at "
              f"step >= {args.steps}; clear it or raise --steps)")
    return metrics


if __name__ == "__main__":
    main()
