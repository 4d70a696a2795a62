"""Training launcher of the port: seeded weights, the deterministic data
pipeline, and the fault-tolerant trainer, on one device or on a mesh of
ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --mesh host --device cpu --steps 6
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --mesh 1x2 --steps 4

``--mesh host`` reduces the configuration (``configs.reduce_for_smoke``),
as the reference does; ``--mesh device`` runs the full configuration on the
one card.  ``--mesh DxM`` spawns D x M ranks (``launch.mesh.spawn``), a
(data, model) mesh over which the batch shards by data and the vocabulary
by model (``models.transformer``'s vocab-parallel layout), under
``rules.make_rules(tensor_parallel=False)``; it runs the full configuration
on CUDA (every rank on card 0 when the ranks outnumber the cards, over
gloo) and the reduced one on the CPU, and pads the configuration for the
model axis (``padded_for_mesh``) unless ``--baseline``; a hybrid or ssm
arch (``zamba2-1.2b``, ``xlstm-1.3b``) raises under a model axis of more
than one rank (ROADMAP A11).  The learning-rate schedule is the arch's (``configs.get_schedule``:
``wsd`` for ``minicpm-2b``, ``cosine`` for the others).  The run is on CUDA
unless ``--device cpu``.  ``--layers``/``--d-model`` override the depth and
width.  Checkpoints go under ``--ckpt-dir`` (inside the checkout by
default); a complete checkpoint at or past ``--steps`` restores past the
whole run.  Prints the loss of the first and last steps; on a mesh, a
``spmd:`` line a rank (its backend and collective transport).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--mesh", default="host",
                    help="host, device, or DxM (data x model ranks)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--layers", type=int, default=0, help="override n_layers")
    ap.add_argument("--d-model", type=int, default=0, help="override d_model")
    ap.add_argument("--ckpt-dir", default="build/repro_torch_launch_train")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="steps between checkpoints (default: steps // 4)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", action="store_true",
                    help="on a DxM mesh, skip the layout policy "
                         "(padded_for_mesh)")
    ap.add_argument("--profile", action="store_true",
                    help="on a DxM mesh, profile one more step on rank 0")
    args = ap.parse_args(argv)
    if args.mesh not in ("host", "device"):
        from repro_torch.launch.mesh import parse_shape

        parse_shape(args.mesh)
    return args


def _config(args, on_cuda: bool):
    from repro_torch.configs import get_config, reduce_for_smoke

    cfg = get_config(args.arch)
    if args.mesh == "host" or (args.mesh != "device" and not on_cuda):
        cfg = reduce_for_smoke(cfg)
    if args.mesh not in ("host", "device") and not args.baseline:
        from repro_torch.launch.mesh import parse_shape

        tp = parse_shape(args.mesh)[1]
        if tp > 1:
            cfg, changes = cfg.padded_for_mesh(tp)
            logging.info("layout policy: %s", changes)
    overrides = {}
    if args.layers:
        overrides["n_layers"] = args.layers
    if args.d_model:
        overrides["d_model"] = args.d_model
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def _trainer(args, cfg, device, mesh=None):
    from repro_torch.configs import get_schedule
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedules import make_schedule
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    data = DataConfig(vocab_size=cfg.vocab_logical or cfg.vocab_size,
                      seq_len=args.seq_len, global_batch=args.global_batch)
    return Trainer(
        build_model(cfg), data, AdamWConfig(),
        make_schedule(get_schedule(args.arch), peak=3e-4, warmup=10,
                      total=args.steps),
        TrainerConfig(n_steps=args.steps,
                      ckpt_every=args.ckpt_every or max(args.steps // 4, 1),
                      ckpt_dir=args.ckpt_dir, log_every=5),
        microbatches=args.microbatches, device=device, mesh=mesh)


def _profile_step(trainer, step: int) -> dict:
    """Device time of one more train step by kernel (torch.profiler's CUDA
    activity) beside its CUDA-event time on this rank."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import make_batch

    batch = make_batch(trainer.data_cfg, step, trainer.sharding,
                       device=trainer.device)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        trainer.step_fn(trainer.state, batch)
        end.record()
        end.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: e.device_time_total, reverse=True)
    return {"wall_ms": start.elapsed_time(end),
            "busy_ms": sum(e.device_time_total for e in rows) / 1e3,
            "launches": sum(e.count for e in rows),
            "top": [(e.key[:48], e.device_time_total / 1e3, e.count)
                    for e in rows[:8]]}


def rank_main(mesh, args) -> dict:
    """One rank of a ``--mesh DxM`` run: its ``Trainer`` on the mesh, then
    what the rank saw -- its metrics, kernel launches, collectives
    (``Mesh.comm``, checkpoint gathers included), peak device memory,
    the digests of the leaves every rank must hold bit for bit, and with
    ``--profile`` one more step profiled on rank 0, with its collectives."""
    import torch

    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.xent import kernel as xent_kernel
    from repro_torch.launch.mesh_checks import digests

    logging.basicConfig(level=logging.INFO,
                        format=f"%(asctime)s rank {mesh.rank} %(name)s "
                               f"%(message)s")
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    trainer = _trainer(args, _config(args, cuda), mesh.device, mesh)
    for table in (xent_kernel.LAUNCHES, rms_kernel.LAUNCHES):
        for k in table:
            table[k] = 0
    mesh.comm.update(calls=0, bytes=0, seconds=0.0)
    metrics = trainer.train(args.seed)
    out = {
        "rank": mesh.rank, "coords": mesh.coords, "backend": mesh.backend,
        "transport": mesh.transport, "comm": dict(mesh.comm),
        "metrics": metrics,
        "launches": {"xent.partial": xent_kernel.LAUNCHES["xent.partial"],
                     "xent": xent_kernel.LAUNCHES["xent"],
                     "rmsnorm": rms_kernel.LAUNCHES["plain"]},
        "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
        "digests": digests(trainer.state, trainer.specs, mesh.axis_sizes),
    }
    if args.profile and cuda:
        before = dict(mesh.comm)
        prof = _profile_step(trainer, args.steps)
        prof["comm"] = {k: mesh.comm[k] - before[k] for k in before}
        out["profile"] = prof if mesh.rank == 0 else None
    return out


def main(argv=None):
    """Run the launcher; returns the metrics of a one-device run, or the
    list of each rank's ``rank_main`` result on a mesh."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    import torch

    from repro_torch import api
    from repro_torch.kernels.util import resolve_device
    from repro_torch.models.params import leaves

    device = resolve_device(args.device)
    # fp32 matmuls in full precision, never TF32 (the reduced configs are fp32)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.mesh not in ("host", "device"):
        return _main_mesh(args, device)
    cfg = _config(args, device.type == "cuda")
    trainer = _trainer(args, cfg, device)
    n_params = sum(t.numel() for _, t in
                   leaves(trainer.model.abstract_params()))
    logging.info("arch=%s params=%.1fM mesh=%s device=%s", cfg.name,
                 n_params / 1e6, args.mesh, device)
    print(api.explain("xent", (args.global_batch * args.seq_len,
                               cfg.vocab_size), torch.float32))
    metrics = trainer.train(args.seed)
    _report(metrics, args)
    return metrics


def _main_mesh(args, device):
    from repro_torch.launch import mesh as mesh_lib

    from repro_torch.models.transformer import require_mesh_ported

    shape = mesh_lib.parse_shape(args.mesh)
    require_mesh_ported(_config(args, device.type == "cuda"),
                        {"data": shape[0], "model": shape[1]})
    if device.type == "cuda":
        from repro_torch.kernels import _build

        _build.build()     # once here, not once a rank
    results = mesh_lib.spawn(rank_main, shape, ("data", "model"),
                             device=str(device), args=(args,))
    for r in results:
        print(f"spmd: rank {r['rank']} at {r['coords']} of mesh "
              f"{dict(zip(('data', 'model'), shape))}: backend {r['backend']}"
              f", collective transport {r['transport']}, launches "
              f"{r['launches']}")
    _report(results[0]["metrics"], args)
    return results


def _report(metrics, args) -> None:
    if metrics:
        print(f"done: {len(metrics)} steps, "
              f"loss {metrics[0]['loss']:.3f} -> {metrics[-1]['loss']:.3f}")
    else:
        print(f"done: 0 steps (checkpoint in {args.ckpt_dir} already at "
              f"step >= {args.steps}; clear it or raise --steps)")


if __name__ == "__main__":
    main()
