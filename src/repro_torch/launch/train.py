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
by model (``models.transformer``'s vocab-parallel layout), and the heads,
KV heads, MLP, experts and recurrent blocks' columns by model too (tensor
parallelism: ``models.blocks``, ``models.moe``, ``models.mamba2``,
``models.xlstm``), under ``rules.launcher_rules(cfg)``: the reference's
``make_rules(fsdp=cfg.fsdp, expert_tp=cfg.expert_tp)``.  Under a config's
``fsdp`` (qwen3-14b, pixtral-12b, qwen3-moe-30b-a3b, grok-1-314b) every
"embed" dim of the parameters, the moments and the master copy is cut over
"data" too (FSDP, ROADMAP A11.5): a rank draws each leaf whole and keeps
its block, a layer gathers its weights whole in its forward (and again in
remat's recomputation), and the gathers' backward reduce-scatters the
gradients.  The reduced configurations have ``fsdp`` off, as the
reference's.  It runs the full configuration on CUDA (every rank on card 0
when the ranks outnumber the cards, over gloo) and the reduced one on the
CPU, and pads the configuration for the model axis (``padded_for_mesh``)
unless ``--baseline``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \
        --mesh 2x1 --layers 2 --steps 2 --seq-len 1024 --global-batch 4


    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \\
        --mesh 2x1 --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \\
        --mesh 1x2 --steps 4 --seq-len 448

A vlm batch carries seeded image embeddings and an encdec batch seeded
audio frames, a rank its rows of them (``data.pipeline``).  The
learning-rate schedule is the arch's (``configs.get_schedule``: ``wsd``
for ``minicpm-2b``, ``cosine`` for the others).  The run is on CUDA
unless ``--device cpu``.  ``--layers``/``--d-model`` override the depth and
width.  Checkpoints go under ``--ckpt-dir`` (inside the checkout by
default); a complete checkpoint at or past ``--steps`` restores past the
whole run.  Prints the loss of the first and last steps; on a mesh, a
``spmd:`` line a rank (its backend and collective transport).

``--obs-jsonl PATH`` streams the run's events (plan-cache provenance,
SPMD fallbacks, per-step metrics, checkpoints) to a record-per-line file,
as the reference's launcher does; aggregate it with ``python -m
repro_torch.obs.report PATH``.  On a mesh only rank 0 opens the file: all
ranks run one schedule, so its stream is the run's, and every other rank
keeps the bus's NullSink default.

``--plan-profile PATH`` replays a measured plan profile
(``python -m repro_torch.measure.sweep`` output): its swept cells override
the analytic planner for the run (``PlanContext.from_profile``).  On a
mesh the cells are one rank's shard shapes, the shapes the SPMD launch
plans (``measure.sweep --mesh DxM``); every rank loads the file.
"""
from __future__ import annotations

import argparse
import contextlib
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
    ap.add_argument("--obs-jsonl", default=None,
                    help="stream observability events (plan cache, SPMD "
                         "fallbacks, step metrics) to this JSONL file; on a "
                         "mesh rank 0 writes it; aggregate with python -m "
                         "repro_torch.obs.report")
    ap.add_argument("--plan-profile", default=None,
                    help="measured plan profile (repro_torch.measure.sweep "
                         "output); its swept cells override the analytic "
                         "planner (on a mesh, cells match per-shard local "
                         "shapes)")
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


def schedule(args):
    """The run's learning rate by step: the arch's schedule, peak 3e-4,
    10 warmup steps, over ``--steps``."""
    from repro_torch.configs import get_schedule
    from repro_torch.optim.schedules import make_schedule

    return make_schedule(get_schedule(args.arch), peak=3e-4, warmup=10,
                         total=args.steps)


def _trainer(args, cfg, device, mesh=None):
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    # the vlm's image embeddings and the encdec's frames, seeded stubs
    data = DataConfig(vocab_size=cfg.vocab_logical or cfg.vocab_size,
                      seq_len=args.seq_len, global_batch=args.global_batch,
                      n_img_tokens=cfg.n_img_tokens,
                      n_frames=cfg.n_frames if cfg.family == "encdec" else 0,
                      d_model=cfg.d_model)
    return Trainer(
        build_model(cfg), data, AdamWConfig(), schedule(args),
        TrainerConfig(n_steps=args.steps,
                      ckpt_every=args.ckpt_every or max(args.steps // 4, 1),
                      ckpt_dir=args.ckpt_dir, log_every=5),
        microbatches=args.microbatches, device=device, mesh=mesh)


@contextlib.contextmanager
def _obs_scope(args, rank: int = 0):
    """The run's event stream: a session writing ``--obs-jsonl`` on rank
    0, else the bus's NullSink default.  Yields the sink, or ``None``."""
    from repro_torch import obs

    if not args.obs_jsonl or rank != 0:
        yield None
        return
    with obs.JsonlSink(args.obs_jsonl) as sink, obs.session(sink):
        yield sink


@contextlib.contextmanager
def plan_profile_scope(path: str | None):
    """The run's plan overrides: a measured profile's cells
    (``--plan-profile``), loaded strictly, else none.  Without a profile
    ``plan_overrides`` stays unspecified: an explicit ``None`` would clear
    the pins an enclosing context holds."""
    if not path:
        yield
        return
    from repro_torch import api
    from repro_torch.measure.profile import load_profile

    overrides = load_profile(path)
    logging.info("plan profile %s: %d swept cell(s)", path, len(overrides))
    with api.plan_context(plan_overrides=overrides):
        yield


def _profile_step(trainer, step: int) -> dict:
    """Device time of one more train step by kernel (torch.profiler's CUDA
    activity) beside its CUDA-event time on this rank, and the host
    seconds the profile took, its post-processing included.  The host's
    operators are not recorded: an sLSTM step launches 10^5 kernels, whose
    operator events would take minutes to aggregate."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import make_batch

    t0 = time.perf_counter()
    batch = make_batch(trainer.data_cfg, step, trainer.sharding,
                       device=trainer.device)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
                    for e in rows[:8]],
            "seconds": time.perf_counter() - t0}


def rank_main(mesh, args) -> dict:
    """One rank of a ``--mesh DxM`` run: its ``Trainer`` on the mesh (rank 0
    streaming to ``--obs-jsonl``), then what the rank saw -- its metrics,
    kernel launches, collectives (``Mesh.comm``, checkpoint gathers
    included; the reduce-scatter's transport), peak device memory, the
    shapes of its blocks of the state (``"params/..."``, ``"opt/m/..."``,
    ...), its saves' seconds, the digests of the leaves every rank must
    hold bit for bit, whether its bus listened and the records it wrote
    (``"obs"``), and with ``--profile`` one more step profiled on rank 0
    (the state donated to it), with its collectives."""
    import torch

    from repro_torch import obs
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.xent import kernel as xent_kernel
    from repro_torch.launch.mesh_checks import digests
    from repro_torch.models.params import leaves

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
    with _obs_scope(args, mesh.rank) as sink, \
            plan_profile_scope(args.plan_profile):
        metrics = trainer.train(args.seed)
        streamed = obs.enabled()
    out = {
        "rank": mesh.rank, "coords": mesh.coords, "backend": mesh.backend,
        "transport": mesh.transport, "comm": dict(mesh.comm),
        "reduce_scatter_transport": mesh.reduce_scatter_transport,
        "metrics": metrics,
        "launches": {"xent.partial": xent_kernel.LAUNCHES["xent.partial"],
                     "xent": xent_kernel.LAUNCHES["xent"],
                     "rmsnorm": rms_kernel.LAUNCHES["plain"],
                     **{f"rmsnorm.{k}": v for k, v in
                        rms_kernel.LAUNCHES.items() if k != "plain"}},
        "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
        "state_shapes": {"/".join(p): tuple(t.shape)
                         for p, t in leaves(trainer.state)},
        "saves": trainer.saves,
        "digests": digests(trainer.state, trainer.specs, mesh.axis_sizes),
        # whether this rank's bus listened while it trained, and the
        # records it wrote: rank 0 alone streams
        "obs": {"enabled": streamed,
                "records": 0 if sink is None else sink.emitted},
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
    with _obs_scope(args), plan_profile_scope(args.plan_profile):
        metrics = trainer.train(args.seed)
    _report(metrics, args)
    return metrics


def _main_mesh(args, device):
    from repro_torch.launch import mesh as mesh_lib

    shape = mesh_lib.parse_shape(args.mesh)
    if device.type == "cuda":
        from repro_torch.kernels import _build

        _build.build()     # once here, not once a rank
    results = mesh_lib.spawn(rank_main, shape, ("data", "model"),
                             device=str(device), args=(args,))
    for r in results:
        print(f"spmd: rank {r['rank']} at {r['coords']} of mesh "
              f"{dict(zip(('data', 'model'), shape))}: backend {r['backend']}"
              f", collective transport {r['transport']} (a reduce-scatter "
              f"as {r['reduce_scatter_transport']}), launches "
              f"{r['launches']}")
    _report(results[0]["metrics"], args)
    return results


def _report(metrics, args) -> None:
    if args.obs_jsonl:
        logging.info("obs event stream at %s (summarize: python -m "
                     "repro_torch.obs.report %s)", args.obs_jsonl,
                     args.obs_jsonl)
    if metrics:
        print(f"done: {len(metrics)} steps, "
              f"loss {metrics[0]['loss']:.3f} -> {metrics[-1]['loss']:.3f}")
    else:
        print(f"done: 0 steps (checkpoint in {args.ckpt_dir} already at "
              f"step >= {args.steps}; clear it or raise --steps)")


if __name__ == "__main__":
    main()
