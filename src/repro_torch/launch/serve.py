"""Serving launcher of the port: seeded weights, seeded ragged requests,
served through ``ContinuousBatcher``; an encoder-decoder as a static batch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --mesh device --slots 8 --max-len 1024 --requests 16

``--mesh host`` reduces the configuration (``configs.reduce_for_smoke``),
as the reference does; ``--mesh device`` runs the full configuration on the
one card.  ``--mesh DxM`` spawns D x M ranks (``launch.mesh.spawn``, as
``launch.train`` does), the full configuration on CUDA (every rank on
card 0 when the ranks outnumber the cards, over gloo) and the reduced one
on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --mesh 2x2 --layers 2 --slots 8 --max-len 1024 --kv-cache both

Each rank draws its block of the seeded weights leaf by leaf and serves
under ``rules.decode_rules(cfg, mesh)``: the slots' rows cut over "data",
the heads, KV heads, MLP, experts, recurrent columns and vocabulary over
"model", FSDP's "embed" over "data" under a config's ``fsdp``
(``ContinuousBatcher(mesh=)``; an encoder-decoder's static batch with its
rows over "data").  It prints a ``serve:`` line a run and an ``spmd:``
line a rank (its collectives: calls, bytes, host ms) and returns rank 0's
result.  ``--kv-cache both`` serves paged, then dense, on the same
weights; ``--replay`` teacher-forces given token streams afterwards and
returns each step's logits.  The run is on CUDA unless ``--device cpu``.
Prompt lengths and new-token counts are drawn from the given ranges with
``--seed``.  The default arch is the reference's, ``zamba2-1.2b`` (the
hybrid; ``xlstm-1.3b`` runs the ssm family, ``qwen3-moe-30b-a3b`` the moe
family, 61 GB of bf16 weights at full width).  Prints the decode batch's
RMSNorm plan (and, for a hybrid or an xlstm, the Mamba2's or the mLSTM's
gated norm's over (slots, d_inner)), then requests, generated tokens,
seconds and tokens/s.

``--arch whisper-tiny`` (the encdec family) takes the reference's
static-batch path instead (``serve_static``): ``--slots`` rows, each with
seeded frames (``--mesh host``: 16 of them; the config's 1,500 at full
width) and a seeded prompt of the top of ``--prompt-len``'s range; the
encoder runs once (``prefill_cross`` fills the cache's cross K/V), the
prompt is fed one token a step through ``make_decode_step``, then the top
of ``--gen``'s range of greedy tokens.  The continuous batcher does not
serve this family (ROADMAP §C).
"""
from __future__ import annotations

import argparse
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--mesh", default="host",
                    help="host, device, or DxM (data x model ranks)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--layers", type=int, default=0, help="override n_layers")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(4, 16),
                    metavar=("MIN", "MAX"))
    ap.add_argument("--gen", type=int, nargs=2, default=(4, 16),
                    metavar=("MIN", "MAX"))
    ap.add_argument("--kv-cache", choices=["dense", "paged", "both"],
                    default="paged",
                    help="both: paged, then dense, on the same weights")
    ap.add_argument("--prefill-chunk", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replay", default=None,
                    help="a .npy of (rows, T) int32 token streams fed one "
                         "token a step through a dense cache after serving "
                         "(teacher-forced); the result holds each step's "
                         "logits, whole over the vocab")
    ap.add_argument("--profile", action="store_true",
                    help="on the card, profile one more decode tick after "
                         "the first run (rank 0 on a mesh)")
    args = ap.parse_args(argv)
    if args.mesh not in ("host", "device"):
        from repro_torch.launch.mesh import parse_shape

        parse_shape(args.mesh)
    return args


def make_requests(n: int, vocab: int, prompt_len, gen, seed: int):
    """``n`` requests, prompt lengths and new-token counts drawn uniformly
    from the inclusive ranges, token ids from [1, vocab), by ``seed``."""
    import numpy as np

    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        reqs.append(Request(
            rid=i, prompt=rng.integers(1, vocab, size=plen).tolist(),
            max_new_tokens=int(rng.integers(gen[0], gen[1] + 1))))
    return reqs


def static_inputs(cfg, rows: int, prompt_len: int, seed: int):
    """Seeded numpy inputs of the static batch: frames (rows, n_frames,
    d_model) fp32 and prompts (rows, prompt_len) int32 in [1, vocab)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((rows, cfg.n_frames, cfg.d_model),
                                 dtype=np.float32)
    prompts = rng.integers(1, cfg.vocab_size, size=(rows, prompt_len))
    return frames, prompts.astype(np.int32)


def _on_mesh():
    """``(mesh, rules)``: the ambient mesh of ranks and its rules, or
    ``(None, None)``."""
    from repro_torch.api import spmd as spmd_lib
    from repro_torch.parallel import rules as rules_lib

    mesh = spmd_lib.spmd_mesh()
    if mesh is None:
        return None, None
    return mesh, rules_lib.mesh_table(mesh)


def _mesh_rows(x, mesh, table):
    """This rank's rows of a global tensor ``x`` (the rules' "batch", or
    every row where they do not divide) and the data axes they are cut
    over."""
    from repro_torch.parallel import rules as rules_lib
    from repro_torch.parallel import specs as specs_lib

    s = rules_lib.spec("batch", *(None,) * (x.ndim - 1), rules=table,
                       shape=tuple(x.shape), axis_sizes=mesh.axis_sizes)
    return (specs_lib.shard_leaf(x, s, mesh),
            rules_lib.dim_axes(s, x.ndim)[0])


def mesh_cache(model, defs, device):
    """A fresh serving cache of the global ``defs``: on a mesh of ranks
    this rank's block of it (``parallel.specs.cache_specs`` under the
    ambient rules), else the whole."""
    from repro_torch.models.params import init_params
    from repro_torch.parallel import specs as specs_lib

    mesh, table = _on_mesh()
    if mesh is None:
        return init_params(0, defs, device=device)
    return init_params(0, defs, device=device, cut=specs_lib.leaf_cutter(
        specs_lib.cache_specs(defs, table, mesh.axis_sizes), mesh))


def serve_static(model, params, frames, prompts, gen: int):
    """Greedy generation of a static batch of an encoder-decoder: the
    encoder once (``prefill_cross`` into the cache's cross K/V), the
    prompts (B, P) fed one token a step, then ``gen`` greedy tokens a row.
    Returns the (B, gen) int32 tokens; the cache (every leaf zeros)
    is made on the frames' device, max_len P + gen.  Under a mesh of ranks
    (an ambient ``launch.mesh.Mesh`` and rules) ``frames`` and ``prompts``
    are the global batch: a rank serves its rows (the rules' "batch", cut
    over the data ranks), its KV heads and its vocab shard, and the tokens
    are gathered over the data ranks."""
    import torch

    from repro_torch.parallel.steps import make_decode_step

    rows, plen = prompts.shape
    mesh, table = _on_mesh()
    with torch.inference_mode():
        data = ()
        if mesh is not None:
            frames, _ = _mesh_rows(frames, mesh, table)
            prompts, data = _mesh_rows(prompts, mesh, table)
        cache = mesh_cache(model, model.cache_defs(rows, plen + gen),
                           frames.device)
        cache["cross_k"], cache["cross_v"] = model.prefill_cross(params,
                                                                 frames)
        decode = make_decode_step(model)
        for t in range(plen):
            tok, cache = decode(params, cache, prompts[:, t:t + 1])
        outs = [tok]
        for _ in range(gen - 1):
            tok, cache = decode(params, cache, outs[-1])
            outs.append(tok)
        out = torch.cat(outs, dim=1)
        return mesh.all_gather(out, data, 0) if data else out


def teacher_forced_logits(model, params, streams, frames=None):
    """Each step's fp32 logits, (T, B, V), of the (B, T) int32 token
    streams fed one token a step from position 0 through a fresh
    dense cache (``make_decode_step``'s model call: a replay whose inputs
    do not depend on what the model predicts); an encoder-decoder's cross
    K/V from ``frames`` (``prefill_cross``).  Under a mesh of ranks
    ``streams`` and ``frames`` are the global batch: a rank feeds its
    rows, and each step's logits are gathered whole over the vocab ranks
    and the data ranks."""
    import torch

    from repro_torch.models import transformer
    from repro_torch.models.moe import data_parallel

    rows, steps = streams.shape
    mesh, table = _on_mesh()
    out = []
    with torch.inference_mode():
        if mesh is not None:
            streams, _ = _mesh_rows(streams, mesh, table)
            if frames is not None:
                frames, _ = _mesh_rows(frames, mesh, table)
        cache = mesh_cache(model, model.cache_defs(rows, steps),
                           streams.device)
        if frames is not None:
            cache["cross_k"], cache["cross_v"] = model.prefill_cross(
                params, frames)
        vmesh, vaxes = transformer.vocab_parallel(model.cfg)
        dmesh, daxes = data_parallel()
        for t in range(steps):
            logits, cache = model.decode_step(params, cache,
                                              streams[:, t:t + 1])
            logits = logits[:, -1]
            if vaxes:
                logits = vmesh.all_gather(logits, vaxes, 1)
            if daxes and logits.shape[0] < rows:
                logits = dmesh.all_gather(logits, daxes, 0)
            out.append(logits)
    return torch.stack(out)


def _config(args, on_cuda: bool):
    """The run's model config: reduced for ``--mesh host`` (and for a
    ``DxM`` mesh off the card), else full; ``--layers`` overrides the
    depth."""
    import dataclasses

    from repro_torch.configs import get_config, reduce_for_smoke

    cfg = get_config(args.arch)
    if args.mesh == "host" or (args.mesh != "device" and not on_cuda):
        cfg = reduce_for_smoke(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return cfg


def _kv_caches(args) -> tuple[str, ...]:
    return ("paged", "dense") if args.kv_cache == "both" else (args.kv_cache,)


def static_run(model, params, frames, prompts, gen: int, *,
               mesh=None) -> dict:
    """``serve_static`` of ``frames`` and ``prompts`` (the global batch),
    timed, the RMSNorm counters and ``mesh``'s collectives zeroed just
    before and read just after: the record ``serve_requests`` gives (each
    row a request), with the (B, gen) tokens under ``out``."""
    import torch

    from repro_torch.kernels.rmsnorm import kernel as rms_kernel

    cuda = frames.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(frames.device)
    for k in rms_kernel.LAUNCHES:
        rms_kernel.LAUNCHES[k] = 0
    if mesh is not None:
        mesh.comm.update(calls=0, bytes=0, seconds=0.0)
    t0 = time.perf_counter()
    out = serve_static(model, params, frames, prompts, gen)
    if cuda:
        torch.cuda.synchronize(frames.device)
    secs = time.perf_counter() - t0
    steps = prompts.shape[1] + gen - 1
    return {"kv_cache": "static", "out": out,
            "completed": {i: row for i, row in enumerate(out.tolist())},
            "seconds": secs, "requests": out.shape[0],
            "tokens": out.numel(), "ticks": steps, "micro_steps": steps,
            "preemptions": 0, "page_len": None,
            "launches": dict(rms_kernel.LAUNCHES),
            "comm": dict(mesh.comm) if mesh is not None else None,
            "profile": None}


def _static_batch(args, cfg, device):
    """``--slots`` rows of seeded frames and prompts of the longest
    prompt length, on ``device``, and the new tokens a row (the longest)."""
    import torch

    frames, prompts = static_inputs(cfg, args.slots, args.prompt_len[1],
                                    args.seed)
    return (torch.from_numpy(frames).to(device),
            torch.from_numpy(prompts).to(device), args.gen[1])


def _main_static(args, model, params, device) -> dict:
    """The encdec path of ``main``: one static batch of ``--slots`` rows."""
    cfg = model.cfg
    r = static_run(model, params, *_static_batch(args, cfg, device))
    print(f"{args.arch} on {device}: static batch of {args.slots} rows, "
          f"{cfg.n_frames} frames, {args.prompt_len[1]} prompt and "
          f"{args.gen[1]} new tokens a row: {r['tokens']} tokens in "
          f"{r['seconds']:.2f} s ({r['tokens'] / r['seconds']:.1f} tok/s), "
          f"{r['ticks']} decode steps")
    print("request 0:", r["completed"][0][:16])
    return r


def profile_tick(batcher, record: bool) -> dict | None:
    """One decode tick of every slot of ``batcher`` on the card
    (``decode_tick``) after one untimed: its CUDA-event time and, where
    ``record``, the device time by kernel (torch.profiler's CUDA activity)
    and its busy share.  On a mesh every rank runs the tick (its
    collectives) and one records.  Returns ``None`` where it does not
    record."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    tick = batcher.decode_tick
    tick()
    torch.cuda.synchronize()
    if batcher.ranks is not None:
        import torch.distributed as dist

        dist.barrier()
    comm0 = dict(batcher.ranks.comm) if batcher.ranks is not None else None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with (profile(activities=[ProfilerActivity.CUDA]) if record
          else contextlib.nullcontext()) as prof:
        start.record()
        tick()
        end.record()
        end.synchronize()
    if not record:
        return None
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: e.device_time_total, reverse=True)
    wall = start.elapsed_time(end)
    busy = sum(e.device_time_total for e in rows) / 1e3
    out = {"wall_ms": wall, "busy_ms": busy, "busy_share": busy / wall,
           "launches": sum(e.count for e in rows),
           "top": [(e.key[:48], e.device_time_total / 1e3, e.count)
                   for e in rows[:6]],
           "seconds": time.perf_counter() - t0}
    if comm0 is not None:
        out["comm"] = {k: batcher.ranks.comm[k] - comm0[k] for k in comm0}
    return out


def serve_requests(model, params, reqs, *, kv_cache: str, slots: int,
                   max_len: int, prefill_chunk: int, device,
                   mesh=None, profile: bool = False) -> dict:
    """``reqs`` (copied) through a ``ContinuousBatcher`` of ``kv_cache``
    (on ``mesh``: the ambient mesh of ranks and rules), the kernel
    counters and the mesh's collectives zeroed just before the run and
    read just after.  Returns the completed streams, seconds, ticks,
    decode steps, preemptions, page length, the launches of each RMSNorm
    mode, the batcher's cache (each leaf's shape, a rank's block on a
    mesh, and their bytes) and, on a mesh, the collectives' calls, bytes
    and host seconds;
    with ``profile`` (on the card) one more decode tick profiled after
    they are read (``profile_tick``, recorded on rank 0)."""
    import torch

    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.models import params as params_lib
    from repro_torch.serving import ContinuousBatcher, Request

    batcher = ContinuousBatcher(model, params, slots=slots, max_len=max_len,
                                kv_cache=kv_cache,
                                prefill_chunk=prefill_chunk, device=device,
                                mesh=mesh)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    for k in rms_kernel.LAUNCHES:
        rms_kernel.LAUNCHES[k] = 0
    if mesh is not None:
        mesh.comm.update(calls=0, bytes=0, seconds=0.0)
    t0 = time.perf_counter()
    out = batcher.run([Request(r.rid, list(r.prompt), r.max_new_tokens)
                       for r in reqs])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    res = {"kv_cache": kv_cache, "completed": out, "seconds": secs,
           "requests": len(out),
           "tokens": sum(len(v) for v in out.values()),
           "ticks": batcher.ticks, "micro_steps": batcher.micro_steps,
           "preemptions": len(batcher.preemption_log),
           "page_len": (batcher.geometry.page_len if batcher.geometry
                        else None),
           "launches": dict(rms_kernel.LAUNCHES),
           "cache_shapes": {"/".join(path): tuple(t.shape) for path, t in
                            params_lib.leaves(batcher.cache)},
           "cache_bytes": sum(t.numel() * t.element_size() for _, t in
                              params_lib.leaves(batcher.cache)),
           "comm": dict(mesh.comm) if mesh is not None else None,
           "profile": None}
    if profile and device.type == "cuda":
        res["profile"] = profile_tick(batcher,
                                      record=mesh is None or mesh.rank == 0)
    return res


def _serve_line(arch, where, r) -> str:
    return (f"{arch} on {where}: {r['requests']} requests, {r['tokens']} "
            f"tokens in {r['seconds']:.2f} s "
            f"({r['tokens'] / r['seconds']:.1f} tok/s), {r['ticks']} "
            f"ticks, {r['micro_steps']} decode steps, page {r['page_len']}"
            f" ({r['kv_cache']}, "
            f"{r['seconds'] / max(r['micro_steps'], 1) * 1e3:.2f} ms a "
            f"step, {r['preemptions']} preemptions)")


def mesh_params(model, mesh, rules, *, seed: int = 0, tree=None):
    """This rank's block of the parameters under ``rules``: of the numpy
    ``tree`` (``interop.params_from_jax``) where given, else of
    ``model.init(seed)``, each leaf drawn whole on the rank's device and
    cut as it is drawn."""
    from repro_torch import interop
    from repro_torch.parallel import specs as specs_lib

    pspecs = specs_lib.param_specs(model.param_defs(), rules,
                                   mesh.axis_sizes)
    if tree is not None:
        whole = interop.params_from_jax(tree, model.cfg, device=mesh.device)
        return specs_lib.shard_tree(whole, pspecs, mesh)
    return model.init(seed, device=mesh.device,
                      cut=specs_lib.leaf_cutter(pspecs, mesh))


def serve_on_mesh(mesh, model, params, reqs, *, kv_caches, slots: int,
                  max_len: int, prefill_chunk: int, rules,
                  replay=None, profile: bool = False, static=None) -> dict:
    """One rank of a mesh serving: ``reqs`` through the batcher for each
    of ``kv_caches`` under ``plan_context(mesh=)`` and ``use_rules(rules,
    mesh)`` (``serve_requests``, the first run's last tick profiled with
    ``profile``) -- or, for an encoder-decoder, its ``static`` batch
    (``(frames, prompts, gen)``, the global tensors on the rank's device;
    ``static_run``) --, then, for ``replay`` ((B, T) int32 token streams),
    their ``teacher_forced_logits`` (over the static batch's frames); this
    rank's peak device memory."""
    import torch

    from repro_torch import api
    from repro_torch.parallel import rules as rules_lib

    cuda = mesh.device.type == "cuda"
    out = {"rank": mesh.rank, "coords": mesh.coords,
           "transport": mesh.transport, "runs": {}}
    with api.plan_context(mesh=mesh), rules_lib.use_rules(rules, mesh):
        if static is not None:
            out["runs"]["static"] = static_run(model, params, *static,
                                               mesh=mesh)
        for i, kv in enumerate(kv_caches if static is None else ()):
            out["runs"][kv] = serve_requests(
                model, params, reqs, kv_cache=kv, slots=slots,
                max_len=max_len, prefill_chunk=prefill_chunk,
                device=mesh.device, mesh=mesh, profile=profile and i == 0)
        if replay is not None:
            streams = torch.as_tensor(replay, dtype=torch.int32,
                                      device=mesh.device)
            out["replay"] = teacher_forced_logits(
                model, params, streams,
                frames=None if static is None else static[0])
    out["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
    return out


def rank_main(mesh, args) -> dict:
    """One rank of a ``--mesh DxM`` run: its block of the seeded weights
    (leaf by leaf), the requests served under ``rules.decode_rules(cfg,
    mesh)`` (an encoder-decoder's static batch, its rows over "data"),
    and what the rank saw: the runs, its collectives and its peak
    memory."""
    import numpy as np
    import torch

    from repro_torch.models import build_model
    from repro_torch.parallel import rules as rules_lib

    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    cfg = _config(args, cuda)
    model = build_model(cfg)
    rules = rules_lib.mesh_table(mesh, rules_lib.decode_rules(cfg, mesh))
    params = mesh_params(model, mesh, rules, seed=args.seed)
    static, reqs = None, []
    if cfg.family == "encdec":
        static = _static_batch(args, cfg, mesh.device)
    else:
        reqs = make_requests(args.requests, cfg.vocab_size, args.prompt_len,
                             args.gen, args.seed)
    return serve_on_mesh(mesh, model, params, reqs,
                         kv_caches=_kv_caches(args), slots=args.slots,
                         max_len=args.max_len,
                         prefill_chunk=args.prefill_chunk, rules=rules,
                         replay=np.load(args.replay) if args.replay else None,
                         profile=args.profile, static=static)


def _main_mesh(args, device) -> dict:
    """``--mesh DxM``: D x M ranks (``launch.mesh.spawn``), each
    ``rank_main``; prints a ``serve:`` line a run and an ``spmd:`` line a
    rank, and returns rank 0's result (its runs: every rank's completed
    streams are the same)."""
    from repro_torch.launch import mesh as mesh_lib

    shape = mesh_lib.parse_shape(args.mesh)
    if device.type == "cuda":
        from repro_torch.kernels import _build

        _build.build()     # once here, not once a rank
    results = mesh_lib.spawn(rank_main, shape, ("data", "model"),
                             device=str(device), args=(args,))
    where = f"a {shape} mesh of {device.type} ranks"
    for kv, r in results[0]["runs"].items():
        print("serve:", _serve_line(args.arch, where, r))
    for res in results:
        for kv, r in res["runs"].items():
            c = r["comm"]
            print(f"spmd: rank {res['rank']} at {res['coords']} {kv}: "
                  f"{res['transport']}, {c['calls']} collectives "
                  f"({c['calls'] / max(r['micro_steps'], 1):.1f} a decode "
                  f"step), {c['bytes']} bytes, host "
                  f"{c['seconds'] * 1e3:.1f} ms, launches "
                  f"{r.get('launches')}, cache {r.get('cache_bytes')} "
                  f"bytes, peak {res['peak_bytes']}")
    first = results[0]["runs"]
    for res in results[1:]:
        for kv, r in res["runs"].items():
            if r["completed"] != first[kv]["completed"]:
                raise RuntimeError(f"rank {res['rank']}'s {kv} streams "
                                   f"differ from rank 0's")
    out = dict(next(iter(first.values())))
    out["ranks"] = results
    return out


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch

    from repro_torch import api
    from repro_torch.kernels.util import resolve_device
    from repro_torch.models import build_model

    device = resolve_device(args.device)
    # fp32 matmuls in full precision, never TF32 (the reduced configs are fp32)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.mesh not in ("host", "device"):
        return _main_mesh(args, device)
    cfg = _config(args, device.type == "cuda")
    model = build_model(cfg)
    params = model.init(args.seed, device=device)
    if cfg.family == "encdec":
        return _main_static(args, model, params, device)
    reqs = make_requests(args.requests, cfg.vocab_size, args.prompt_len,
                         args.gen, args.seed)
    print(api.explain("rmsnorm", (args.slots, cfg.d_model), cfg.adtype))
    if cfg.family in ("hybrid", "ssm"):   # the Mamba2's or the mLSTM's
        d_inner = (cfg.ssm_expand if cfg.family == "hybrid" else 2) * (
            cfg.d_model)
        print(api.explain("rmsnorm.gated", (args.slots, d_inner),
                          cfg.adtype))
    runs = {}
    for kv in _kv_caches(args):
        runs[kv] = r = serve_requests(
            model, params, reqs, kv_cache=kv, slots=args.slots,
            max_len=args.max_len, prefill_chunk=args.prefill_chunk,
            device=device, profile=args.profile and not runs)
        print(_serve_line(args.arch, device, r))
        print("request 0:", r["completed"][0][:16])
    out = dict(next(iter(runs.values())))
    if args.replay:
        import numpy as np

        streams = torch.from_numpy(np.load(args.replay)).to(device)
        out["replay"] = teacher_forced_logits(model, params, streams)
    out["runs"] = runs
    return out


if __name__ == "__main__":
    main()
