"""Rank functions that run the SPMD path on global inputs, for ``spawn``.

Each takes the ``launch.mesh.Mesh`` a spawned rank was given and global
numpy inputs, cuts this rank's shards by the specs of the launchers' rules
(``rules.launcher_rules`` for a model, ``make_rules()`` for a kernel
alone) or of the ``rules`` a job is given (FSDP's, ``make_rules(fsdp=True,
...)``, for a reduced config, whose ``fsdp`` is off), runs the port's SPMD
path on
them and returns what the rank computed on its shards, for the caller to
put back together and hold against a single-device run.  They live in the
package so that a spawned rank imports nothing but the port.  ``run``
strings several together, so one spawn of a mesh serves many checks:

    from repro_torch.launch import mesh as mesh_lib
    out = mesh_lib.spawn(mesh_checks.run, (1, 2), device="cpu",
                         args=([("xent", {...}), ("train", {...})],))
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import itertools
import logging
import math
import threading

import numpy as np
import torch

from repro_torch import api, interop
from repro_torch.api import spmd
from repro_torch.core import planner
from repro_torch.data.pipeline import make_batch
from repro_torch.kernels.jacobi import ops as jacobi_ops
from repro_torch.kernels.lbm import ops as lbm_ops
from repro_torch.kernels.lbm import ref as lbm_ref
from repro_torch.kernels.xent import kernel as xent_kernel
from repro_torch.kernels.xent import ops as xent_ops
# a rank job too: the comm census of ``measure.validate``
from repro_torch.measure.validate import bare_shifts, validate_comm  # noqa: F401
from repro_torch.models import build_model
from repro_torch.models.params import leaves, map_leaves, map_tree
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedules import make_schedule
from repro_torch.parallel import rules as rules_lib
from repro_torch.parallel import specs as specs_lib
from repro_torch.parallel import steps


def run(mesh, jobs) -> list:
    """Each ``(name, kwargs)`` of ``jobs`` in turn: this module's function
    ``name(mesh, **kwargs)``; their results in order."""
    return [globals()[name](mesh, **kw) for name, kw in jobs]


def mesh_rules(mesh, rules: dict | None = None, cfg=None) -> dict:
    """``rules`` restricted to ``mesh``; unless given, the launchers' rules
    for model config ``cfg`` (``rules.launcher_rules``), or the default
    rules for a kernel alone."""
    return rules_lib.restrict_to_mesh(
        rules or (rules_lib.launcher_rules(cfg) if cfg is not None
                  else rules_lib.make_rules()), mesh)


def digests(tree, specs, axis_sizes) -> dict[str, str]:
    """sha256 of the bytes of every leaf whose spec cuts it over no mesh
    axis of more than one rank: the leaves every rank must hold bit for
    bit."""
    cut = set(specs_lib.sharded_paths(specs, axis_sizes))
    out = {}
    for path, t in leaves(tree):
        if path in cut:
            continue
        raw = t.detach().to("cpu").reshape(-1).view(torch.uint8).numpy()
        out["/".join(path)] = hashlib.sha256(raw.tobytes()).hexdigest()
    return out


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@contextlib.contextmanager
def _spmd_log():
    """The SPMD path's log lines while the scope runs."""
    handler = _Records()
    spmd_log = logging.getLogger("repro_torch.api.spmd")
    spmd_log.addHandler(handler)
    spmd_log.setLevel(logging.INFO)
    try:
        yield handler.messages
    finally:
        spmd_log.removeHandler(handler)


def _local_cells(kernel: str) -> list[tuple]:
    return [k[1] for k in planner.plan_cache_keys() if k[0] == kernel and k[-1]]


def _halo_launch(mesh, kernel: str, stripe, rules, **scalars) -> dict:
    """One ``api.launch`` of a halo kernel on this rank's ``stripe`` under
    an overlap report: the result, the report, the bytes ``mesh.comm``
    counted beside the stripe's local plan's prediction, and the launches
    the counter saw."""
    from repro_torch.kernels.jacobi import kernel as jkernel
    from repro_torch.kernels.lbm import kernel as lkernel

    out = []
    before = mesh.comm["bytes"]
    launches = jkernel.LAUNCHES["jacobi"] + sum(lkernel.LAUNCHES.values())
    with api.plan_context(mesh=mesh), rules_lib.use_rules(rules, mesh):
        report = spmd.overlap_report(
            lambda: out.append(api.launch(kernel, stripe, **scalars)))
        predicted = api.plan_for(kernel, tuple(stripe.shape), stripe.dtype,
                                 local=True).predicted_comm_bytes
    return {"out": out[0], "report": report,
            "comm_bytes": mesh.comm["bytes"] - before,
            "predicted_comm_bytes": predicted,
            "launches": jkernel.LAUNCHES["jacobi"]
            + sum(lkernel.LAUNCHES.values()) - launches}


def jacobi(mesh, grid: np.ndarray, sweeps: int = 3,
           rules: dict | None = None) -> dict:
    """This rank's row stripe of the global ``grid`` through the Jacobi
    shard bodies: one overlapped ``api.launch`` (with its overlap report,
    its comm bytes and their prediction), one launch of the blocking body
    (with its report) and ``jacobi_sweeps(sweeps)``; the stripe's spec,
    the local plan cells and the SPMD log.  ``rules`` replaces the
    launcher's rules (a row dim over two mesh axes takes the gather)."""
    rules = mesh_rules(mesh, rules)
    spec_ = rules_lib.spec("batch", None, rules=rules, shape=grid.shape,
                           axis_sizes=mesh.axis_sizes)
    src = specs_lib.shard_leaf(torch.from_numpy(grid), spec_,
                               mesh).to(mesh.device)
    blocking = dataclasses.replace(
        api.resolve("jacobi"), spmd_body=jacobi_ops._spmd_jacobi_blocking)
    blocked = []
    shapes = ((grid.shape[0], None),)
    with _spmd_log() as logs:
        res = _halo_launch(mesh, "jacobi", src, rules, global_shapes=shapes)
        with api.plan_context(mesh=mesh), rules_lib.use_rules(rules, mesh):
            res["blocking_report"] = spmd.overlap_report(
                lambda: blocked.append(
                    spmd.spmd_launch(blocking, mesh, (src,), {}, shapes)))
            res["sweeps"] = jacobi_ops.jacobi_sweeps(src, sweeps,
                                                     global_shapes=shapes)
    res.update(blocking=blocked[0], spec=spec_, logs=logs,
               cells=_local_cells("jacobi"))
    return res


def lbm(mesh, f: np.ndarray, omega: float, layout: str,
        mask: np.ndarray | None = None, steps: int = 0,
        rules: dict | None = None) -> dict:
    """This rank's X stripe of the global (Q, X, Y, Z) lattice ``f`` after
    one ``api.launch(f"lbm.{layout}")`` (with the global ``mask``), with
    its overlap report, comm bytes and their prediction, and, for
    ``steps`` > 0, after ``lbm_run(steps)``; the stripe's spec and the
    local plan cells.  ``rules`` as ``jacobi`` takes them."""
    rules = mesh_rules(mesh, rules)
    spec_ = rules_lib.spec(None, "batch", None, None, rules=rules,
                           shape=f.shape, axis_sizes=mesh.axis_sizes)
    src = specs_lib.shard_leaf(torch.from_numpy(f), spec_,
                               mesh).to(mesh.device)
    m = None if mask is None else torch.from_numpy(mask).to(mesh.device)
    shapes = ((None, f.shape[1], None, None),)
    res = _halo_launch(mesh, f"lbm.{layout}", src, rules, omega=omega,
                       mask=m, global_shapes=shapes)
    if steps:
        with api.plan_context(mesh=mesh), rules_lib.use_rules(rules, mesh):
            res["run"] = lbm_ops.lbm_run(src, omega, steps, layout=layout,
                                         global_shapes=shapes)
    res.update(spec=spec_, cells=_local_cells(f"lbm.{layout}"))
    return res


def overlap(mesh, logits: np.ndarray, labels: np.ndarray,
            rules: dict | None = None) -> dict:
    """The overlap report of the cross-entropy's vocab-parallel launch on
    this rank's shards (its log-sum-exp combine blocks); ``rules`` replaces
    the launcher's (to cut the vocab over another axis)."""
    rules = mesh_rules(mesh, rules)
    t, v = logits.shape
    lg = specs_lib.shard_leaf(torch.from_numpy(logits), rules_lib.spec(
        "batch", "vocab", rules=rules, shape=(t, v),
        axis_sizes=mesh.axis_sizes), mesh).to(mesh.device)
    lb = specs_lib.shard_leaf(torch.from_numpy(labels), rules_lib.spec(
        "batch", rules=rules, shape=(t,), axis_sizes=mesh.axis_sizes),
        mesh).to(mesh.device)
    with api.plan_context(mesh=mesh), rules_lib.use_rules(rules, mesh):
        return {"report": spmd.overlap_report(
            lambda: api.launch("xent", lg, lb,
                               global_shapes=((None, v), (None,))))}


def xent(mesh, logits: np.ndarray, labels: np.ndarray, g: float = 1.0,
         logical_v: int = 0, dtype: str = "float32") -> dict:
    """``api.launch("xent")`` and ``xent_grad`` on this rank's shards of
    global (T, V) logits and (T,) labels.  Returns the loss, the rank's
    gradient block and its spec, the SPMD log lines and the launches."""
    rules = mesh_rules(mesh)
    sizes = mesh.axis_sizes
    t, v = logits.shape
    lg_spec = rules_lib.spec("batch", "vocab", rules=rules, shape=(t, v),
                             axis_sizes=sizes)
    lb_spec = rules_lib.spec("batch", rules=rules, shape=(t,),
                             axis_sizes=sizes)
    lg = specs_lib.shard_leaf(
        torch.from_numpy(logits).to(getattr(torch, dtype)), lg_spec,
        mesh).to(mesh.device)
    lb = specs_lib.shard_leaf(torch.from_numpy(labels), lb_spec,
                              mesh).to(mesh.device)
    shapes = ((None, v), (None,))
    handler = _Records()
    spmd_log = logging.getLogger("repro_torch.api.spmd")
    spmd_log.addHandler(handler)
    spmd_log.setLevel(logging.INFO)
    before = dict(xent_kernel.LAUNCHES)
    try:
        with api.plan_context(mesh=mesh), rules_lib.use_rules(rules, mesh):
            loss = api.launch("xent", lg, lb, logical_v=logical_v,
                              global_shapes=shapes)
            grad = xent_ops.xent_grad(lg, lb, g, logical_v=logical_v,
                                      global_shapes=shapes)
    finally:
        spmd_log.removeHandler(handler)
    return {"loss": float(loss), "grad": grad, "spec": lg_spec,
            "logs": handler.messages,
            "launches": {k: xent_kernel.LAUNCHES[k] - before[k]
                         for k in before}}


def train(mesh, cfg, state: dict, data_cfg, steps_run: int,
          opt_cfg: AdamWConfig = AdamWConfig(), schedule: tuple = (),
          rules: dict | None = None) -> dict:
    """From a reference train state (numpy), this rank's loss, gradients
    and global norm at step 0, then ``steps_run`` train steps: the losses,
    the rank's final state, the digests of its replicated leaves and the
    kernel launches of the whole job (the card's counters; 0 on the CPU).
    ``schedule`` is ``make_schedule``'s ``(kind, peak, warmup, total)``;
    ``rules`` replaces the launchers' rules."""
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel

    before = {**xent_kernel.LAUNCHES,
              **{f"rmsnorm.{k}": v for k, v in rms_kernel.LAUNCHES.items()}}
    rules = mesh_rules(mesh, rules, cfg)
    sizes = mesh.axis_sizes
    st = interop.train_state_from_jax(state, cfg, device=mesh.device,
                                      mesh=mesh, rules=rules)
    model = build_model(cfg)
    kind, peak, warmup, total = schedule
    step_fn = steps.make_train_step(
        model, opt_cfg, make_schedule(kind, peak=peak, warmup=warmup,
                                      total=total), mesh=mesh, rules=rules)
    grad_fn = steps.make_grad_fn(model, mesh=mesh, rules=rules)
    sharding = specs_lib.NamedSharding(mesh, rules_lib.spec(
        "batch", None, rules=rules, axis_sizes=sizes,
        shape=(data_cfg.global_batch, data_cfg.seq_len)))
    loss0, grads0, gnorm0 = grad_fn(st["params"],
                                    make_batch(data_cfg, 0, sharding))
    losses = []
    for step in range(steps_run):
        st, metrics = step_fn(st, make_batch(data_cfg, step, sharding))
        losses.append(float(metrics["loss"]))
    specs = specs_lib.state_specs(model.param_defs(), rules,
                                  master="master" in st["opt"],
                                  axis_sizes=sizes)
    after = {**xent_kernel.LAUNCHES,
             **{f"rmsnorm.{k}": v for k, v in rms_kernel.LAUNCHES.items()}}
    return {"loss0": float(loss0), "grads0": grads0, "gnorm0": float(gnorm0),
            "losses": losses, "state": st, "specs": specs,
            "digests": digests(st, specs, sizes),
            "launches": {k: after[k] - before[k] for k in before}}


def serve(mesh, cfg, reqs=(), tree=None, seed: int = 0,
          kv_caches=("paged", "dense"), slots: int = 2, max_len: int = 32,
          prefill_chunk: int = 4, rules: dict | None = None, replay=None,
          frames=None, gen: int = 0) -> dict:
    """Serving on the mesh (``launch.serve``'s mesh path) from the numpy
    weights ``tree`` (else ``model.init(seed)`` on the rank's device), under
    ``rules`` (default ``rules.decode_rules(cfg, mesh)``): the requests
    ``reqs`` through the batcher for each of ``kv_caches``
    (``serve.serve_on_mesh``: the rank's completed streams, every RMSNorm
    mode's launches, its collectives), and a teacher-forced replay of
    ``replay``'s token streams (each step's logits whole over the vocab
    ranks); an encoder-decoder serves the static batch of the global numpy
    ``frames`` and prompts ``replay`` (``gen`` new tokens a row) instead
    of requests, and replays over the same frames."""
    from repro_torch.launch import serve as serve_lib

    table = rules_lib.restrict_to_mesh(
        rules or rules_lib.decode_rules(cfg, mesh), mesh)
    model = build_model(cfg)
    params = serve_lib.mesh_params(model, mesh, table, seed=seed, tree=tree)
    static = None
    if cfg.family == "encdec":
        static = (torch.from_numpy(np.asarray(frames)).to(mesh.device),
                  torch.from_numpy(np.asarray(replay, np.int32)).to(
                      mesh.device), gen)
    return serve_lib.serve_on_mesh(
        mesh, model, params, list(reqs), kv_caches=kv_caches, slots=slots,
        max_len=max_len, prefill_chunk=prefill_chunk, rules=table,
        replay=replay, static=static)


def greedy(mesh, cfg, logits: np.ndarray) -> dict:
    """``steps.greedy`` of this rank's vocab shard of the global (B, V)
    ``logits`` under ``rules.decode_rules(cfg, mesh)``: the tokens and the
    collectives it made."""
    table = rules_lib.restrict_to_mesh(rules_lib.decode_rules(cfg, mesh),
                                       mesh)
    s = rules_lib.spec(None, "vocab", rules=table, shape=logits.shape,
                       axis_sizes=mesh.axis_sizes)
    mine = specs_lib.shard_leaf(torch.from_numpy(logits), s,
                                mesh).to(mesh.device)
    before = mesh.comm["calls"]
    with api.plan_context(mesh=mesh), rules_lib.use_rules(table, mesh):
        got = steps.greedy(mine, cfg)
    return {"tokens": got, "calls": mesh.comm["calls"] - before}


def chunk(mesh, cfg, tree, tokens: np.ndarray, nvalid: np.ndarray,
          rules: dict | None = None, max_len: int | None = None) -> dict:
    """One chunk step (``steps.make_chunk_step``) of the global (B, C)
    ``tokens`` on a fresh dense cache of ``max_len`` positions (else C),
    each rank's rows advancing by their own ``nvalid`` (uneven across the
    data ranks), the micro-step count the global rows' longest, as the
    batcher passes it: the next tokens gathered over the data ranks, the
    cache's ``idx``, the rank's block of the cache, and what the step
    raised, before any collective, where it was not told the count."""
    from repro_torch.launch import serve as serve_lib

    table = rules_lib.restrict_to_mesh(
        rules or rules_lib.decode_rules(cfg, mesh), mesh)
    model = build_model(cfg)
    params = serve_lib.mesh_params(model, mesh, table, tree=tree)
    defs = model.cache_defs(tokens.shape[0], max_len or tokens.shape[1])
    axes = map_tree(lambda d: d.axes.index("batch"), defs)
    with api.plan_context(mesh=mesh), rules_lib.use_rules(table, mesh), \
            torch.inference_mode():
        cache = serve_lib.mesh_cache(model, defs, mesh.device)
        toks, _ = serve_lib._mesh_rows(
            torch.from_numpy(tokens).to(mesh.device), mesh, table)
        nv, data = serve_lib._mesh_rows(
            torch.from_numpy(nvalid).to(mesh.device), mesh, table)
        step = steps.make_chunk_step(model, axes)
        try:
            step(params, cache, toks, nv)
            refused = None
        except ValueError as e:
            refused = str(e)
        nxt, cache = step(params, cache, toks, nv, int(nvalid.max()))
        idx = cache["idx"]
        if data:
            nxt = mesh.all_gather(nxt, data, 0)
            idx = mesh.all_gather(idx, data, 0)
    return {"next": nxt, "idx": idx, "refused": refused, "cache": cache}


def reduce_scatter(mesh, xs: np.ndarray) -> dict:
    """``Mesh.reduce_scatter`` of this rank's ``xs[rank]`` over every set
    of mesh axes each of more than one rank, along every dim their ranks
    divide: ``{"cases": {(axes, dim): (block, bytes counted)},
    "transport"}``."""
    x = torch.from_numpy(xs[mesh.rank]).to(mesh.device)
    cases = {}
    for k in range(1, len(mesh.axis_names) + 1):
        for axes in itertools.combinations(mesh.axis_names, k):
            if any(mesh.axis_size(a) <= 1 for a in axes):
                continue
            n = mesh.axis_size(axes)
            for dim in range(x.ndim):
                if x.shape[dim] % n:
                    continue
                before = mesh.comm["bytes"]
                cases[axes, dim] = (mesh.reduce_scatter(x, axes, dim),
                                    mesh.comm["bytes"] - before)
    return {"cases": cases, "transport": mesh.reduce_scatter_transport}


def moe_layer(mesh, cfg, tree: dict, x: np.ndarray) -> dict:
    """One MoE layer (``tree``, numpy leaves) on this rank's rows of the
    global (B, S, d) ``x``: the capacity ranks and the kept mask of the
    rank's assignments, the rows its buffer gives an expert
    (``moe.own_cells``), its output rows, the load-balance loss and the
    router's gradient of that loss alone (the rank's share, before any sum
    over the data axis)."""
    from repro_torch.models import moe

    rules = mesh_rules(mesh, cfg=cfg)
    spec_ = rules_lib.spec("batch", None, None, rules=rules, shape=x.shape,
                           axis_sizes=mesh.axis_sizes)
    rows = specs_lib.shard_leaf(torch.from_numpy(x), spec_,
                                mesh).to(mesh.device)
    p = {k: torch.from_numpy(np.asarray(v)).to(mesh.device)
         for k, v in tree.items()}
    router = p["router"].requires_grad_(True)
    with api.plan_context(mesh=mesh), rules_lib.use_rules(rules, mesh):
        *_, slot, pos, keep, cap = moe.route(
            p, rows.reshape(-1, x.shape[-1]), cfg)
        cells = moe.own_cells(slot, pos, keep, cfg.n_experts, cap)[1]
        out, aux = moe.apply_moe(p, rows, cfg)
        (grad,) = torch.autograd.grad(aux, [router])
    return {"pos": pos, "keep": keep, "cap": cap, "cells": cells,
            "out": out.detach(),
            "aux": float(aux.detach()), "router_grad": grad}


def seeded_grads(mesh, cfg, seed: int, data_cfg,
                 rules: dict | None = None, mask: np.ndarray | None = None,
                 tree: dict | None = None) -> dict:
    """This rank's loss, gradient blocks and global norm at step 0 of the
    weights ``model.init(seed)`` draws on the rank's device (the weights of
    every rank and of one device on that device type), or of the numpy
    ``tree`` where given, on batch 0 of ``data_cfg``, with the parameter
    specs.  No numpy state crosses the spawn without ``tree``, so it
    serves full-width models.  ``rules`` replaces the launchers' rules;
    ``mask`` (the global (B, S) loss mask) makes the loss the masked one,
    a rank taking its rows of it as of the tokens."""
    from repro_torch.launch import serve as serve_lib

    rules = mesh_rules(mesh, rules, cfg)
    sizes = mesh.axis_sizes
    model = build_model(cfg)
    specs = specs_lib.param_specs(model.param_defs(), rules, sizes)
    params = (serve_lib.mesh_params(model, mesh, rules, tree=tree)
              if tree is not None else specs_lib.shard_tree(
                  model.init(seed, device=mesh.device), specs, mesh))
    sharding = specs_lib.NamedSharding(mesh, rules_lib.spec(
        "batch", None, rules=rules, axis_sizes=sizes,
        shape=(data_cfg.global_batch, data_cfg.seq_len)))
    batch = make_batch(data_cfg, 0, sharding)
    if mask is not None:
        batch["mask"] = specs_lib.shard_leaf(
            torch.from_numpy(mask), sharding.spec, mesh).to(mesh.device)
    grad_fn = steps.make_grad_fn(model, mesh=mesh, rules=rules)
    loss0, grads0, gnorm0 = grad_fn(params, batch)
    return {"loss0": float(loss0), "grads0": grads0, "gnorm0": float(gnorm0),
            "specs": specs}


def trainer(mesh, cfg, data_cfg, restore_dir: str, save_dir: str,
            steps_run: int, seed: int = 0, schedule: tuple = (),
            rules: dict | None = None) -> dict:
    """A ``Trainer`` on the mesh restoring the latest checkpoint of
    ``restore_dir`` (returns the rank's restored state), then one training
    ``steps_run`` steps from ``seed`` into ``save_dir`` (returns its
    metrics and final local state).  ``rules`` replaces the launchers'
    rules, as the rules a ``Trainer`` is built under."""
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    model = build_model(cfg)
    kind, peak, warmup, total = schedule
    table = mesh_rules(mesh, rules, cfg)

    def make(directory, n):
        with rules_lib.use_rules(table):
            return Trainer(model, data_cfg, AdamWConfig(),
                           make_schedule(kind, peak=peak, warmup=warmup,
                                         total=total),
                           TrainerConfig(n_steps=n, ckpt_every=max(n, 1),
                                         ckpt_dir=directory, keep=1),
                           mesh=mesh)

    step, restored = make(restore_dir, 0).init_or_restore(seed)
    run_ = make(save_dir, steps_run)
    metrics = run_.train(seed)
    return {"restored_step": step, "restored": restored, "metrics": metrics,
            "final": run_.state}


def mid_run_save(mesh, cfg, data_cfg, save_dir: str, seed: int = 0,
                 schedule: tuple = (), rules: dict | None = None) -> dict:
    """A ``Trainer`` on the mesh taking two steps from ``seed`` into
    ``save_dir`` with a checkpoint after each, the file write of the first
    held until the second save begins: the second step, donated, writes
    into the state while that write is pending, the worst order the async
    writer allows.  Returns this rank's state at step 1 (copied before the
    second step) and its final state.  ``rules`` as for ``trainer``."""
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    kind, peak, warmup, total = schedule
    with rules_lib.use_rules(mesh_rules(mesh, rules, cfg)):
        run_ = Trainer(build_model(cfg), data_cfg, AdamWConfig(),
                       make_schedule(kind, peak=peak, warmup=warmup,
                                     total=total),
                       TrainerConfig(n_steps=2, ckpt_every=1,
                                     ckpt_dir=save_dir, keep=2),
                       mesh=mesh)
    second = threading.Event()
    write, save = run_.ckpt._write, run_.ckpt.save

    def held_write(step, flat, meta):
        if step == 1:
            second.wait()
        write(step, flat, meta)

    def releasing_save(step, state, **kw):
        if step == 2:
            second.set()
        save(step, state, **kw)

    run_.ckpt._write, run_.ckpt.save = held_write, releasing_save
    at = {}

    def snapshot(step):
        if step == 1:
            at[step] = map_leaves(lambda t: t.detach().clone(), run_.state)

    run_.train(seed, fail_injector=snapshot)
    return {"step1": at[1], "final": run_.state}


def _card_ms(fn, reps: int) -> float:
    """ms a call of ``fn`` on the card: CUDA events around ``reps`` calls
    after one untimed."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _mesh_ms(fn, reps: int) -> float:
    """``_card_ms`` with every rank starting together."""
    import torch.distributed as dist

    dist.barrier()
    return _card_ms(fn, reps)


def _one_device_ms(mesh, fn, reps: int) -> float:
    """``_card_ms`` of ``fn`` outside the SPMD path on rank 0 alone, the
    other ranks waiting (0.0 on them)."""
    import torch.distributed as dist

    dist.barrier()
    ms = 0.0
    if mesh.rank == 0:
        with api.plan_context(spmd=False):
            ms = _card_ms(fn, reps)
    dist.barrier()
    return ms


def _lattice(n: int, seed: int, device) -> torch.Tensor:
    """The equilibrium shear flow with a +-2.5 % seeded perturbation, the
    same bits on every rank."""
    f = lbm_ops.init_equilibrium(n, device=device)
    gen = torch.Generator(device=f.device).manual_seed(seed)
    noise = torch.rand(f.shape, generator=gen, device=f.device)
    return f * (1 + 0.05 * (noise - 0.5))


def halo_card(mesh, grid: int, sweeps: int, lbm_sizes, steps: int,
              omega: float, seed: int = 0) -> dict:
    """The halo bodies at full size on a mesh of ranks over the data axis,
    each rank making the global inputs from ``seed`` on its device and
    keeping its stripe.  The kernel counters are zeroed just before the
    main drive (``jacobi_sweeps`` of a ``grid`` x ``grid`` fp32 grid for
    ``sweeps`` sweeps, ``lbm_run`` for ``steps`` steps at each of
    ``lbm_sizes`` in both layouts) and read just after.  Returns, per case,
    the gates (mesh = one device and overlapped = blocking by
    ``torch.equal``, the overlap reports, comm bytes = prediction, B7 = B8
    per site) and the times: ms a sweep or step of the overlapped body, the
    blocking body (Jacobi) and one device (rank 0 alone), the interior's
    CUDA-event time, the halo's host seconds and bytes, and the bytes and
    seconds of bare shifts of each halo payload (the link's rate)."""
    from repro_torch.kernels.jacobi import kernel as jkernel
    from repro_torch.kernels.lbm import kernel as lkernel

    dev = mesh.device
    n, idx = mesh.axis_size("data"), mesh.index("data")
    rules = mesh_rules(mesh)
    out = {"rank": mesh.rank, "transport": mesh.transport, "jacobi": {},
           "lbm": {}}
    for table in (jkernel.LAUNCHES, lkernel.LAUNCHES):
        for k in table:
            table[k] = 0
    with api.plan_context(mesh=mesh), rules_lib.use_rules(rules, mesh):
        # ---- the main drive, counted ----
        g = jacobi_ops.init_grid(grid, grid, seed=seed, device=dev)
        nl = grid // n
        stripe = g[idx * nl:(idx + 1) * nl].clone()
        swept = jacobi_ops.jacobi_sweeps(stripe, sweeps)
        lattices, runs = {}, {}
        for size in lbm_sizes:
            f = _lattice(size, seed + size, dev)
            xl = size // n
            lattices[size] = f[:, idx * xl:(idx + 1) * xl].contiguous()
            del f
            for layout in lbm_ops.LAYOUTS:
                runs[size, layout] = lbm_ops.lbm_run(
                    lattices[size], omega, steps, layout=layout)
        torch.cuda.synchronize()
        out["launches"] = {"jacobi": jkernel.LAUNCHES["jacobi"],
                           "lbm.soa": lkernel.LAUNCHES["soa"],
                           "lbm.ivjk": lkernel.LAUNCHES["ivjk"]}

        # ---- Jacobi: gates, then times ----
        res = out["jacobi"]
        with api.plan_context(spmd=False):
            one = jacobi_ops.jacobi_sweeps(g, sweeps)[idx * nl:(idx + 1) * nl]
        res["equal_one_device"] = torch.equal(swept, one)
        del one
        with spmd.shard_scope("jacobi", mesh, (stripe,)) as (ctx, _):
            blocked = jacobi_ops._shard_sweeps(ctx, stripe, sweeps,
                                               overlapped=False)
        res["equal_blocking"] = torch.equal(swept, blocked)
        del blocked, swept
        blocking = dataclasses.replace(
            api.resolve("jacobi"), spmd_body=jacobi_ops._spmd_jacobi_blocking)
        before = mesh.comm["bytes"]
        res["report"] = spmd.overlap_report(api.launch, "jacobi", stripe)
        res["comm_bytes"] = mesh.comm["bytes"] - before
        res["predicted_comm_bytes"] = api.plan_for(
            "jacobi", (nl, grid), torch.float32,
            local=True).predicted_comm_bytes
        res["blocking_report"] = spmd.overlap_report(
            spmd.spmd_launch, blocking, mesh, (stripe,), {})
        c0 = dict(mesh.comm)
        res["ms"] = _mesh_ms(lambda: jacobi_ops.jacobi_sweeps(
            stripe, sweeps), 2) / sweeps
        res["halo_seconds"] = mesh.comm["seconds"] - c0["seconds"]
        res["halo_bytes"] = mesh.comm["bytes"] - c0["bytes"]
        res["halo_calls"] = mesh.comm["calls"] - c0["calls"]

        def blocking_sweeps():
            with spmd.shard_scope("jacobi", mesh, (stripe,)) as (ctx, _):
                jacobi_ops._shard_sweeps(ctx, stripe, sweeps,
                                         overlapped=False)

        res["blocking_ms"] = _mesh_ms(blocking_sweeps, 2) / sweeps
        res["one_device_ms"] = _one_device_ms(
            mesh, lambda: jacobi_ops.jacobi_sweeps(g, sweeps), 2) / sweeps
        plan = api.plan_for("jacobi", (nl, grid), torch.float32, local=True)
        a = jacobi_ops.pitched(stripe, plan)
        b = torch.empty_like(a)
        res["interior_ms"] = _mesh_ms(lambda: jkernel.sweep(
            a, b, n_cols=grid, block=plan.block_shape), 10)
        del a, b, g
        res["link"] = bare_shifts(mesh, stripe[:1], ring=False)
        del stripe

        # ---- LBM: gates, then times ----
        for size in lbm_sizes:
            f = _lattice(size, seed + size, dev)
            xl = size // n
            mine = lattices[size]
            out["lbm"][f"link N={size}"] = bare_shifts(
                mesh, mine[list(lbm_ops._PLUS_X), -1:], ring=True)
            for layout in lbm_ops.LAYOUTS:
                res = out["lbm"][f"{layout} N={size}"] = {}
                with api.plan_context(spmd=False):
                    one = lbm_ops.lbm_run(f, omega, steps, layout=layout)
                res["equal_one_device"] = torch.equal(
                    runs[size, layout], one[:, idx * xl:(idx + 1) * xl])
                del one
                before = mesh.comm["bytes"]
                res["report"] = spmd.overlap_report(
                    api.launch, f"lbm.{layout}", mine, omega=omega)
                res["comm_bytes"] = mesh.comm["bytes"] - before
                res["predicted_comm_bytes"] = api.plan_for(
                    f"lbm.{layout}", tuple(mine.shape), torch.float32,
                    local=True).predicted_comm_bytes
                c0 = dict(mesh.comm)
                res["ms"] = _mesh_ms(lambda lay=layout: lbm_ops.lbm_run(
                    mine, omega, steps, layout=lay), 1) / steps
                res["halo_seconds"] = mesh.comm["seconds"] - c0["seconds"]
                res["halo_bytes"] = mesh.comm["bytes"] - c0["bytes"]
                res["one_device_ms"] = _one_device_ms(
                    mesh, lambda lay=layout: lbm_ops.lbm_run(
                        f, omega, steps, layout=lay), 1) / steps
                # the interior's work: its propagation and collision
                inner_shape = (lbm_ref.Q, xl - 2) + tuple(mine.shape[2:])
                inner = lbm_ops._Collision(layout, api.plan_for(
                    f"lbm.{layout}", inner_shape, torch.float32, local=True),
                    inner_shape, mine)
                prop = lbm_ops._logical(inner.prop, inner_shape)

                def interior(col=inner, p=prop):
                    lbm_ops._propagate_interior(mine, p)
                    col.run(omega)

                res["interior_ms"] = _mesh_ms(interior, 5)
                res["collide_ms"] = _mesh_ms(lambda col=inner: col.run(
                    omega), 5)
                if layout == "ivjk":
                    # B8 and B7 on the same propagated interior, per site
                    soa = lkernel.collide_soa(inner.prop, omega)
                    ivjk = inner.run(omega)
                    s = math.prod(inner_shape[1:])
                    out["lbm"][f"b7_equals_b8 N={size}"] = torch.equal(
                        soa[:, :s], ivjk[:, :s])
                del inner, prop
            del f, mine, lattices[size]
            for layout in lbm_ops.LAYOUTS:
                del runs[size, layout]
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out
