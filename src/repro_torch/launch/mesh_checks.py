"""Rank functions that run the SPMD path on global inputs, for ``spawn``.

Each takes the ``launch.mesh.Mesh`` a spawned rank was given and global
numpy inputs, cuts this rank's shards by the specs of
``rules.make_rules(tensor_parallel=False)``, runs the port's SPMD path on
them and returns what the rank computed on its shards, for the caller to
put back together and hold against a single-device run.  They live in the
package so that a spawned rank imports nothing but the port.  ``run``
strings several together, so one spawn of a mesh serves many checks:

    from repro_torch.launch import mesh as mesh_lib
    out = mesh_lib.spawn(mesh_checks.run, (1, 2), device="cpu",
                         args=([("xent", {...}), ("train", {...})],))
"""
from __future__ import annotations

import hashlib
import logging

import numpy as np
import torch

from repro_torch import api, interop
from repro_torch.data.pipeline import make_batch
from repro_torch.kernels.xent import kernel as xent_kernel
from repro_torch.kernels.xent import ops as xent_ops
from repro_torch.models import build_model
from repro_torch.models.params import leaves
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedules import make_schedule
from repro_torch.parallel import rules as rules_lib
from repro_torch.parallel import specs as specs_lib
from repro_torch.parallel import steps


def run(mesh, jobs) -> list:
    """Each ``(name, kwargs)`` of ``jobs`` in turn: this module's function
    ``name(mesh, **kwargs)``; their results in order."""
    return [globals()[name](mesh, **kw) for name, kw in jobs]


def mesh_rules(mesh) -> dict:
    return rules_lib.restrict_to_mesh(
        rules_lib.make_rules(tensor_parallel=False), mesh)


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
          opt_cfg: AdamWConfig = AdamWConfig(), schedule: tuple = ()) -> dict:
    """From a reference train state (numpy), this rank's loss, gradients
    and global norm at step 0, then ``steps_run`` train steps: the losses,
    the rank's final state and the digests of its replicated leaves.
    ``schedule`` is ``make_schedule``'s ``(kind, peak, warmup, total)``."""
    rules = mesh_rules(mesh)
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
    return {"loss0": float(loss0), "grads0": grads0, "gnorm0": float(gnorm0),
            "losses": losses, "state": st, "specs": specs,
            "digests": digests(st, specs, sizes)}


def seeded_grads(mesh, cfg, seed: int, data_cfg) -> dict:
    """This rank's loss, gradient blocks and global norm at step 0 of the
    weights ``model.init(seed)`` draws on the rank's device (the weights of
    every rank and of one device on that device type), on batch 0 of
    ``data_cfg``, with the parameter specs.  No numpy state crosses the
    spawn, so it serves full-width models."""
    rules = mesh_rules(mesh)
    sizes = mesh.axis_sizes
    model = build_model(cfg)
    specs = specs_lib.param_specs(model.param_defs(), rules, sizes)
    params = specs_lib.shard_tree(model.init(seed, device=mesh.device),
                                  specs, mesh)
    sharding = specs_lib.NamedSharding(mesh, rules_lib.spec(
        "batch", None, rules=rules, axis_sizes=sizes,
        shape=(data_cfg.global_batch, data_cfg.seq_len)))
    grad_fn = steps.make_grad_fn(model, mesh=mesh, rules=rules)
    loss0, grads0, gnorm0 = grad_fn(params, make_batch(data_cfg, 0, sharding))
    return {"loss0": float(loss0), "grads0": grads0, "gnorm0": float(gnorm0),
            "specs": specs}


def trainer(mesh, cfg, data_cfg, restore_dir: str, save_dir: str,
            steps_run: int, seed: int = 0, schedule: tuple = ()) -> dict:
    """A ``Trainer`` on the mesh restoring the latest checkpoint of
    ``restore_dir`` (returns the rank's restored state), then one training
    ``steps_run`` steps from ``seed`` into ``save_dir`` (returns its
    metrics and final local state)."""
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    model = build_model(cfg)
    kind, peak, warmup, total = schedule

    def make(directory, n):
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
