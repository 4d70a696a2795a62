"""Fault-tolerant training loop.

Counterpart of ``repro.runtime.trainer``.  Checkpoints every
``ckpt_every`` steps (async, atomic); a *transient* exception in a step
restores the latest checkpoint and replays from its step with
exponential backoff (the data pipeline is a pure function of the step, so
the replay is exact), while a persistent failure -- a ``DeviceLossError``
-- propagates at once.  ``fail_injector`` lets tests inject failures at
chosen steps; a step whose wall time blows past ``straggler_factor`` times
the step-time EMA is reported to the log.

Under an ``obs`` session each step streams a ``TrainStepEvent`` (the
floats ``Trainer.metrics`` holds), each save and restore a
``CheckpointEvent`` and each straggler or retry a ``DegradedEvent``, as
the reference's trainer does; ``metrics`` and ``saves`` stay the return
surface.  On a mesh each rank's ``Trainer`` emits on its own bus, and
only rank 0 opens a sink (``launch.train --obs-jsonl``).

``Trainer.state`` is the latest train state (``{"params", "opt"}``), there
for a caller that inspects or snapshots it between steps
(``fail_injector`` runs before each step).

``Trainer(..., mesh=, sharding=)`` trains on a mesh of ranks
(``launch.mesh``): every rank runs its own ``Trainer`` on its shards of the
state (cut by ``parallel.specs`` under the ambient rules, or
``rules.launcher_rules(cfg)``) and on its rows of each batch
(``sharding``, by default the rules' batch spec).  A fresh state is the
single-device init from the seed, each leaf drawn whole and cut to this
rank's block before the next is drawn, so a mesh run starts from the same
weights as a one-device run and never holds the whole state (under FSDP a
rank's share of it).  A save gathers the shards leaf by leaf into the
single-device layout (on the host where the collectives run there); rank
0 keeps each gathered leaf and writes them, the other ranks drop each at
once.  A restore cuts the saved arrays to the rank's blocks, so a
checkpoint moves between a mesh and one device either way.  On a mesh a
step donates its state (``make_train_step(donate=True)``, the update
written in place), and a failed step is not retried: every rank would have
to fail and restore together, which waits for the elastic runtime (ROADMAP
A12); it raises, and the launcher stops every rank.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

import torch

from repro_torch import api, obs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.kernels.util import resolve_device
from repro_torch.models.params import leaves
from repro_torch.optim import adamw
from repro_torch.parallel import rules as rules_lib
from repro_torch.parallel import specs as specs_lib
from repro_torch.parallel import steps as steps_lib
from repro_torch.runtime.faults import DeviceLossError

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    n_steps: int = 20
    ckpt_every: int = 5
    ckpt_dir: str = "build/repro_torch_ckpt"
    max_retries: int = 3
    log_every: int = 1
    # Exponential backoff between transient-failure retries:
    # base * 2**(retry-1), capped.
    backoff_base_s: float = 0.05
    backoff_max_s: float = 5.0
    # A step slower than straggler_factor x the step-time EMA is logged as
    # a straggler once history exists (>= 3 steps).  0 disables detection.
    straggler_factor: float = 4.0
    # complete checkpoints kept on disk
    keep: int = 3


class Trainer:
    def __init__(self, model, data_cfg: DataConfig, opt_cfg: adamw.AdamWConfig,
                 schedule, tcfg: TrainerConfig, *, microbatches: int = 1,
                 device=None, sharding=None, mesh=None):
        self.model = model
        self.data_cfg = data_cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.device = resolve_device(
            device if device is not None or self.mesh is None
            else self.mesh.device)
        self.rules = self.specs = None
        self.sharding = sharding
        if self.mesh is not None:
            self.rules = rules_lib.restrict_to_mesh(
                rules_lib.current_rules()
                or rules_lib.launcher_rules(model.cfg), self.mesh)
            sizes = self.mesh.axis_sizes
            self.specs = specs_lib.state_specs(
                model.param_defs(), self.rules, master=opt_cfg.master,
                axis_sizes=sizes)
            # a cut a dim does not divide leaves it whole: logged, not silent
            for path, d in leaves(model.param_defs()):
                _, fallbacks = rules_lib.spec_report(
                    *d.axes, rules=self.rules, shape=d.shape,
                    axis_sizes=sizes)
                for reason in fallbacks:
                    log.info("spec of %s: %s", "/".join(path), reason)
            if sharding is None:
                self.sharding = specs_lib.NamedSharding(
                    self.mesh, rules_lib.spec(
                        "batch", None, rules=self.rules, axis_sizes=sizes,
                        shape=(data_cfg.global_batch, data_cfg.seq_len)))
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.step_fn = steps_lib.make_train_step(
            model, opt_cfg, schedule, microbatches=microbatches,
            mesh=self.mesh, rules=self.rules, donate=self.mesh is not None)
        self.metrics: list[dict] = []
        # each save's step and host seconds (the gathers and the
        # device-to-host copy; the final one's write waited for too)
        self.saves: list[dict] = []
        self.kernel_plans: dict[str, object] = {}
        self.state: dict | None = None

    def plan_hot_kernels(self) -> dict[str, object]:
        """This run's hot-kernel plans: the per-token norm over (tokens,
        d_model) in the activation dtype and the loss over (tokens, vocab)
        in fp32 (the logits' dtype).  Memoized in the plan cache, so the
        launches of every step find them."""
        d = self.data_cfg
        cfg = self.model.cfg
        tokens = max(d.global_batch * d.seq_len, 1)
        with api.plan_context(mesh=self.mesh):
            plans = {
                "rmsnorm": api.plan_for("rmsnorm", (tokens, cfg.d_model),
                                        cfg.adtype),
                "xent": api.plan_for("xent", (tokens, cfg.vocab_size),
                                     torch.float32),
            }
        for name, plan in plans.items():
            log.debug("kernel plan %s:\n%s", name, plan.explain())
        self.kernel_plans = plans
        return plans

    def init_or_restore(self, seed: int = 0) -> tuple[int, dict]:
        cut = init_cut = None
        if self.mesh is not None:
            cut = specs_lib.leaf_cutter(self.specs, self.mesh)

            def init_cut(path, leaf):
                return cut(("params",) + path, leaf)
        state = steps_lib.init_train_state(self.model, self.opt_cfg, seed,
                                           device=self.device, cut=init_cut)
        restored = self.ckpt.restore_latest(state, cut=cut)
        if restored is not None:
            step, state = restored
            log.info("restored checkpoint at step %d", step)
            if obs.enabled():
                obs.emit(obs.CheckpointEvent(step=step, action="restore"))
            return step, state
        return 0, state

    def _save(self, step: int, state: dict, meta: dict) -> None:
        """Save ``state``; on a mesh every rank gathers the blocks of the
        sharded leaves into the single-device layout leaf by leaf (on the
        host where the collectives run there).  Rank 0 keeps each gathered
        leaf on the host and writes them with a host copy of each leaf no
        rule cuts, taken here, as the donated step after it writes into
        the state while the writer thread may still run; the other ranks
        drop each gathered leaf at once, so none but rank 0 ever holds the
        whole state."""
        t0 = time.perf_counter()
        if self.mesh is None:
            self.ckpt.save(step, state, meta=meta)
            self.saves.append({"step": step,
                               "seconds": time.perf_counter() - t0})
            return
        sizes = self.mesh.axis_sizes
        host = self.mesh.backend == "gloo"
        keep = self.mesh.rank == 0

        def whole(t, spec):
            if not any(rules_lib.spec_size(axes, sizes) > 1
                       for axes in rules_lib.dim_axes(spec, t.ndim)):
                # a copy: the next step, donated, writes into ``t`` while
                # the async writer may still read what is kept
                return t.detach().to("cpu", copy=True) if keep else None
            full = specs_lib.gather_leaf(t.to("cpu") if host else t, spec,
                                         self.mesh)
            return full.to("cpu") if keep else None

        full = specs_lib.map_with_specs(whole, state, self.specs)
        if keep:
            self.ckpt.save(step, full, meta=meta)
        self.saves.append({"step": step, "seconds": time.perf_counter() - t0})

    def _note_straggler(self, step: int, step_s: float, ema: float | None,
                        n_hist: int) -> None:
        factor = self.tcfg.straggler_factor
        if factor <= 0 or ema is None or n_hist < 3:
            return
        if step_s > factor * ema:
            log.warning("step %d straggled: %.3fs vs EMA %.3fs (x%.1f)",
                        step, step_s, ema, step_s / ema)
            if obs.enabled():
                obs.emit(obs.DegradedEvent(
                    reason="straggler", step=step,
                    detail=f"step {step_s:.3f}s vs ema {ema:.3f}s "
                           f"(threshold x{factor:g})"))

    def _backoff(self, retries: int) -> None:
        base = self.tcfg.backoff_base_s
        if base <= 0:
            return
        delay = min(base * 2 ** (retries - 1), self.tcfg.backoff_max_s)
        log.info("backing off %.2fs before retry %d", delay, retries)
        time.sleep(delay)

    def train(self, seed: int = 0, *,
              fail_injector: Callable[[int], None] | None = None
              ) -> list[dict]:
        """Run to ``n_steps`` from the latest checkpoint (or a fresh init
        from ``seed``); returns ``metrics``, one dict a completed step."""
        self.plan_hot_kernels()
        step, self.state = self.init_or_restore(seed)
        retries = 0
        ema: float | None = None
        n_hist = 0
        while step < self.tcfg.n_steps:
            try:
                if fail_injector is not None:
                    fail_injector(step)
                t0 = time.perf_counter()
                batch = make_batch(self.data_cfg, step, self.sharding,
                                   device=self.device)
                self.state, metrics = self.step_fn(self.state, batch)
                # float() waits for the device, so the wall time spans the
                # whole step, not just its enqueue
                loss = float(metrics["loss"])
                grad_norm = float(metrics["grad_norm"])
                step_s = time.perf_counter() - t0
                self._note_straggler(step, step_s, ema, n_hist)
                ema = step_s if ema is None else 0.7 * ema + 0.3 * step_s
                n_hist += 1
                self.metrics.append({"step": step, "loss": loss,
                                     "grad_norm": grad_norm,
                                     "lr": float(metrics["lr"]),
                                     "step_s": step_s})
                if obs.enabled():
                    obs.emit(obs.TrainStepEvent(
                        step=step, loss=loss, grad_norm=grad_norm,
                        step_s=step_s))
                if step % self.tcfg.log_every == 0:
                    log.info("step %d loss %.4f", step, loss)
                step += 1
                retries = 0
                if step % self.tcfg.ckpt_every == 0:
                    self._save(step, self.state, {"loss": loss})
                    if obs.enabled():
                        obs.emit(obs.CheckpointEvent(step=step,
                                                     action="save"))
            except DeviceLossError:
                # Persistent: retrying cannot bring the device back.
                raise
            except Exception as e:  # noqa: BLE001 -- the whole point
                retries += 1
                if retries > self.tcfg.max_retries or self.mesh is not None:
                    raise
                log.warning("step %d failed (%s); restoring (retry %d/%d)",
                            step, e, retries, self.tcfg.max_retries)
                if obs.enabled():
                    obs.emit(obs.DegradedEvent(
                        reason="transient_retry", step=step,
                        detail=f"{type(e).__name__}: {e} "
                               f"(retry {retries}/{self.tcfg.max_retries})"))
                self._backoff(retries)
                restored = self.ckpt.restore_latest(self.state)
                if restored is not None:
                    step, self.state = restored
                    if obs.enabled():
                        obs.emit(obs.CheckpointEvent(step=step,
                                                     action="restore"))
                # else: replay from the current state (failure before the
                # first checkpoint)
        t0 = time.perf_counter()
        self._save(step, self.state, {"final": True})
        self.ckpt.wait()
        self.saves[-1]["seconds"] = time.perf_counter() - t0
        if obs.enabled():
            obs.emit(obs.CheckpointEvent(step=step, action="save"))
        return self.metrics
