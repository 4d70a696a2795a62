"""Knob sweeps around the analytic plan, emitting a loadable profile.

Counterpart of ``repro.measure.sweep``.  The planner's closed form is the
default; this harness is the escape hatch: per (kernel, shape, dtype) cell
it varies the port planner's two knobs -- the per-CTA shared-memory budget
(divided by ``BUDGET_DIVIDERS``) and the SM count the grid must fill (the
context's and half of it) -- times each distinct resulting (padded, block)
geometry once on the card through the registered body, and keeps the
fastest, the smaller ``predicted_hbm_bytes`` and then the analytic plan
breaking ties.  The winner is serialized via ``repro_torch.measure.profile``
so ``PlanContext.from_profile(path)`` (or a launcher's ``--plan-profile``)
replays the measured choice.

Sweeping *knobs* rather than raw block tuples keeps every candidate a plan
the planner itself would produce, and makes the profile replayable: the
file records the knobs, loading re-derives the plan and cross-checks the
geometry.  These knobs move only the row-blocked families' blocks (STREAM,
the triads, the norms); Jacobi's strip and tile, the LBM block, the
cross-entropy's rows and every kernel's vector width and threads are fixed
by the closed form or compiled into the CUDA sources, and
``scripts/{kernel,jacobi,xent}_designs.py`` time those designs.

Without a card the sweep exits non-zero; ``--device cpu`` runs it untimed
(``ms`` null: the least predicted bytes win, the analytic plan on a tie).

Usage:
    python -m repro_torch.measure.sweep --cell rmsnorm:2048,2560:bfloat16
    python -m repro_torch.measure.sweep --all --out build/profile.json
    python -m repro_torch.measure.sweep --cell rmsnorm:4096,896:bfloat16 \\
        --mesh 1x2     # one rank's cell of a launcher's --mesh 1x2 run
    python -m repro_torch.measure.sweep --all --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys

import torch

from repro_torch import api
from repro_torch.core.layout import hopper_limits
from repro_torch.core.planner import dtype_name, plan_kernel
from repro_torch.measure import profile as profile_lib
from repro_torch.measure import validate as validate_lib
from repro_torch.measure.timing import time_ms

PROFILE_OUT_DEFAULT = "build/profile.json"

# Budget dividers: 1 is the analytic default; larger dividers shrink the
# block, which can cut the padding of a row count with no block-sized
# divisor and puts more CTAs on the grid.
BUDGET_DIVIDERS = (1, 4, 16, 64)


@dataclasses.dataclass(frozen=True)
class Candidate:
    knobs: dict
    plan: object
    measured: dict
    analytic: bool

    @property
    def score(self) -> tuple:
        ms = self.measured["ms"]
        return (ms if ms is not None else math.inf,
                self.plan.predicted_hbm_bytes, not self.analytic)


@dataclasses.dataclass(frozen=True)
class SweepResult:
    kernel: str
    shape: tuple
    dtype: str
    default_plan: object
    candidates: tuple
    best: Candidate

    @property
    def changed(self) -> bool:
        """Did measurement override the analytic choice?"""
        d, b = self.default_plan, self.best.plan
        return (d.padded_shape, d.block_shape) != (b.padded_shape,
                                                   b.block_shape)

    def entry(self) -> dict:
        return profile_lib.entry_from_plan(
            self.best.plan, self.best.knobs,
            score={"ms": self.best.measured["ms"],
                   "predicted_hbm_bytes": self.best.plan.predicted_hbm_bytes,
                   "changed": self.changed})


def candidate_knobs(ctx=None) -> list[dict]:
    """Knob grid centred on the context's analytic choice: its budget over
    each of ``BUDGET_DIVIDERS``, at its SM count and half of it."""
    ctx = ctx or api.current_context()
    limits = hopper_limits()
    budget = ctx.smem_budget or limits.smem_per_cta
    sms = ctx.sm_count or limits.sm_count
    return [{"smem_budget": max(budget // d, 1), "sm_count": s}
            for d in BUDGET_DIVIDERS
            for s in sorted({sms, max(sms // 2, 1)}, reverse=True)]


def sweep_cell(kernel: str, shape, dtype, *, ctx=None, device="cuda",
               timer=None, local: bool = False,
               seed: int = 0) -> SweepResult:
    """Time every distinct candidate plan of one cell, ``shape`` the
    operands' (``validate.args_for``).  ``local`` sweeps one rank's shard
    under the context's mesh.  On a CUDA device the timer is ``time_ms``;
    ``timer`` replaces it (tests); on the CPU with none, untimed."""
    ctx = ctx or api.current_context()
    dev = torch.device(device)
    timed = timer is not None or dev.type == "cuda"
    timer = timer or (time_ms if timed else None)
    entry = api.resolve(kernel)
    args, scalars = validate_lib.args_for(kernel, shape, dtype,
                                          device=dev if timed else "meta",
                                          seed=seed)
    pshape, pdtype = entry.plan_args(*args, **scalars)
    default = api.plan_for(kernel, pshape, pdtype, ctx=ctx, local=local)
    default_geom = (default.padded_shape, default.block_shape)
    seen: dict[tuple, Candidate] = {}
    for knobs in candidate_knobs(ctx):
        plan = plan_kernel(kernel, pshape, pdtype, mesh=ctx.mesh,
                           model=ctx.model, local=local, **knobs)
        geom = (plan.padded_shape, plan.block_shape)
        if geom in seen:
            continue
        ms = (timer(lambda p=plan: entry.body(p, *args, **scalars))
              if timed else None)
        seen[geom] = Candidate(knobs=knobs, plan=plan, measured={"ms": ms},
                               analytic=geom == default_geom)
    candidates = tuple(seen.values())
    best = min(candidates, key=lambda c: c.score)
    best = dataclasses.replace(
        best, plan=dataclasses.replace(best.plan, provenance="sweep"))
    return SweepResult(kernel=kernel, shape=tuple(pshape),
                       dtype=dtype_name(pdtype), default_plan=default,
                       candidates=candidates, best=best)


def sweep_cells(cells, **kw) -> list[SweepResult]:
    return [sweep_cell(k, s, d, **kw) for k, s, d in cells]


def _parse_cell(spec: str) -> tuple[str, tuple[int, ...], str]:
    """'kernel:r,c:dtype' -> (kernel, (r, c), dtype)."""
    try:
        kernel, shape_s, dtype = spec.split(":")
        shape = tuple(int(x) for x in shape_s.split(",") if x)
    except ValueError as e:
        raise SystemExit(f"bad --cell {spec!r} (want kernel:dims:dtype): {e}")
    return kernel, shape, dtype


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.measure.sweep",
        description="sweep planner knobs per cell, emit a plan profile")
    ap.add_argument("--cell", action="append", default=[],
                    help="kernel:dims:dtype, the operands' dims, e.g. "
                         "rmsnorm:2048,2560:bfloat16")
    ap.add_argument("--all", action="store_true",
                    help="sweep every validate cell (the card's on a card)")
    ap.add_argument("--mesh", default=None,
                    help="DxM: each cell is one rank's shard of a DxM mesh "
                         "(a launcher's --plan-profile on that mesh)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default) times on the card and fails without "
                         "one; cpu sweeps untimed")
    ap.add_argument("--out", default=PROFILE_OUT_DEFAULT)
    args = ap.parse_args(argv)

    cells = [_parse_cell(c) for c in args.cell]
    if args.all:
        cells += [(k, shape, dtype) for k, (shape, dtype)
                  in validate_lib.cases_for(args.device).items()]
    if not cells:
        ap.error("pass --cell or --all")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("sweep: no CUDA device: the sweep times on the card; "
              "--device cpu sweeps untimed", file=sys.stderr)
        return 2
    ctx = api.current_context()
    if args.mesh:
        from repro_torch.launch.mesh import parse_shape

        ctx = ctx.evolve(mesh=dict(zip(("data", "model"),
                                       parse_shape(args.mesh))))
    results = sweep_cells(cells, ctx=ctx, device=args.device,
                          local=bool(args.mesh))
    for r in results:
        mark = "SWEPT" if r.changed else "kept "
        ms = r.best.measured["ms"]
        print(f"[{mark}] {r.kernel:20s} {r.shape} {r.dtype}: "
              f"{len(r.candidates)} candidates, best "
              f"padded={r.best.plan.padded_shape} "
              f"block={r.best.plan.block_shape} "
              + (f"{ms:.4f} ms " if ms is not None else "untimed ")
              + f"(analytic block={r.default_plan.block_shape})")
    profile_lib.save_profile(
        args.out, [r.entry() for r in results],
        backend=validate_lib.device_label(args.device),
        meta={"timed": args.device == "cuda", "torch": torch.__version__})
    n_changed = sum(r.changed for r in results)
    print(f"wrote {len(results)} cells -> {args.out} "
          f"({n_changed} differ from the analytic choice)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
