"""Measured-vs-predicted validation of the port's layout planner.

Counterpart of ``repro.measure.validate``, with the same records, envelopes,
report merge keys and CLI flags, and ``ValidationEvent``s with the
reference's ``check`` names ("hbm", "comm", "exposed_comm").

**The ``hbm`` check is timed, not a byte census.**  The reference lowers
each registered Pallas body and reads the compiled program's bytes
accessed; the port has no compiled program to read.  Its measurable on the
card is time: each registry kernel's registered body runs at its plan
(``entry.body(plan, *args)``, what ``api.launch`` runs once it has planned)
under the CUDA-event timer (``measure.timing.time_ms``), and
``measured_bytes`` is that time at the card's data-sheet memory rate, so
the ratio is ``ms / bound_ms`` with ``bound_ms = predicted_hbm_bytes /
rate``.  A kernel that moves the predicted bytes at 80 % of the data sheet
reads 1.25, and one that moves twice the bytes at full rate reads 2.0 as
well: the check cannot tell them apart.  Below an envelope's ``lo`` (0.95)
the body would have beaten the data sheet, so the prediction counts bytes
the kernel does not move.  The body includes the wrapper's pads and
slices, and for LBM the whole step (the plain-torch propagation beside the
collision the plan prices), so the envelopes are family multipliers
calibrated on an H100, as the reference's were on its backend.

Two sets of cells.  ``CASES`` are the reference's keys and shapes plus the
split norm's four passes: the CPU tests hold ``args_for`` and the logical
bytes there against the reference, and ``--device cpu`` plans them.
``CARD_CASES`` are the main path's shapes, which the card times
(``cases_for``).  A cell whose predicted bytes fit the H100's 50 MB L2 is
marked ``under_l2``: its back-to-back calls may read their inputs from L2.

The ``comm`` check: each rank of a ``launch.mesh`` mesh (gloo ranks on the
CPU, ranks sharing the card) launches the kernel on its shards of a seeded
global input under ``api.spmd.overlap_report``, prices every collective and
shift the rank issued with the ring formulas (``_site_wire_bytes``, from
the *input* bytes the port's trace records) and holds their sum against
the local plan's ``predicted_comm_bytes``.  ``--exposed`` also requires a
halo family's collectives to be overlappable and holds the bytes left on
the critical path against ``predicted_exposed_comm_bytes`` at the
device-memory and link rates measured on the card (B1's copy and bare
shifts of the halo payload, ``measure_rates``) or given (``--rates``).

Without a CUDA device the timed paths exit non-zero; only an explicit
``--device cpu`` runs the untimed parts (plans, predicted bytes, and the
comm census over gloo).  Tests inject a timer by argument.

Usage:
    python -m repro_torch.measure.validate --all
    python -m repro_torch.measure.validate --family rmsnorm --out build/v.json
    python -m repro_torch.measure.validate --comm --exposed --mesh 2x1
    python -m repro_torch.measure.validate --all --device cpu
    python -m repro_torch.measure.validate --comm --exposed --mesh 2x1 \\
        --device cpu --rates 3.35e12 4e8
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import Mapping

import torch

from repro_torch import api
from repro_torch import obs
from repro_torch.api import spmd
from repro_torch.core import planner as planner_lib
from repro_torch.core.planner import dtype_name, torch_dtype
from repro_torch.measure.timing import datasheet, require_cuda, time_ms
from repro_torch.parallel import rules as rules_lib

OUT_DEFAULT = "build/validation.json"
VALIDATION_FORMAT = "repro_torch.validation"
VALIDATION_VERSION = 1
# The H100's L2: a cell whose predicted traffic fits may be timed from it.
L2_BYTES = 50 * 2**20


# ---------------------------------------------------------------------------
# Representative cells
# ---------------------------------------------------------------------------

def _draw(shape, dtype, gen, device, kind: str = "normal") -> torch.Tensor:
    """A seeded tensor (an empty one on the meta device)."""
    shape = tuple(int(s) for s in shape)
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    if kind == "positive":
        x = torch.rand(shape, generator=gen, device=device) + 0.5
    else:
        x = torch.randn(shape, generator=gen, device=device)
    return x.to(dtype)


def args_for(kernel: str, shape, dtype, *, device="meta",
             seed: int = 0) -> tuple[list, dict]:
    """Launch arguments for ``kernel`` on operands of ``shape`` and
    ``dtype``: the tensors the registered body takes (seeded draws on
    ``device``, empty ones on the meta device) and its default scalars.

    The operand layout is the reference's for its eleven kernels (a
    Jacobi grid is ``shape`` itself, planned on its interior rows); the
    split norm's passes take x (and the gate z), the scale, and the apply
    pass the fp32 row statistic with ``d_total`` the block's own width.
    Shared by validate and sweep, so any cell the planner can plan, the
    harness can time."""
    dt = torch_dtype(dtype)
    gen = (None if torch.device(device).type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    a = lambda s=shape, d=dt, kind="normal": _draw(s, d, gen, device, kind)
    family = kernel.split(".")[0]
    if family in ("stream", "triad"):
        n_arrays = {"stream.copy": 1, "stream.scale": 1, "stream.add": 2,
                    "stream.triad": 2, "triad": 3}[kernel]
        scalars = {"stream.scale": {"s": 2.0},
                   "stream.triad": {"s": 3.0}}.get(kernel, {})
        return [a() for _ in range(n_arrays)], scalars
    if family == "jacobi":
        return [a()], {}
    if family == "lbm":
        return [a(kind="positive")], {"omega": 1.2}
    if kernel == "xent":
        labels = (torch.empty(tuple(shape[:1]), dtype=torch.int32,
                              device="meta") if gen is None else
                  torch.randint(0, int(shape[-1]), tuple(shape[:1]),
                                generator=gen, device=device,
                                dtype=torch.int32))
        return [a(), labels], {"logical_v": int(shape[-1])}
    if family == "rmsnorm":
        gated = kernel.startswith("rmsnorm.gated")
        xs = [a(), a()] if gated else [a()]
        scale = a(shape[-1:], kind="positive")
        if kernel.endswith(".sumsq"):
            return xs, {}
        if kernel.endswith(".apply"):
            ss = a(shape[:-1], torch.float32, kind="positive") * shape[-1]
            return [*xs, scale, ss], {"d_total": int(shape[-1]), "eps": 1e-6}
        return [*xs, scale], {"eps": 1e-6}
    raise KeyError(f"no argument template for kernel {kernel!r}")


# One representative (shape, dtype) cell per registry kernel, the
# reference's, with odd logical extents so the plans pay padding; the
# split passes at the one-pass norms' cell.
CASES: dict[str, tuple[tuple[int, ...], str]] = {
    "stream.copy": ((99999,), "float32"),
    "stream.scale": ((99999,), "float32"),
    "stream.add": ((99999,), "float32"),
    "stream.triad": ((99999,), "float32"),
    "triad": ((50000,), "float32"),
    "jacobi": ((257, 513), "float32"),
    "lbm.soa": ((19, 8, 8, 8), "float32"),
    "lbm.ivjk": ((19, 8, 8, 8), "float32"),
    "rmsnorm": ((300, 1111), "float32"),
    "rmsnorm.gated": ((300, 1111), "float32"),
    "rmsnorm.sumsq": ((300, 1111), "float32"),
    "rmsnorm.gated.sumsq": ((300, 1111), "float32"),
    "rmsnorm.apply": ((300, 1111), "float32"),
    "rmsnorm.gated.apply": ((300, 1111), "float32"),
    "xent": ((300, 5000), "float32"),
}

# The main path's shapes (chip_smoke.py's rows of PERF.md's kernel table):
# STREAM and the triads at n = 2**27; Jacobi's 16384^2 grid (planned on its
# (16382, 16384) interior); the LBM lattice at N = 256; RMSNorm at
# Qwen3-4B's prefill rows, the gated norm at a zamba2 Mamba2's; the split
# passes at phase 3j's ranks' blocks (an sLSTM's fp32, a Mamba2's bf16);
# the loss at the training step's logits.
CARD_CASES: dict[str, tuple[tuple[int, ...], str]] = {
    "stream.copy": ((1 << 27,), "float32"),
    "stream.scale": ((1 << 27,), "float32"),
    "stream.add": ((1 << 27,), "float32"),
    "stream.triad": ((1 << 27,), "float32"),
    "triad": ((1 << 27,), "float32"),
    "jacobi": ((16384, 16384), "float32"),
    "lbm.soa": ((19, 256, 256, 256), "float32"),
    "lbm.ivjk": ((19, 256, 256, 256), "float32"),
    "rmsnorm": ((2048, 2560), "bfloat16"),
    "rmsnorm.gated": ((2048, 4096), "bfloat16"),
    "rmsnorm.sumsq": ((2048, 1024), "float32"),
    "rmsnorm.apply": ((2048, 1024), "float32"),
    "rmsnorm.gated.sumsq": ((2048, 2048), "bfloat16"),
    "rmsnorm.gated.apply": ((2048, 2048), "bfloat16"),
    "xent": ((4096, 151936), "float32"),
}


def cases_for(device) -> dict[str, tuple[tuple[int, ...], str]]:
    """The card's cells on a CUDA device, the reference's elsewhere."""
    return CARD_CASES if torch.device(device).type == "cuda" else CASES


@dataclasses.dataclass(frozen=True)
class Tolerance:
    """Per-family envelope on measured_bytes / predicted_hbm_bytes."""

    lo: float
    hi: float

    def holds(self, ratio: float) -> bool:
        return self.lo <= ratio <= self.hi


# lo: below it a body would beat the data sheet (the prediction counts bytes
# the kernel does not move).  hi: about twice the largest ratio of the
# family's CARD_CASES on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md: STREAM
# 1.099-1.118, the triad 1.075, Jacobi 1.109, LBM 10.68-13.42, the norms
# 1.48-2.07, xent 1.108), so a clock or CUDA-version change does not flap
# while a doubled stream still lands outside.  LBM's body is a whole step, its
# propagation plain torch; a norm's body pads its scale (and the apply
# pass its statistic) beside the kernel.
TOLERANCES: dict[str, Tolerance] = {
    "stream": Tolerance(0.95, 2.3),
    "triad": Tolerance(0.95, 2.2),
    "jacobi": Tolerance(0.95, 2.2),
    "lbm": Tolerance(0.95, 27.0),
    "rmsnorm": Tolerance(0.95, 4.2),
    "xent": Tolerance(0.95, 2.2),
}


# ---------------------------------------------------------------------------
# Communication validation (SPMD launches only)
# ---------------------------------------------------------------------------

# Representative *global* cells for the communicating families (the
# reference's), divisible by every mesh of up to 8 ranks an axis so the
# declared partitioning engages; the LBM X extent keeps an interior.
COMM_CASES: dict[str, tuple[tuple[int, ...], str]] = {
    "xent": ((64, 4096), "float32"),
    "jacobi": ((64, 258), "float32"),
    "lbm.soa": ((19, 32, 8, 8), "float32"),
    "lbm.ivjk": ((19, 32, 8, 8), "float32"),
}

# The census applies the planner's ring formulas to what the rank issued,
# so the ratio sits at 1.0 when the launch issues the predicted collectives
# and nothing else; a dropped halo (ratio 0) or a replicated-logits
# regression (10-100x the lse payload) lands far outside.
COMM_TOLERANCES: dict[str, Tolerance] = {
    "xent": Tolerance(0.5, 2.0),
    "jacobi": Tolerance(0.5, 2.0),
    "lbm.soa": Tolerance(0.5, 2.0),
    "lbm.ivjk": Tolerance(0.5, 2.0),
}


def _mesh_sizes(mesh) -> dict[str, int]:
    return dict(zip(tuple(mesh.axis_names), tuple(mesh.shape)))


def _shards(kernel: str, args, mesh, table) -> list:
    """This rank's shards of the global ``args`` under the kernel's
    declared partitioning and ``table``, with the divisibility fallback."""
    part = spmd.partitioning_for(api.resolve(kernel), len(args))
    out = []
    for template, x in zip(part.in_axes, args):
        spec = rules_lib.spec(*spmd._expand(template, x.ndim), rules=table,
                              shape=tuple(x.shape),
                              axis_sizes=mesh.axis_sizes)
        for d, axes in enumerate(rules_lib.dim_axes(spec, x.ndim)):
            n = rules_lib.spec_size(axes, mesh.axis_sizes)
            if n > 1:
                step = x.shape[d] // n
                x = x.narrow(d, mesh.index(axes) * step, step)
        out.append(x.contiguous())
    return out


def local_shard_shape(kernel: str, args, shards) -> tuple[int, ...]:
    """The per-shard shape the kernel's SPMD body plans on: operand 0's
    shard when the partitioning cut anything, else the registry's planning
    shape of the whole operands (Jacobi's interior rows)."""
    if tuple(shards[0].shape) != tuple(args[0].shape):
        return tuple(int(s) for s in shards[0].shape)
    return tuple(int(s) for s in api.resolve(kernel).plan_args(*args)[0])


def _comm_launch(kernel: str, mesh, shape, dtype, seed: int):
    """Launch ``kernel`` on this rank's shards of a seeded global input
    under an overlap report: (local plan, report, local shape, host s)."""
    args, scalars = args_for(kernel, shape, dtype, device=mesh.device,
                             seed=seed)
    table = rules_lib.mesh_table(mesh)
    shards = _shards(kernel, args, mesh, table)
    gshapes = tuple(tuple(int(s) for s in a.shape) for a in args)
    with api.plan_context(mesh=mesh), rules_lib.use_rules(table, mesh):
        local = local_shard_shape(kernel, args, shards)
        plan = api.plan_for(kernel, local, dtype, local=True)
        t0 = time.perf_counter()
        rep = spmd.overlap_report(lambda: api.launch(
            kernel, *shards, global_shapes=gshapes, **scalars))
    return plan, rep, local, time.perf_counter() - t0


def _site_wire_bytes(site, sizes: Mapping[str, int]) -> float:
    """Per-rank ring wire bytes of one collective or shift the rank issued.

    The reference prices a site by its *result*; the port's trace records
    its *input* (``launch.mesh.Mesh._count``), so the gather and the
    reduce-scatter, whose result is n times or 1/n of it, convert."""
    n = 1
    for a in site.axes:
        n *= int(sizes.get(a, 1))
    b = float(site.result_bytes)
    if site.primitive == "all_reduce":
        return 2.0 * (n - 1) / max(n, 1) * b     # all-reduce ring
    if site.primitive == "all_gather":
        return float(n - 1) * b                  # (n-1)/n of n x the input
    if site.primitive == "reduce_scatter":
        return (n - 1) / max(n, 1) * b           # (n-1) x the input / n
    return b                                     # a shift (ppermute)


def _ratio(measured: float, predicted: float) -> float:
    if predicted:
        return measured / predicted
    return 0.0 if measured == 0 else math.inf


def _json_ratio(ratio):
    return round(ratio, 4) if math.isfinite(ratio) else "inf"


def validate_comm_kernel(kernel: str, mesh, *, shape=None, dtype=None,
                         seed: int = 0) -> dict:
    """One measured-vs-predicted *wire bytes* record for ``kernel``
    launched through the SPMD path over ``mesh`` (every rank calls it)."""
    if shape is None or dtype is None:
        shape, dtype = COMM_CASES[kernel]
    plan, rep, local, secs = _comm_launch(kernel, mesh, shape, dtype, seed)
    sizes = _mesh_sizes(mesh)
    measured = sum(_site_wire_bytes(s, sizes) for s in rep.collectives)
    predicted = plan.predicted_comm_bytes
    ratio = _ratio(measured, predicted)
    tol = COMM_TOLERANCES[kernel]
    ok = tol.holds(ratio) if predicted else measured == 0
    by_op: dict[str, dict] = {}
    for s in rep.collectives:
        c = by_op.setdefault(s.primitive, {"count": 0, "wire_bytes": 0.0})
        c["count"] += 1
        c["wire_bytes"] += _site_wire_bytes(s, sizes)
    return _emitted({
        "kernel": kernel,
        "family": kernel.split(".")[0],
        "check": "comm",
        "shape": list(shape),
        "dtype": dtype_name(dtype),
        "mesh": sizes,
        "local_shape": list(local),
        "predicted": {"comm_bytes": predicted},
        "measured": {"wire_bytes": measured, "collectives": by_op,
                     "seconds": round(secs, 4)},
        "ratio": _json_ratio(ratio),
        "tolerance": [tol.lo, tol.hi],
        "status": "ok" if ok else "fail",
    })


def bare_shifts(mesh, x: torch.Tensor, ring: bool, reps: int = 20
                ) -> tuple[int, float]:
    """The bytes and host seconds ``mesh.comm`` counts for ``reps`` + 1
    pairs of shifts of ``x`` down and up the data axis (a ring when
    ``ring``) with nothing between issue and wait: the link's rate at that
    payload.  Every rank calls it."""
    import torch.distributed as dist

    n = mesh.axis_size("data")
    if ring:
        down = [(i, (i + 1) % n) for i in range(n)]
        up = [(i, (i - 1) % n) for i in range(n)]
    else:
        down = [(i, i + 1) for i in range(n - 1)]
        up = [(i, i - 1) for i in range(1, n)]
    c0 = dict(mesh.comm)
    dist.barrier()
    for _ in range(reps + 1):
        for t in (mesh.ppermute(x, "data", down),
                  mesh.ppermute(x, "data", up)):
            t.wait()
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return (mesh.comm["bytes"] - c0["bytes"],
            mesh.comm["seconds"] - c0["seconds"])


def measure_rates(mesh, payload_bytes: int) -> tuple[float, float]:
    """(device-memory, link) bytes/s on this rank of a mesh on the card, as
    phase 3i's ``halo:`` lines read them: B1's ``stream.copy`` of 2**26
    fp32 (each element read and written once) by ``time_ms``, and bare
    shifts of a ``payload_bytes`` payload over the data axis."""
    require_cuda("the exposed-comm rates")
    x = torch.ones(1 << 26, dtype=torch.float32, device=mesh.device)
    with api.plan_context(spmd=False):
        ms = time_ms(lambda: api.launch("stream.copy", x))
    hbm = 2 * x.numel() * x.element_size() / (ms * 1e-3)
    del x
    payload = torch.zeros(max(int(payload_bytes), 1), dtype=torch.uint8,
                          device=mesh.device)
    nbytes, secs = bare_shifts(mesh, payload, ring=False)
    return hbm, nbytes / secs


def validate_exposed_kernel(kernel: str, mesh, *, shape=None, dtype=None,
                            rates: tuple[float, float] | None = None,
                            seed: int = 0) -> dict:
    """One exposed-comm record: is the halo structured as overlappable,
    and do the wire bytes left on the critical path match
    ``predicted_exposed_comm_bytes``?

    Collectives some kernel launch lies between the issue and the wait of
    may hide behind it, so only the overflow past the plan's hiding
    capacity (predicted total less predicted exposed) stays on the
    critical path; blocking collectives are fully exposed.  Halo families
    (``planner.HALO_MODEL``) *fail* if any of their collectives is
    blocking.  The hiding capacity needs the device-memory and link
    ``rates`` (bytes/s): given, or measured here on the card
    (``measure_rates``, the halo's payload); a family with no halo, or no
    communication, hides nothing and needs none."""
    if shape is None or dtype is None:
        shape, dtype = COMM_CASES[kernel]
    plan, rep, local, _ = _comm_launch(kernel, mesh, shape, dtype, seed)
    sizes = _mesh_sizes(mesh)
    blocking = sum(_site_wire_bytes(s, sizes) for s in rep.collectives
                   if not s.overlappable)
    overlappable = sum(_site_wire_bytes(s, sizes) for s in rep.collectives
                       if s.overlappable)
    predicted_total = plan.predicted_comm_bytes
    halo = kernel in planner_lib.HALO_MODEL
    if halo and predicted_total:
        if rates is None:
            if mesh.device.type != "cuda":
                raise ValueError(
                    f"the exposed check of {kernel} needs the device-memory "
                    f"and link rates: measured on the card, or given "
                    f"(--rates) on the CPU")
            rates = measure_rates(mesh, predicted_total // 2)
        predicted = plan.predicted_exposed_comm_bytes(
            hbm_bytes_per_s=rates[0], link_bytes_per_s=rates[1])
    else:
        predicted = predicted_total
    measured = blocking + max(0.0, overlappable
                              - (predicted_total - predicted))
    ratio = _ratio(measured, predicted)
    tol = COMM_TOLERANCES[kernel]
    structure_ok = (rep.all_overlappable and bool(rep.collectives)
                    if halo and predicted_total else True)
    ok = structure_ok and (tol.holds(ratio) if predicted else measured == 0)
    return _emitted({
        "kernel": kernel,
        "family": kernel.split(".")[0],
        "check": "exposed_comm",
        "shape": list(shape),
        "dtype": dtype_name(dtype),
        "mesh": sizes,
        "local_shape": list(local),
        "predicted": {"comm_bytes": predicted_total,
                      "exposed_comm_bytes": predicted},
        "measured": {
            "exposed_wire_bytes": measured,
            "blocking_wire_bytes": blocking,
            "overlappable_wire_bytes": overlappable,
            "n_kernel_launches": rep.n_kernel_launches,
            "rates": None if rates is None else list(rates),
            "collectives": [
                {"primitive": s.primitive, "axes": list(s.axes),
                 "input_bytes": s.result_bytes,
                 "overlappable": s.overlappable}
                for s in rep.collectives
            ],
        },
        "structure_ok": structure_ok,
        "ratio": _json_ratio(ratio),
        "tolerance": [tol.lo, tol.hi],
        "status": "ok" if ok else "fail",
    })


def validate_comm(mesh, kernels=None, *, exposed: bool = False,
                  rates: tuple[float, float] | None = None,
                  cases: Mapping | None = None) -> list[dict]:
    """The comm records (and with ``exposed`` the exposed-comm records) of
    ``kernels`` (default: every ``COMM_CASES`` kernel) at ``cases``'
    global cells (default ``COMM_CASES``) on this rank of ``mesh``.  Every
    rank of the mesh calls it with the same arguments."""
    cases = cases or COMM_CASES
    names = list(kernels) if kernels is not None else sorted(COMM_CASES)
    records = []
    for k in names:
        shape, dtype = cases[k]
        records.append(validate_comm_kernel(k, mesh, shape=shape,
                                            dtype=dtype))
        if exposed:
            records.append(validate_exposed_kernel(
                k, mesh, shape=shape, dtype=dtype, rates=rates))
    return records


# ---------------------------------------------------------------------------
# The hbm check
# ---------------------------------------------------------------------------

def event_of(record: dict) -> obs.ValidationEvent:
    """The ``ValidationEvent`` of a timed or comm record."""
    if record["check"] == "hbm":
        predicted = float(record["predicted"]["hbm_bytes"])
        measured = float(record["measured"]["bytes"])
    elif record["check"] == "comm":
        predicted = float(record["predicted"]["comm_bytes"])
        measured = float(record["measured"]["wire_bytes"])
    else:
        predicted = float(record["predicted"]["exposed_comm_bytes"])
        measured = float(record["measured"]["exposed_wire_bytes"])
    ratio = record["ratio"]
    mesh = record.get("mesh")
    return obs.ValidationEvent(
        kernel=record["kernel"], family=record["family"],
        check=record["check"], predicted_bytes=predicted,
        measured_bytes=measured,
        ratio=-1.0 if ratio == "inf" else float(ratio),
        status=record["status"],
        mesh=tuple(sorted(mesh.items())) if mesh else ())


def _emitted(record: dict) -> dict:
    if obs.enabled():
        obs.emit(event_of(record))
    return record


def device_label(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return dev.type


def validate_kernel(kernel: str, *, shape=None, dtype=None, device="cuda",
                    timer=None, bytes_per_s: float | None = None,
                    seed: int = 0) -> dict:
    """One measured-vs-predicted record for ``kernel`` at (shape, dtype)
    (default: its cell of ``cases_for(device)``).

    On a CUDA device the body is timed by ``time_ms`` against the card's
    data-sheet rate.  ``timer`` (``fn -> ms``) replaces the timer, with
    ``bytes_per_s`` the rate it is held to (required off the card).  On
    the CPU with no timer the record is untimed: the plan and its
    predicted bytes, ``status`` "untimed", no event."""
    entry = api.resolve(kernel)
    dev = torch.device(device)
    if shape is None or dtype is None:
        shape, dtype = cases_for(dev)[kernel]
    timed = timer is not None or dev.type == "cuda"
    if timed and dev.type == "cuda":
        require_cuda(f"validating {kernel}")
        timer = timer or time_ms
        if bytes_per_s is None:
            bytes_per_s = datasheet(torch.cuda.get_device_name(dev))[0]
    if timed and bytes_per_s is None:
        raise ValueError("an injected timer off the card needs bytes_per_s")
    args, scalars = args_for(kernel, shape, dtype,
                             device=dev if timed else "meta", seed=seed)
    pshape, pdtype = entry.plan_args(*args, **scalars)
    plan = api.plan_for(kernel, pshape, pdtype)
    predicted = plan.predicted_hbm_bytes
    family = kernel.split(".")[0]
    tol = TOLERANCES[family]
    measured = {"ms": None, "bound_ms": None, "bytes": None,
                "bytes_per_s": bytes_per_s,
                "under_l2": predicted <= L2_BYTES}
    ratio, status = None, "untimed"
    if timed:
        ms = timer(lambda: entry.body(plan, *args, **scalars))
        measured.update(ms=ms, bound_ms=predicted / bytes_per_s * 1e3,
                        bytes=ms * 1e-3 * bytes_per_s)
        ratio = round(measured["bytes"] / predicted, 4)
        status = "ok" if tol.holds(ratio) else "fail"
    record = {
        "kernel": kernel,
        "family": family,
        "check": "hbm",
        "shape": list(shape),
        "dtype": dtype_name(dtype),
        "device": device_label(dev),
        "predicted": {
            "hbm_bytes": predicted,
            "logical_bytes": plan.predicted_logical_bytes,
            "comm_bytes": plan.predicted_comm_bytes,
            "waste_bytes": plan.waste_bytes,
            "balance": plan.predicted_balance,
            "naive_balance": plan.naive_balance,
        },
        "measured": measured,
        "ratio": ratio,
        "tolerance": [tol.lo, tol.hi],
        "status": status,
        "plan": {
            "planned_shape": list(plan.logical_shape),
            "padded_shape": list(plan.padded_shape),
            "block_shape": list(plan.block_shape),
            "minor_unit": plan.minor_unit,
        },
    }
    return _emitted(record) if timed else record


def validate_kernels(kernels=None, **kw) -> list[dict]:
    """Records for ``kernels`` (default: every registry kernel with a
    cell).  An explicit empty selection is empty, never silently widened
    to everything.  ``kw`` as ``validate_kernel`` takes it."""
    names = list(kernels) if kernels is not None else [
        k for k in api.list_kernels() if k in CASES
    ]
    return [validate_kernel(k, **kw) for k in names]


def _record_key(r: dict) -> tuple:
    mesh = r.get("mesh")
    return (r["kernel"], tuple(r["shape"]), r["dtype"], r.get("check", "hbm"),
            tuple(sorted(mesh.items())) if mesh else ())


def write_report(records: list[dict], out: str, *,
                 backend: str | None = None) -> None:
    """Merge ``records`` into ``out`` (same-cell records update in place).
    A zero-size file is "nothing here yet", not corruption."""
    existing: list[dict] = []
    if os.path.exists(out) and os.path.getsize(out) > 0:
        with open(out) as f:
            doc = json.load(f)
            if doc.get("format") == VALIDATION_FORMAT:
                existing = doc.get("records", [])
    merged = {_record_key(r): r for r in existing}
    for r in records:
        merged[_record_key(r)] = r
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump({
            "format": VALIDATION_FORMAT,
            "version": VALIDATION_VERSION,
            "backend": backend,
            "records": list(merged.values()),
        }, f, indent=1)


def hbm_line(r: dict) -> str:
    """One printed line of an hbm record."""
    p, m = r["predicted"], r["measured"]
    if r["status"] == "untimed":
        return (f"[untimed] {r['kernel']:20s} {tuple(r['shape'])} "
                f"{r['dtype']}: predicted {p['hbm_bytes']} B (logical "
                f"{p['logical_bytes']} B, waste {p['waste_bytes']} B), plan "
                f"{tuple(r['plan']['padded_shape'])} block "
                f"{tuple(r['plan']['block_shape'])}")
    return (f"[{r['status']:4s}] {r['kernel']:20s} {tuple(r['shape'])} "
            f"{r['dtype']}: {m['ms']:.4f} ms against bound "
            f"{m['bound_ms']:.4f} ms ({p['hbm_bytes']} B predicted), ratio "
            f"{r['ratio']:.3f}, envelope [{r['tolerance'][0]}, "
            f"{r['tolerance'][1]}]"
            + (", working set under the 50 MB L2" if m["under_l2"] else ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.measure.validate",
        description="measured-vs-predicted validation of kernel plans")
    ap.add_argument("--all", action="store_true",
                    help="validate every registry kernel")
    ap.add_argument("--family", action="append", default=[],
                    help="validate one family (repeatable)")
    ap.add_argument("--kernel", action="append", default=[],
                    help="validate one kernel (repeatable)")
    ap.add_argument("--comm", action="store_true",
                    help="validate predicted_comm_bytes against the "
                         "collectives a mesh of ranks issues (see --mesh)")
    ap.add_argument("--exposed", action="store_true",
                    help="with --comm: also check the overlap structure and "
                         "the exposed-comm envelope")
    ap.add_argument("--mesh", default="2x1",
                    help="DxM (data x model) ranks for --comm")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default) times on the card and fails without "
                         "one; cpu runs the untimed parts only")
    ap.add_argument("--rates", type=float, nargs=2, default=None,
                    metavar=("HBM", "LINK"),
                    help="device-memory and link bytes/s for --exposed on "
                         "the CPU (measured on the card)")
    ap.add_argument("--out", default=OUT_DEFAULT)
    ap.add_argument("--obs-jsonl", default=None,
                    help="stream per-check events (repro_torch.obs) to this "
                         "JSONL file; aggregate with python -m "
                         "repro_torch.obs.report")
    args = ap.parse_args(argv)
    if args.exposed and not args.comm:
        ap.error("--exposed is a --comm mode (it checks the SPMD launch's "
                 "overlap structure); pass both")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("validate: no CUDA device: the hbm check and the exposed "
              "rates are timed on the card; --device cpu runs the untimed "
              "parts (plans, predicted bytes, the comm census over gloo)",
              file=sys.stderr)
        return 2
    if args.obs_jsonl:
        with obs.session(obs.JsonlSink(args.obs_jsonl)):
            return _run(ap, args)
    return _run(ap, args)


def _run_comm(ap, args) -> int:
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import mesh_checks

    shape = mesh_lib.parse_shape(args.mesh)
    unknown = set(args.kernel) - set(COMM_CASES)
    if unknown:
        ap.error(f"no comm cell for {sorted(unknown)}; only the "
                 f"communicating families have one: {sorted(COMM_CASES)}")
    if args.device == "cuda":
        from repro_torch.kernels import _build

        _build.build()     # once here, not once a rank
    job = ("validate_comm", dict(
        kernels=args.kernel or None, exposed=args.exposed,
        rates=None if args.rates is None else tuple(args.rates)))
    ranks = [r[0] for r in mesh_lib.spawn(mesh_checks.run, shape,
                                          device=args.device,
                                          args=([job],))]
    records = ranks[0]
    for r in records:
        if obs.enabled():
            obs.emit(event_of(r))
        m = r["measured"]
        if r["check"] == "exposed_comm":
            n_over = sum(c["overlappable"] for c in m["collectives"])
            print(f"[{r['status']:4s}] exposed {r['kernel']:8s} "
                  f"mesh={r['mesh']} "
                  f"measured={m['exposed_wire_bytes']:.4g} "
                  f"predicted={r['predicted']['exposed_comm_bytes']:.4g} "
                  f"ratio={r['ratio']} "
                  f"overlappable={n_over}/{len(m['collectives'])}")
        else:
            print(f"[{r['status']:4s}] comm {r['kernel']:8s} "
                  f"mesh={r['mesh']} measured={m['wire_bytes']:.4g} "
                  f"predicted={r['predicted']['comm_bytes']:.4g} "
                  f"ratio={r['ratio']} "
                  f"tol=[{r['tolerance'][0]}, {r['tolerance'][1]}]")
    write_report(records, args.out, backend=device_label(args.device))
    n_fail = sum(r["status"] != "ok" for rank in ranks for r in rank)
    print(f"wrote {len(records)} comm records of rank 0 -> {args.out}"
          + (f" ({n_fail} FAILED over the ranks)" if n_fail else ""))
    return 1 if n_fail else 0


def _run(ap, args) -> int:
    if args.comm:
        return _run_comm(ap, args)
    cases = cases_for(args.device)
    names = [k for k in api.list_kernels() if k in cases]
    if not args.all:
        wanted = set(args.kernel)
        wanted.update(k for k in names if k.split(".")[0] in args.family)
        if not wanted:
            ap.error("pass --all, --family, or --kernel")
        unknown = wanted - set(names)
        if unknown:
            ap.error(f"no validation cell for {sorted(unknown)}; "
                     f"known: {names}")
        names = [k for k in names if k in wanted]
    records = validate_kernels(names, device=args.device)
    for r in records:
        print(hbm_line(r))
    write_report(records, args.out, backend=device_label(args.device))
    n_fail = sum(r["status"] == "fail" for r in records)
    print(f"wrote {len(records)} records -> {args.out}"
          + (f" ({n_fail} FAILED)" if n_fail else ""))
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
