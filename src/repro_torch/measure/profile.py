"""Plan-override profiles: the serialized form of a measured sweep.

Counterpart of ``repro.measure.profile``.  A profile is versioned JSON
keyed the way the planner memoizes (``plan_cache_keys``): each entry names
a (kernel, logical shape, dtype, mesh, local) cell plus the planner
*knobs* (the per-CTA shared-memory budget and the SM count) that won the
sweep.  Loading re-derives the plan through ``plan_kernel`` with those
knobs -- the profile stores decisions, not serialized plan objects -- and
cross-checks the derived geometry against the recorded ``expect`` block:
if the planner has drifted since the sweep ran, the mismatch is a loud,
readable error instead of a silently different layout.

    {
      "format": "repro_torch.plan_profile", "version": 1, "backend": "cuda",
      "entries": [
        {"kernel": "rmsnorm", "logical_shape": [2048, 2560],
         "dtype": "bfloat16", "mesh": [], "local": false,
         "knobs": {"smem_budget": 58112, "sm_count": 132},
         "expect": {"padded_shape": [2048, 2560], "block_shape": [2, 2560]},
         "score": {"ms": 0.0081, "predicted_hbm_bytes": 20976640},
         "source": "sweep"}
      ]
    }

The knobs are the port planner's own, so a profile of the JAX package
(format ``repro.plan_profile``, knobs ``sublanes`` and ``vmem_budget``) is
refused, as that package's loader refuses this one.  On a mesh a cell is
one rank's shard (``local``: true), the shape the SPMD launch plans.

``load_profile`` returns ``{(kernel, shape, dtype): KernelPlan}`` -- the
cell-keyed mapping ``PlanContext(plan_overrides=...)`` consumes -- with
every plan's ``provenance`` set to ``profile:<path>`` so ``explain()`` and
the ``PlanEvent``s report where the layout decision came from.
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings

from repro_torch.core.planner import KernelPlan, dtype_name, plan_kernel
from repro_torch.obs import bus as obs_bus
from repro_torch.obs import events as obs_events

PROFILE_FORMAT = "repro_torch.plan_profile"
PROFILE_VERSION = 1
KNOBS = ("smem_budget", "sm_count")
# The JAX package's profile format: named in the refusal, never read.
REFERENCE_FORMAT = "repro.plan_profile"


def profile_key(kernel: str, shape, dtype) -> tuple:
    """The override-mapping key for one profiled cell."""
    return (kernel, tuple(int(s) for s in shape), dtype_name(dtype))


def entry_from_plan(plan: KernelPlan, knobs: dict, *, score: dict | None = None,
                    source: str = "sweep") -> dict:
    """Serialize one swept plan: the knobs that produced it plus the
    geometry it must reproduce on load."""
    missing = set(KNOBS) - set(knobs)
    if missing:
        raise ValueError(f"profile knobs missing {sorted(missing)}")
    return {
        "kernel": plan.kernel,
        "logical_shape": list(plan.logical_shape),
        "dtype": plan.dtype,
        "mesh": [list(kv) for kv in plan.mesh],
        "local": bool(plan.local),
        "knobs": {k: int(knobs[k]) for k in KNOBS},
        "expect": {"padded_shape": list(plan.padded_shape),
                   "block_shape": list(plan.block_shape)},
        "score": dict(score or {}),
        "source": source,
    }


def save_profile(path: str, entries: list[dict], *, backend: str | None = None,
                 meta: dict | None = None) -> None:
    """Write a versioned profile; parent directories are created."""
    doc = {
        "format": PROFILE_FORMAT,
        "version": PROFILE_VERSION,
        "backend": backend,
        "meta": dict(meta or {}),
        "entries": list(entries),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _format_error(path: str, doc: dict) -> str | None:
    fmt = doc.get("format")
    if fmt == PROFILE_FORMAT:
        return None
    if fmt == REFERENCE_FORMAT:
        return (f"{path}: a {REFERENCE_FORMAT} profile (the JAX package's: "
                f"sublanes and vmem_budget knobs), not a {PROFILE_FORMAT}; "
                f"sweep again with python -m repro_torch.measure.sweep")
    return f"{path}: not a plan profile (format={fmt!r})"


def _derive(entry: dict) -> tuple[KernelPlan, dict]:
    """The plan an entry's knobs give today, and its drift from the
    recorded geometry (``{field: (profiled, derived)}``).  The kernel's
    family module is imported first: its registration declares the
    family's streams to the planner."""
    from repro_torch.api import registry

    registry.resolve(entry["kernel"])
    knobs = entry["knobs"]
    mesh = tuple((str(a), int(n)) for a, n in entry.get("mesh", ())) or None
    plan = plan_kernel(
        entry["kernel"], tuple(int(s) for s in entry["logical_shape"]),
        entry["dtype"], mesh=mesh, local=bool(entry.get("local", False)),
        smem_budget=int(knobs["smem_budget"]),
        sm_count=int(knobs["sm_count"]))
    expect = entry.get("expect", {})
    derived = {"padded_shape": list(plan.padded_shape),
               "block_shape": list(plan.block_shape)}
    return plan, {k: (expect[k], derived[k]) for k in expect
                  if expect[k] != derived[k]}


def _drift_detail(drift: dict) -> str:
    return "; ".join(f"{k}: profiled {a} != derived {b}"
                     for k, (a, b) in sorted(drift.items()))


def load_profile(path: str, *, strict: bool = True) -> dict:
    """Profile file -> ``{(kernel, shape, dtype): KernelPlan}``.

    Each entry's plan is re-derived via ``plan_kernel`` under the recorded
    knobs, mesh and locality, then checked against the recorded geometry.
    A drifted entry raises (``strict=True``) or is skipped with a warning,
    so a stale profile can never silently impose a layout the sweep did
    not measure; under an ``obs`` session a ``ProfileDriftEvent`` is
    streamed first, so a loader that dies on drift still leaves it in the
    stream."""
    doc = _read(path)
    error = _format_error(path, doc)
    if error:
        raise ValueError(error)
    if int(doc.get("version", 0)) > PROFILE_VERSION:
        raise ValueError(
            f"{path}: profile version {doc.get('version')} is newer than "
            f"supported {PROFILE_VERSION}"
        )
    overrides: dict = {}
    for entry in doc.get("entries", ()):
        kernel, shape, dtype = (entry["kernel"], entry["logical_shape"],
                                entry["dtype"])
        plan, drift = _derive(entry)
        if drift:
            cell = f"{kernel} {tuple(shape)} {dtype}"
            detail = _drift_detail(drift)
            msg = (f"{path}: profiled cell {cell} no longer reproduces its "
                   f"swept geometry (planner drift): {detail}")
            if obs_bus.enabled():
                obs_bus.emit(obs_events.ProfileDriftEvent(
                    path=path, cell=cell, detail=detail))
            if strict:
                raise ValueError(msg)
            warnings.warn(msg + " -- entry skipped", stacklevel=2)
            continue
        overrides[profile_key(kernel, shape, dtype)] = dataclasses.replace(
            plan, provenance=f"profile:{path}")
    return overrides


def audit_profile(path: str) -> list[dict]:
    """Static hygiene check of one profile.

    Unlike :func:`load_profile` this never raises on a bad cell -- it
    returns one issue dict per problem (``kind``, ``cell``, ``detail``) so
    a caller can report every stale or orphan override at once:

    * ``orphan``  -- the cell's kernel is no longer in the registry, so no
      launch can ever consume the override;
    * ``stale``   -- re-deriving the plan under the recorded knobs no longer
      reproduces the recorded geometry: a strict ``load_profile`` of this
      file will fail;
    * ``invalid`` -- the file is not a port profile, or the entry cannot be
      planned at all (unknown dtype, unplannable shape, missing fields).
    """
    from repro_torch.api import registry

    doc = _read(path)
    error = _format_error(path, doc)
    if error:
        return [{"kind": "invalid", "cell": path, "detail": error}]
    registered = set(registry.list_kernels())
    issues: list[dict] = []
    for entry in doc.get("entries", ()):
        kernel = entry.get("kernel", "?")
        cell = (f"{kernel} {tuple(entry.get('logical_shape', ()))} "
                f"{entry.get('dtype', '?')}")
        if kernel not in registered:
            issues.append({
                "kind": "orphan", "cell": cell,
                "detail": f"kernel {kernel!r} is not registered; the "
                          f"override can never be consumed",
            })
            continue
        try:
            _, drift = _derive(entry)
        except (KeyError, TypeError, ValueError) as e:
            issues.append({"kind": "invalid", "cell": cell,
                           "detail": f"{type(e).__name__}: {e}"})
            continue
        if drift:
            issues.append({"kind": "stale", "cell": cell,
                           "detail": _drift_detail(drift)})
    return issues
