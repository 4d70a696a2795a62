"""Aggregate a JSONL event stream into a health summary.

Counterpart of ``repro.obs.report``: the same sections, numbers and
text, so either package's report reads either package's streams.

    python -m repro_torch.obs.report run.jsonl [more.jsonl ...] [--json] \
        [--fail-on-validation]

Reads the record-per-line stream a ``JsonlSink`` wrote and reports, per
section:

  * plan cache -- hit/miss/override counts and the hit rate, split by
    kernel, plus where decisions came from (analytic vs profile pins);
  * SPMD health -- declared shardings that fell back to replication
    (with reasons) and override cells shadowed by per-shard planning;
  * validation -- worst measured/predicted ratio per (family, check)
    and any out-of-envelope records, for both HBM bytes and comm wire
    bytes;
  * trainer -- steps, loss trajectory, mean step wall time, checkpoints;
  * batcher -- admissions, peak queue depth, mean packing waste (free +
    tile-pad slots as a fraction of the physical decode batch), plus the
    paged-KV signals: mean/peak page-pool utilization, preemptions (by
    reason), and requests abandoned at a run's tick budget;
  * elastic -- mesh changes (with the surviving topology), elastic
    resumes (restore step, re-chunked batch), and degraded-mode events
    by reason (stragglers, transient retries, retired surplus devices,
    serving pool shrinks);
  * profile drift -- swept cells the planner no longer reproduces.

Sections with no events still print (zeroed), so the summary shape is
stable for scraping.  ``--json`` emits the aggregate as one JSON object
instead.  Exit status: 0 on success, 1 with ``--fail-on-validation``
when any validation event is out of envelope, 2 on unreadable input.
"""
from __future__ import annotations

import argparse
import json
import sys

__all__ = ["aggregate", "render", "main"]


def _read_records(paths) -> tuple[list[dict], int]:
    """All parseable records across ``paths`` plus the malformed-line
    count (a torn final line from a crashed run is data, not an error)."""
    records: list[dict] = []
    bad = 0
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    bad += 1
                    continue
                if isinstance(rec, dict) and "kind" in rec:
                    records.append(rec)
                else:
                    bad += 1
    return records, bad


def _mesh_str(mesh) -> str:
    if not mesh:
        return "-"
    return ",".join(f"{a}={n}" for a, n in mesh)


def aggregate(records: list[dict]) -> dict:
    """Fold a record stream into the summary dict ``render`` prints."""
    plan = {"total": 0, "hits": 0, "misses": 0, "overrides": 0,
            "by_kernel": {}, "sources": {}}
    fallbacks = {"total": 0, "by_site": {}}
    shadows = {"total": 0, "cells": []}
    validation: dict[str, dict] = {}
    train = {"steps": 0, "first_loss": None, "last_loss": None,
             "sum_step_s": 0.0, "checkpoint_saves": 0,
             "checkpoint_restores": 0}
    batcher = {"admissions": 0, "max_queue_depth": 0, "ticks": 0,
               "sum_waste_frac": 0.0, "page_ticks": 0,
               "sum_page_util": 0.0, "peak_page_util": None,
               "preemptions": 0, "preempt_reasons": {},
               "abandoned": 0}
    elastic = {"mesh_changes": 0, "last_mesh": None, "resumes": 0,
               "last_resume_step": None, "invalidated_plans": 0,
               "degraded": 0, "degraded_reasons": {}}
    drift = {"total": 0, "cells": []}

    for rec in records:
        kind = rec["kind"]
        if kind == "plan":
            plan["total"] += 1
            cache = rec.get("cache", "miss")
            bucket = {"hit": "hits", "miss": "misses"}.get(cache, "overrides")
            plan[bucket] += 1
            k = plan["by_kernel"].setdefault(
                rec.get("kernel", "?"),
                {"hits": 0, "misses": 0, "overrides": 0})
            k[bucket] += 1
            src = rec.get("source", "analytic")
            plan["sources"][src] = plan["sources"].get(src, 0) + 1
        elif kind == "spmd_fallback":
            fallbacks["total"] += 1
            site = (f"{rec.get('kernel', '?')}@"
                    f"{_mesh_str(rec.get('mesh', ()))}")
            s = fallbacks["by_site"].setdefault(
                site, {"count": 0, "reasons": []})
            s["count"] += 1
            for r in rec.get("reasons", ()):
                if r not in s["reasons"]:
                    s["reasons"].append(r)
        elif kind == "spmd_override_shadow":
            shadows["total"] += 1
            for c in rec.get("cells", ()):
                if c not in shadows["cells"]:
                    shadows["cells"].append(c)
        elif kind == "validation":
            key = f"{rec.get('family', '?')}/{rec.get('check', 'hbm')}"
            v = validation.setdefault(
                key, {"n": 0, "fails": 0, "min_ratio": None,
                      "max_ratio": None, "worst": None})
            v["n"] += 1
            if rec.get("status") != "ok":
                v["fails"] += 1
            try:
                ratio = float(rec.get("ratio", 0.0))
            except (TypeError, ValueError):  # "inf" etc.
                ratio = float("inf")
            if v["min_ratio"] is None or ratio < v["min_ratio"]:
                v["min_ratio"] = ratio
            if v["max_ratio"] is None or ratio > v["max_ratio"]:
                v["max_ratio"] = ratio
            # Worst = farthest from the model's prediction (ratio 1.0).
            prev = v["worst"]
            if prev is None or abs(ratio - 1.0) > abs(prev - 1.0):
                v["worst"] = ratio
        elif kind == "train_step":
            train["steps"] += 1
            loss = rec.get("loss")
            if train["first_loss"] is None:
                train["first_loss"] = loss
            train["last_loss"] = loss
            train["sum_step_s"] += float(rec.get("step_s", 0.0) or 0.0)
        elif kind == "checkpoint":
            if rec.get("action") == "save":
                train["checkpoint_saves"] += 1
            else:
                train["checkpoint_restores"] += 1
        elif kind == "admission":
            batcher["admissions"] += 1
            batcher["max_queue_depth"] = max(
                batcher["max_queue_depth"], int(rec.get("queue_depth", 0)))
        elif kind == "batcher_tick":
            batcher["ticks"] += 1
            padded = int(rec.get("padded_slots", 0)) or 1
            waste = int(rec.get("free_slots", 0)) + int(
                rec.get("pad_slots", 0))
            batcher["sum_waste_frac"] += waste / padded
            batcher["max_queue_depth"] = max(
                batcher["max_queue_depth"], int(rec.get("queue_depth", 0)))
        elif kind == "page_pool":
            batcher["page_ticks"] += 1
            live = int(rec.get("live_pages", 0)) or 1
            util = int(rec.get("used_pages", 0)) / live
            batcher["sum_page_util"] += util
            if (batcher["peak_page_util"] is None
                    or util > batcher["peak_page_util"]):
                batcher["peak_page_util"] = util
        elif kind == "preemption":
            batcher["preemptions"] += 1
            reason = rec.get("reason", "?")
            batcher["preempt_reasons"][reason] = (
                batcher["preempt_reasons"].get(reason, 0) + 1)
        elif kind == "request_abandoned":
            batcher["abandoned"] += 1
        elif kind == "mesh_change":
            elastic["mesh_changes"] += 1
            elastic["last_mesh"] = _mesh_str(rec.get("new_mesh", ()))
        elif kind == "resume":
            elastic["resumes"] += 1
            elastic["last_resume_step"] = rec.get("step")
            elastic["invalidated_plans"] += int(
                rec.get("invalidated_plans", 0))
        elif kind == "degraded":
            elastic["degraded"] += 1
            reason = rec.get("reason", "?")
            elastic["degraded_reasons"][reason] = (
                elastic["degraded_reasons"].get(reason, 0) + 1)
        elif kind == "profile_drift":
            drift["total"] += 1
            cell = rec.get("cell", "?")
            if cell not in drift["cells"]:
                drift["cells"].append(cell)

    planned = plan["hits"] + plan["misses"]
    plan["hit_rate"] = plan["hits"] / planned if planned else None
    train["mean_step_s"] = (
        train["sum_step_s"] / train["steps"] if train["steps"] else None)
    batcher["mean_waste_frac"] = (
        batcher["sum_waste_frac"] / batcher["ticks"]
        if batcher["ticks"] else None)
    batcher["mean_page_util"] = (
        batcher["sum_page_util"] / batcher["page_ticks"]
        if batcher["page_ticks"] else None)
    return {
        "events": len(records),
        "plan": plan,
        "spmd_fallbacks": fallbacks,
        "spmd_override_shadows": shadows,
        "validation": validation,
        "train": train,
        "batcher": batcher,
        "elastic": elastic,
        "profile_drift": drift,
    }


def _fmt(v, spec: str = ".3g") -> str:
    return "-" if v is None else format(v, spec)


def render(summary: dict) -> str:
    """Human-readable health summary (one stable section per subsystem)."""
    plan = summary["plan"]
    lines = [f"events: {summary['events']}"]
    rate = plan["hit_rate"]
    lines.append(
        f"plan cache: {plan['total']} plan(s) -- {plan['hits']} hit / "
        f"{plan['misses']} miss / {plan['overrides']} override"
        + (f", hit rate {rate:.1%}" if rate is not None else ""))
    for kernel in sorted(plan["by_kernel"]):
        k = plan["by_kernel"][kernel]
        lines.append(f"  {kernel}: {k['hits']} hit / {k['misses']} miss / "
                     f"{k['overrides']} override")
    for src in sorted(plan["sources"]):
        lines.append(f"  source {src}: {plan['sources'][src]}")

    fb = summary["spmd_fallbacks"]
    lines.append(f"spmd fallbacks: {fb['total']}")
    for site in sorted(fb["by_site"]):
        s = fb["by_site"][site]
        lines.append(f"  {site}: x{s['count']} ({'; '.join(s['reasons'])})")
    sh = summary["spmd_override_shadows"]
    lines.append(f"spmd shadowed overrides: {sh['total']}"
                 + (f" (cells: {', '.join(sh['cells'])})"
                    if sh["cells"] else ""))

    val = summary["validation"]
    lines.append(f"validation: {sum(v['n'] for v in val.values())} record(s)")
    for key in sorted(val):
        v = val[key]
        lines.append(
            f"  {key}: worst ratio {_fmt(v['worst'])} "
            f"(range {_fmt(v['min_ratio'])}..{_fmt(v['max_ratio'])}, "
            f"{v['fails']} fail / {v['n']})")

    tr = summary["train"]
    lines.append(
        f"trainer: {tr['steps']} step(s), loss "
        f"{_fmt(tr['first_loss'], '.4g')} -> {_fmt(tr['last_loss'], '.4g')}, "
        f"mean step {_fmt(tr['mean_step_s'], '.3g')}s, "
        f"ckpt {tr['checkpoint_saves']} save / "
        f"{tr['checkpoint_restores']} restore")

    ba = summary["batcher"]
    waste = ba["mean_waste_frac"]
    lines.append(
        f"batcher: {ba['admissions']} admission(s), {ba['ticks']} tick(s), "
        f"peak queue {ba['max_queue_depth']}, mean packing waste "
        + (f"{waste:.1%}" if waste is not None else "-"))
    util = ba["mean_page_util"]
    reasons = "; ".join(f"{r}: {n}" for r, n in
                        sorted(ba["preempt_reasons"].items()))
    lines.append(
        "  paged kv: "
        + (f"mean pool util {util:.1%}, peak {ba['peak_page_util']:.1%}"
           if util is not None else "no page-pool events")
        + f", {ba['preemptions']} preemption(s)"
        + (f" ({reasons})" if reasons else "")
        + f", {ba['abandoned']} abandoned request(s)")

    el = summary["elastic"]
    reasons = "; ".join(f"{r}: {n}" for r, n in
                        sorted(el["degraded_reasons"].items()))
    lines.append(
        f"elastic: {el['mesh_changes']} mesh change(s)"
        + (f" (now {el['last_mesh']})" if el["last_mesh"] else "")
        + f", {el['resumes']} resume(s)"
        + (f" (last from step {el['last_resume_step']}, "
           f"{el['invalidated_plans']} plan(s) invalidated)"
           if el["last_resume_step"] is not None else "")
        + f", {el['degraded']} degraded event(s)"
        + (f" ({reasons})" if reasons else ""))

    dr = summary["profile_drift"]
    lines.append(f"profile drift: {dr['total']}"
                 + (f" (cells: {', '.join(dr['cells'])})"
                    if dr["cells"] else ""))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="aggregate a repro_torch.obs JSONL event stream into a "
                    "health summary")
    ap.add_argument("paths", nargs="+", help="JSONL event stream(s)")
    ap.add_argument("--json", action="store_true",
                    help="emit the aggregate as JSON instead of text")
    ap.add_argument("--fail-on-validation", action="store_true",
                    help="exit 1 if any validation event is out of its "
                         "envelope")
    args = ap.parse_args(argv)

    try:
        records, bad = _read_records(args.paths)
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    summary = aggregate(records)
    if bad:
        summary["malformed_lines"] = bad
    if args.json:
        print(json.dumps(summary, indent=1))
    else:
        print(render(summary))
        if bad:
            print(f"({bad} malformed line(s) skipped)")
    if args.fail_on_validation and any(
            v["fails"] for v in summary["validation"].values()):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
