"""Obs smoke of the port: launch a kernel under a JSONL sink and check the
stream.

Counterpart of ``scripts/obs_smoke.py``, with the same checks: two
``api.launch("stream.scale")`` and one ``api.plan_for("rmsnorm", (64,
256), float32)`` under ``obs.session(JsonlSink(out))`` leave a parseable
stream of at least three ``plan`` records holding both a miss and a hit,
and a launch with no session makes no sink call at all.  The stream stays
on disk for ``python -m repro_torch.obs.report``.  From the root of a
checkout:

    python scripts/torch_obs_smoke.py [out.jsonl] [--device cuda|cpu]

The launches run on the card (B2, ``csrc/stream.cu``) unless ``--device
cpu`` asks for the kernel's plain version on the CPU.  ``chip_smoke.py``
calls ``obs_smoke`` for its phase-1 stream.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"obs smoke: {msg}")


def obs_smoke(out, device="cuda") -> list[dict]:
    """Run the sequence on ``device`` with its stream in ``out``; raises
    ``RuntimeError`` on a failed check, else returns the records."""
    import torch

    from repro_torch import api, obs
    from repro_torch.kernels.util import resolve_device
    from repro_torch.obs import sinks as sinks_lib

    x = torch.arange(2000, dtype=torch.float32, device=resolve_device(device))
    with obs.JsonlSink(out) as sink, obs.session(sink) as active:
        y = api.launch("stream.scale", x, s=2.0)
        api.launch("stream.scale", x, s=2.0)     # second launch: cache hit
        api.plan_for("rmsnorm", (64, 256), "float32")
    _check(torch.equal(y, x * 2.0), "stream.scale did not give x * 2")
    _check(len(active) == 1, f"session sinks {active}")

    with open(out) as f:
        records = [json.loads(line) for line in f]
    kinds = [r["kind"] for r in records]
    _check(kinds.count("plan") >= 3, f"fewer than 3 plan records: {kinds}")
    caches = {r["cache"] for r in records if r["kind"] == "plan"}
    _check({"hit", "miss"} <= caches, f"plan caches {caches} lack a hit or "
                                       f"a miss")

    # the default (no session) must deliver nothing to any sink
    calls = []
    orig = sinks_lib.NullSink.emit
    sinks_lib.NullSink.emit = lambda self, e: calls.append(e)
    try:
        api.launch("stream.scale", x, s=2.0)
    finally:
        sinks_lib.NullSink.emit = orig
    _check(not calls, f"{len(calls)} sink call(s) with obs disabled")
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="build/torch_obs_smoke.jsonl")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    records = obs_smoke(args.out, args.device)
    print(f"obs smoke ok: {len(records)} event(s) -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
