"""The cost of summing the attention's and the MLP's row-parallel partials
in fp32 (``blocks.row_parallel``, the recurrent blocks' rule) instead of in
the activation dtype (``blocks._out_proj``'s rule), on Qwen2-0.5B trained
tensor-parallel on a (1, 2) mesh of one card.  From the root of a checkout,
on a machine with a CUDA card:

    python3 scripts/row_parallel_cost.py

It writes a copy of ``src/`` to ``build/row_parallel_fp32/`` in which
``_out_proj`` and ``apply_mlp`` call ``row_parallel``, then runs
``launch.train --arch qwen2-0.5b --mesh 1x2 --baseline --profile`` for
``STEPS`` steps of 8 x 512 tokens from the checkout (A) and from the copy
(B), in the order A B B A, each in a process of its own.  Each run prints
one ``run:`` line (rank 0's losses, ms a step, the profiled step's wall,
busy and collectives, the peak memory a rank); the last line compares
the medians of steps 1 to ``STEPS - 1``.  About 5 minutes on an H100."""
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANT = ROOT / "build" / "row_parallel_fp32"
STEPS = 4
# the two down projections that keep the activation dtype's sum, and
# their form through row_parallel
SWAPS = [('return leave(torch.einsum("bqhd,hdm->bqm", ctx, wo), *tp)',
          'b, sq, h, d = ctx.shape\n    return row_parallel('
          'ctx.reshape(b, sq, h * d), wo.reshape(h * d, -1), tp)'),
         ('return leave(torch.matmul(act * h, p["wo"]), mesh, axes)',
          'return row_parallel(act * h, p["wo"], (mesh, axes))')]

RUN = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.launch import train
ranks = train.main(["--arch", "qwen2-0.5b", "--mesh", "1x2", "--baseline",
                    "--steps", sys.argv[3], "--seq-len", "512",
                    "--global-batch", "8", "--ckpt-every", "1000000",
                    "--seed", "0", "--ckpt-dir", sys.argv[2], "--profile"])
r = ranks[0]
prof = r["profile"]
print("RESULT " + json.dumps({
    "losses": [m["loss"] for m in r["metrics"]],
    "steps_ms": [m["step_s"] * 1e3 for m in r["metrics"]],
    "peak_gib": [x["peak_bytes"] / 2**30 for x in ranks],
    "profile_wall_ms": prof["wall_ms"], "profile_busy_ms": prof["busy_ms"],
    "profile_comm": prof["comm"]}))
'''


def make_variant() -> Path:
    """``src/`` copied to ``VARIANT`` with both swaps made once each."""
    shutil.rmtree(VARIANT, ignore_errors=True)
    shutil.copytree(ROOT / "src", VARIANT / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    blocks = VARIANT / "src" / "repro_torch" / "models" / "blocks.py"
    text = blocks.read_text()
    for old, new in SWAPS:
        if text.count(old) != 1:
            sys.exit(f"row_parallel_cost: {old!r} is not in blocks.py once")
        text = text.replace(old, new)
    blocks.write_text(text)
    return VARIANT / "src"


def run(src: Path, tag: str) -> dict:
    ckpt = ROOT / "build" / f"row_parallel_cost_{tag}"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", RUN, str(src), str(ckpt),
                          str(STEPS)], capture_output=True, text=True,
                         cwd=ROOT)
    shutil.rmtree(ckpt, ignore_errors=True)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT")]
    if out.returncode or not lines:
        sys.exit(f"row_parallel_cost: run {tag} failed:\n"
                 f"{out.stderr[-4000:]}")
    res = json.loads(lines[0].removeprefix("RESULT "))
    res["median_ms"] = statistics.median(res["steps_ms"][1:])
    print(f"run: {tag} {time.perf_counter() - t0:.1f} s {json.dumps(res)}",
          flush=True)
    return res


def main() -> int:
    variant = make_variant()
    order = [("A1", ROOT / "src"), ("B1", variant), ("B2", variant),
             ("A2", ROOT / "src")]
    res = {tag: run(src, tag) for tag, src in order}
    a = [res["A1"]["median_ms"], res["A2"]["median_ms"]]
    b = [res["B1"]["median_ms"], res["B2"]["median_ms"]]
    print(f"row_parallel_cost: ms a step (median of steps 1-{STEPS - 1}), "
          f"bf16 sums {a}, fp32 sums {b}: fp32/bf16 "
          f"{statistics.mean(b) / statistics.mean(a):.4f}; profiled step's "
          f"collective bytes bf16 {res['A1']['profile_comm']['bytes']}, "
          f"fp32 {res['B1']['profile_comm']['bytes']}")
    shutil.rmtree(VARIANT, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
