#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment: torch/CUDA versions, the card's name and power limit;
  2. build every kernel source with nvcc (one process per source, in
     parallel) and print the seconds;
  3. the main path at real size through ``repro_torch.api.launch``:
     STREAM copy/scale/add/triad and the Schoenauer triad at n = 2**27
     (fp32 and bf16) and at one ragged n, a phase sweep of
     ``vector_triad_phased`` (stream k at element phase k*p, p = 0..64), and
     ``jacobi_sweeps`` on a 16384 x 16384 fp32 grid; launch counters are
     zeroed just before and read just after, and every output is checked
     against the registered plain oracle on the card;
  4. each kernel against its plain PyTorch version on the same inputs at
     the main path's shapes, with the tolerance stated;
  5. CUDA-event times (median of 10 samples after warm-up) of each kernel,
     its plain version and one PyTorch library call computing the same
     function, beside the least time the card could take (``bound_ms``).

The last three lines are the card's name and power limit as nvidia-smi
reports them, the ``kernels`` JSON object and
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N = 1 << 27                # 512 MiB per fp32 array, far above the 50 MB L2
N_RAGGED = N - 12_345
GRID = 16_384              # Jacobi grid edge: 1 GiB per fp32 buffer
SWEEPS = 20
SCALAR = 3.0
PHASES = range(0, 65)

# Data-sheet rates (NVIDIA H100/H200 data sheets): device-memory bytes/s and
# fp32 operations/s outside the tensor cores.  Matched on the card's name.
DATASHEET = [
    ("H200", 4.8e12, 67e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),
]

# Where each TPU kernel this port replaces is defined.
REPLACES = {
    "stream.copy": "src/repro/kernels/stream/kernel.py:21",
    "stream.scale": "src/repro/kernels/stream/kernel.py:25",
    "stream.add": "src/repro/kernels/stream/kernel.py:29",
    "stream.triad": "src/repro/kernels/stream/kernel.py:33",
    "triad": "src/repro/kernels/triad/kernel.py:26",
    "jacobi": "src/repro/kernels/jacobi/kernel.py:31",
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def datasheet(name: str) -> tuple[float, float]:
    for key, bw, fp32 in DATASHEET:
        if key in name:
            return bw, fp32
    fail(f"no data-sheet rates for {name!r}")


def time_ms(fn, samples: int = 10, per_sample: int = 5) -> float:
    """Median ms per call of ``fn`` over ``samples`` CUDA-event windows of
    ``per_sample`` calls each, after a warm-up.  An untimed call is queued
    before each window so the card is busy while the window's calls are
    enqueued."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn()
        start.record()
        for _ in range(per_sample):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_sample)
    return statistics.median(times)


def check_close(what: str, got, want, rtol: float, atol: float) -> float:
    """Fail unless |got - want| <= atol + rtol * |want| everywhere and
    every value is finite; returns the max abs error."""
    import torch

    if got.shape != want.shape:
        fail(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    g, w = got.to(torch.float32), want.to(torch.float32)
    if not bool(torch.isfinite(g).all()):
        fail(f"{what}: non-finite values")
    err = (g - w).abs()
    if bool((err > atol + rtol * w.abs()).any()):
        fail(f"{what}: max abs err {float(err.max())} over rtol {rtol} "
             f"atol {atol}")
    return float(err.max())


def tol(dtype) -> tuple[float, float]:
    """Tolerance of the main path against the plain oracle: the oracle
    rounds after each operation in the array dtype and the kernels round
    once, so bf16 may differ by one bf16 rounding (2e-2 relative, as
    tests/test_kernels.py uses); fp32 kernels and oracles both round each
    product and sum separately (rtol 1e-5, atol 1e-6 as there)."""
    import torch

    return (2e-2, 2e-2) if dtype == torch.bfloat16 else (1e-5, 1e-6)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from repro_torch import api
    from repro_torch.kernels import _build
    from repro_torch.kernels.jacobi import kernel as jacobi_kernel
    from repro_torch.kernels.jacobi import ops as jacobi_ops
    from repro_torch.kernels.jacobi import ref as jacobi_ref
    from repro_torch.kernels.stream import kernel as stream_kernel
    from repro_torch.kernels.stream import ops as stream_ops
    from repro_torch.kernels.triad import kernel as triad_kernel
    from repro_torch.kernels.triad import ops as triad_ops
    from repro_torch.core.layout import hopper_limits
    from repro_torch.kernels.util import to_tiles

    # Full fp32 in the library yardstick's convolution (cuDNN would take
    # TF32 by default) and in any matmul.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 1. environment ---------------------------------------------------
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    bw, fp32_rate = datasheet(kind)
    print(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {kind}, nvidia-smi: {smi}")
    limits = hopper_limits()
    print(f"data sheet: {bw / 1e12} TB/s device memory, "
          f"{fp32_rate / 1e12} TFLOP/s fp32 (non-tensor); planner limits: "
          f"{limits.smem_per_cta} B shared memory per CTA, "
          f"{limits.sm_count} SMs")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    secs = time.perf_counter() - t0
    print(f"build: {sorted(built) or 'cached'} for sm_90a in {secs:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items())})")

    # ---- 3. the main path ----------------------------------------------
    counters = {
        "stream.copy": (stream_kernel.LAUNCHES, "copy"),
        "stream.scale": (stream_kernel.LAUNCHES, "scale"),
        "stream.add": (stream_kernel.LAUNCHES, "add"),
        "stream.triad": (stream_kernel.LAUNCHES, "triad"),
        "triad": (triad_kernel.LAUNCHES, "triad"),
        "jacobi": (jacobi_kernel.LAUNCHES, "jacobi"),
    }
    for table, key in counters.values():
        table[key] = 0

    def run_stream_ops(n, dtype, seed):
        a, b, c = stream_ops.random_vectors(n, 3, dtype, seed=seed)
        cases = {
            "stream.copy": ((a,), {}),
            "stream.scale": ((a,), {"s": SCALAR}),
            "stream.add": ((a, b), {}),
            "stream.triad": ((a, b), {"s": SCALAR}),
            "triad": ((a, b, c), {}),
        }
        for name, (args, kw) in cases.items():
            out = api.launch(name, *args, **kw)
            check_close(f"{name} n={n} {dtype}", out, api.ref(name, *args, **kw),
                        *tol(dtype))
        torch.cuda.synchronize()
        print(f"main: stream copy/scale/add/triad + triad n={n} {dtype}: ok")

    run_stream_ops(N, torch.float32, 0)
    run_stream_ops(N, torch.bfloat16, 1)
    run_stream_ops(N_RAGGED, torch.float32, 2)

    b, c, d = stream_ops.random_vectors(N, 3, torch.float32, seed=3)
    want = api.ref("triad", b, c, d)
    for p in PHASES:
        phases = (p, 2 * p, 3 * p)
        out = triad_ops.vector_triad_phased(b, c, d, phases=phases)
        check_close(f"vector_triad_phased {phases}", out, want,
                    *tol(torch.float32))
    del out, want
    print(f"main: vector_triad_phased n={N} fp32 at phases (p, 2p, 3p), "
          f"p = {PHASES.start}..{PHASES.stop - 1}: ok")

    grid = jacobi_ops.init_grid(GRID, GRID, torch.float32, seed=4)
    check_close("jacobi one sweep", api.launch("jacobi", grid),
                jacobi_ref.jacobi_step(grid), *tol(torch.float32))
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    swept = jacobi_ops.jacobi_sweeps(grid, SWEEPS)
    end.record()
    end.synchronize()
    sweeps_ms = start.elapsed_time(end)
    mlups = jacobi_ops.mlups(GRID, GRID, sweeps_ms / 1e3, SWEEPS)
    check_close(f"jacobi_sweeps x{SWEEPS}", swept,
                jacobi_ref.jacobi_sweeps(grid, SWEEPS), *tol(torch.float32))
    del swept
    print(f"main: jacobi_sweeps {GRID}x{GRID} fp32 x{SWEEPS}: "
          f"{sweeps_ms:.3f} ms, {mlups:.1f} MLUP/s (incl. the copy-in): ok")

    launches = {name: table[key] for name, (table, key) in counters.items()}
    print(f"main: launches {launches}")
    missing = [name for name, count in launches.items() if count == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")

    # ---- 4. kernels against their plain versions ------------------------
    def tiles(name, n, dtype, count, seed):
        plan = api.plan_for(name, (n,), dtype)
        xs = stream_ops.random_vectors(n, count, dtype, seed=seed)
        return plan, [to_tiles(x, plan)[0] for x in xs]

    # fp32 copy/scale/add and jacobi round at most once: bit-exact.  Both
    # triads round the product and the sum separately on both sides
    # (no contraction), so they are expected bit-exact too; the stated
    # tolerance allows FMA contraction (tests/test_kernels.py fp32 tol).
    cases = {}
    for dtype in (torch.float32, torch.bfloat16):
        suffix = "" if dtype == torch.float32 else ".bf16"
        for name, op, count, s, exact in [
            ("stream.copy", "copy", 1, None, True),
            ("stream.scale", "scale", 1, SCALAR, True),
            ("stream.add", "add", 2, None, True),
            ("stream.triad", "triad", 2, SCALAR, False),
        ]:
            plan, xs = tiles(name, N, dtype, count, 5)
            wrapper = getattr(stream_kernel, f"{op}2d")
            args = (*xs, s) if s is not None else tuple(xs)
            cases[name + suffix] = dict(
                kernel=lambda w=wrapper, a=args, p=plan: w(*a, brows=p.block_rows),
                plain=lambda o=op, x=xs, s=s: stream_kernel.plain(o, x, s),
                exact=exact and dtype == torch.float32, dtype=dtype,
                bytes=(count + 1) * N * dtype.itemsize,
                ops={"copy": 0, "scale": 1, "add": 1, "triad": 2}[op] * N,
                library={"copy": lambda x=xs: torch.clone(x[0]),
                         "scale": lambda x=xs: torch.mul(x[0], SCALAR),
                         "add": lambda x=xs: torch.add(x[0], x[1]),
                         "triad": lambda x=xs: torch.add(x[0], x[1], alpha=SCALAR),
                         }[op])
        plan, xs = tiles("triad", N, dtype, 3, 6)
        cases["triad" + suffix] = dict(
            kernel=lambda x=xs, p=plan: triad_kernel.triad2d(*x, brows=p.block_rows),
            plain=lambda x=xs: triad_kernel.plain(*x),
            exact=False, dtype=dtype, bytes=4 * N * dtype.itemsize, ops=2 * N,
            library=lambda x=xs: torch.addcmul(*x))
    jplan = api.plan_for("jacobi", (GRID - 2, GRID), torch.float32)
    jsrc = jacobi_ops.pitched(grid, jplan)
    jdst = torch.empty_like(jsrc)
    weight = torch.tensor([[0.0, 0.25, 0.0], [0.25, 0.0, 0.25],
                           [0.0, 0.25, 0.0]], device=grid.device)[None, None]
    cases["jacobi"] = dict(
        kernel=lambda: jacobi_kernel.sweep(jsrc, jdst, n_cols=GRID,
                                           brows=jplan.block_rows),
        plain=lambda: jacobi_kernel.plain(jsrc, torch.empty_like(jsrc), GRID),
        exact=True, dtype=torch.float32, bytes=2 * GRID * GRID * 4,
        ops=4 * (GRID - 2) * (GRID - 2),
        library=lambda: F.conv2d(grid[None, None], weight))

    errors = {}
    for name, case in cases.items():
        got = case["kernel"]()
        want = case["plain"]()
        rtol, atol = (0.0, 0.0) if case["exact"] else tol(case["dtype"])
        errors[name] = check_close(f"{name} kernel vs plain", got, want, rtol,
                                   atol)
        print(f"check: {name} kernel vs plain: max abs err {errors[name]:.3g} "
              f"(tolerance rtol {rtol} atol {atol})")
        del got, want
    torch.cuda.synchronize()

    # ---- 5. times -------------------------------------------------------
    time_ms(cases["triad"]["kernel"], samples=20)   # warm-up, discarded
    times = {}
    for name, case in cases.items():
        bound_bytes = case["bytes"] / bw * 1e3
        bound_ops = case["ops"] / fp32_rate * 1e3
        times[name] = {
            "ms": time_ms(case["kernel"]),
            "plain_ms": time_ms(case["plain"]),
            "library_ms": time_ms(case["library"]),
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        }
        t = times[name]
        print(f"time: {name}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"{case['bytes'] / t['ms'] / 1e6:.1f} GB/s effective")

    print(f"time: jacobi kernel "
          f"{jacobi_ops.mlups(GRID, GRID, times['jacobi']['ms'] / 1e3):.1f} "
          f"MLUP/s per sweep of {GRID}x{GRID} fp32")

    vplan = api.plan_for("triad", (N,), torch.float32)
    for p in PHASES:
        phased = [triad_ops.phased_tiles(x, k * p, vplan)
                  for k, x in zip((1, 2, 3), (b, c, d))]
        ms = time_ms(lambda t=phased: triad_kernel.triad2d(
            *t, brows=vplan.block_rows))
        gbs = triad_ops.triad_bytes(N, 4, rfo=False) / ms / 1e6
        print(f"phase: triad phases ({p}, {2 * p}, {3 * p}) elements: "
              f"{ms:.4f} ms, {gbs:.1f} GB/s effective")
        del phased

    kernels = []
    for name in REPLACES:
        src = "jacobi.cu" if name == "jacobi" else "stream.cu"
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errors[name], **times[name],
        })

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
