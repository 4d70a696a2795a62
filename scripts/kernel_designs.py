#!/usr/bin/env python3
"""Time the shipped STREAM and RMSNorm kernels beside the designs they were
chosen over, on one NVIDIA GPU.

    python3 scripts/kernel_designs.py

The alternatives live in ``scripts/kernel_designs/`` and are built here
with nvcc (one process each, in parallel) into ``build/kernel_designs/``:

  * ``stream_ring.cu``: persistent CTAs (occupancy x SMs) fed by a ring of
    1-D bulk asynchronous copies in shared memory, as many 16 KB stages as
    fit 227 KB (``ring``), at most 4 (``ring_k4``), or with an evict-first
    L2 policy (``ring_ef``);
  * ``stream_persistent.cu``: persistent 256-thread CTAs, 4 independent
    16-B streaming loads per stream per thread (``persistent``);
  * ``rmsnorm_ring.cu``: persistent CTAs that stream their rows through a
    2- or 4-stage ring of bulk copies (``ring2``, ``ring4``).

Each runs at the main path's shapes (those of ``chip_smoke.py``: STREAM and
the triad at n = 2**27 in fp32 and bf16 on the plan's tiles; RMSNorm in
bf16 at the decode (8, 2560), prefill (2048, 2560), training (4096, 896)
and gated (2048, 4096) shapes), checked bit for bit against the shipped
kernel, and timed with ``repro_torch.measure.timing.time_ms`` beside the
shipped kernel and the library call.  The designs of a shape are timed twice, in one order and
then in the reverse one, and each time is the mean of its two: a drift of
the card's clocks over the run then falls on every design alike.  One
``design:`` line a shape gives each time and its ratio to the library's;
the card's name and power limit come first.  Exits non-zero without a CUDA
device.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

DESIGNS = ROOT / "scripts" / "kernel_designs"
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "kernel_designs"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC), "-I", str(DESIGNS))
# name: (source, extra nvcc flags)
BUILDS = {
    "ring": ("stream_ring.cu", ()),
    "ring_k4": ("stream_ring.cu", ("-DSTREAM_MAX_STAGES=4",)),
    "ring_ef": ("stream_ring.cu", ("-DSTREAM_EVICT_FIRST=1",)),
    "persistent": ("stream_persistent.cu", ()),
    "ring2": ("rmsnorm_ring.cu", ("-DRMS_STAGES=2",)),
    "ring4": ("rmsnorm_ring.cu", ("-DRMS_STAGES=4",)),
}
STREAM_DESIGNS = ("ring", "ring_k4", "ring_ef", "persistent")
RMS_DESIGNS = ("ring2", "ring4")
N = 1 << 27
RMS_SHAPES = [((8, 2560), False), ((2048, 2560), False), ((4096, 896), False),
              ((2048, 4096), True)]


def build() -> dict[str, ctypes.CDLL]:
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {name: subprocess.Popen(
        ["nvcc", *FLAGS, *extra, "-o", str(OUT / f"{name}.so"),
         str(DESIGNS / src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, (src, extra) in BUILDS.items()}
    libs = {}
    for name, proc in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"kernel_designs: nvcc {name} failed:\n{out}")
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    for name in STREAM_DESIGNS:
        fn = libs[name].design_stream
        fn.argtypes = [ctypes.c_int, ctypes.c_int, P, P, P, P, ctypes.c_float,
                       I64, I64, I64, P]
        fn.restype = ctypes.c_int
    for name in RMS_DESIGNS:
        fn = libs[name].design_rmsnorm
        fn.argtypes = [ctypes.c_int, P, P, P, P, I64, I64, I64, I64,
                       ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return libs


def abba(fns: dict) -> dict[str, float]:
    """ms of each callable: timed in order and in reverse, the mean."""
    from repro_torch.measure.timing import time_ms

    first = {k: time_ms(f) for k, f in fns.items()}
    second = {k: time_ms(fns[k]) for k in reversed(list(fns))}
    return {k: (first[k] + second[k]) / 2 for k in fns}


def line(what: str, ms: dict, bound: float) -> str:
    lib = ms.get("library")
    parts = [f"{k} {v:.4f} ms" + (f" ({v / lib:.3f} of library)" if lib and
                                   k != "library" else "")
             for k, v in ms.items()]
    return (f"design: {what}: " + ", ".join(parts)
            + f"; bound {bound:.4f} ms, shipped at {bound / ms['shipped']:.1%}"
            " of it")


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from repro_torch import api
    from repro_torch.measure.timing import datasheet
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.stream import kernel as stream_kernel
    from repro_torch.kernels.stream import ops as stream_ops
    from repro_torch.kernels.util import to_tiles

    if not torch.cuda.is_available():
        print("kernel_designs: no CUDA device is available", file=sys.stderr)
        return 1
    print(chip_smoke.nvidia_smi_line())
    bw, _ = datasheet(torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    libs = build()
    print(f"design: built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    stream = torch.cuda.current_stream().cuda_stream
    ops = {"copy": (1, None, lambda x: torch.clone(x[0])),
           "scale": (1, 3.0, lambda x: torch.mul(x[0], 3.0)),
           "add": (2, None, lambda x: torch.add(x[0], x[1])),
           "triad": (2, 3.0, lambda x: torch.add(x[0], x[1], alpha=3.0)),
           "vtriad": (3, None, lambda x: torch.addcmul(*x))}
    for dtype in (torch.float32, torch.bfloat16):
        for op, (count, s, library) in ops.items():
            name = "triad" if op == "vtriad" else f"stream.{op}"
            plan = api.plan_for(name, (N,), dtype)
            xs = [to_tiles(x, plan)[0] for x in
                  stream_ops.random_vectors(N, count, dtype, seed=5)]
            rows, width = xs[0].shape
            brows = plan.block_rows
            scalar = 0.0 if s is None else stream_kernel.round_scalar(s, dtype)
            want = stream_kernel.launch_cuda(op, xs, s, brows)
            fns = {"library": lambda x=xs, f=library: f(x),
                   "shipped": lambda x=xs: stream_kernel.launch_cuda(
                       op, x, s, brows)}
            for design in STREAM_DESIGNS:
                out = torch.empty_like(xs[0])
                ptrs = [x.data_ptr() for x in xs] + [None] * (3 - count)

                def run(fn=libs[design].design_stream, out=out, ptrs=ptrs):
                    code = fn(stream_kernel.OPS[op],
                              stream_kernel.DTYPES[dtype], *ptrs,
                              out.data_ptr(), scalar, rows, width, brows,
                              stream)
                    if code:
                        raise RuntimeError(f"{design}: CUDA error {code}")

                run()
                if not torch.equal(out, want):
                    raise SystemExit(f"kernel_designs: {design} {op} {dtype} "
                                     f"differs from the shipped kernel")
                fns[design] = run
            bound = (count + 1) * N * dtype.itemsize / bw * 1e3
            print(line(f"{op} n=2**27 {dtype}", abba(fns), bound), flush=True)
            del xs, want, fns
            torch.cuda.empty_cache()

    for (rows, width), gated in RMS_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(rows + width)
        x, z = (torch.randn((rows, width), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        sc = (torch.randn(width, generator=gen, device="cuda") + 1).to(
            torch.bfloat16)
        brows = api.plan_for("rmsnorm.gated" if gated else "rmsnorm",
                             (rows, width), torch.bfloat16).block_rows

        def shipped():
            if gated:
                return rms_kernel.gated_rmsnorm2d(x, z, sc, d_logical=width,
                                                  brows=brows)
            return rms_kernel.rmsnorm2d(x, sc, d_logical=width, brows=brows)

        want = shipped()
        fns = {} if gated else {"library": lambda: F.rms_norm(
            x, (width,), weight=sc, eps=1e-6)}
        fns["shipped"] = shipped
        if rows > 132:
            for design in RMS_DESIGNS:
                out = torch.empty_like(x)

                def run(fn=libs[design].design_rmsnorm, out=out):
                    code = fn(int(gated), x.data_ptr(), z.data_ptr(),
                              sc.data_ptr(), out.data_ptr(), rows, width,
                              brows, width, 1e-6, stream)
                    if code:
                        raise RuntimeError(f"{design}: CUDA error {code}")

                run()
                if not torch.equal(out, want):
                    raise SystemExit(f"kernel_designs: {design} rmsnorm "
                                     f"{(rows, width)} differs from the "
                                     f"shipped kernel")
                fns[design] = run
        bound = (3 if gated else 2) * rows * width * 2 / bw * 1e3
        print(line(f"rmsnorm{'.gated' if gated else ''} {(rows, width)} bf16",
                   abba(fns), bound), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
