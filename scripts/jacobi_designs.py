#!/usr/bin/env python3
"""Time the Jacobi sweep (B6) at the shapes of ``chip_smoke.py`` beside the
designs it was chosen over, on one NVIDIA GPU.

    python3 scripts/jacobi_designs.py

``csrc/jacobi.cu`` is built as the port builds it and launched through its
wrapper (``kernels/jacobi/kernel.py``), in the plan's 2-D tiles.  The other
candidates are built here with nvcc (one process each, in parallel) into
``build/jacobi_designs/``:

  * ``strip=S``, ``tile=128t``: the shipped kernel in strips of S rows, or
    in tiles of 128 threads, instead of the plan's;
  * ``tma 8``: ``scripts/jacobi_designs/jacobi_ring.cu``, the same tiles
    fed by a ring of 8 bulk asynchronous copies (TMA) in shared memory;
  * ``old``: ``scripts/jacobi_designs/jacobi_rows.cu``, the mapping the
    port had before, one CTA a full-width row (its plan's one row a CTA);
  * ``row entry`` (the slab only): the shipped row entry, which sweeps the
    slab's middle row from its three rows where they lie, as a mesh rank's
    boundary row is swept;
  * ``copy``: ``Tensor.copy_`` of the same pitched grid, what the card gives
    a plain read and write of these bytes;
  * ``conv2d``: ``F.conv2d`` with the 5-point weights on the unpitched grid,
    cuDNN's TF32 off.

At 16384^2 in fp32 and bf16, and at a (3, 16384) fp32 boundary slab, each
sweep is checked bit for bit against the plain version, and everything is
timed with ``repro_torch.measure.timing.time_ms``, in one order and then
in the reverse one, the mean of the two kept.  One ``design:`` line a shape gives each
time and its share of the bound (bytes: the pitched grid read once and
written once, over the data sheet's rate), after the card's name and power
limit and ptxas's registers and spills of each build.  Exits non-zero
without a CUDA device.
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

DESIGNS = ROOT / "scripts" / "jacobi_designs"
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "jacobi_designs"
# name: (source, C entry)
BUILDS = {
    "shipped": (CSRC / "jacobi.cu", "jacobi_launch"),
    "tma 8": (DESIGNS / "jacobi_ring.cu", "design_jacobi_ring"),
    "old": (DESIGNS / "jacobi_rows.cu", "design_jacobi_rows"),
}
GRID = 16384
SHAPES = [((GRID, GRID), "float32"), ((GRID, GRID), "bfloat16"),
          ((3, GRID), "float32")]
STRIPS = (2, 8, 32)


def build() -> dict[str, tuple[ctypes.CDLL, list[dict]]]:
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    flags = [*_build.NVCC_FLAGS, "-I", str(CSRC), "-I",
             str(ROOT / "scripts" / "kernel_designs")]
    jobs = {}
    for name, (src, _) in BUILDS.items():
        so = OUT / (name.replace(" ", "_") + ".so")
        jobs[name] = (subprocess.Popen(
            [_build._nvcc(), *flags, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"jacobi_designs: nvcc {name} failed:\n{out}")
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, BUILDS[name][1])
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        fn.argtypes = ([ctypes.c_int, ctypes.c_int, ptr, ptr] + [i64] * 5
                       + ([] if name == "old" else [i64]) + [ptr])
        fn.restype = ctypes.c_int
        libs[name] = (fn, _build.parse_ptxas(out))
    return libs


def abba(fns: dict) -> dict[str, float]:
    """ms of each callable: timed in order and in reverse, the mean."""
    from repro_torch.measure.timing import time_ms

    first = {k: time_ms(f) for k, f in fns.items()}
    second = {k: time_ms(fns[k]) for k in reversed(list(fns))}
    return {k: (first[k] + second[k]) / 2 for k in fns}


def line(what: str, ms: dict, bound: float) -> str:
    parts = [f"{k} {v:.4f} ms ({bound / v:.1%} of bound)"
             for k, v in ms.items()]
    return (f"design: {what}: " + ", ".join(parts)
            + f"; bound {bound:.4f} ms (bytes)")


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from repro_torch import api
    from repro_torch.measure.timing import datasheet
    from repro_torch.kernels import _build
    from repro_torch.kernels.jacobi import kernel
    from repro_torch.kernels.jacobi import ops
    from repro_torch.kernels.stream.kernel import DTYPES

    if not torch.cuda.is_available():
        print("jacobi_designs: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.nvidia_smi_line())
    bw, _ = datasheet(torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    _build.library("jacobi")
    libs = build()
    print(f"design: built jacobi.cu and {sorted(libs)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, (_, entries) in libs.items():
        print(f"design: registers {name}: " + ("; ".join(
            f"{e['kernel']} {e['registers']} (spills {e['spill_bytes']} B, "
            f"smem {e['smem']} B)" for e in entries) if entries else
            "reused from the build directory, ptxas not run"))
    stream = torch.cuda.current_stream().cuda_stream
    dev = torch.cuda.current_device()
    print(f"design: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    for (n, m), name in SHAPES:
        dtype = getattr(torch, name)
        plan = api.plan_for("jacobi", (n - 2, m), dtype)
        grid = ops.init_grid(n, m, dtype, seed=n + m)
        src = ops.pitched(grid, plan)
        dst = torch.empty_like(src)
        want = kernel.plain(src, torch.empty_like(src), m)
        strip, tile = plan.block_shape
        vec = 16 // src.element_size()
        args = (dev, DTYPES[dtype], src.data_ptr(), dst.data_ptr(), n,
                src.shape[1], m, src.stride(0))

        def sweep(block):
            return lambda: kernel.sweep(src, dst, n_cols=m, block=block)

        fns = {f"shipped {strip}x{tile}": sweep(plan.block_shape)}
        if n > 3:
            fns.update({f"strip={s}": sweep((s, tile)) for s in STRIPS})
        fns["tile=128t"] = sweep((strip, 128 * vec))
        for design, (fn, _) in libs.items():
            if design == "shipped":
                continue
            extra = (1,) if design == "old" else (strip, tile)

            def run(fn=fn, extra=extra, design=design):
                code = fn(*args, *extra, stream)
                if code:
                    raise RuntimeError(f"{design}: CUDA error {code}")

            fns[design] = run
        for what, fn in fns.items():
            dst.fill_(-1.0)
            fn()
            if not torch.equal(dst, want):
                raise SystemExit(f"jacobi_designs: {what} at {(n, m)} {name} "
                                 f"differs from the plain version")
        if n == 3:
            halo = grid[0].clone()
            row = torch.empty_like(src[1])
            kernel.sweep_row(halo, src[1], src[2], row, n_cols=m)
            if not torch.equal(row, want[1]):
                raise SystemExit("jacobi_designs: the row entry differs from "
                                 "the plain version")
            fns["row entry"] = lambda: kernel.sweep_row(halo, src[1], src[2],
                                                        row, n_cols=m)
        fns["copy"] = lambda: dst.copy_(src)
        weight = torch.tensor([[0.0, 0.25, 0.0], [0.25, 0.0, 0.25],
                               [0.0, 0.25, 0.0]], device="cuda",
                              dtype=dtype)[None, None]
        fns["conv2d"] = lambda: F.conv2d(grid[None, None], weight)
        bound = 2 * n * src.shape[1] * src.element_size() / bw * 1e3
        print(line(f"jacobi {(n, m)} {name}, plan block {strip}x{tile}",
                   abba(fns), bound), flush=True)
        del grid, src, dst, want, fns
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
