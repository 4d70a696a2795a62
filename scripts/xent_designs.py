#!/usr/bin/env python3
"""Time the cross-entropy kernels (B11, B12) at the shapes of
``chip_smoke.py`` beside the mappings and paths they were chosen over, on
one NVIDIA GPU.

    python3 scripts/xent_designs.py

``csrc/xent.cu`` is built as the port builds it and launched through its
wrappers (``kernels/xent/kernel.py``).  At each shape the kernel is checked
against its plain version and timed with
``repro_torch.measure.timing.time_ms`` at the plan's rows a CTA beside:

  * ``rows=N``: the same kernel walking N rows a CTA instead of the plan's
    (the narrow ragged shapes only);
  * ``read``: ``torch.amax(x, -1)``, a read of the same logits by one
    PyTorch reduction, what the card gives a plain read of these bytes;
  * ``library``: ``F.cross_entropy`` on the same logits, where it computes
    the same function (every column counts);
  * ``pad+kernel``: at a width of no whole number of 16-B vectors, the
    path before the kernel read ragged rows: ``F.pad`` to whole vectors,
    then the kernel on the padded copy.

Each is timed in one order and then in the reverse one, the mean of the
two kept.  One ``design:`` line a shape gives each time, the bound (bytes:
the logits read once, labels and outputs once, over the data sheet's rate)
and each one's share of it, after the card's name and power limit and
ptxas's registers of each kernel.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# (tokens, width, logical vocab) for B11; (tokens, width, vl, offset,
# logical vocab) for B12; dtype; the rows a CTA to try beside the plan's
B11_SHAPES = [((3584, 51865, 51865), "float32", ()),
              ((3584, 51865, 51865), "bfloat16", ()),
              ((4096, 151936, 151936), "float32", ()),
              ((2048, 122753, 122753), "float32", ()),
              ((1000, 32008, 32000), "bfloat16", (1, 2, 4, 8))]
B12_SHAPES = [((4096, 75968, 75968, 75968, 151936), "float32", ()),
              ((1000, 32008, 32000, 96000, 127990), "bfloat16", (1, 2, 4, 8))]


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
    from repro_torch.kernels.xent import kernel

    if not torch.cuda.is_available():
        print("xent_designs: no CUDA device is available", file=sys.stderr)
        return 1
    print(chip_smoke.nvidia_smi_line())
    bw, _ = datasheet(torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    _build.library("xent")
    ptxas = _build.PTXAS.get("xent")
    print(f"design: xent.cu ready in {time.perf_counter() - t0:.1f} s; "
          + ("registers per instantiation: " + "; ".join(
              f"{e['kernel']} {e['registers']} (spills {e['spill_bytes']} B)"
              for e in ptxas) if ptxas else
             "reused from the build directory, ptxas not run"))

    for (t, v, lv), name, extra_rows in B11_SHAPES:
        dtype = getattr(torch, name)
        brows = api.plan_for("xent", (t, v), dtype).block_rows
        gen = torch.Generator(device="cuda").manual_seed(t + v)
        x = (3 * torch.randn((t, v), generator=gen, device="cuda")).to(dtype)
        lab = torch.randint(0, lv, (t,), generator=gen, device="cuda",
                            dtype=torch.int32)
        chip_smoke.check_close(
            f"xent_designs ({t}, {v})",
            kernel.xent_nll(x, lab, logical_v=lv, brows=brows),
            kernel.plain(x, lab, lv), 1e-5, 1e-5)
        fns = {f"rows={r}": lambda r=r: kernel.xent_nll(
            x, lab, logical_v=lv, brows=r) for r in (brows, *extra_rows)}
        fns["read"] = lambda: torch.amax(x, -1)
        if lv == v:
            lab64 = lab.to(torch.int64)
            fns["library"] = lambda: F.cross_entropy(x, lab64)
        vec = 16 // x.element_size()
        if v % vec:
            vp = -(-v // vec) * vec
            fns["pad+kernel"] = lambda: kernel.xent_nll(
                F.pad(x, (0, vp - v)), lab, logical_v=lv, brows=brows)
        bound = (t * v * x.element_size() + 8 * t) / bw * 1e3
        print(line(f"xent ({t}, {v}) logical {lv} {name}, plan rows a CTA "
                   f"{brows}", abba(fns), bound), flush=True)
        del x, lab, fns
        torch.cuda.empty_cache()

    for (t, width, vl, off, lv), name, extra_rows in B12_SHAPES:
        dtype = getattr(torch, name)
        brows = api.plan_for("xent", (t, vl), dtype, local=True).block_rows
        gen = torch.Generator(device="cuda").manual_seed(t + width + off)
        x = (3 * torch.randn((t, width), generator=gen, device="cuda")).to(
            dtype)
        lab = torch.randint(0, lv, (t,), generator=gen, device="cuda",
                            dtype=torch.int32)
        chip_smoke.check_partials(
            f"xent_designs partial ({t}, {width})",
            kernel.xent_partials(x, lab, vl=vl, off=off, logical_v=lv,
                                 brows=brows),
            kernel.plain_partials(x, lab, vl=vl, off=off, logical_v=lv),
            dtype)
        fns = {f"rows={r}": lambda r=r: kernel.xent_partials(
            x, lab, vl=vl, off=off, logical_v=lv, brows=r)
            for r in (brows, *extra_rows)}
        fns["read"] = lambda: torch.amax(x, -1)
        bound = (t * width * x.element_size() + 16 * t) / bw * 1e3
        print(line(f"xent.partial ({t}, {width}) vl {vl} off {off} {name}, "
                   f"plan rows a CTA {brows}", abba(fns), bound), flush=True)
        del x, lab, fns
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
