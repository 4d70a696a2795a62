"""CUDA-event timing and the data-sheet rates the port's bounds divide by.

The one copy of the timer that ``chip_smoke.py``, ``measure.validate``,
``measure.sweep`` and the design scripts under ``scripts/`` use.  Nothing
here runs without a card: the timer raises on a host with no CUDA device,
so a CPU run never reports a time as the card's.
"""
from __future__ import annotations

import statistics

# Data-sheet rates (NVIDIA H100/H200 data sheets): device-memory bytes/s and
# fp32 operations/s outside the tensor cores.  Matched on the card's name.
DATASHEET = [
    ("H200", 4.8e12, 67e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),
]

# GPU cycles the card spins before each timing window (about 2 ms at the
# H100's boost clock): longer than the host takes to enqueue a window of
# microsecond kernels, so the window times the card, not the host.
SPIN_CYCLES = 4_000_000


def datasheet(name: str) -> tuple[float, float]:
    """(device-memory bytes/s, fp32 operations/s) of the card ``name``
    (``torch.cuda.get_device_name``); raises ``LookupError`` for a card
    the table does not hold."""
    for key, bw, fp32 in DATASHEET:
        if key in name:
            return bw, fp32
    raise LookupError(f"no data-sheet rates for {name!r}")


def require_cuda(what: str) -> None:
    """Raise unless a CUDA device is present: ``what`` is timed on the card
    and has no CPU stand-in."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} times on a CUDA device and none is "
                           f"available")


def time_ms(fn, samples: int = 10, per_sample: int = 5) -> float:
    """Median ms per call of ``fn`` over ``samples`` CUDA-event windows of
    ``per_sample`` calls each, after a warm-up.  An untimed call and a spin
    of ``SPIN_CYCLES`` are queued before each window so the card is busy
    while the window's calls are enqueued: the window holds the calls back
    to back on the card, whatever the host's cost of a call."""
    import torch

    require_cuda("time_ms")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(per_sample):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_sample)
    return statistics.median(times)
