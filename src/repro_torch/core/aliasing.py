"""Interleaved-memory conflict model (the paper's address->controller map).

The UltraSPARC T2 maps a physical address to one of four memory controllers
via bits 8:7 (and to one of two L2 banks per controller via bit 6), so
consecutive 64 B cache lines round-robin through the banks/controllers with a
512 B period.  The paper's whole diagnosis -- period-64 (DP words) bandwidth
collapse, 2x recovery at odd multiples of 32, full recovery under analytic
skew -- follows from this map.

``InterleavedMemoryModel`` keeps that map verbatim (default: 4 channels,
shift 7, 64 B lines) and generalizes it (n_channels, shift) so the same class
models any power-of-two interleaved resource: HBM channel hashing, VMEM
banks, or ICI links round-robined by shard index.  It is used three ways:

  1. ``benchmarks/``: reproduce Figs. 2/4/6/7 analytically (bandwidth vs
     offset / N / layout) and validate the paper's claims in tests,
  2. ``core/autotune.py``: derive optimal skews *analytically* ("no trial and
     error" -- the paper's headline remedy),
  3. as a documentation artifact for the TPU port: the same balance metric is
     applied to shard->link maps in the distribution layer.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Stream:
    """One load or store stream of a kernel."""

    base: int                 # byte address of first element touched
    kind: str = "read"        # "read" | "write"
    stride: int = 0           # extra bytes to skip per line (0 = contiguous)

    def __post_init__(self):
        if self.kind not in ("read", "write"):
            raise ValueError(f"kind must be read|write, got {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class InterleavedMemoryModel:
    """Address-interleaved multi-channel memory.

    channel(addr) = (addr >> channel_shift) % n_channels  -- T2: bits 8:7.
    The interleave *period* is ``n_channels << channel_shift`` bytes (512 B on
    T2 = 64 DP words, the paper's observed offset periodicity).
    """

    n_channels: int = 4
    channel_shift: int = 7
    line_bytes: int = 64
    peak_bw: float = 16.0       # balanced-envelope bandwidth, GB/s (Fig. 4 top)
    rfo: bool = True            # write streams read-for-ownership first

    # L2 banks: the paper's second interleave level ("bit 6 determines the
    # L2 bank" -- two banks per controller on T2).
    banks_per_channel: int = 2
    bank_shift: int = 6

    @property
    def period_bytes(self) -> int:
        return self.n_channels << self.channel_shift

    @property
    def bank_period_bytes(self) -> int:
        """Full channel x bank rotation period (512 B on T2 either way,
        since banks interleave below the channel bits)."""
        return max(self.period_bytes,
                   self.n_channels * self.banks_per_channel << self.bank_shift)

    def channel(self, addr: int) -> int:
        return (addr >> self.channel_shift) % self.n_channels

    def bank(self, addr: int) -> int:
        """Global bank id: (channel, bank-within-channel)."""
        return self.channel(addr) * self.banks_per_channel + (
            (addr >> self.bank_shift) % self.banks_per_channel
        )

    def bank_balance(self, streams: Sequence[Stream], **kw) -> float:
        """Same lockstep metric at bank granularity (2x the resources, so a
        single contiguous stream sustains at most 1 / (channels*banks))."""
        n_banks = self.n_channels * self.banks_per_channel
        n_ticks = kw.pop("n_ticks", None) or max(
            1, self.bank_period_bytes // self.line_bytes
        )
        chunk = kw.pop("chunk_bytes", None) or n_ticks * self.line_bytes
        n_threads = kw.pop("n_threads", 1)
        counts = np.zeros((n_ticks, n_banks), dtype=np.int64)
        for s in streams:
            weight = 2 if (s.kind == "write" and self.rfo) else 1
            step = self.line_bytes + s.stride
            for t in range(n_threads):
                start = s.base + t * chunk
                for i in range(n_ticks):
                    counts[i, self.bank(start + i * step)] += weight
        total = counts.sum()
        if total == 0:
            return 1.0
        return float(total / n_banks / counts.max(axis=1).sum())

    # ------------------------------------------------------------------
    def tick_histograms(
        self,
        streams: Sequence[Stream],
        *,
        n_threads: int = 1,
        chunk_bytes: int | None = None,
        n_ticks: int | None = None,
    ) -> np.ndarray:
        """Per-tick channel request counts, shape (n_ticks, n_channels).

        The T2 execution model is *lockstep*: an in-order thread has a single
        outstanding miss, so at tick i every (thread, stream) pair requests
        line i of its own range -- base + t * chunk_bytes + i * line step
        (static OpenMP split / per-device shard).  Writes count double under
        RFO (the line is read for ownership, then written back).  The window
        defaults to one interleave period, which is exact for contiguous
        streams (the pattern repeats with period_bytes / line_bytes ticks).
        """
        if n_ticks is None:
            n_ticks = max(1, self.period_bytes // self.line_bytes)
        if chunk_bytes is None:
            chunk_bytes = n_ticks * self.line_bytes
        counts = np.zeros((n_ticks, self.n_channels), dtype=np.int64)
        for s in streams:
            weight = 2 if (s.kind == "write" and self.rfo) else 1
            step = self.line_bytes + s.stride
            for t in range(n_threads):
                start = s.base + t * chunk_bytes
                for i in range(n_ticks):
                    counts[i, self.channel(start + i * step)] += weight
        return counts

    def balance(self, streams: Sequence[Stream], **kw) -> float:
        """Fraction of peak bandwidth the channel system can sustain.

        At each lockstep tick the channels drain their queues in parallel, so
        the tick costs ``max_c requests_c(i)`` channel cycles; a perfectly
        balanced system would spend ``total(i) / n_channels``.  The sustained
        fraction over the window is

            sum_i total(i) / n_channels  /  sum_i max_c requests_c(i)

        which is 1/n_channels when every stream aliases onto one controller
        (the paper's zero-offset collapse) and 1.0 under full skew.
        """
        ticks = self.tick_histograms(streams, **kw)
        total = ticks.sum()
        if total == 0:
            return 1.0
        serial = ticks.max(axis=1).sum()
        return float(total / self.n_channels / serial)

    def mean_channels_hit(self, streams: Sequence[Stream], **kw) -> float:
        """Average number of distinct controllers addressed per tick -- the
        paper's own back-of-envelope metric ("two controllers are addressed,
        leading to an expected performance improvement of 100%")."""
        ticks = self.tick_histograms(streams, **kw)
        return float((ticks > 0).sum(axis=1).mean())

    def bandwidth(self, streams: Sequence[Stream], **kw) -> float:
        """Model bandwidth in GB/s: balance x balanced envelope."""
        return self.balance(streams, **kw) * self.peak_bw

    # ------------------------------------------------------------------
    def stream_triad_curve(
        self,
        *,
        n_elements: int,
        elem_bytes: int = 8,
        offsets: Iterable[int],
        n_threads: int = 64,
        n_arrays: int = 3,
        write_idx: int = 0,
    ) -> dict[int, float]:
        """Paper Fig. 2 generator: bandwidth vs COMMON-block offset.

        Arrays are laid out back to back (Fortran COMMON): array k starts at
        k * (n_elements + offset) * elem_bytes.  ``write_idx`` marks the
        store stream (A for triad, C for copy ... the caller decides).
        """
        out: dict[int, float] = {}
        for off in offsets:
            ndim = (n_elements + off) * elem_bytes
            streams = [
                Stream(base=k * ndim, kind=("write" if k == write_idx else "read"))
                for k in range(n_arrays)
            ]
            chunk = (n_elements // max(n_threads, 1)) * elem_bytes
            out[off] = self.bandwidth(streams, n_threads=n_threads, chunk_bytes=chunk)
        return out


# ---- analytic skew derivation (the "no trial and error" claim) ------------

def analytic_skews(model: InterleavedMemoryModel, n_streams: int) -> list[int]:
    """Offsets that place stream k on channel (c0 + k) mod n_channels.

    On T2 this yields 0, 128, 256, 384 B for the four vector-triad streams --
    exactly the paper's optimal offsets -- because one channel step is
    ``1 << channel_shift`` bytes.
    """
    step = 1 << model.channel_shift
    return [k * step for k in range(n_streams)]


def exhaustive_best_skews(
    model: InterleavedMemoryModel,
    n_streams: int,
    *,
    write_idx: int = 0,
    granularity: int | None = None,
) -> tuple[list[int], float]:
    """Brute-force the best per-stream offsets over one interleave period.

    Exists to *verify* ``analytic_skews`` in tests (the paper's point is that
    the analytic answer matches the exhaustive one).  Stream 0 is pinned at
    offset 0; the rest scan the period at line granularity.
    """
    gran = granularity or model.line_bytes
    period = model.period_bytes
    choices = range(0, period, gran)
    best: tuple[list[int], float] = ([0] * n_streams, -1.0)
    for combo in itertools.product(choices, repeat=n_streams - 1):
        offs = [0, *combo]
        streams = [
            Stream(base=o, kind=("write" if k == write_idx else "read"))
            for k, o in enumerate(offs)
        ]
        b = model.balance(streams, chunk_bytes=period)
        if b > best[1]:
            best = (offs, b)
    return best


def layout_balance(
    model: InterleavedMemoryModel,
    stream_bases: Sequence[int],
    write_mask: Sequence[bool],
    **kw,
) -> float:
    """Balance score for an arbitrary set of stream base addresses -- used to
    compare data layouts (e.g. LBM IJKv vs IvJK) where the layout, not an
    explicit pad, determines the bases."""
    streams = [
        Stream(base=b, kind=("write" if w else "read"))
        for b, w in zip(stream_bases, write_mask)
    ]
    return model.balance(streams, **kw)
