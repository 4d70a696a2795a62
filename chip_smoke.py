#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment: torch/CUDA versions, the card's name and power limit;
  2. build every kernel source with nvcc (one process per source, in
     parallel) and print the seconds, ptxas's registers, static shared
     memory and spills of every STREAM and RMSNorm instantiation;
  3. the main path at real size through ``repro_torch.api.launch``:
     STREAM copy/scale/add/triad and the Schoenauer triad at n = 2**27
     (fp32 and bf16) and at one ragged n, a phase sweep of
     ``vector_triad_phased`` (stream k at element phase k*p, p = 0..64),
     ``jacobi_sweeps`` on a 16384 x 16384 fp32 grid, ``lbm_run`` for 20
     D3Q19 steps in both layouts at N = 256 and N = 250 (paper Fig. 7,
     MLUP/s printed), and ``vector_triad_segmented`` at n = 2**27 in 8
     segments (paper Fig. 5); launch counters are zeroed just before and
     read just after, and every output is checked against the registered
     plain oracle (or the flat triad) on the card, and STREAM, the triad
     and the phase sweep bit for bit against the kernels' plain versions;
  3b. serving at full Qwen3-4B width, its depth cut to 18 of 36 layers
     to make room for 3e (bf16, seeded weights, one card):
     ``ContinuousBatcher`` with 8 slots, max_len 1024 and prefill chunk 16
     serves 16 seeded requests (prompts 32-256 tokens, 16-64 new tokens)
     with the paged KV cache and again with the dense one; fatal unless
     every request completes, paged tokens equal dense tokens, two requests
     re-run alone in the same slot geometry give the same tokens, and the
     rmsnorm launch counter, zeroed just before and read just after, is at
     least 37 (2 x 18 layers + the final norm) a decode step.  One
     ``make_prefill_step`` forward at B = 4, S = 512 (rmsnorm on 2048 x
     2560 rows) must give finite logits; ``api.launch("rmsnorm.gated")``
     runs at (2048, 4096);
  3c. training at full Qwen2-0.5B width (24 layers, d_model 896, 14/2
     heads, d_ff 4864, vocab 151936, tied embeddings, QKV bias; bf16 with
     an fp32 master, remat on, seeded weights, one card): first the
     reduced fp32 model's loss and every gradient leaf on the card against
     the CPU, and the full model's first backward (every leaf finite and
     nonzero somewhere); then ``Trainer`` runs 8 AdamW steps on
     ``DataConfig(151936, seq_len 512, batch 8)`` (4096 tokens a step,
     cosine schedule, peak 3e-4, warmup 2) with a checkpoint every 4 steps
     (keep 1) under build/, fatal unless every loss is finite, the loss of
     a batch the run never trains on (batch 8) is lower at the trained
     weights than at the initial ones, the cross-entropy kernel ran once a
     step and RMSNorm
     at least 49 times; a fresh ``Trainer`` restores step 4, whose state
     must equal the one saved bit for bit, and replays steps 4-7: step 4's
     loss must equal the uninterrupted run's bit for bit, later ones to a
     stated tolerance.  The checkpoints are deleted at the end;
  3d. vocab-parallel training on a (1, 2) mesh: the partial cross-entropy
     kernel (B12) first, at the (4096, 75968) vocab shards of M = 2 (both
     shards) and M = 4, fp32 and bf16, and a ragged shard, against its plain
     version (m and ll exact, l to rtol 1e-5 fp32 / 2e-2 bf16), and the
     shards' partials combined into each row's NLL against B11 on the whole
     row (rtol 1e-5); then the vocab-parallel backward on a (2, 2) mesh
     of four ranks on the card: ``xent`` and ``xent_grad`` at (256, 32000),
     logical vocab 31990, and the reduced fp32 model with a vocab of 500
     padded to 512 (``padded_for_mesh``), its loss, gradient norm, every
     gradient leaf and two AdamW steps, each rank's block against the
     one-device port on the card (``mesh_backward_checks``); then the
     full-width Qwen2-0.5B backward in fp32 from ``model.init`` on one
     device against a (1, 2) mesh of two ranks on the card, the loss, the
     norm and every gradient leaf (``full_width_backward_check``, whose
     docstring argues the tolerances); then
     ``python -m repro_torch.launch.train --mesh 1x2``
     (``launch.train.main``) spawns two ranks on the one card (gloo, its
     collectives staged through pinned host buffers) that train Qwen2-0.5B
     at full width from seed 0 for 4 steps of the training phase's batches
     (``--baseline``: the unpadded vocab, so the weights are the training
     phase's), a checkpoint every 2 steps gathered into the one-device
     layout, and one more step profiled on rank 0.  Fatal unless the first
     two losses equal the training phase's to rtol 1e-6 (step 0's rate is
     0 under warmup: both are forwards of the initial weights), every loss
     is finite, the unsharded leaves of the state hold the same bits on both
     ranks, B12 ran once a rank a step and B11 never; a second launch
     restores step 2 and replays steps 2-3, step 2's loss bit-equal.  The
     bf16 gradient norms are printed beside the one-device run's, not
     gated (the training phase prints the one-device step-0 norm beside
     the same batch's as two microbatches, the spread rounding gives).
     ``spmd:`` lines give ms a step, tokens/s, each rank's peak memory, the
     collective transport, the collectives' calls, bytes and host time, and
     the profiled step's busy share.  Two ranks on
     one card stand in for ranks on separate cards: their times are not
     scaling numbers;
  3e. the hybrid at full zamba2-1.2b width, its depth cut to 18 of its 38
     Mamba2 layers to make room for 3f (d_model 2048, d_inner 4096, 64 SSM
     heads of 64, state 64; one shared attention block applied after every
     6, so 3 times; vocab 32000), bf16, seeded weights,
     one card: ``ContinuousBatcher`` with 3b's slots, max_len, prefill
     chunk and 16 requests, paged and dense; fatal unless every request
     completes, paged tokens equal dense tokens, requests 0 and 1 re-run
     alone in the same slot geometry give the batched tokens (a reused
     slot's SSM state is reset), and the counters, zeroed just before and
     read just after, show at least 25 B9 launches (18 mamba ln1, 3 x 2 of
     the shared block, the final norm) and 18 B10 launches (each Mamba2
     gate and norm) a decode step; a ``profile:`` line of one decode tick;
     one ``make_prefill_step`` forward at B = 4, S = 512 (two chunks of
     the SSD, where the reference's forward is NaN; B10 on 2048 x 4096
     rows inside the model) with finite logits and exactly 25 and 18
     launches; the reduced fp32 hybrid's loss and every gradient leaf at
     S = 300 (across a chunk) on the card (B9, B10, B11 under their
     autograd Functions, remat on) against the CPU, loss rtol 1e-5, each
     leaf rtol 1e-4 / atol 1e-2 of its scale, every leaf nonzero; then one
     bf16 forward each of minicpm-2b and qwen3-14b at full width, B = 1,
     S = 512, fatal unless the logits are finite and B9 ran 81 times
     (2 x 40 layers + the final norm), each model freed before the next;
  3f. the ssm family at full xlstm-1.3b width, its depth cut to 24 of its
     48 layers (3 of its 6 x [7 mLSTM, 1 sLSTM] blocks) to make room for
     3g (d_model 2048, mLSTM d_inner 4096 in 4 heads of 1024;
     vocab 50304; no attention), bf16, seeded weights, one card:
     ``ContinuousBatcher`` with 3b's slots, max_len, prefill chunk and 16
     requests, paged and dense; fatal unless every request completes, paged
     tokens equal dense tokens, requests 0 and 1 re-run alone in the same
     slot geometry give the batched tokens (a reused slot's mLSTM and sLSTM
     state is reset), and the counters, zeroed just before and read just
     after, show at least 28 B9 launches (24 ln1, 3 sLSTM output norms on
     fp32 rows, the final norm) and 21 B10 launches (each mLSTM gate and
     norm) a decode step, over the runs and in one decode step alone; a
     ``profile:`` line of one decode tick and one of the mLSTM state
     update's ops on the 2.8 GB of matrix memory (CUDA events, its share
     of the tick); two ``make_prefill_step`` forwards at B = 4, S = 512
     (two mLSTM chunks) with finite logits and exactly 28 and 21 launches
     each, both timed (the first includes warm-up); the reduced fp32
     xlstm's loss and every gradient leaf at S = 300 (past the length
     where the reference's mLSTM gradient is NaN) on the card (B9, B10,
     B11 under their autograd Functions, remat on) against the CPU, loss
     rtol 1e-5, each leaf rtol 1e-4 / atol 1e-2 of its scale, every leaf
     nonzero;
  3g. the moe family at full qwen3-moe-30b-a3b width (48 layers, d_model
     2048, 32/4 heads of 128, 128 experts of d_ff 768, top-8, capacity
     factor 1.25, skewed expert placement; vocab 151936), bf16, seeded
     weights, one card: the whole model initialised on the card (its
     parameter count, bytes and peak memory printed), one
     ``make_prefill_step`` forwards at B = 4, S = 512 through all 48
     layers with finite logits and exactly 97 B9 launches each, both timed
     (the first includes warm-up); ``ContinuousBatcher``
     with 3b's slots, max_len, prefill chunk and 16 requests over the
     first ``MOE_SERVE_LAYERS`` layers (views of the same stacked tensors),
     paged and dense, fatal unless every request completes, paged tokens
     equal dense tokens at the config's capacity factor and the counter,
     zeroed just before and read just after, shows at least 2 x layers + 1
     B9 launches a decode step, over the runs and in one step alone; a
     ``profile:`` line of one decode tick and one of the three expert
     products over the served layers beside their byte bound; requests 0
     and 1 batched and each alone at capacity factor 16 (>= E / k, so
     nothing drops) give the same tokens; the reduced fp32 MoE (top-2 of 8,
     capacity factor 1.0, so assignments drop) loss and every gradient leaf
     on the card (B9, B11 under their autograd Functions, remat on) against
     the CPU with the same expert picks and kept masks, loss rtol 1e-5,
     each leaf within 1e-4 of its scale;
  4. each kernel against its plain PyTorch version on the same inputs at
     the main path's shapes (and at zamba2-1.2b's: B9 at (8, 2048) and
     (2048, 2048), B10 at (8, 4096), bf16; at xlstm-1.3b's sLSTM norm: B9
     on fp32 rows at (8, 2048) and (2048, 2048); and at qwen3-moe-30b-a3b's
     ln1 and ln2: B9 at (8, 2048) and (2048, 2048) bf16), with the
     tolerance stated;
  5. CUDA-event times (median of 10 samples after warm-up) of each kernel,
     its plain version and one PyTorch library call computing the same
     function, beside the least time the card could take (``bound_ms``),
     with the kernel/library ratio and the share of the bound; the kernel
     and the library call are each timed twice, in turns (kernel, library,
     library, kernel), and the mean kept;
     the LBM collision's time per layout and size apart from the whole
     step, and the segmented triad's time over the flat triad's.

A ``serve:`` line gives requests, generated tokens, seconds, tokens/s,
ticks, ms a decode step, preemptions and the page size (for zamba2-1.2b,
xlstm-1.3b and qwen3-moe-30b-a3b also the B9 (and B10) launches a step,
and for xlstm-1.3b and qwen3-moe-30b-a3b a summary with the card's busy
share of a decode tick), and a ``profile:``
line where the device time of one decode tick goes; ``train:`` lines the loss at each
step, ms a step (median of steps 1-7), tokens/s and the peak of
``torch.cuda.max_memory_allocated``, and a ``profile:`` line one train
step.

The last three lines are the card's name and power limit as nvidia-smi
reports them, the ``kernels`` JSON object and
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import math
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
LBM_SIZES = (256, 250)     # 256: N % 64 == 0, 1.27 GB a lattice; 250: ragged
LBM_STEPS = 20
LBM_BF16_N = 64
OMEGA = 1.2
SEGMENTS = 8               # segmented triad: 8 segments, align 128, shift 16
# serving at full Qwen3-4B width
SERVE_ARCH = "qwen3-4b"
# the depth of phase 3b, cut from 36 layers so that the script with
# phase 3e stays near 11 minutes; every width is the config's
SERVE_LAYERS = 18
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_CHUNK, SERVE_REQUESTS = 8, 1024, 16, 16
SERVE_PROMPT, SERVE_GEN = (32, 256), (16, 64)
PREFILL_B, PREFILL_S = 4, 512
GATED_SHAPE = (2048, 4096)  # the d_inner of a zamba2-1.2b Mamba2 block
SEED = 0
# training at full Qwen2-0.5B width
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_CKPT_EVERY = 512, 8, 8, 4
TRAIN_PEAK, TRAIN_WARMUP = 3e-4, 2
# phase 3e: serving at full zamba2-1.2b width (the dense phase's slots,
# max_len, chunk and requests), the reduced hybrid's train step at a length
# that crosses the SSD's 256-token chunk, and full-width prefill forwards of
# the two other dense configs
HYBRID_ARCH = "zamba2-1.2b"
# the depth of phase 3e, cut from 38 Mamba2 layers (6 shared-block
# applications) so that the script with phase 3f stays near 12 minutes;
# every width is the config's
HYBRID_LAYERS = 18
HYBRID_TRAIN_SEQ = 300
DENSE_ARCHS = ("minicpm-2b", "qwen3-14b")
DENSE_PREFILL_S = 512
# phase 3f: serving at full xlstm-1.3b width (the dense phase's slots,
# max_len, chunk and requests), its prefill at two mLSTM chunks, and the
# reduced xlstm's train step at a length past the one where the reference's
# mLSTM gradient is NaN
XLSTM_ARCH = "xlstm-1.3b"
# the depth of phase 3f, cut from 48 layers (3 of its 6 blocks of 7 mLSTM
# and 1 sLSTM) so that the script with phase 3g stays near 13 minutes;
# every width is the config's
XLSTM_LAYERS = 24
XLSTM_TRAIN_SEQ = 300
# phase 3g: the moe family at full qwen3-moe-30b-a3b width (the dense
# phase's slots, max_len, chunk and requests): the whole 48-layer model on
# the card and its prefill forward; serving of its first MOE_SERVE_LAYERS
# layers (views of the same stacked tensors, every width the config's) so
# that the script stays near 13 minutes
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_PARAMS = 30_532_122_624
MOE_SERVE_LAYERS = 16
# isolated re-runs at a capacity factor >= E / k (128 / 8): cap >= T, so
# nothing drops and a request alone must give its batched tokens; the
# first MOE_ISOLATED requests batched, then each alone
MOE_NO_DROP_CF, MOE_ISOLATED = 16.0, 2
# the reduced MoE's train step with real routing (top-2 of 8) at a
# capacity factor where assignments drop
MOE_TRAIN_CF, MOE_TRAIN_SEQ = 1.0, 64
TRAIN_DIR = ROOT / "build" / "chip_smoke_train"
# a replayed step after the first: a backward that sums with atomics may
# change the last bits of a gradient, and a bf16 weight whose fp32 master
# crosses a rounding boundary then moves by one bf16 ulp
REPLAY_RTOL = 1e-3
XENT_RAGGED = (1000, 32_008, 32_000)   # (tokens, width, logical vocab) bf16
# vocab-parallel training on two ranks of the one card
SPMD_MESH, SPMD_STEPS, SPMD_CKPT_EVERY = "1x2", 4, 2
SPMD_DIR = ROOT / "build" / "chip_smoke_spmd"
# the mesh's first two losses against the one-device run's: the schedule's
# warmup gives step 0 a rate of 0, so both are forwards of the same weights
LOSS_RTOL = 1e-6
# the vocab-parallel backward where rounding cannot hide a fault: reduced
# fp32 qwen2-0.5b with a vocab of 500 padded for the model axis to 512 (the
# logical limit inside the last shard) on a (2, 2) mesh of four ranks on the
# card, and the loss alone at (tokens, vocab, logical vocab), both against
# the one-device port on the card from the same inputs
MESH_CHECK, MESH_CHECK_VOCAB, MESH_CHECK_LR = (2, 2), 500, 1e-3
# the full-width fp32 backward, one device against a (1, 2) mesh: the loss,
# the global gradient norm, each leaf as a share of its largest magnitude
# (the argument is in full_width_backward_check)
FULL_LOSS_RTOL, FULL_NORM_RTOL, FULL_LEAF_ATOL = 1e-5, 1e-4, 1e-4
MESH_XENT = (256, 32_000, 31_990)
# a B12 shard with local padding past vl, the vocab ending inside it:
# (tokens, width, vl, offset, logical vocab) bf16
XENT_PARTIAL_RAGGED = (1000, 32_008, 32_000, 96_000, 127_990)

# Data-sheet rates (NVIDIA H100/H200 data sheets): device-memory bytes/s and
# fp32 operations/s outside the tensor cores.  Matched on the card's name.
DATASHEET = [
    ("H200", 4.8e12, 67e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),
]

# Each ported kernel: its CUDA source under src/repro_torch/kernels/csrc/
# and where the TPU kernel it replaces is defined.
KERNELS = {
    "stream.copy": ("stream.cu", "src/repro/kernels/stream/kernel.py:21"),
    "stream.scale": ("stream.cu", "src/repro/kernels/stream/kernel.py:25"),
    "stream.add": ("stream.cu", "src/repro/kernels/stream/kernel.py:29"),
    "stream.triad": ("stream.cu", "src/repro/kernels/stream/kernel.py:33"),
    "triad": ("stream.cu", "src/repro/kernels/triad/kernel.py:26"),
    "jacobi": ("jacobi.cu", "src/repro/kernels/jacobi/kernel.py:31"),
    "lbm.soa": ("lbm.cu", "src/repro/kernels/lbm/kernel.py:51"),
    "lbm.ivjk": ("lbm.cu", "src/repro/kernels/lbm/kernel.py:57"),
    "rmsnorm": ("rmsnorm.cu", "src/repro/kernels/rmsnorm/kernel.py:29"),
    "rmsnorm.gated": ("rmsnorm.cu", "src/repro/kernels/rmsnorm/kernel.py:34"),
    "xent": ("xent.cu", "src/repro/kernels/xent/kernel.py:25"),
    "xent.partial": ("xent.cu", "src/repro/kernels/xent/kernel.py:54"),
}
NO_LIBRARY = {"lbm.soa": "no single PyTorch call computes a BGK collision",
              "lbm.ivjk": "no single PyTorch call computes a BGK collision",
              "rmsnorm.gated": "no single PyTorch call gates x by silu(z) "
                               "before an RMSNorm",
              "xent.ragged": "F.cross_entropy does not mask padded vocab "
                             "columns"}
# the nearest PyTorch call to a kernel that no single call computes
NEAREST = {"xent.partial": "torch.logsumexp(x.float(), -1) of the shard: "
                           "the lse alone, not (m, l, ll)"}


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


# GPU cycles the card spins before each timing window (about 2 ms at the
# H100's boost clock): longer than the host takes to enqueue a window of
# microsecond kernels, so the window times the card, not the host.
SPIN_CYCLES = 4_000_000


def time_ms(fn, samples: int = 10, per_sample: int = 5) -> float:
    """Median ms per call of ``fn`` over ``samples`` CUDA-event windows of
    ``per_sample`` calls each, after a warm-up.  An untimed call and a spin
    of ``SPIN_CYCLES`` are queued before each window so the card is busy
    while the window's calls are enqueued: the window holds the calls back
    to back on the card, whatever the host's cost of a call."""
    import torch

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


def host_ms(fn, calls: int = 10) -> float:
    """Host milliseconds to enqueue one call of ``fn`` (no synchronise
    inside the window; the card drains the queue afterwards)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return ms


def device_profile(label: str, fn, top: int = 6) -> None:
    """Print the device time of one call of ``fn`` by kernel, as
    torch.profiler's CUDA activity records it, beside the call's
    CUDA-event time; their difference is the card's idle time in the
    call.  Returns (CUDA-event ms, device-kernel ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        end.synchronize()
    # device-side events only (kernels, copies, fills): a host op such as
    # aten::roll also reports the time of the kernels it launched
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: e.device_time_total, reverse=True)
    busy = sum(e.device_time_total for e in rows) / 1e3
    wall = start.elapsed_time(end)
    print(f"profile: {label}: {wall:.3f} ms, device kernels {busy:.3f} ms "
          f"(busy {busy / wall:.1%}) in {sum(e.count for e in rows)} "
          f"launches; "
          + "; ".join(f"{e.key[:48]} {e.device_time_total / 1e3:.3f} ms "
                      f"x{e.count}" for e in rows[:top]))
    return wall, busy


def check_close(what: str, got, want, rtol: float, atol: float) -> float:
    """Fail unless |got - want| <= atol + rtol * |want| everywhere and
    every value is finite; returns the max abs error.  Callers pass logical
    elements only: a padded LBM site's velocity is NaN by design."""
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


def serving_phase() -> dict[str, int]:
    """Phase 3b: continuous-batching serving at full Qwen3-4B width
    (``SERVE_LAYERS`` of its 36 layers), a
    prefill forward, and the gated norm's launch path.  Each rmsnorm
    counter is zeroed just before a run and read just after; returns the
    launches of each kernel over the phase."""
    import dataclasses

    import torch

    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model
    from repro_torch.parallel.steps import make_prefill_step
    from repro_torch.serving import ContinuousBatcher, Request

    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=SERVE_LAYERS)
    model = build_model(cfg)
    params = model.init(SEED)
    reqs = make_requests(SERVE_REQUESTS, cfg.vocab_size, SERVE_PROMPT,
                         SERVE_GEN, SEED)
    per_step = 2 * cfg.n_layers + 1      # ln1 + ln2 a layer, the final norm
    counts = {"rmsnorm": 0, "rmsnorm.gated": 0}

    def serve(kv, subset):
        batcher = ContinuousBatcher(model, params, slots=SERVE_SLOTS,
                                    max_len=SERVE_MAX_LEN, kv_cache=kv,
                                    prefill_chunk=SERVE_CHUNK)
        torch.cuda.synchronize()
        rms_kernel.LAUNCHES["plain"] = 0
        t0 = time.perf_counter()
        out = batcher.run([Request(r.rid, list(r.prompt), r.max_new_tokens)
                           for r in subset])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = rms_kernel.LAUNCHES["plain"]
        counts["rmsnorm"] += launched
        for r in subset:
            if len(out.get(r.rid, ())) != r.max_new_tokens:
                fail(f"serve {kv}: request {r.rid} did not complete")
        if launched < per_step * batcher.micro_steps:
            fail(f"serve {kv}: {launched} rmsnorm launches for "
                 f"{batcher.micro_steps} decode steps (< {per_step} a step)")
        return batcher, out, secs, launched

    runs = {}
    for kv in ("paged", "dense"):
        batcher, out, secs, launched = serve(kv, reqs)
        runs[kv] = (batcher, out)
        tokens = sum(len(v) for v in out.values())
        page = batcher.geometry.page_len if batcher.geometry else None
        print(f"serve: {SERVE_ARCH} bf16 {cfg.n_layers} layers {kv}: "
              f"{len(out)} requests, "
              f"{tokens} generated tokens in {secs:.3f} s, "
              f"{tokens / secs:.2f} tokens/s, {batcher.ticks} ticks, "
              f"{batcher.micro_steps} decode steps "
              f"({secs / batcher.micro_steps * 1e3:.2f} ms a step), "
              f"{len(batcher.preemption_log)} preemptions, page {page}, "
              f"rmsnorm launches {launched}")
    if runs["paged"][1] != runs["dense"][1]:
        bad = [r.rid for r in reqs
               if runs["paged"][1][r.rid] != runs["dense"][1][r.rid]]
        fail(f"serve: paged tokens differ from dense for requests {bad}")
    print(f"serve: paged tokens equal dense tokens for all "
          f"{SERVE_REQUESTS} requests")
    for rid in (0, 1):
        _, alone, _, _ = serve("paged", [reqs[rid]])
        if alone[rid] != runs["paged"][1][rid]:
            fail(f"serve: request {rid} alone gave other tokens than batched")
    print("serve: requests 0 and 1 re-run alone in the same slot geometry "
          "give the batched tokens")

    # where the device time of one decode tick goes (all slots stepping)
    batcher = runs["paged"][0]
    feed = torch.ones((batcher.padded_slots, 1), dtype=torch.int32,
                      device="cuda")

    def tick():
        with torch.inference_mode():
            batcher.decode(params, batcher.cache, feed)

    device_profile(f"decode tick {SERVE_ARCH} ({cfg.n_layers} layers) "
                   f"{SERVE_SLOTS} slots paged "
                   f"max_len {SERVE_MAX_LEN}", tick, top=8)
    del runs, batcher

    prefill = make_prefill_step(model)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                           generator=gen, device="cuda")
    rms_kernel.LAUNCHES["plain"] = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():
        start.record()
        logits = prefill(params, {"tokens": tokens})
        end.record()
    end.synchronize()
    launched = rms_kernel.LAUNCHES["plain"]
    counts["rmsnorm"] += launched
    if tuple(logits.shape) != (PREFILL_B, cfg.vocab_size):
        fail(f"prefill: logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        fail("prefill: non-finite logits")
    if launched != per_step:
        fail(f"prefill: {launched} rmsnorm launches, want {per_step}")
    print(f"prefill: {SERVE_ARCH} bf16 B={PREFILL_B} S={PREFILL_S} "
          f"(rmsnorm on {PREFILL_B * PREFILL_S} x {cfg.d_model} rows): "
          f"{start.elapsed_time(end):.3f} ms, logits finite, rmsnorm "
          f"launches {launched}")
    del model, params, logits

    x, z = (torch.randn(GATED_SHAPE, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    scale = (torch.randn(GATED_SHAPE[-1:], generator=gen, device="cuda")
             + 1).to(torch.bfloat16)
    rms_kernel.LAUNCHES["gated"] = 0
    y = api.launch("rmsnorm.gated", x, z, scale)
    counts["rmsnorm.gated"] = rms_kernel.LAUNCHES["gated"]
    err = check_close(f"rmsnorm.gated {GATED_SHAPE} bf16", y,
                      api.ref("rmsnorm.gated", x, z, scale),
                      *tol(torch.bfloat16))
    print(f"main: rmsnorm.gated {GATED_SHAPE} bf16 through api.launch vs "
          f"its oracle: max abs err {err:.3g}: ok")
    torch.cuda.empty_cache()
    return counts


def hybrid_phase() -> dict[str, int]:
    """Phase 3e: continuous-batching serving at full zamba2-1.2b width
    (``HYBRID_LAYERS`` of its 38 Mamba2 layers, and a shared attention
    block; B9 and B10 inside the model), a
    prefill forward past the SSD's chunk, the reduced hybrid's train step on
    the card against the CPU, and full-width prefill forwards of
    minicpm-2b and qwen3-14b.  Each rmsnorm counter is zeroed just before a
    run and read just after; returns the launches of each kernel over the
    phase."""
    import dataclasses

    import torch

    from repro_torch import interop
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.interop import numpy_params
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model
    from repro_torch.models.params import leaves
    from repro_torch.parallel import steps
    from repro_torch.parallel.steps import make_prefill_step
    from repro_torch.serving import ContinuousBatcher, Request

    t_phase = time.perf_counter()
    counts = {"rmsnorm": 0, "rmsnorm.gated": 0}

    def zero():
        rms_kernel.LAUNCHES["plain"] = rms_kernel.LAUNCHES["gated"] = 0

    def read():
        plain, gated = rms_kernel.LAUNCHES["plain"], rms_kernel.LAUNCHES[
            "gated"]
        counts["rmsnorm"] += plain
        counts["rmsnorm.gated"] += gated
        return plain, gated

    cfg = dataclasses.replace(get_config(HYBRID_ARCH), n_layers=HYBRID_LAYERS)
    n_mamba = sum(n for kind, n in cfg.stages() if kind == "mamba")
    n_shared = sum(kind == "shared_attn" for kind, _ in cfg.stages())
    # a mamba layer's ln1, a shared block's ln1 and ln2, the final norm;
    # a mamba layer's gated norm
    plain_step, gated_step = n_mamba + 2 * n_shared + 1, n_mamba
    d_inner = cfg.ssm_expand * cfg.d_model
    model = build_model(cfg)
    params = model.init(SEED)
    n_params = sum(t.numel() for _, t in leaves(params))
    reqs = make_requests(SERVE_REQUESTS, cfg.vocab_size, SERVE_PROMPT,
                         SERVE_GEN, SEED)

    def serve(kv, subset):
        batcher = ContinuousBatcher(model, params, slots=SERVE_SLOTS,
                                    max_len=SERVE_MAX_LEN, kv_cache=kv,
                                    prefill_chunk=SERVE_CHUNK)
        torch.cuda.synchronize()
        zero()
        t0 = time.perf_counter()
        out = batcher.run([Request(r.rid, list(r.prompt), r.max_new_tokens)
                           for r in subset])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = read()
        for r in subset:
            if len(out.get(r.rid, ())) != r.max_new_tokens:
                fail(f"serve {HYBRID_ARCH} {kv}: request {r.rid} did not "
                     f"complete")
        steps_run = batcher.micro_steps
        if (launched[0] < plain_step * steps_run
                or launched[1] < gated_step * steps_run):
            fail(f"serve {HYBRID_ARCH} {kv}: {launched} (rmsnorm, "
                 f"rmsnorm.gated) launches for {steps_run} decode steps "
                 f"(< ({plain_step}, {gated_step}) a step)")
        return batcher, out, secs, launched

    runs = {}
    for kv in ("paged", "dense"):
        batcher, out, secs, launched = serve(kv, reqs)
        runs[kv] = (batcher, out)
        tokens = sum(len(v) for v in out.values())
        page = batcher.geometry.page_len if batcher.geometry else None
        print(f"serve: {HYBRID_ARCH} bf16 {cfg.n_layers} layers {kv}, "
              f"{n_params} parameters: "
              f"{len(out)} requests, {tokens} generated tokens in "
              f"{secs:.3f} s, {tokens / secs:.2f} tokens/s, "
              f"{batcher.ticks} ticks, {batcher.micro_steps} decode steps "
              f"({secs / batcher.micro_steps * 1e3:.2f} ms a step), "
              f"{len(batcher.preemption_log)} preemptions, page {page}, "
              f"launches rmsnorm {launched[0]} "
              f"({launched[0] / batcher.micro_steps:.1f} a step), "
              f"rmsnorm.gated {launched[1]} "
              f"({launched[1] / batcher.micro_steps:.1f} a step)")
    if runs["paged"][1] != runs["dense"][1]:
        bad = [r.rid for r in reqs
               if runs["paged"][1][r.rid] != runs["dense"][1][r.rid]]
        fail(f"serve {HYBRID_ARCH}: paged tokens differ from dense for "
             f"requests {bad}")
    print(f"serve: {HYBRID_ARCH}: paged tokens equal dense tokens for all "
          f"{SERVE_REQUESTS} requests")
    for rid in (0, 1):
        _, alone, _, _ = serve("paged", [reqs[rid]])
        if alone[rid] != runs["paged"][1][rid]:
            fail(f"serve {HYBRID_ARCH}: request {rid} alone gave other "
                 f"tokens than batched")
    print(f"serve: {HYBRID_ARCH}: requests 0 and 1 re-run alone in the same "
          f"slot geometry (their slots' SSM state reset on reuse) give the "
          f"batched tokens")

    batcher = runs["paged"][0]
    feed = torch.ones((batcher.padded_slots, 1), dtype=torch.int32,
                      device="cuda")

    def tick():
        with torch.inference_mode():
            batcher.decode(params, batcher.cache, feed)

    device_profile(f"decode tick {HYBRID_ARCH} {SERVE_SLOTS} slots paged "
                   f"max_len {SERVE_MAX_LEN}", tick, top=8)
    del runs, batcher

    # the prefill forward where the reference's SSD gives NaN: two chunks
    prefill = make_prefill_step(model)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                           generator=gen, device="cuda")
    zero()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():
        start.record()
        logits = prefill(params, {"tokens": tokens})
        end.record()
    end.synchronize()
    launched = read()
    if tuple(logits.shape) != (PREFILL_B, cfg.vocab_size):
        fail(f"prefill {HYBRID_ARCH}: logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        fail(f"prefill {HYBRID_ARCH}: non-finite logits")
    if launched != (plain_step, gated_step):
        fail(f"prefill {HYBRID_ARCH}: {launched} (rmsnorm, rmsnorm.gated) "
             f"launches, want ({plain_step}, {gated_step})")
    print(f"prefill: {HYBRID_ARCH} bf16 B={PREFILL_B} S={PREFILL_S} (two "
          f"SSD chunks; rmsnorm on {PREFILL_B * PREFILL_S} x {cfg.d_model} "
          f"rows, rmsnorm.gated on {PREFILL_B * PREFILL_S} x {d_inner}): "
          f"{start.elapsed_time(end):.3f} ms, logits finite, launches "
          f"rmsnorm {launched[0]}, rmsnorm.gated {launched[1]}")
    del model, params, logits
    torch.cuda.empty_cache()

    # the reduced fp32 hybrid: the card (B9, B10, B11 under their autograd
    # Functions, remat on) against the CPU (their plain versions), the same
    # numpy weights on both, 300 tokens a row across the SSD's chunk; the
    # dense phase's tolerance (loss rtol 1e-5; each gradient leaf rtol 1e-4
    # with an atol of 1e-2 of its scale)
    small = build_model(dataclasses.replace(reduce_for_smoke(cfg),
                                            remat=True))
    tree = numpy_params(small.param_defs(), SEED, true_fan_in=True)
    data = DataConfig(vocab_size=small.cfg.vocab_size,
                      seq_len=HYBRID_TRAIN_SEQ, global_batch=4)
    zero()
    loss, grads = steps.value_and_grad(
        small, interop.params_from_jax(tree, small.cfg), make_batch(data, 0))
    launched = read()
    want, want_g = steps.value_and_grad(
        small, interop.params_from_jax(tree, small.cfg, device="cpu"),
        make_batch(data, 0, device="cpu"))
    if launched[1] < small.cfg.n_layers:
        fail(f"reduced {HYBRID_ARCH} train step: {launched[1]} "
             f"rmsnorm.gated launches for {small.cfg.n_layers} mamba layers")
    check_close(f"reduced {HYBRID_ARCH} train step loss, card vs cpu",
                loss.cpu(), want, 1e-5, 0.0)
    worst = 0.0
    for (path, g), (_, w) in zip(leaves(grads), leaves(want_g)):
        name = "/".join(path)
        if not bool(g.abs().max() > 0):
            fail(f"reduced {HYBRID_ARCH} train step: gradient of {name} is "
                 f"zero")
        scale = float(w.abs().max())
        err = check_close(f"reduced {HYBRID_ARCH} train step grad {name}, "
                          f"card vs cpu", g.cpu(), w, 1e-4, 1e-2 * scale)
        worst = max(worst, err / scale)
    print(f"train: reduced {HYBRID_ARCH} fp32 (remat on) S="
          f"{HYBRID_TRAIN_SEQ}: loss {float(loss)!r} on the card, "
          f"{float(want)!r} on the cpu; launches rmsnorm {launched[0]}, "
          f"rmsnorm.gated {launched[1]}; every one of "
          f"{len(list(leaves(grads)))} gradient leaves finite, nonzero and "
          f"within rtol 1e-4 / atol 1e-2 of its scale (worst {worst:.3g} of "
          f"scale): ok")
    del grads, want_g

    # the other dense configs at full width: one bf16 prefill forward each
    for arch in DENSE_ARCHS:
        dcfg = get_config(arch)
        dmodel = build_model(dcfg)
        dparams = dmodel.init(SEED)
        n = sum(t.numel() for _, t in leaves(dparams))
        tokens = torch.randint(0, dcfg.vocab_size, (1, DENSE_PREFILL_S),
                               generator=gen, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        zero()
        start.record()
        with torch.inference_mode():
            logits, _ = dmodel(dparams, tokens)
        end.record()
        end.synchronize()
        launched = read()
        want_plain = 2 * dcfg.n_layers + 1
        if tuple(logits.shape) != (1, DENSE_PREFILL_S, dcfg.vocab_size):
            fail(f"prefill {arch}: logits shape {tuple(logits.shape)}")
        if not bool(torch.isfinite(logits).all()):
            fail(f"prefill {arch}: non-finite logits")
        if launched[0] != want_plain:
            fail(f"prefill {arch}: {launched[0]} rmsnorm launches, want "
                 f"{want_plain}")
        print(f"prefill: {arch} bf16 full width, {n} parameters, B=1 "
              f"S={DENSE_PREFILL_S}: {start.elapsed_time(end):.3f} ms, "
              f"logits finite, rmsnorm launches {launched[0]}, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        del dmodel, dparams, logits
        torch.cuda.empty_cache()
    print(f"hybrid: the phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


def xlstm_phase() -> dict[str, int]:
    """Phase 3f: continuous-batching serving at full xlstm-1.3b width
    (mLSTM and sLSTM blocks, no attention; B10 inside each mLSTM layer, B9
    behind every layer and inside each sLSTM layer), the share of a decode
    step the mLSTM state update takes, two prefill forwards past the
    mLSTM's chunk, and the reduced xlstm's train step on the card against
    the CPU.  Each rmsnorm counter is zeroed just before a run and read
    just after; returns the launches of each kernel over the phase."""
    import dataclasses

    import torch

    from repro_torch import interop
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.interop import numpy_params
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model
    from repro_torch.models.params import leaves
    from repro_torch.parallel import steps
    from repro_torch.parallel.steps import make_prefill_step
    from repro_torch.serving import ContinuousBatcher, Request

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    counts = {"rmsnorm": 0, "rmsnorm.gated": 0}

    def zero():
        rms_kernel.LAUNCHES["plain"] = rms_kernel.LAUNCHES["gated"] = 0

    def read():
        plain, gated = rms_kernel.LAUNCHES["plain"], rms_kernel.LAUNCHES[
            "gated"]
        counts["rmsnorm"] += plain
        counts["rmsnorm.gated"] += gated
        return plain, gated

    cfg = dataclasses.replace(get_config(XLSTM_ARCH), n_layers=XLSTM_LAYERS)
    n_m = sum(n for kind, n in cfg.stages() if kind == "mlstm")
    n_s = sum(n for kind, n in cfg.stages() if kind == "slstm")
    # ln1 a layer, an sLSTM's output norm, the final norm; an mLSTM's gate
    # and norm
    plain_step, gated_step = cfg.n_layers + n_s + 1, n_m
    d_inner = 2 * cfg.d_model
    model = build_model(cfg)
    params = model.init(SEED)
    n_params = sum(t.numel() for _, t in leaves(params))
    reqs = make_requests(SERVE_REQUESTS, cfg.vocab_size, SERVE_PROMPT,
                         SERVE_GEN, SEED)

    def serve(kv, subset):
        batcher = ContinuousBatcher(model, params, slots=SERVE_SLOTS,
                                    max_len=SERVE_MAX_LEN, kv_cache=kv,
                                    prefill_chunk=SERVE_CHUNK)
        torch.cuda.synchronize()
        zero()
        t0 = time.perf_counter()
        out = batcher.run([Request(r.rid, list(r.prompt), r.max_new_tokens)
                           for r in subset])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = read()
        for r in subset:
            if len(out.get(r.rid, ())) != r.max_new_tokens:
                fail(f"serve {XLSTM_ARCH} {kv}: request {r.rid} did not "
                     f"complete")
        steps_run = batcher.micro_steps
        if (launched[0] < plain_step * steps_run
                or launched[1] < gated_step * steps_run):
            fail(f"serve {XLSTM_ARCH} {kv}: {launched} (rmsnorm, "
                 f"rmsnorm.gated) launches for {steps_run} decode steps "
                 f"(< ({plain_step}, {gated_step}) a step)")
        return batcher, out, secs, launched

    runs, batcher = {}, None
    for kv in ("paged", "dense"):
        b, out, secs, launched = serve(kv, reqs)
        tokens = sum(len(v) for v in out.values())
        ms = secs / b.micro_steps * 1e3
        runs[kv] = (out, tokens / secs, ms)
        if kv == "paged":
            batcher = b
        state = sum(t.numel() * t.element_size()
                    for key, sub in b.cache.items() if isinstance(sub, dict)
                    for _, t in leaves(sub))
        page = b.geometry.page_len if b.geometry else None
        print(f"serve: {XLSTM_ARCH} bf16 {kv}, {n_params} parameters, "
              f"{state} B of recurrent state: {len(out)} requests, {tokens} "
              f"generated tokens in {secs:.3f} s, {tokens / secs:.2f} "
              f"tokens/s, {b.ticks} ticks, {b.micro_steps} decode steps "
              f"({ms:.2f} ms a step), {len(b.preemption_log)} preemptions, "
              f"page {page}, launches rmsnorm {launched[0]} "
              f"({launched[0] / b.micro_steps:.1f} a step), rmsnorm.gated "
              f"{launched[1]} ({launched[1] / b.micro_steps:.1f} a step)")
        del b
    if runs["paged"][0] != runs["dense"][0]:
        bad = [r.rid for r in reqs
               if runs["paged"][0][r.rid] != runs["dense"][0][r.rid]]
        fail(f"serve {XLSTM_ARCH}: paged tokens differ from dense for "
             f"requests {bad}")
    print(f"serve: {XLSTM_ARCH}: paged tokens equal dense tokens for all "
          f"{SERVE_REQUESTS} requests")

    # one decode tick (all slots stepping): its launches, where its device
    # time goes, and the mLSTM state update's share of it
    feed = torch.ones((batcher.padded_slots, 1), dtype=torch.int32,
                      device="cuda")

    def tick():
        with torch.inference_mode():
            batcher.decode(params, batcher.cache, feed)

    tick()
    torch.cuda.synchronize()
    zero()
    tick()
    torch.cuda.synchronize()
    launched = read()
    if launched[0] < plain_step or launched[1] < gated_step:
        fail(f"decode step {XLSTM_ARCH}: {launched} (rmsnorm, "
             f"rmsnorm.gated) launches (< ({plain_step}, {gated_step}))")
    print(f"serve: {XLSTM_ARCH}: one decode step launches rmsnorm "
          f"{launched[0]} and rmsnorm.gated {launched[1]} times (gates "
          f">= {plain_step}, >= {gated_step})")
    wall, busy = device_profile(
        f"decode tick {XLSTM_ARCH} {SERVE_SLOTS} slots paged max_len "
        f"{SERVE_MAX_LEN}", tick, top=8)
    # the decode step's ops on the matrix memory C of every mLSTM layer, as
    # models.xlstm.mlstm_decode_step runs them (C *= f; C += (i k) v^T; q C),
    # with f = 1 and i = 0 so the state keeps its values
    cs = [c for key, sub in batcher.cache.items()
          if key.endswith("_mlstm") for c in sub["c"].unbind(0)]
    b_, h_, p_ = cs[0].shape[:3]
    ones = torch.ones((b_, h_, 1, 1), device="cuda")
    ik = torch.zeros((b_, h_, p_, 1), device="cuda")
    v = torch.randn((b_, h_, 1, p_), device="cuda")
    q = torch.randn((b_, h_, p_), device="cuda")

    def state_update():
        with torch.inference_mode():
            for c in cs:
                c.mul_(ones)
                c.addcmul_(ik, v)
                torch.einsum("bhp,bhpq->bhq", q, c)

    c_bytes = sum(c.numel() * c.element_size() for c in cs)
    state_ms = time_ms(state_update, samples=5, per_sample=2)
    bw = datasheet(torch.cuda.get_device_name(0))[0]
    print(f"profile: {XLSTM_ARCH} mLSTM state update of a decode step (C *= "
          f"f, C += (i k) v^T, q C over {len(cs)} layers of "
          f"{tuple(cs[0].shape)} fp32, {c_bytes} B): {state_ms:.3f} ms, "
          f"{state_ms / busy:.1%} of the tick's device time and "
          f"{state_ms / wall:.1%} of its {wall:.3f} ms; five passes over "
          f"C, bound of the two a step needs {2 * c_bytes / bw * 1e3:.3f} ms")
    print(f"serve: {XLSTM_ARCH} summary: paged {runs['paged'][1]:.2f} "
          f"tokens/s, {runs['paged'][2]:.2f} ms a decode step; dense "
          f"{runs['dense'][1]:.2f} tokens/s, {runs['dense'][2]:.2f} ms a "
          f"decode step; the card busy {busy / wall:.1%} of a profiled "
          f"decode tick ({busy:.3f} of {wall:.3f} ms), the mLSTM state "
          f"update {state_ms / wall:.1%} of it")
    batched = runs["paged"][0]
    del batcher, cs, runs
    torch.cuda.empty_cache()

    # slot reuse with the mLSTM and sLSTM state: requests alone
    for rid in (0, 1):
        _, alone, _, _ = serve("paged", [reqs[rid]])
        if alone[rid] != batched[rid]:
            fail(f"serve {XLSTM_ARCH}: request {rid} alone gave other "
                 f"tokens than batched")
    print(f"serve: {XLSTM_ARCH}: requests 0 and 1 re-run alone in the same "
          f"slot geometry (their slots' mLSTM and sLSTM state reset on "
          f"reuse) give the batched tokens")
    torch.cuda.empty_cache()

    # two prefill forwards of two mLSTM chunks each: the first includes the
    # warm-up of the model's first forward (PERF.md §7)
    prefill = make_prefill_step(model)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                           generator=gen, device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(2):
        zero()
        with torch.inference_mode():
            start.record()
            logits = prefill(params, {"tokens": tokens})
            end.record()
        end.synchronize()
        launched = read()
        times.append(start.elapsed_time(end))
        if tuple(logits.shape) != (PREFILL_B, cfg.vocab_size):
            fail(f"prefill {XLSTM_ARCH}: logits shape "
                 f"{tuple(logits.shape)}")
        if not bool(torch.isfinite(logits).all()):
            fail(f"prefill {XLSTM_ARCH}: non-finite logits")
        if launched != (plain_step, gated_step):
            fail(f"prefill {XLSTM_ARCH}: {launched} (rmsnorm, "
                 f"rmsnorm.gated) launches, want ({plain_step}, "
                 f"{gated_step})")
    print(f"prefill: {XLSTM_ARCH} bf16 B={PREFILL_B} S={PREFILL_S} (two "
          f"mLSTM chunks; rmsnorm on {PREFILL_B * PREFILL_S} x "
          f"{cfg.d_model} rows, bf16 and the sLSTM's fp32, rmsnorm.gated on "
          f"{PREFILL_B * PREFILL_S} x {d_inner}): first {times[0]:.3f} ms, "
          f"second {times[1]:.3f} ms, logits finite, launches rmsnorm "
          f"{launched[0]}, rmsnorm.gated {launched[1]} a forward")
    del model, params, logits
    torch.cuda.empty_cache()

    # the reduced fp32 xlstm: the card (B9, B10, B11 under their autograd
    # Functions, remat on) against the CPU (their plain versions), the same
    # numpy weights on both, 300 tokens a row, where the reference's mLSTM
    # gradient is NaN; the dense phase's tolerance (loss rtol 1e-5; each
    # gradient leaf rtol 1e-4 with an atol of 1e-2 of its scale)
    small = build_model(dataclasses.replace(reduce_for_smoke(cfg),
                                            remat=True))
    tree = numpy_params(small.param_defs(), SEED, true_fan_in=True)
    data = DataConfig(vocab_size=small.cfg.vocab_size,
                      seq_len=XLSTM_TRAIN_SEQ, global_batch=4)
    zero()
    loss, grads = steps.value_and_grad(
        small, interop.params_from_jax(tree, small.cfg), make_batch(data, 0))
    launched = read()
    want, want_g = steps.value_and_grad(
        small, interop.params_from_jax(tree, small.cfg, device="cpu"),
        make_batch(data, 0, device="cpu"))
    small_m = sum(n for kind, n in small.cfg.stages() if kind == "mlstm")
    if launched[1] < small_m:
        fail(f"reduced {XLSTM_ARCH} train step: {launched[1]} "
             f"rmsnorm.gated launches for {small_m} mLSTM layers")
    check_close(f"reduced {XLSTM_ARCH} train step loss, card vs cpu",
                loss.cpu(), want, 1e-5, 0.0)
    worst = 0.0
    for (path, g), (_, w) in zip(leaves(grads), leaves(want_g)):
        name = "/".join(path)
        if not bool(g.abs().max() > 0):
            fail(f"reduced {XLSTM_ARCH} train step: gradient of {name} is "
                 f"zero")
        scale = float(w.abs().max())
        err = check_close(f"reduced {XLSTM_ARCH} train step grad {name}, "
                          f"card vs cpu", g.cpu(), w, 1e-4, 1e-2 * scale)
        worst = max(worst, err / scale)
    print(f"train: reduced {XLSTM_ARCH} fp32 (remat on) S="
          f"{XLSTM_TRAIN_SEQ}: loss {float(loss)!r} on the card, "
          f"{float(want)!r} on the cpu; launches rmsnorm {launched[0]}, "
          f"rmsnorm.gated {launched[1]}; every one of "
          f"{len(list(leaves(grads)))} gradient leaves finite, nonzero and "
          f"within rtol 1e-4 / atol 1e-2 of its scale (worst {worst:.3g} of "
          f"scale): ok")
    del grads, want_g
    print(f"xlstm: the phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


def moe_phase() -> dict[str, int]:
    """Phase 3g: the moe family at full qwen3-moe-30b-a3b width (48 layers
    of attention and 128 routed experts of d_ff 768, top-8, capacity factor
    1.25, skewed expert placement; B9 behind the attention and the experts
    of every layer): the whole model initialised on the card, a prefill
    forward at full depth, continuous-batching serving of the first
    ``MOE_SERVE_LAYERS`` layers (views of the same stacked tensors) paged
    and dense, isolated re-runs where nothing drops, one profiled decode
    tick beside the expert products' byte bound, and the reduced MoE's
    train step on the card against the CPU.  The rmsnorm counter is zeroed
    just before a run and read just after; returns the launches of each
    kernel over the phase."""
    import dataclasses

    import torch

    from repro_torch import interop
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.interop import numpy_params
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.xent import kernel as xent_kernel
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model, moe
    from repro_torch.models.params import leaves, map_leaves
    from repro_torch.parallel import steps
    from repro_torch.parallel.steps import make_prefill_step
    from repro_torch.serving import ContinuousBatcher, Request

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    counts = {"rmsnorm": 0, "xent": 0}

    def zero():
        rms_kernel.LAUNCHES["plain"] = 0

    def read():
        counts["rmsnorm"] += rms_kernel.LAUNCHES["plain"]
        return rms_kernel.LAUNCHES["plain"]

    full = get_config(MOE_ARCH)
    model = build_model(full)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = [t for _, t in leaves(params) if t.is_floating_point()]
    n_params = sum(t.numel() for t in weights)
    n_bytes = sum(t.numel() * t.element_size() for t in weights)
    print(f"init: {MOE_ARCH} bf16 full width, {full.n_layers} layers, "
          f"{n_params} parameters, {n_bytes} B of weights, in {init_s:.1f} "
          f"s; peak {torch.cuda.max_memory_allocated()} B "
          f"(torch.cuda.max_memory_allocated) of "
          f"{torch.cuda.get_device_properties(0).total_memory} B")
    if n_params != MOE_PARAMS:
        fail(f"init {MOE_ARCH}: {n_params} parameters, want {MOE_PARAMS}")

    # the prefill forward at full depth: B9 is ln1 and ln2 of every layer
    # and the final norm (the qk-norm is plain torch)
    full_step = 2 * full.n_layers + 1
    prefill = make_prefill_step(model)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tokens = torch.randint(0, full.vocab_size, (PREFILL_B, PREFILL_S),
                           generator=gen, device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(2):
        zero()
        with torch.inference_mode():
            start.record()
            logits = prefill(params, {"tokens": tokens})
            end.record()
        end.synchronize()
        launched = read()
        times.append(start.elapsed_time(end))
        if tuple(logits.shape) != (PREFILL_B, full.vocab_size):
            fail(f"prefill {MOE_ARCH}: logits shape {tuple(logits.shape)}")
        if not bool(torch.isfinite(logits).all()):
            fail(f"prefill {MOE_ARCH}: non-finite logits")
        if launched != full_step:
            fail(f"prefill {MOE_ARCH}: {launched} rmsnorm launches, want "
                 f"{full_step}")
    print(f"prefill: {MOE_ARCH} bf16 full depth B={PREFILL_B} S={PREFILL_S} "
          f"(capacity {moe.capacity(full, PREFILL_B * PREFILL_S)} a expert; "
          f"rmsnorm on {PREFILL_B * PREFILL_S} x {full.d_model} rows): first "
          f"{times[0]:.3f} ms, second {times[1]:.3f} ms, logits finite, "
          f"rmsnorm launches {launched} a forward; peak "
          f"{torch.cuda.max_memory_allocated()} B")
    del logits

    # serving: the first MOE_SERVE_LAYERS layers, views of the stacked
    # tensors of the full model
    cfg = dataclasses.replace(full, n_layers=MOE_SERVE_LAYERS)
    served = dict(params)
    served["s00_moe"] = map_leaves(lambda a: a[:MOE_SERVE_LAYERS],
                                   params["s00_moe"])
    smodel = build_model(cfg)
    per_step = 2 * cfg.n_layers + 1
    reqs = make_requests(SERVE_REQUESTS, cfg.vocab_size, SERVE_PROMPT,
                         SERVE_GEN, SEED)

    def serve(m, kv, subset):
        batcher = ContinuousBatcher(m, served, slots=SERVE_SLOTS,
                                    max_len=SERVE_MAX_LEN, kv_cache=kv,
                                    prefill_chunk=SERVE_CHUNK)
        torch.cuda.synchronize()
        zero()
        t0 = time.perf_counter()
        out = batcher.run([Request(r.rid, list(r.prompt), r.max_new_tokens)
                           for r in subset])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = read()
        for r in subset:
            if len(out.get(r.rid, ())) != r.max_new_tokens:
                fail(f"serve {MOE_ARCH} {kv}: request {r.rid} did not "
                     f"complete")
        if launched < per_step * batcher.micro_steps:
            fail(f"serve {MOE_ARCH} {kv}: {launched} rmsnorm launches for "
                 f"{batcher.micro_steps} decode steps (< {per_step} a step)")
        return batcher, out, secs, launched

    runs, batcher = {}, None
    for kv in ("paged", "dense"):
        b, out, secs, launched = serve(smodel, kv, reqs)
        tokens_out = sum(len(v) for v in out.values())
        ms = secs / b.micro_steps * 1e3
        runs[kv] = (out, tokens_out / secs, ms)
        if kv == "paged":
            batcher = b
        page = b.geometry.page_len if b.geometry else None
        print(f"serve: {MOE_ARCH} bf16 {cfg.n_layers} of {full.n_layers} "
              f"layers {kv}, capacity factor {cfg.capacity_factor} "
              f"(capacity {moe.capacity(cfg, b.padded_slots)} a expert for "
              f"{b.padded_slots} rows): {len(out)} requests, {tokens_out} "
              f"generated tokens in {secs:.3f} s, {tokens_out / secs:.2f} "
              f"tokens/s, {b.ticks} ticks, {b.micro_steps} decode steps "
              f"({ms:.2f} ms a step), {len(b.preemption_log)} preemptions, "
              f"page {page}, rmsnorm launches {launched} "
              f"({launched / b.micro_steps:.1f} a step)")
        del b
    if runs["paged"][0] != runs["dense"][0]:
        bad = [r.rid for r in reqs
               if runs["paged"][0][r.rid] != runs["dense"][0][r.rid]]
        fail(f"serve {MOE_ARCH}: paged tokens differ from dense for "
             f"requests {bad}")
    print(f"serve: {MOE_ARCH}: paged tokens equal dense tokens for all "
          f"{SERVE_REQUESTS} requests at capacity factor "
          f"{cfg.capacity_factor}")

    # one decode tick (all slots stepping): its B9 launches, where its
    # device time goes, and the expert products' share of it
    feed = torch.ones((batcher.padded_slots, 1), dtype=torch.int32,
                      device="cuda")

    def tick():
        with torch.inference_mode():
            batcher.decode(served, batcher.cache, feed)

    tick()
    torch.cuda.synchronize()
    zero()
    tick()
    torch.cuda.synchronize()
    launched = read()
    if launched < per_step:
        fail(f"decode step {MOE_ARCH}: {launched} rmsnorm launches "
             f"(< {per_step})")
    print(f"serve: {MOE_ARCH}: one decode step launches rmsnorm {launched} "
          f"times (gate >= {per_step})")
    wall, busy = device_profile(
        f"decode tick {MOE_ARCH} ({cfg.n_layers} layers) {SERVE_SLOTS} "
        f"slots paged max_len {SERVE_MAX_LEN}", tick, top=8)
    # the three expert products of a decode step over every served layer,
    # as models.moe.apply_moe runs them on an (E, cap, d) buffer
    cap = moe.capacity(cfg, batcher.padded_slots)
    stage = served["s00_moe"]["moe"]
    eb = torch.randn((cfg.n_experts, cap, cfg.d_model), generator=gen,
                     device="cuda").to(cfg.adtype)

    def expert_products():
        with torch.inference_mode():
            for wi, wg, wo in zip(stage["wi"], stage["wg"], stage["wo"]):
                h = torch.bmm(eb, wi)
                torch.bmm(torch.nn.functional.silu(torch.bmm(eb, wg)) * h, wo)

    expert_bytes = sum(stage[w].numel() * stage[w].element_size()
                       for w in ("wi", "wg", "wo"))
    expert_ms = time_ms(expert_products, samples=5, per_sample=2)
    bw = datasheet(torch.cuda.get_device_name(0))[0]
    bound_ms = expert_bytes / bw * 1e3
    print(f"profile: {MOE_ARCH} expert products of a decode step (3 bmm "
          f"over ({cfg.n_experts}, {cap}, {cfg.d_model}) x {cfg.n_layers} "
          f"layers, {expert_bytes} B of weights): {expert_ms:.3f} ms "
          f"against a byte bound of {bound_ms:.3f} ms ({bound_ms / expert_ms:.1%}"
          f" of it; {full.n_layers} layers: {expert_ms * full.n_layers / cfg.n_layers:.3f}"
          f" ms against {bound_ms * full.n_layers / cfg.n_layers:.3f}); "
          f"{expert_ms / busy:.1%} of the tick's device time and "
          f"{expert_ms / wall:.1%} of its {wall:.3f} ms")
    print(f"serve: {MOE_ARCH} summary: paged {runs['paged'][1]:.2f} "
          f"tokens/s, {runs['paged'][2]:.2f} ms a decode step; dense "
          f"{runs['dense'][1]:.2f} tokens/s, {runs['dense'][2]:.2f} ms a "
          f"decode step; the card busy {busy / wall:.1%} of a profiled "
          f"decode tick ({busy:.3f} of {wall:.3f} ms), the expert products "
          f"{expert_ms / wall:.1%} of it")
    del batcher, runs, eb
    torch.cuda.empty_cache()

    # isolated re-runs where the reference's semantics make them hold: at
    # a capacity factor >= E / k the capacity is >= T and nothing drops
    nodrop = build_model(dataclasses.replace(cfg,
                                             capacity_factor=MOE_NO_DROP_CF))
    subset = reqs[:MOE_ISOLATED]
    _, batched, _, _ = serve(nodrop, "paged", subset)
    for r in subset:
        _, alone, _, _ = serve(nodrop, "paged", [r])
        if alone[r.rid] != batched[r.rid]:
            fail(f"serve {MOE_ARCH} capacity factor {MOE_NO_DROP_CF}: "
                 f"request {r.rid} alone gave other tokens than batched")
    print(f"serve: {MOE_ARCH}: at capacity factor {MOE_NO_DROP_CF} (nothing "
          f"drops), requests {[r.rid for r in subset]} each re-run alone in "
          f"the same slot geometry give their batched tokens")
    del model, smodel, nodrop, params, served, stage
    torch.cuda.empty_cache()

    # the reduced fp32 MoE with real routing (top-2 of 8) at a capacity
    # factor where assignments drop: the card (B9, B11 under their autograd
    # Functions, remat on) against the CPU (their plain versions), the same
    # numpy weights and perm tables on both; the loss rtol 1e-5, each
    # gradient leaf within 1e-4 of its scale; a pick that flips between
    # the two (a near-tie in the router) is reported by layer and token
    small = build_model(dataclasses.replace(
        reduce_for_smoke(full), top_k=2, capacity_factor=MOE_TRAIN_CF,
        remat=True))
    tree = numpy_params(small.param_defs(), SEED, true_fan_in=True,
                        cfg=small.cfg)
    data = DataConfig(vocab_size=small.cfg.vocab_size, seq_len=MOE_TRAIN_SEQ,
                      global_batch=4)
    routes = {"cuda": [], "cpu": []}
    route = moe.route

    def spy(p, xf, c):
        out = route(p, xf, c)
        routes[xf.device.type].append((out[1].cpu(), out[5].cpu()))
        return out

    moe.route = spy
    try:
        zero()
        before = xent_kernel.LAUNCHES["xent"]
        loss, grads = steps.value_and_grad(
            small, interop.params_from_jax(tree, small.cfg),
            make_batch(data, 0))
        launched = read()
        counts["xent"] += xent_kernel.LAUNCHES["xent"] - before
        want, want_g = steps.value_and_grad(
            small, interop.params_from_jax(tree, small.cfg, device="cpu"),
            make_batch(data, 0, device="cpu"))
    finally:
        moe.route = route
    if len(routes["cuda"]) != len(routes["cpu"]):
        fail(f"reduced {MOE_ARCH} train step: {len(routes['cuda'])} MoE "
             f"calls on the card, {len(routes['cpu'])} on the cpu")
    dropped = 0
    for i, ((e_card, k_card), (e_cpu, k_cpu)) in enumerate(
            zip(routes["cuda"], routes["cpu"])):
        flips = (e_card.sort(-1).values != e_cpu.sort(-1).values).any(-1)
        if bool(flips.any()):
            t = int(flips.nonzero()[0])
            fail(f"reduced {MOE_ARCH} train step: MoE call {i} (layer "
                 f"{i % small.cfg.n_layers}), token {t}: experts "
                 f"{e_card[t].tolist()} on the card, {e_cpu[t].tolist()} on "
                 f"the cpu (a near-tie in the router)")
        if not torch.equal(k_card, k_cpu):
            fail(f"reduced {MOE_ARCH} train step: MoE call {i}: the kept "
                 f"masks differ between the card and the cpu")
        dropped += int((~k_card).sum())
    if launched < 2 * small.cfg.n_layers + 1:
        fail(f"reduced {MOE_ARCH} train step: {launched} rmsnorm launches")
    if not dropped:
        fail(f"reduced {MOE_ARCH} train step: capacity factor "
             f"{MOE_TRAIN_CF} dropped nothing")
    check_close(f"reduced {MOE_ARCH} train step loss, card vs cpu",
                loss.cpu(), want, 1e-5, 0.0)
    worst = 0.0
    for (path, g), (_, w) in zip(leaves(grads), leaves(want_g)):
        if g is None:           # the perm tables
            continue
        name = "/".join(path)
        if not bool(g.abs().max() > 0):
            fail(f"reduced {MOE_ARCH} train step: gradient of {name} is zero")
        scale = float(w.abs().max())
        err = check_close(f"reduced {MOE_ARCH} train step grad {name}, card "
                          f"vs cpu", g.cpu(), w, 0.0, 1e-4 * scale)
        worst = max(worst, err / scale)
    print(f"train: reduced {MOE_ARCH} fp32 top-{small.cfg.top_k} of "
          f"{small.cfg.n_experts}, capacity factor {MOE_TRAIN_CF} (remat on) "
          f"S={MOE_TRAIN_SEQ}: loss {float(loss)!r} on the card, "
          f"{float(want)!r} on the cpu; {len(routes['cuda'])} MoE calls with "
          f"the same picks and kept masks on both, {dropped} assignments "
          f"dropped; rmsnorm launches {launched}; every gradient leaf finite, "
          f"nonzero and within 1e-4 of its scale (worst {worst:.3g} of "
          f"scale): ok")
    del grads, want_g
    print(f"moe: the phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


def training_phase() -> tuple[dict[str, int], list[float]]:
    """Phase 3c: training at full Qwen2-0.5B width, with a checkpoint round
    trip.  Each kernel counter is zeroed just before a training run and
    read just after; returns the launches of each kernel over the runs and
    the uninterrupted run's losses."""
    import dataclasses
    import os
    import shutil

    import torch

    from repro_torch import interop
    from repro_torch.configs import get_config, get_schedule, reduce_for_smoke
    from repro_torch.interop import numpy_params
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.xent import kernel as xent_kernel
    from repro_torch.models import build_model
    from repro_torch.models.params import leaves, map_leaves
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.adamw import global_norm as adamw_global_norm
    from repro_torch.optim.schedules import make_schedule
    from repro_torch.parallel import steps
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    cfg = get_config(TRAIN_ARCH)

    # the reduced fp32 model: the card (B9/B11 under their autograd
    # Functions, remat on) against the CPU (their plain versions), the same
    # numpy weights on both.  Loss rtol 1e-5; each gradient leaf rtol 1e-4
    # with an atol of 1e-2 of its scale: the reduced qwen2-0.5b amplifies
    # fp32 reordering (its CPU gradients lie 2.3e-3 of a leaf's scale from
    # a float64 run; the card's differed from the CPU's by 6.3e-3 on an
    # NVIDIA H100 80GB HBM3 at 700 W; tests/test_torch_train.py,
    # tests/test_torch_cuda.py).
    small = build_model(dataclasses.replace(reduce_for_smoke(cfg), remat=True))
    tree = numpy_params(small.param_defs(), SEED)
    data = DataConfig(vocab_size=small.cfg.vocab_size, seq_len=64,
                      global_batch=4)
    loss, grads = steps.value_and_grad(
        small, interop.params_from_jax(tree, small.cfg), make_batch(data, 0))
    want, want_g = steps.value_and_grad(
        small, interop.params_from_jax(tree, small.cfg, device="cpu"),
        make_batch(data, 0, device="cpu"))
    check_close("reduced train step loss, card vs cpu", loss.cpu(), want,
                1e-5, 0.0)
    worst = 0.0
    for (path, g), (_, w) in zip(leaves(grads), leaves(want_g)):
        name = "/".join(path)
        if not bool(g.abs().max() > 0):
            fail(f"reduced train step: gradient of {name} is zero")
        scale = float(w.abs().max())
        err = check_close(f"reduced train step grad {name}, card vs cpu",
                          g.cpu(), w, 1e-4, 1e-2 * scale)
        worst = max(worst, err / scale)
    print(f"train: reduced {TRAIN_ARCH} fp32 (remat on): loss "
          f"{float(loss)!r} on the card, {float(want)!r} on the cpu; every "
          f"one of {len(list(leaves(grads)))} gradient leaves nonzero and "
          f"within rtol 1e-4 / atol 1e-2 of its scale (worst {worst:.3g} "
          f"of scale): ok")
    del grads, want_g

    model = build_model(cfg)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    tokens = TRAIN_SEQ * TRAIN_BATCH

    def trainer(directory):
        return Trainer(
            model, data, AdamWConfig(),
            make_schedule(get_schedule(TRAIN_ARCH), peak=TRAIN_PEAK,
                          warmup=TRAIN_WARMUP, total=TRAIN_STEPS),
            TrainerConfig(n_steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
                          ckpt_dir=str(directory), keep=1, log_every=1))

    # the first backward at full width: every leaf finite, nonzero somewhere
    params = model.init(SEED)
    n_params = sum(t.numel() for _, t in leaves(params))
    _, grads = steps.value_and_grad(model, params, make_batch(data, 0))
    for path, g in leaves(grads):
        if not bool(torch.isfinite(g).all()) or not bool(g.abs().max() > 0):
            fail(f"train: first backward: gradient of {'/'.join(path)} is "
                 f"not finite or is zero")
    print(f"train: {TRAIN_ARCH} bf16, {n_params} parameters: the first "
          f"backward gives every one of {len(list(leaves(grads)))} leaves a "
          f"finite gradient, nonzero somewhere: ok")
    # how far rounding alone moves the step-0 gradient at these weights:
    # the same batch as two microbatches (fp32 accumulation), the same
    # math in another order
    norm = float(adamw_global_norm(grads))
    del grads
    _, grads2, _ = steps.make_grad_fn(model, microbatches=2)(
        params, make_batch(data, 0))
    norm2 = float(adamw_global_norm(grads2))
    print(f"train: step-0 gradient norm {norm!r} in one batch, {norm2!r} "
          f"as two microbatches (relative {abs(norm2 - norm) / norm!r}): "
          f"the spread rounding alone gives the full-width backward")
    # a batch the run never trains on, to hold the trained weights to the
    # initial ones on the same tokens
    held_out = make_batch(data, TRAIN_STEPS)
    with torch.no_grad():
        before = float(model.loss(params, held_out))
    del params, grads2

    # the uninterrupted run; before step 4 its state (the one the step-4
    # checkpoint holds) is copied to the host, off the card's peak memory,
    # and the checkpoint linked aside for the replay (keep 1 deletes it at
    # step 8)
    run = trainer(TRAIN_DIR / "run")
    replay_dir = TRAIN_DIR / "replay"
    saved = {}

    def keep_step(step):
        if step != TRAIN_CKPT_EVERY:
            return
        saved["state"] = map_leaves(lambda t: t.to("cpu", copy=True),
                                    run.state)
        run.ckpt.wait()
        name = f"step_{step:08d}"
        (replay_dir / name).mkdir(parents=True)
        for f in os.listdir(TRAIN_DIR / "run" / name):
            os.link(TRAIN_DIR / "run" / name / f, replay_dir / name / f)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rms_kernel.LAUNCHES["plain"] = 0
    xent_kernel.LAUNCHES["xent"] = 0
    metrics = run.train(SEED, fail_injector=keep_step)
    launched = {"rmsnorm": rms_kernel.LAUNCHES["plain"],
                "xent": xent_kernel.LAUNCHES["xent"]}
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in metrics]
    if [m["step"] for m in metrics] != list(range(TRAIN_STEPS)):
        fail(f"train: steps run {[m['step'] for m in metrics]}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"train: non-finite loss in {losses}")
    with torch.no_grad():
        after = float(model.loss(run.state["params"], held_out))
    if not after < before:
        fail(f"train: the loss of held-out batch {TRAIN_STEPS} is {after!r} "
             f"after training, not below {before!r} at the initial weights")
    if launched["xent"] != TRAIN_STEPS:
        fail(f"train: {launched['xent']} xent launches for {TRAIN_STEPS} "
             f"steps (want one a step)")
    if launched["rmsnorm"] < (2 * cfg.n_layers + 1) * TRAIN_STEPS:
        fail(f"train: {launched['rmsnorm']} rmsnorm launches for "
             f"{TRAIN_STEPS} steps (< {2 * cfg.n_layers + 1} a step)")
    step_ms = statistics.median(m["step_s"] for m in metrics[1:]) * 1e3
    print(f"train: {TRAIN_ARCH} bf16 + fp32 master, remat, {tokens} tokens "
          f"a step (batch {TRAIN_BATCH} x seq {TRAIN_SEQ}): losses "
          f"{losses}, gradient norms {[m['grad_norm'] for m in metrics]}; "
          f"held-out batch {TRAIN_STEPS}: loss {before!r} at the initial "
          f"weights, {after!r} after training")
    print(f"train: {step_ms:.1f} ms a step (median of steps 1-"
          f"{TRAIN_STEPS - 1}), {tokens / step_ms * 1e3:.0f} tokens/s, "
          f"steps {[round(m['step_s'] * 1e3, 1) for m in metrics]} ms, peak "
          f"memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated), launches {launched} "
          f"({launched['rmsnorm'] / TRAIN_STEPS:.0f} rmsnorm a step, remat "
          f"recompute included)")

    # one step, profiled
    state = run.state
    batch = make_batch(data, TRAIN_STEPS)
    device_profile(f"train step {TRAIN_ARCH} {tokens} tokens",
                   lambda: run.step_fn(state, batch), top=8)
    del run, state, batch
    torch.cuda.empty_cache()

    # the round trip: a fresh Trainer restores step 4 and replays 4..7
    again = trainer(replay_dir)

    def compare_restored(step):
        if step != TRAIN_CKPT_EVERY:
            return
        for (path, got), (_, want) in zip(leaves(again.state),
                                          leaves(saved["state"])):
            if got.dtype != want.dtype or not torch.equal(got.cpu(), want):
                fail(f"train: restored {'/'.join(path)} differs from the "
                     f"saved state")
        saved.clear()

    rms_kernel.LAUNCHES["plain"] = 0
    xent_kernel.LAUNCHES["xent"] = 0
    replayed = again.train(SEED, fail_injector=compare_restored)
    launched["rmsnorm"] += rms_kernel.LAUNCHES["plain"]
    launched["xent"] += xent_kernel.LAUNCHES["xent"]
    if saved:
        fail("train: the restored state was never compared")
    if [m["step"] for m in replayed] != list(range(TRAIN_CKPT_EVERY,
                                                   TRAIN_STEPS)):
        fail(f"train: replayed steps {[m['step'] for m in replayed]}")
    first = replayed[0]["loss"]
    if first != losses[TRAIN_CKPT_EVERY]:
        fail(f"train: replayed step {TRAIN_CKPT_EVERY} loss {first!r} != "
             f"{losses[TRAIN_CKPT_EVERY]!r}")
    diffs = []
    for m in replayed[1:]:
        want = losses[m["step"]]
        diffs.append(abs(m["loss"] - want) / abs(want))
        if diffs[-1] > REPLAY_RTOL:
            fail(f"train: replayed step {m['step']} loss {m['loss']!r} vs "
                 f"{want!r} beyond rtol {REPLAY_RTOL}")
    print(f"train: restored step {TRAIN_CKPT_EVERY} into a fresh Trainer: "
          f"the state equals the saved one bit for bit; replayed step "
          f"{TRAIN_CKPT_EVERY} loss {first!r} equals the uninterrupted "
          f"run's bit for bit; steps {TRAIN_CKPT_EVERY + 1}-"
          f"{TRAIN_STEPS - 1} relative differences {diffs} (rtol "
          f"{REPLAY_RTOL}): ok")
    del again
    shutil.rmtree(TRAIN_DIR)
    torch.cuda.empty_cache()
    return launched, metrics


def check_partials(what: str, got, want, dtype) -> float:
    """B12's (m, l, ll) against the plain version's: m and ll exact (a max
    and a single logit), l to rtol 1e-5 (fp32) or 2e-2 (bf16); returns the
    max abs error over the three."""
    import torch

    rtol = 1e-5 if dtype == torch.float32 else 2e-2
    errs = [check_close(f"{what} m", got[0], want[0], 0.0, 0.0),
            check_close(f"{what} l", got[1], want[1], rtol, 0.0),
            check_close(f"{what} ll", got[2], want[2], 0.0, 0.0)]
    return max(errs)


def partial_kernel_checks() -> None:
    """B12 at the mesh's shard shapes against its plain version, and the
    shards' partials combined into each row's NLL against B11 on the whole
    row.  These launches compare; they are not the main path's."""
    import torch

    from repro_torch.kernels.xent import kernel as xent_kernel

    t, v = TRAIN_SEQ * TRAIN_BATCH, 151936
    gen = torch.Generator(device="cuda").manual_seed(21)
    whole = 3 * torch.randn((t, v), generator=gen, device="cuda")
    labels = torch.randint(0, v, (t,), generator=gen, device="cuda",
                           dtype=torch.int32)
    want = xent_kernel.xent_nll(whole, labels, logical_v=v)
    for dtype in (torch.float32, torch.bfloat16):
        x = whole.to(dtype)
        for n in (2, 4):
            vl = v // n
            parts = []
            for k in range(n):
                shard = x[:, k * vl:(k + 1) * vl].contiguous()
                got = xent_kernel.xent_partials(shard, labels, vl=vl,
                                                off=k * vl, logical_v=v)
                check_partials(f"xent.partial M={n} shard {k} {dtype}", got,
                               xent_kernel.plain_partials(
                                   shard, labels, vl=vl, off=k * vl,
                                   logical_v=v), dtype)
                parts.append(got)
                del shard
            mg = torch.stack([p[0] for p in parts]).amax(0)
            lsum = sum(p[1] * torch.exp(p[0] - mg) for p in parts)
            nll = (torch.log(torch.clamp(lsum, min=1e-30)) + mg
                   - sum(p[2] for p in parts))
            ref = want if dtype == torch.float32 else xent_kernel.xent_nll(
                x, labels, logical_v=v)
            err = check_close(f"xent.partial M={n} {dtype} combined vs B11",
                              nll, ref, 1e-5, 0.0)
            print(f"check: xent.partial ({t}, {vl}) x {n} shards {dtype}: "
                  f"(m, ll) exact, l within rtol "
                  f"{1e-5 if dtype == torch.float32 else 2e-2}; combined "
                  f"NLL vs B11 on the whole row max abs err {err:.3g} (rtol "
                  f"1e-5): ok")
        del x
    del whole
    rt, width, vl, off, lv = XENT_PARTIAL_RAGGED
    x = (3 * torch.randn((rt, width), generator=gen, device="cuda")).to(
        torch.bfloat16)
    lab = torch.randint(0, lv, (rt,), generator=gen, device="cuda",
                        dtype=torch.int32)
    lab[0] = off + vl           # the next shard's column, in local padding
    err = check_partials("xent.partial ragged bf16",
                         xent_kernel.xent_partials(x, lab, vl=vl, off=off,
                                                   logical_v=lv),
                         xent_kernel.plain_partials(x, lab, vl=vl, off=off,
                                                    logical_v=lv),
                         torch.bfloat16)
    print(f"check: xent.partial ragged {XENT_PARTIAL_RAGGED} bf16 (local "
          f"padding past vl, logical_v inside the shard, a label aliasing "
          f"the padding): max abs err {err:.3g}: ok")
    torch.cuda.empty_cache()


def mesh_backward_checks() -> None:
    """The vocab-parallel loss and backward on the card, over gloo with
    the collectives staged through pinned host buffers: ``api.launch
    ("xent")`` and ``xent_grad`` on a (2, 2) mesh at ``MESH_XENT``, and the
    reduced fp32 model padded for the model axis (``MESH_CHECK_VOCAB``),
    its step-0 loss, global gradient norm and every gradient leaf, then two
    AdamW steps, against the one-device port on the card from the same
    numpy inputs.  Tolerances as ``tests/test_torch_spmd.py`` holds the
    mesh to the reference: the loss rtol 1e-5, the cross-entropy gradient
    rtol 1e-5 / atol 1e-9, the norm rtol 5e-3, each model gradient leaf
    rtol 1e-4 with an atol of 1e-2 of its scale, the loss after the first
    update rtol 2e-3.  Each rank's block is held against the same block
    cut from the one-device result.  These launches compare; they are not
    the main path's."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import api, interop
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.interop import numpy_params
    from repro_torch.kernels.xent import ops as xent_ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import mesh_checks
    from repro_torch.models import build_model
    from repro_torch.models.params import leaves, map_leaves
    from repro_torch.optim import adamw
    from repro_torch.optim.schedules import make_schedule
    from repro_torch.parallel import specs, steps

    d, m = MESH_CHECK
    sizes = {"data": d, "model": m}
    cfg, _ = dataclasses.replace(
        reduce_for_smoke(get_config(TRAIN_ARCH)),
        vocab_size=MESH_CHECK_VOCAB).padded_for_mesh(m)
    model = build_model(cfg)
    tree = numpy_params(model.param_defs(), SEED)
    host = interop.params_from_jax(tree, cfg, device="cpu")
    state = map_leaves(interop.to_numpy, {
        "params": host, "opt": adamw.init_state(host, adamw.AdamWConfig())})
    data = DataConfig(vocab_size=cfg.vocab_logical, seq_len=64,
                      global_batch=4)
    schedule = ("cosine", MESH_CHECK_LR, 0, 10)
    rng = np.random.default_rng(SEED)
    t, v, lv = MESH_XENT
    x = (3 * rng.standard_normal((t, v))).astype(np.float32)
    labels = rng.integers(0, lv, size=t).astype(np.int32)
    t0 = time.perf_counter()
    ranks = mesh_lib.spawn(
        mesh_checks.run, MESH_CHECK, device="cuda",
        args=([("xent", dict(logits=x, labels=labels, logical_v=lv)),
               ("train", dict(cfg=cfg, state=state, data_cfg=data,
                              steps_run=2, schedule=schedule))],))
    secs = time.perf_counter() - t0

    xc, lc = torch.from_numpy(x).cuda(), torch.from_numpy(labels).cuda()
    want_loss = api.launch("xent", xc, lc, logical_v=lv)
    want_grad = xent_ops.xent_grad(xc, lc, 1.0, logical_v=lv)
    params = interop.params_from_jax(tree, cfg)
    loss, grads = steps.value_and_grad(model, params, make_batch(data, 0))
    gnorm = adamw.global_norm(grads)
    step_fn = steps.make_train_step(
        model, adamw.AdamWConfig(),
        make_schedule(schedule[0], peak=schedule[1], warmup=schedule[2],
                      total=schedule[3]))
    st = {"params": params, "opt": adamw.init_state(params,
                                                    adamw.AdamWConfig())}
    losses = []
    for i in range(2):
        st, metrics = step_fn(st, make_batch(data, i))
        losses.append(metrics["loss"])

    worst = 0.0
    for r, (xo, tr) in enumerate(ranks):
        where = f"spmd: mesh {MESH_CHECK} rank {r}"
        if xo["launches"]["xent.partial"] < 1 or xo["launches"]["xent"]:
            fail(f"{where}: xent launches {xo['launches']} (want B12, not "
                 f"B11)")
        check_close(f"{where} xent loss", torch.tensor(xo["loss"]),
                    want_loss.cpu(), 1e-5, 0.0)
        check_close(f"{where} xent_grad block", xo["grad"],
                    specs.shard_leaf(want_grad, xo["spec"], sizes,
                                     rank=r).cpu(), 1e-5, 1e-9)
        check_close(f"{where} model loss", torch.tensor(tr["loss0"]),
                    loss.cpu(), 1e-5, 0.0)
        check_close(f"{where} gradient norm", torch.tensor(tr["gnorm0"]),
                    gnorm.cpu(), 5e-3, 0.0)
        for path, g in leaves(grads):
            name = "/".join(path)
            block = specs.shard_leaf(g, pick(tr["specs"]["params"], path),
                                     sizes, rank=r).cpu()
            scale = float(g.abs().max())
            err = check_close(f"{where} gradient {name}",
                              pick(tr["grads0"], path), block, 1e-4,
                              1e-2 * scale)
            worst = max(worst, err / scale)
        for i, (got, want) in enumerate(zip(tr["losses"], losses)):
            check_close(f"{where} loss of step {i}", torch.tensor(got),
                        want.cpu(), 1e-5 if i == 0 else 2e-3, 0.0)
        if tr["digests"] != ranks[0][1]["digests"]:
            fail(f"{where}: unsharded leaves differ from rank 0's")
    print(f"check: vocab-parallel backward on a {MESH_CHECK} mesh of "
          f"{d * m} ranks on the card (gloo, pinned host buffers): xent "
          f"{MESH_XENT} loss and xent_grad blocks within rtol 1e-5 of the "
          f"one-device run, B12 on every rank; reduced {TRAIN_ARCH} fp32 "
          f"with vocab {cfg.vocab_logical} padded to {cfg.vocab_size}: loss "
          f"{ranks[0][1]['loss0']!r} vs {float(loss)!r}, gradient norm "
          f"{ranks[0][1]['gnorm0']!r} vs {float(gnorm)!r}, every one of "
          f"{len(list(leaves(grads)))} gradient leaves within rtol 1e-4 / "
          f"atol 1e-2 of its scale (worst {worst:.3g} of scale), losses "
          f"{ranks[0][1]['losses']} vs {[float(v) for v in losses]}, "
          f"unsharded leaves bit-equal on every rank; {secs:.1f} s for the "
          f"spawn: ok")
    del params, grads, st, want_grad, xc
    torch.cuda.empty_cache()


def pick(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def full_width_backward_check() -> None:
    """The vocab-parallel backward at full width, fatal: Qwen2-0.5B in fp32
    (every dimension of the config, remat on, the weights ``model.init``
    draws from ``SEED``: the port's init, at the true attention fan-ins,
    ROADMAP §C) on one seeded batch of ``TRAIN_BATCH`` x ``TRAIN_SEQ``
    tokens, on one device and on a (1, 2) mesh of two ranks on the card
    (``launch.mesh_checks.seeded_grads``): the loss, the global gradient
    norm and every gradient leaf, each rank's block against the same block
    cut from the one-device gradient.

    fp32, because the point is the algorithm, and it fits: 2 GB of weights
    and 2 GB of gradients a process.  The tolerances: the mesh computes the
    head's two products over the two vocab halves, combines the log-sum-exp
    across the ranks and sums the head's dx over them, so its logits and dx
    differ from one device's by fp32 rounding (unit 6e-8) over sums of 896
    and 151,936 terms; at the true fan-ins the backward carries that through
    24 layers without growth (on the CPU the reduced model's mesh matches
    one device to 1e-6 of each leaf's scale, tests/test_torch_spmd.py, and
    two frameworks that order every sum differently gave full-width norms
    5.8e-5 apart, ROADMAP §C).  Held: the loss rtol 1e-5, the norm rtol
    1e-4, each leaf atol 1e-4 of its largest magnitude.  A dropped or
    doubled sum over the ranks moves a leaf by the order of its scale.
    These launches check; they are not the main path's."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import mesh_checks
    from repro_torch.models import build_model
    from repro_torch.models.params import leaves, map_leaves
    from repro_torch.optim.adamw import global_norm
    from repro_torch.parallel import specs, steps

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32")
    model = build_model(cfg)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    loss, grads = steps.value_and_grad(model, model.init(SEED),
                                       make_batch(data, 0))
    norm = float(global_norm(grads))
    grads = map_leaves(lambda g: g.cpu(), grads)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = mesh_lib.spawn(mesh_checks.run, (1, 2), device="cuda", args=(
        [("seeded_grads", dict(cfg=cfg, seed=SEED, data_cfg=data))],))
    secs = time.perf_counter() - t0
    sizes = {"data": 1, "model": 2}
    worst, n_leaves = 0.0, 0
    for r, (res,) in enumerate(ranks):
        where = f"full-width backward, mesh (1, 2) rank {r}"
        check_close(f"{where} loss", torch.tensor(res["loss0"]), loss.cpu(),
                    FULL_LOSS_RTOL, 0.0)
        check_close(f"{where} gradient norm", torch.tensor(res["gnorm0"]),
                    torch.tensor(norm), FULL_NORM_RTOL, 0.0)
        n_leaves = 0
        for path, g in leaves(grads):
            name = "/".join(path)
            scale = float(g.abs().max())
            if not scale > 0:
                fail(f"{where}: the one-device gradient of {name} is zero")
            block = specs.shard_leaf(g, pick(res["specs"], path), sizes,
                                     rank=r)
            err = check_close(f"{where} gradient {name}",
                              pick(res["grads0"], path), block, 0.0,
                              FULL_LEAF_ATOL * scale)
            worst = max(worst, err / scale)
            n_leaves += 1
    rel = abs(ranks[0][0]["gnorm0"] - norm) / norm
    print(f"check: full-width {TRAIN_ARCH} fp32 backward (seed {SEED}, "
          f"{TRAIN_BATCH * TRAIN_SEQ} tokens), one device against a (1, 2) "
          f"mesh of two ranks on the card: loss {ranks[0][0]['loss0']!r} vs "
          f"{float(loss)!r}, step-0 gradient norm {ranks[0][0]['gnorm0']!r} "
          f"vs {norm!r} (relative {rel:.3g}; rtol {FULL_NORM_RTOL}), every "
          f"one of {n_leaves} leaves within atol {FULL_LEAF_ATOL} of its "
          f"scale (worst {worst:.3g} of scale): ok; {secs:.1f} s for the "
          f"spawn")
    del grads, ranks
    torch.cuda.empty_cache()


def spmd_phase(train_metrics: list[dict]) -> dict[str, int]:
    """Phase 3d: the vocab-parallel loss and backward checked on the card,
    then vocab-parallel training of Qwen2-0.5B at full width on a (1, 2)
    mesh of two ranks on the one card, through the launcher, held against
    the one-device run's ``train_metrics``, and a checkpoint replay.  Each
    rank zeroes its kernel counters just before its run and reads them just
    after; returns the launches summed over the ranks of the first run."""
    import os
    import shutil

    import torch

    from repro_torch.launch import train as train_launcher

    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"spmd: compute mode {mode}")
    if mode.splitlines()[0].strip() != "Default":
        fail(f"spmd: two ranks on one card need the Default compute mode, "
             f"not {mode!r}")
    t_phase = time.perf_counter()
    partial_kernel_checks()
    mesh_backward_checks()
    full_width_backward_check()
    shutil.rmtree(SPMD_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    argv = ["--arch", TRAIN_ARCH, "--mesh", SPMD_MESH, "--baseline",
            "--steps", str(SPMD_STEPS), "--seq-len", str(TRAIN_SEQ),
            "--global-batch", str(TRAIN_BATCH), "--ckpt-every",
            str(SPMD_CKPT_EVERY), "--seed", str(SEED)]
    t0 = time.perf_counter()
    ranks = train_launcher.main(argv + ["--ckpt-dir", str(SPMD_DIR / "run"),
                                        "--profile"])
    secs = time.perf_counter() - t0
    tokens = TRAIN_SEQ * TRAIN_BATCH
    for r in ranks:
        losses = [m["loss"] for m in r["metrics"]]
        if [m["step"] for m in r["metrics"]] != list(range(SPMD_STEPS)):
            fail(f"spmd: rank {r['rank']} ran steps "
                 f"{[m['step'] for m in r['metrics']]}")
        if not all(math.isfinite(v) for v in losses):
            fail(f"spmd: rank {r['rank']}: non-finite loss in {losses}")
        if r["launches"]["xent.partial"] != SPMD_STEPS or \
                r["launches"]["xent"] != 0:
            fail(f"spmd: rank {r['rank']} launches {r['launches']} (want "
                 f"xent.partial {SPMD_STEPS}, one a step, and xent 0)")
        if losses != [m["loss"] for m in ranks[0]["metrics"]]:
            fail(f"spmd: rank {r['rank']} losses {losses} differ from rank "
                 f"0's")
    losses = [m["loss"] for m in ranks[0]["metrics"]]
    one = [m["loss"] for m in train_metrics]
    rel = [abs(losses[i] - one[i]) / abs(one[i]) for i in range(2)]
    if max(rel) > LOSS_RTOL:
        fail(f"spmd: losses {losses[:2]} vs the one-device run's {one[:2]}:"
             f" relative {rel} > {LOSS_RTOL}")
    diff = [k for k in ranks[0]["digests"]
            if ranks[1]["digests"].get(k) != ranks[0]["digests"][k]]
    if diff or ranks[0]["digests"].keys() != ranks[1]["digests"].keys():
        fail(f"spmd: unsharded leaves differ between the ranks: {diff}")
    step_ms = statistics.median(m["step_s"] for m in
                                ranks[0]["metrics"][1:]) * 1e3
    prof = ranks[0]["profile"]
    print(f"spmd: {TRAIN_ARCH} bf16 + fp32 master, remat, mesh "
          f"{SPMD_MESH} (data 1, model 2) on one card, backend "
          f"{ranks[0]['backend']}, collective transport "
          f"{ranks[0]['transport']}: losses {losses}; the first two equal "
          f"the one-device run's {one[:2]} to {rel} (rtol {LOSS_RTOL}; step "
          f"0's rate is 0, so both are forwards of the initial weights); "
          f"gradient norms {[m['grad_norm'] for m in ranks[0]['metrics']]} "
          f"vs the one-device run's "
          f"{[m['grad_norm'] for m in train_metrics[:SPMD_STEPS]]} "
          f"(reported, not gated: bf16 rounding moves them; the fp32 "
          f"full-width gate above holds the mesh's backward to one "
          f"device's)")
    comm = ranks[0]["comm"]
    print(f"spmd: {step_ms:.1f} ms a step (median of steps 1-"
          f"{SPMD_STEPS - 1}, rank 0), {tokens / step_ms * 1e3:.0f} tokens/s, "
          f"steps {[round(m['step_s'] * 1e3, 1) for m in ranks[0]['metrics']]}"
          f" ms; peak memory "
          + ", ".join(f"rank {r['rank']} {r['peak_bytes'] / 2**30:.2f} GiB"
                      for r in ranks)
          + f"; launches a rank {ranks[0]['launches']}; collectives on "
          f"rank 0 {comm['calls']} calls, {comm['bytes']} bytes, "
          f"{comm['seconds'] * 1e3:.1f} ms on the host's clock over the run "
          f"(staging and checkpoint gathers included); "
          f"{len(ranks[0]['digests'])} unsharded leaves bit-equal on both "
          f"ranks; {secs:.1f} s for the launch (spawn, init, "
          f"{SPMD_STEPS} steps, checkpoints, the profiled step)")
    print(f"profile: spmd train step rank 0 of {SPMD_MESH}: "
          f"{prof['wall_ms']:.3f} ms, device kernels {prof['busy_ms']:.3f} ms "
          f"(busy {prof['busy_ms'] / prof['wall_ms']:.1%}) in "
          f"{prof['launches']} launches, collectives {prof['comm']['calls']} "
          f"calls, {prof['comm']['bytes']} bytes, "
          f"{prof['comm']['seconds'] * 1e3:.1f} ms on the host's clock; "
          + "; ".join(f"{k} {ms:.3f} ms x{n}" for k, ms, n in prof["top"]))

    # the round trip: a second launch restores step 2 and replays 2..3
    name = f"step_{SPMD_CKPT_EVERY:08d}"
    (SPMD_DIR / "replay" / name).mkdir(parents=True)
    for f in os.listdir(SPMD_DIR / "run" / name):
        os.link(SPMD_DIR / "run" / name / f, SPMD_DIR / "replay" / name / f)
    shutil.rmtree(SPMD_DIR / "run")
    replayed = train_launcher.main(argv + ["--ckpt-dir",
                                           str(SPMD_DIR / "replay")])
    got = [m["loss"] for m in replayed[0]["metrics"]]
    if [m["step"] for m in replayed[0]["metrics"]] != list(
            range(SPMD_CKPT_EVERY, SPMD_STEPS)):
        fail(f"spmd: replayed steps "
             f"{[m['step'] for m in replayed[0]['metrics']]}")
    if got[0] != losses[SPMD_CKPT_EVERY]:
        fail(f"spmd: replayed step {SPMD_CKPT_EVERY} loss {got[0]!r} != "
             f"{losses[SPMD_CKPT_EVERY]!r}")
    print(f"spmd: restored step {SPMD_CKPT_EVERY} (gathered into the "
          f"one-device layout by the mesh run) into a new mesh run: replayed "
          f"step {SPMD_CKPT_EVERY} loss {got[0]!r} equals the first run's bit "
          f"for bit; later steps {got[1:]} vs {losses[SPMD_CKPT_EVERY + 1:]}: "
          f"ok")
    shutil.rmtree(SPMD_DIR)
    print(f"spmd: the phase took {time.perf_counter() - t_phase:.1f} s (B12 "
          f"checks, two launches of the mesh, their checkpoints)")
    return {"xent.partial": sum(r["launches"]["xent.partial"] for r in ranks)}


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
    from repro_torch.kernels.lbm import kernel as lbm_kernel
    from repro_torch.kernels.lbm import ops as lbm_ops
    from repro_torch.kernels.lbm import ref as lbm_ref
    from repro_torch.kernels.stream import kernel as stream_kernel
    from repro_torch.kernels.stream import ops as stream_ops
    from repro_torch.kernels.triad import kernel as triad_kernel
    from repro_torch.kernels.triad import ops as triad_ops
    from repro_torch.core.layout import hopper_limits
    from repro_torch.core.segmented import SegmentedArray
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.util import to_tiles
    from repro_torch.kernels.xent import kernel as xent_kernel

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
    print(f"build: ptxas registers and spill-store bytes per source: "
          + str({k: {"registers": [e["registers"] for e in v],
                     "spill_bytes": sum(e["spill_bytes"] for e in v)}
                 for k, v in _build.PTXAS.items()}))
    # the two kernels redesigned for Hopper: each instantiation's registers,
    # static shared memory and spills
    for source in ("stream", "rmsnorm"):
        for e in _build.PTXAS.get(source, []):
            print(f"build: {source}: {e['kernel'][:120]}: {e['registers']} "
                  f"registers, {e['smem']} B static shared memory, "
                  f"{e['spill_bytes']} B spill stores")

    # ---- 3. the main path ----------------------------------------------
    counters = {
        "stream.copy": (stream_kernel.LAUNCHES, "copy"),
        "stream.scale": (stream_kernel.LAUNCHES, "scale"),
        "stream.add": (stream_kernel.LAUNCHES, "add"),
        "stream.triad": (stream_kernel.LAUNCHES, "triad"),
        "triad": (triad_kernel.LAUNCHES, "triad"),
        "jacobi": (jacobi_kernel.LAUNCHES, "jacobi"),
        "lbm.soa": (lbm_kernel.LAUNCHES, "soa"),
        "lbm.ivjk": (lbm_kernel.LAUNCHES, "ivjk"),
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
            plain = (triad_kernel.plain(*args) if name == "triad" else
                     stream_kernel.plain(name.removeprefix("stream."), args,
                                         kw.get("s")))
            check_close(f"{name} n={n} {dtype} vs its plain version", out,
                        plain, 0.0, 0.0)
            del out, plain
        torch.cuda.synchronize()
        print(f"main: stream copy/scale/add/triad + triad n={n} {dtype}: "
              f"within tolerance of the oracle, bit-exact against the plain "
              f"versions: ok")

    run_stream_ops(N, torch.float32, 0)
    run_stream_ops(N, torch.bfloat16, 1)
    run_stream_ops(N_RAGGED, torch.float32, 2)

    b, c, d = stream_ops.random_vectors(N, 3, torch.float32, seed=3)
    want = api.ref("triad", b, c, d)
    for p in PHASES:
        phases = (p, 2 * p, 3 * p)
        out = triad_ops.vector_triad_phased(b, c, d, phases=phases)
        check_close(f"vector_triad_phased {phases}", out, want, 0.0, 0.0)
    del out, want
    print(f"main: vector_triad_phased n={N} fp32 at phases (p, 2p, 3p), "
          f"p = {PHASES.start}..{PHASES.stop - 1}: bit-exact: ok")

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

    def lattice(n, dtype, seed):
        """The equilibrium shear flow with a +-2.5 % seeded perturbation,
        made on the card."""
        f = lbm_ops.init_equilibrium(n)
        gen = torch.Generator(device=f.device).manual_seed(seed)
        noise = torch.rand(f.shape, generator=gen, device=f.device)
        return (f * (1 + 0.05 * (noise - 0.5))).to(dtype)

    step_ms = {}
    for n in LBM_SIZES:
        f = lattice(n, torch.float32, n)
        want = f
        for _ in range(LBM_STEPS):
            want = lbm_ref.lbm_step(want, OMEGA)
        for layout in ("soa", "ivjk"):
            lbm_ops.lbm_run(f, OMEGA, 1, layout=layout)   # warm-up
            torch.cuda.synchronize()
            start.record()
            got = lbm_ops.lbm_run(f, OMEGA, LBM_STEPS, layout=layout)
            end.record()
            end.synchronize()
            step_ms[layout, n] = start.elapsed_time(end) / LBM_STEPS
            # multi-step tolerance of tests/test_kernels.py
            check_close(f"lbm_run {layout} N={n} x{LBM_STEPS}", got, want,
                        2e-4, 1e-6)
            print(f"main: lbm_run {layout} N={n} fp32 x{LBM_STEPS}: "
                  f"{step_ms[layout, n]:.3f} ms a step, "
                  f"{n ** 3 / step_ms[layout, n] / 1e3:.1f} MLUP/s "
                  f"(propagation and layout copies included): ok")
            del got
        del f, want

    sb, sc, sd = stream_ops.random_vectors(N, 3, torch.float32, seed=8)
    segs = [SegmentedArray.from_flat(v, SEGMENTS, align=128, shift=16)
            for v in (torch.zeros_like(sb), sb, sc, sd)]
    check_close("vector_triad_segmented vs flat triad",
                triad_ops.vector_triad_segmented(*segs).to_flat(),
                api.launch("triad", sb, sc, sd), 0.0, 0.0)
    print(f"main: vector_triad_segmented n={N} fp32, {SEGMENTS} segments, "
          f"phases {segs[0].phases}: equal to the flat triad: ok")

    serve_launches = serving_phase()
    train_launches, train_metrics = training_phase()
    spmd_launches = spmd_phase(train_metrics)
    hybrid_launches = hybrid_phase()
    xlstm_launches = xlstm_phase()
    moe_launches = moe_phase()
    launches = {name: table[key] for name, (table, key) in counters.items()}
    launches.update(serve_launches)
    launches["rmsnorm"] += train_launches["rmsnorm"]
    launches["xent"] = train_launches["xent"]
    launches.update(spmd_launches)
    for phase in (hybrid_launches, xlstm_launches, moe_launches):
        for name, count in phase.items():
            launches[name] += count
    print(f"main: launches {launches}")
    missing = [name for name, count in launches.items() if count == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")

    # ---- 4. kernels against their plain versions ------------------------
    def tiles(name, n, dtype, count, seed):
        plan = api.plan_for(name, (n,), dtype)
        xs = stream_ops.random_vectors(n, count, dtype, seed=seed)
        return plan, [to_tiles(x, plan)[0] for x in xs]

    # STREAM and both triads compute in fp32 with explicitly rounded
    # multiplies and adds (no FMA contraction) and round once to the
    # dtype, as their plain versions do: bit-exact at fp32 and bf16.
    # Jacobi rounds at most once: bit-exact.
    cases = {}
    for dtype in (torch.float32, torch.bfloat16):
        suffix = "" if dtype == torch.float32 else ".bf16"
        for name, op, count, s in [
            ("stream.copy", "copy", 1, None),
            ("stream.scale", "scale", 1, SCALAR),
            ("stream.add", "add", 2, None),
            ("stream.triad", "triad", 2, SCALAR),
        ]:
            plan, xs = tiles(name, N, dtype, count, 5)
            wrapper = getattr(stream_kernel, f"{op}2d")
            args = (*xs, s) if s is not None else tuple(xs)
            cases[name + suffix] = dict(
                kernel=lambda w=wrapper, a=args, p=plan: w(*a, brows=p.block_rows),
                plain=lambda o=op, x=xs, s=s: stream_kernel.plain(o, x, s),
                exact=True, dtype=dtype,
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
            exact=True, dtype=dtype, bytes=4 * N * dtype.itemsize, ops=2 * N,
            library=lambda x=xs: torch.addcmul(*x))

    def lbm_case(n, dtype, layout):
        """The collision at the main path's shape: the propagated lattice
        laid out by the plan (the input a step hands the kernel)."""
        f = lattice(n, dtype, n + 1)
        plan = api.plan_for(f"lbm.{layout}", f.shape, dtype)
        flat, s = lbm_ops._flatten_pad(lbm_ref.propagate(f), plan)
        if layout == "soa":
            x = flat
        else:
            lanes = plan.padded_shape[2]
            x = flat.view(19, -1, lanes).transpose(0, 1).contiguous()

        def run():
            if layout == "soa":
                return lbm_kernel.collide_soa(x, OMEGA, bs=plan.block_cols)
            return lbm_kernel.collide_ivjk(x, OMEGA, bsb=plan.block_rows)

        def logical(y):
            axis = lbm_kernel.V_AXIS[layout]
            return y.movedim(axis, 0).reshape(19, -1)[:, :s]

        sites = x.numel() // 19
        return dict(
            kernel=lambda: logical(run()),
            plain=lambda: logical(lbm_kernel.plain(x, OMEGA, layout)),
            exact=True, dtype=dtype, bytes=2 * x.numel() * dtype.itemsize,
            ops=lbm_kernel.OPS_PER_SITE * sites, library=None,
            # timed without the logical-site slice
            run=run, plain_run=lambda: lbm_kernel.plain(x, OMEGA, layout))

    for layout in ("soa", "ivjk"):
        cases[f"lbm.{layout}"] = lbm_case(LBM_SIZES[0], torch.float32, layout)
        cases[f"lbm.{layout}.bf16"] = lbm_case(LBM_BF16_N, torch.bfloat16,
                                               layout)
    def rms_case(shape, dtype, gated, seed):
        """A norm at a main-path shape, through the wrapper as
        ``api.launch`` calls it (the scale in x's dtype)."""
        rows, d = shape
        name = "rmsnorm.gated" if gated else "rmsnorm"
        plan = api.plan_for(name, shape, dtype)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x, z = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        s = (torch.randn(d, generator=gen, device="cuda") + 1).to(dtype)

        def run():
            if gated:
                return rms_kernel.gated_rmsnorm2d(x, z, s, d_logical=d,
                                                  brows=plan.block_rows)
            return rms_kernel.rmsnorm2d(x, s, d_logical=d,
                                        brows=plan.block_rows)

        def plain():
            return rms_kernel.plain(x, s, d, 1e-6, z if gated else None)

        def library():
            return F.rms_norm(x, (d,), weight=s, eps=1e-6)

        # x (and z) read once, y written once, the scale read once (the
        # planner's count, ``predicted_hbm_bytes``); squares, sums and two
        # scalings an element, and for the gate a sigmoid (exp, add, divide)
        # and two products more
        return dict(kernel=run, plain=plain, exact=False, dtype=dtype,
                    bytes=((3 if gated else 2) * rows + 1) * d
                    * dtype.itemsize,
                    ops=(9 if gated else 4) * rows * d,
                    library=None if gated else library)

    # B9 at the decode shape (the JSON row: most launches) and the prefill
    # shape; B10 at (2048, 4096).  bf16 is the serving dtype.
    for dtype in (torch.bfloat16, torch.float32):
        suffix = "" if dtype == torch.bfloat16 else ".fp32"
        cases["rmsnorm" + suffix] = rms_case((SERVE_SLOTS, 2560), dtype,
                                             False, 10)
        cases["rmsnorm.prefill" + suffix] = rms_case(
            (PREFILL_B * PREFILL_S, 2560), dtype, False, 11)
        cases["rmsnorm.gated" + suffix] = rms_case(GATED_SHAPE, dtype, True,
                                                   12)
    # zamba2-1.2b's rows (phase 3e), bf16: B9 at its decode (8, 2048) and
    # prefill (2048, 2048) shapes, B10 at its decode (8, 4096) shape (its
    # prefill shape is GATED_SHAPE)
    cases["rmsnorm.zamba2"] = rms_case((SERVE_SLOTS, 2048), torch.bfloat16,
                                       False, 17)
    cases["rmsnorm.prefill.zamba2"] = rms_case(
        (PREFILL_B * PREFILL_S, 2048), torch.bfloat16, False, 18)
    cases["rmsnorm.gated.zamba2"] = rms_case((SERVE_SLOTS, 4096),
                                             torch.bfloat16, True, 19)
    # xlstm-1.3b's sLSTM output norm (phase 3f): B9 on fp32 rows of its
    # d_model with the scale in fp32, at the decode (8, 2048) and prefill
    # (2048, 2048) shapes; its bf16 rows and B10's are zamba2's shapes above
    cases["rmsnorm.xlstm.fp32"] = rms_case((SERVE_SLOTS, 2048),
                                           torch.float32, False, 20)
    cases["rmsnorm.prefill.xlstm.fp32"] = rms_case(
        (PREFILL_B * PREFILL_S, 2048), torch.float32, False, 21)
    # qwen3-moe-30b-a3b's ln1 and ln2 (phase 3g), bf16: B9 at its decode
    # (8, 2048) and prefill (2048, 2048) shapes (zamba2's shapes, other
    # inputs)
    cases["rmsnorm.moe"] = rms_case((SERVE_SLOTS, 2048), torch.bfloat16,
                                    False, 22)
    cases["rmsnorm.prefill.moe"] = rms_case((PREFILL_B * PREFILL_S, 2048),
                                            torch.bfloat16, False, 23)
    def xent_case(t, v, logical_v, dtype, seed):
        """B11 at a main-path shape, through the wrapper as ``_launch_xent``
        calls it: per-token NLL of (t, v) logits (3 x N(0, 1)) over the
        first ``logical_v`` columns, labels in [0, logical_v)."""
        plan = api.plan_for("xent", (t, v), dtype)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x = (3 * torch.randn((t, v), generator=gen, device="cuda")).to(dtype)
        labels = torch.randint(0, logical_v, (t,), generator=gen,
                               device="cuda", dtype=torch.int32)
        labels64 = labels.to(torch.int64)

        def run():
            return xent_kernel.xent_nll(x, labels, logical_v=logical_v,
                                        brows=plan.block_rows)

        # the logits read once, the labels read and the NLL written once;
        # a max, a subtract, an exp and an add an element
        return dict(kernel=run,
                    plain=lambda: xent_kernel.plain(x, labels, logical_v),
                    exact=False, dtype=dtype, tol=(1e-5, 1e-5),
                    bytes=t * v * dtype.itemsize + 8 * t, ops=4 * t * v,
                    library=(lambda: F.cross_entropy(x, labels64))
                    if logical_v == v else None)

    # B11 at the training step's (4096, 151936) fp32 logits, and bf16 logits
    # of a padded vocab (logical_v < width)
    cases["xent"] = xent_case(TRAIN_SEQ * TRAIN_BATCH, 151936, 151936,
                              torch.float32, 13)
    cases["xent.ragged.bf16"] = xent_case(*XENT_RAGGED, torch.bfloat16, 14)

    def xent_partial_case(t, width, vl, off, lv, dtype, seed):
        """B12 at a vocab shard of the mesh path, through the wrapper as
        ``_spmd_xent`` calls it: (m, l, ll) of (t, width) logits (3 x N(0,
        1)) at global offset ``off``, labels anywhere in [0, lv)."""
        plan = api.plan_for("xent", (t, vl), dtype, local=True)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x = (3 * torch.randn((t, width), generator=gen, device="cuda")).to(
            dtype)
        labels = torch.randint(0, lv, (t,), generator=gen, device="cuda",
                               dtype=torch.int32)

        def run():
            return xent_kernel.xent_partials(x, labels, vl=vl, off=off,
                                             logical_v=lv,
                                             brows=plan.block_rows)

        # the shard's logits read once, the labels read and three fp32
        # partials written once; a max, a subtract, an exp and an add an
        # element
        return dict(kernel=run,
                    plain=lambda: xent_kernel.plain_partials(
                        x, labels, vl=vl, off=off, logical_v=lv),
                    check=lambda got, want: check_partials(
                        f"xent.partial ({t}, {width}) off {off}", got, want,
                        dtype),
                    exact=False, dtype=dtype,
                    bytes=t * width * dtype.itemsize + 4 * t + 12 * t,
                    ops=4 * t * width, library=None,
                    nearest=lambda: torch.logsumexp(x.float(), -1))

    # B12 at the mesh's (4096, 75968) fp32 shard, the second of two (the
    # JSON row), and a ragged bf16 shard
    vshard = 151936 // 2
    cases["xent.partial"] = xent_partial_case(
        TRAIN_SEQ * TRAIN_BATCH, vshard, vshard, vshard, 151936,
        torch.float32, 15)
    cases["xent.partial.ragged.bf16"] = xent_partial_case(
        *XENT_PARTIAL_RAGGED, torch.bfloat16, 16)
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
        # the LBM gate is tests/test_kernels.py's one-step tolerance
        # (fp32 rtol 2e-5 / atol 1e-7, bf16 2e-2); bit-exact is expected
        gate = ((2e-2, 2e-2) if case["dtype"] == torch.bfloat16 else
                (2e-5, 1e-7)) if name.startswith("lbm") else (0.0, 0.0)
        rtol, atol = case.get("tol") or (
            gate if case["exact"] else tol(case["dtype"]))
        if "check" in case:
            errors[name] = case["check"](got, want)
            gate_text = (f"m and ll exact, l rtol "
                         f"{1e-5 if case['dtype'] == torch.float32 else 2e-2}")
        else:
            errors[name] = check_close(f"{name} kernel vs plain", got, want,
                                       rtol, atol)
            gate_text = f"rtol {rtol} atol {atol}"
        print(f"check: {name} kernel vs plain: max abs err {errors[name]:.3g} "
              f"(tolerance {gate_text})")
        del got, want
    torch.cuda.synchronize()

    # ---- 5. times -------------------------------------------------------
    time_ms(cases["triad"]["kernel"], samples=20)   # warm-up, discarded
    times = {}
    for name, case in cases.items():
        bound_bytes = case["bytes"] / bw * 1e3
        bound_ops = case["ops"] / fp32_rate * 1e3
        library = case["library"]
        kernel = case.get("run", case["kernel"])
        # in turns, kernel and library each timed before and after the
        # other: a drift of the card's clocks falls on both alike
        k1 = time_ms(kernel)
        l1 = None if library is None else time_ms(library)
        plain_ms = time_ms(case.get("plain_run", case["plain"]))
        l2 = None if library is None else time_ms(library)
        k2 = time_ms(kernel)
        times[name] = {
            "ms": (k1 + k2) / 2,
            "plain_ms": plain_ms,
            "library_ms": None if library is None else (l1 + l2) / 2,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        }
        t = times[name]
        base = name.removesuffix(".zamba2").removesuffix(".bf16")
        base = base.removesuffix(".fp32")
        base = base.replace(".prefill", "").replace("partial.ragged",
                                                    "partial")
        if "nearest" in case:
            lib = (f"none; nearest {time_ms(case['nearest']):.4f} ms "
                   f"({NEAREST[base]})")
        else:
            lib = (f"{t['library_ms']:.4f} ms" if library is not None else
                   f"none ({NO_LIBRARY[base]})")
        ratio = (f"kernel/library {t['ms'] / t['library_ms']:.3f}"
                 if library is not None else "kernel/library -")
        print(f"time: {name}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library {lib}, "
              f"bound {t['bound_ms']:.4g} ms ({t['bound_by']}), "
              f"{ratio}, {t['bound_ms'] / t['ms']:.1%} of bound, "
              f"{case['bytes'] / t['ms'] / 1e6:.1f} GB/s effective")

    # the host's cost of one call: what a decode step pays 73 times
    for name in ("rmsnorm", "rmsnorm.prefill", "rmsnorm.gated"):
        lib = cases[name]["library"]
        extra = (f", {host_ms(lib, 100):.4f} ms for the library call"
                 if lib else "")
        print(f"host: {name} bf16: {host_ms(cases[name]['kernel'], 100):.4f} "
              f"ms to enqueue one wrapper call{extra}")

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

    # paper Fig. 7: the collision alone beside the whole step
    for n in LBM_SIZES:
        for layout in ("soa", "ivjk"):
            case = (cases[f"lbm.{layout}"] if n == LBM_SIZES[0]
                    else lbm_case(n, torch.float32, layout))
            ms = (times[f"lbm.{layout}"]["ms"] if n == LBM_SIZES[0]
                  else time_ms(case["run"]))
            print(f"fig7: {layout} N={n} fp32: collide {ms:.4f} ms "
                  f"({n ** 3 / ms / 1e3:.1f} MLUP/s, "
                  f"{case['bytes'] / ms / 1e6:.1f} GB/s), whole step "
                  f"{step_ms[layout, n]:.4f} ms "
                  f"({n ** 3 / step_ms[layout, n] / 1e3:.1f} MLUP/s)")
            del case

    # paper Fig. 5: the segmented triad over the flat one
    flat_ms = time_ms(lambda: api.launch("triad", sb, sc, sd))
    seg_ms = time_ms(lambda: triad_ops.vector_triad_segmented(*segs))
    print(f"fig5: triad n={N} fp32: flat {flat_ms:.4f} ms, {SEGMENTS} "
          f"segments {seg_ms:.4f} ms, segmented/flat {seg_ms / flat_ms:.4f}; "
          f"host enqueue a call: flat "
          f"{host_ms(lambda: api.launch('triad', sb, sc, sd)):.4f} ms, "
          f"segmented "
          f"{host_ms(lambda: triad_ops.vector_triad_segmented(*segs)):.4f} ms")

    # where the time of an LBM step and of the segmented triad goes
    f = lattice(LBM_SIZES[0], torch.float32, 1)
    for layout in ("soa", "ivjk"):
        device_profile(f"lbm_run {layout} N={LBM_SIZES[0]} x2",
                       lambda lay=layout: lbm_ops.lbm_run(f, OMEGA, 2,
                                                          layout=lay))
    del f
    device_profile(f"vector_triad_segmented n={N}",
                   lambda: triad_ops.vector_triad_segmented(*segs))

    kernels = []
    for name, (src, replaces) in KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errors[name], **times[name],
        })

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
