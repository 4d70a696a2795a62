"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips where
``torch.cuda.is_available()`` is false; run them on the card with
``python -m pytest -q tests/test_torch_cuda.py``.  This file imports no JAX:
the machine with the card has none.

Tolerances: fp32 copy/scale/add and the Jacobi sweep round at most once and
must be bit-exact; both triads round the product and the sum separately on
both sides, so they are expected bit-exact, and the stated tolerance (fp32
rtol 1e-5 / atol 1e-6, bf16 2e-2, as tests/test_kernels.py) only allows for
a compiler contracting them into an FMA.  The LBM collision and its plain
version do the same rounded operations in the same order in fp32 and round
once to the array dtype, so they must agree bit for bit at both dtypes, on
the logical sites (a padded site's velocity is NaN by design).  The RMSNorm
kernels sum the squares in another order than their plain versions, so they
are held to the tolerance (fp32 rtol 1e-5 / atol 1e-6, bf16 2e-2), not bit
for bit.  The reduced serving run holds the paged stream to the dense one
bit for bit (same tokens).  The cross-entropy kernel sums its exps in
another order than its plain version, each by ``__expf`` (a few ulp from
the exact exp near the row's max); both widen the logits to fp32 first, so
the per-token NLL is held to rtol 1e-5 / atol 1e-5 at either dtype, at
logits of 3 x N(0, 1) and of 30 x N(0, 1), where ``__expf``'s error, which
grows with the distance from the max, would show first.

The vocab-shard partials (B12) are a max, a single logit and a sum of
exps: ``m`` and ``ll`` must equal the plain version's exactly, ``l`` to rtol
1e-5 (fp32) and 2e-2 (bf16).  Both kernels read rows of any width at any
storage offset in place, and are held at every misalignment of a row.  The SPMD checks spawn a (1, 2) mesh of two
ranks on the one card over gloo: the loss and the gradient blocks to the
cross-entropy tolerance against the CPU, the reduced train step's loss to
rtol 1e-5 against the one-device CPU step, the replicated leaves the same
bits on both ranks.

The reduced fp32 train step on the card is held to the same step on the
CPU: loss rtol 1e-5, each gradient leaf rtol 1e-4 with an atol of 1e-2 of
the leaf's scale.  That atol was set when the port's init copied the
reference's attention fan-in and the reduced qwen2-0.5b was
ill-conditioned (see tests/test_torch_train.py): the card, summing in
other orders, differed from the CPU by up to 3.5e-3 of the scale then
(NVIDIA H100 80GB HBM3, 700 W).  The init now takes the true fan-ins
(ROADMAP §C); 1e-2 still fails any dropped or misrouted gradient.

The hybrid (reduced zamba2) serves paged = dense bit for bit like the
dense models, and its train step runs 300 tokens a row, across a chunk of
the SSD, to the same tolerance.  B10 at zamba2-1.2b's shapes is held to
its plain version at the bf16 tolerance; ``GatedRMSNormFn``'s gradients on
the card (a plain fp32 backward behind the kernel's forward) to the same
Function on the CPU at rtol 1e-4 / atol 1e-5 for x and z, and the scale's
(a sum over the rows) within a bound derived from the sum of its terms'
magnitudes (``_scale_grad_bound``), every input from a seeded generator;
both backwards give the same bits on a second run.  The xlstm (reduced
xlstm-1.3b) serves paged = dense the same way, and its train step runs 300
tokens a row, past the length where the reference's mLSTM gradient is NaN,
to the same tolerance; B9 on its sLSTM output norm's fp32 rows of 2048
with the bf16 scale cast to fp32 is held to the fp32 tolerance.

The MoE layer (``models.moe``, reduced top-2 of 8 at capacity factor 1.0)
routes and drops the same assignments on the card as on the CPU, its
output and aux at rtol 1e-5 / atol 1e-6; at qwen3-moe-30b-a3b's full
layer width in bf16 two runs give the same bits (no float atomics in the
dispatch or the combine) and agree with the CPU at the bf16 tolerance.
The reduced qwen3-moe serves paged = dense and trains as the dense models.

The Jacobi sweep's 2-D tiles equal its plain version bit for bit at strip
and tile edges (a width one under and over a tile, strip + 1..3 rows,
inside a wider pitch), its boundary-row entry equals the 3-row slab path
bit for bit, and rows off 16 B are refused before any launch.  The Jacobi
and LBM halo bodies on a (2, 1) mesh of two ranks of the card equal one
device on the card bit for bit (the blocking Jacobi body too,
with a mask and over several steps), and B7 and B8 give every site of the
same propagated lattice the same bits, which lets the LBM body collide an
ivjk lattice's boundary planes with B7.

``Mesh.reduce_scatter`` over NCCL, on a mesh of one card a rank, equals
the gloo form on the CPU (an all-reduce, then this rank's block) on the
same inputs, every block at rtol 1e-6 / atol 1e-6 (sums of 2 or 4 fp32
terms in another order); it skips where the cards are fewer than the
ranks.

The STREAM kernels write every element of pitched and contiguous tiles
once, bit-exact (both dtypes: one rounding of the same fp32 operations),
and leave the row padding alone.  A row normed by the RMSNorm kernel has
the same bits whatever rows and blocks it is launched with.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.kernels.jacobi import kernel as jkernel
from repro_torch.core.layout import round_up
from repro_torch.core.segmented import SegmentedArray
from repro_torch.kernels.jacobi import ops as jops
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels.lbm import kernel as lkernel
from repro_torch.kernels.rmsnorm import kernel as rkernel
from repro_torch.models import build_model
from repro_torch.serving import ContinuousBatcher, Request
from repro_torch.kernels.lbm import ops as lops
from repro_torch.kernels.stream import kernel as skernel
from repro_torch.kernels.stream import ops as sops
from repro_torch.kernels.triad import kernel as tkernel
from repro_torch.kernels.triad import ops as tops
from repro_torch.kernels.util import at_storage_offset, to_tiles
from repro_torch.kernels.xent import kernel as xkernel
from repro_torch.kernels.xent import ops as xops
from repro_torch.models import blocks, transformer
from repro_torch.models.params import leaves, map_leaves
from repro_torch.parallel import steps

pytestmark = pytest.mark.cuda

SIZES = [1, 7, 1000, 8191, 20000, 1 << 20]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(
        rtol=1e-5, atol=1e-6)


def exact(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_stream_kernels_match_plain(n, dtype):
    a, b, c = sops.random_vectors(n, 3, dtype, seed=n)
    for op, count, s in [("copy", 1, None), ("scale", 1, 3.0), ("add", 2, None),
                         ("triad", 2, 3.0)]:
        plan = api.plan_for(f"stream.{op}", (n,), dtype)
        xs = [to_tiles(x, plan)[0] for x in (a, b, c)[:count]]
        args = (*xs, s) if s is not None else tuple(xs)
        before = skernel.LAUNCHES[op]
        got = getattr(skernel, f"{op}2d")(*args, brows=plan.block_rows)
        assert skernel.LAUNCHES[op] == before + 1
        want = skernel.plain(op, xs, s)
        if dtype == torch.float32 and op != "triad":
            exact(got, want)
        else:
            torch.testing.assert_close(got, want, **tol(dtype))


STREAM_OPS = [("copy", 1, None), ("scale", 1, 3.0), ("add", 2, None),
              ("triad", 2, 3.0), ("vtriad", 3, None)]


# (rows, width, extra pitch, brows): one row; a ragged last block (rows no
# multiple of brows); blocks wider than one pass of a CTA's threads (7 rows
# of 12288); contiguous blocks, walked across rows, and non-contiguous rows
# (pitch > width), each element found by its row and column
STREAM_TILES = [(1, 128, 0, 1), (1, 4096, 0, 1), (43, 896, 0, 4),
                (133, 2560, 0, 1), (263, 128, 0, 3), (265, 4096, 0, 2),
                (43, 896, 8, 4), (133, 2560, 8, 1), (265, 4096, 128, 2),
                (7, 12288, 0, 7), (5, 12288, 64, 2)]


@pytest.mark.parametrize("rows,width,extra,brows", STREAM_TILES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_stream_kernels_write_every_element_once(rows, width, extra, brows,
                                               dtype):
    """Every op on pitched (rows, width) tiles into an output pre-filled
    with NaN: every logical element bit-equal to the plain version (the
    same rounded fp32 operations, one rounding to the dtype), the row
    padding left alone."""
    if width % (16 // torch.tensor([], dtype=dtype).element_size()):
        pytest.skip("width is not whole 16-B vectors")
    gen = torch.Generator(device="cuda").manual_seed(rows * width + extra)
    pitch = width + extra
    xs = []
    for _ in range(3):
        t = torch.empty_strided((rows, width), (pitch, 1), dtype=dtype,
                                device="cuda")
        t.copy_(torch.randn(rows, width, generator=gen, device="cuda"))
        xs.append(t)
    for op, count, s in STREAM_OPS:
        out = torch.full((rows * pitch,), float("nan"), dtype=dtype,
                         device="cuda").as_strided((rows, width), (pitch, 1))
        skernel.launch_cuda(op, xs[:count], s, brows, out)
        want = (tkernel.plain(*xs) if op == "vtriad"
                else skernel.plain(op, xs[:count], s))
        exact(out, want)
        if extra:
            pad = out.as_strided((rows, extra), (pitch, 1), width)
            assert bool(pad.isnan().all()), op


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_triad_kernel_matches_plain(n, dtype):
    b, c, d = sops.random_vectors(n, 3, dtype, seed=n + 1)
    out = api.launch("triad", b, c, d)
    torch.testing.assert_close(out, tkernel.plain(b, c, d), **tol(dtype))


@pytest.mark.parametrize("phases", [(0, 0, 0), (1, 2, 3), (16, 32, 48),
                                    (4, 8, 12), (3, 0, 5)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_phased_triad_reads_unaligned_bases(phases, dtype):
    n = 100_003
    b, c, d = sops.random_vectors(n, 3, dtype, seed=7)
    out = tops.vector_triad_phased(b, c, d, phases=phases)
    torch.testing.assert_close(out, tkernel.plain(b, c, d), **tol(dtype))


# the fp32 tile is 1024 columns, the bf16 one 2048: widths one under and
# one over each; a (3, 16384) boundary slab; a grid whose plan has 275
# strips of 4 rows by 16 tiles (8 in bf16)
@pytest.mark.parametrize("shape", [(34, 130), (66, 257), (3, 3), (2, 5),
                                   (1030, 1000), (40, 1023), (40, 1025),
                                   (40, 2047), (40, 2049), (3, 16384),
                                   (1100, 16384)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_jacobi_kernel_matches_plain(shape, dtype):
    grid = jops.init_grid(*shape, dtype, seed=3)
    plan = api.plan_for("jacobi", (shape[0] - 2, shape[1]), dtype)
    src = jops.pitched(grid, plan)
    before = jkernel.LAUNCHES["jacobi"]
    got = jkernel.sweep(src, torch.empty_like(src), n_cols=shape[1],
                        block=plan.block_shape)
    assert jkernel.LAUNCHES["jacobi"] == before + 1
    exact(got, jkernel.plain(src, torch.empty_like(src), shape[1]))
    exact(jops.jacobi_sweeps(grid, 10),
          jops.jacobi_sweeps(grid.cpu(), 10).to(grid.device))


@pytest.mark.parametrize("threads", [32, 256])
@pytest.mark.parametrize("strip", [32, 5, 4, 3])
@pytest.mark.parametrize("extra_rows", [1, 2, 3])
@pytest.mark.parametrize("extra_cols", [-1, 0, 1])
@pytest.mark.parametrize("dtype", DTYPES)
def test_jacobi_tiles_at_strip_and_tile_edges(dtype, extra_cols, extra_rows,
                                              strip, threads):
    """Tiles of ``threads`` 16-B vectors by strips of ``strip`` rows on a
    grid of strip + 1..3 rows and a tile's width -1, 0, +1 columns, inside
    a wider row pitch, the last columns padding: bit for bit with the plain
    version, the pitch's columns past the width never written."""
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    tile = threads * vec
    n, m = strip + extra_rows, tile + extra_cols
    pitch = round_up(m + 1, vec)
    src_buf = torch.full((n, pitch), 5.0, dtype=dtype, device="cuda")
    dst_buf = torch.full((n, pitch), 7.0, dtype=dtype, device="cuda")
    src, dst = src_buf[:, :m], dst_buf[:, :m]
    src.copy_(jops.init_grid(n, m, dtype, seed=n + m))
    n_cols = m - 3
    got = jkernel.sweep(src, dst, n_cols=n_cols, block=(strip, tile))
    exact(got, jkernel.plain(src, torch.empty_like(src), n_cols))
    assert torch.all(dst_buf[:, m:] == 7.0)


def test_jacobi_refuses_unaligned_rows():
    """The tiles read 16-B vectors: a base or a row pitch off 16 B raises
    before any launch, and ``api.launch`` lays such a grid out first."""
    buf = torch.zeros(6 * 130 + 1, device="cuda")
    off = buf[1:].view(6, 130)
    off.copy_(jops.init_grid(6, 130, seed=1))
    before = jkernel.LAUNCHES["jacobi"]
    block = api.plan_for("jacobi", (4, 130), torch.float32).block_shape
    with pytest.raises(ValueError, match="16-B aligned"):
        jkernel.sweep(off, torch.empty(6, 130, device="cuda"), n_cols=130,
                      block=block)
    pitch = torch.zeros(6, 131, device="cuda")[:, :130]
    with pytest.raises(ValueError, match="16-B aligned"):
        jkernel.sweep(pitch, torch.zeros(6, 131, device="cuda")[:, :130],
                      n_cols=130, block=block)
    assert jkernel.LAUNCHES["jacobi"] == before
    exact(api.launch("jacobi", off), api.launch("jacobi", off.clone()))


@pytest.mark.parametrize("m", [16384, 1000, 130, 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_jacobi_row_entry_equals_the_slab_path(m, dtype):
    """A mesh rank's boundary row by the row entry (one launch, the halo
    row where it was received, the stripe's rows in place) against the
    3-row slab swept by the tiles, bit for bit, padding columns included;
    the halo row at a storage offset too."""
    plan = api.plan_for("jacobi", (4, m), dtype, local=True)
    stripe = jops.pitched(jops.init_grid(6, m, dtype, seed=m), plan)
    stripe[:, m:] = 3.0
    for offset in (0, 1):
        halo = at_storage_offset(jops.init_grid(1, m, dtype, seed=m + 1)[0],
                                 offset)
        slab = jops._slab([halo[None], stripe[0:1], stripe[1:2]],
                          plan.width, m)
        slab[1, m:] = 3.0
        want = jkernel.sweep(slab, torch.empty_like(slab), n_cols=m,
                             block=plan.block_shape)[1]
        out = torch.empty_like(stripe)
        before = jkernel.LAUNCHES["jacobi"]
        jkernel.sweep_row(halo, stripe[0], stripe[1], out[0], n_cols=m)
        assert jkernel.LAUNCHES["jacobi"] == before + 1
        exact(out[0], want)
        exact(out[0], jkernel.plain_row(halo.cpu(), stripe[0].cpu(),
                                        stripe[1].cpu(),
                                        torch.empty_like(out[0].cpu()),
                                        m).to(out.device))


def reference_geometry(plan):
    """The plan with the JAX package's LBM geometry: interleave width 128
    at every dtype, and blocks that are not one site per thread."""
    sites = round_up(plan.logical_elems // 19, 16 * 128)
    if plan.kernel == "lbm.soa":
        return dataclasses.replace(plan, padded_shape=(19, sites),
                                   block_shape=(19, 16 * 128), minor_unit=128)
    return dataclasses.replace(plan, padded_shape=(sites // 128, 19, 128),
                               block_shape=(16, 19, 128), minor_unit=128)


def lattice(n, dtype, seed):
    f = lops.init_equilibrium(n, torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.rand(f.shape, generator=gen, device="cuda")
    return (f * (1 + 0.05 * (noise - 0.5))).to(dtype)


@pytest.mark.parametrize("geometry", ["port", "reference"])
@pytest.mark.parametrize("layout", ["soa", "ivjk"])
@pytest.mark.parametrize("n", [7, 12, 37, 50])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lbm_kernels_match_plain(dtype, n, layout, geometry):
    f = lattice(n, dtype, seed=n)
    plan = api.plan_for(f"lbm.{layout}", f.shape, dtype)
    if geometry == "reference":
        plan = reference_geometry(plan)
    flat, s = lops._flatten_pad(f, plan)
    before = lkernel.LAUNCHES[layout]
    if layout == "soa":
        x = flat
        got = lkernel.collide_soa(x, 1.2, bs=plan.block_cols)
    else:
        lanes = plan.padded_shape[2]
        x = flat.view(19, -1, lanes).transpose(0, 1).contiguous()
        got = lkernel.collide_ivjk(x, 1.2, bsb=plan.block_rows)
    assert lkernel.LAUNCHES[layout] == before + 1
    want = lkernel.plain(x, 1.2, layout)
    axis = lkernel.V_AXIS[layout]
    exact(got.movedim(axis, 0).reshape(19, -1)[:, :s],
          want.movedim(axis, 0).reshape(19, -1)[:, :s])
    # a whole step through the launch path, against the CPU's plain step
    step = api.launch(f"lbm.{layout}", f, omega=1.2, plan=plan)
    exact(step, api.launch(f"lbm.{layout}", f.cpu(), omega=1.2).to(f.device))


@pytest.mark.parametrize("n", [1 << 20, 100_003])
def test_segmented_triad_matches_flat_triad(n):
    b, c, d = sops.random_vectors(n, 3, torch.float32, seed=9)
    segs = [SegmentedArray.from_flat(v, 8, align=128, shift=16)
            for v in (torch.zeros_like(b), b, c, d)]
    before = tkernel.LAUNCHES["triad"]
    out = tops.vector_triad_segmented(*segs)
    assert tkernel.LAUNCHES["triad"] == before + 8
    exact(out.to_flat(), api.launch("triad", b, c, d))


def test_wrappers_refuse_what_the_kernel_does_not_take():
    x = torch.zeros(4, 128, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        skernel.copy2d(x)
    y = torch.zeros(4, 128, device="cuda")
    with pytest.raises(ValueError):
        skernel.add2d(y, torch.zeros(4, 256, device="cuda")[:, :128])
    with pytest.raises(ValueError):
        jkernel.sweep(y, y, n_cols=128, block=(1, 128))
    with pytest.raises(ValueError, match="overlaps"):
        tkernel.triad2d(y, y.clone(), y.clone(), out=y)
    lat = torch.zeros(19, 256, device="cuda")
    with pytest.raises(ValueError, match="overlap"):
        lkernel.collide_soa(lat, 1.0, out=lat)
    with pytest.raises(TypeError):
        lkernel.collide_soa(lat.half(), 1.0)


@pytest.mark.parametrize("width", [96, 2304, 2561, 40_000])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernels_match_plain(width, gated, dtype):
    gen = torch.Generator(device="cuda").manual_seed(width)
    x, z = (torch.randn(3, 5, width, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    scale = (torch.randn(width, generator=gen, device="cuda") + 1).to(dtype)
    name = "rmsnorm.gated" if gated else "rmsnorm"
    args = (x, z, scale) if gated else (x, scale)
    variant = "gated" if gated else "plain"
    before = rkernel.LAUNCHES[variant]
    got = api.launch(name, *args)
    assert rkernel.LAUNCHES[variant] == before + 1
    assert got.shape == x.shape and got.dtype == dtype
    torch.testing.assert_close(got, api.ref(name, *args), **tol(dtype))
    # the kernel on the padded block against its plain version there
    plan = api.plan_for(name, (15, width), dtype)
    pad = [torch.nn.functional.pad(t.reshape(15, width),
                                   (0, plan.width - width)) for t in (x, z)]
    sp = torch.nn.functional.pad(scale, (0, plan.width - width))
    if gated:
        got = rkernel.gated_rmsnorm2d(*pad, sp, d_logical=width)
        want = rkernel.plain(pad[0], sp, width, 1e-6, pad[1])
    else:
        got = rkernel.rmsnorm2d(pad[0], sp, d_logical=width)
        want = rkernel.plain(pad[0], sp, width, 1e-6)
    torch.testing.assert_close(got, want, **tol(dtype))


# (rows, width, d_logical): one row; few rows and many, row counts that are
# no multiple of a block (brows) or of a group of rows loaded at once (up
# to 4); d_logical below the width; a width past 1024 vectors (rows read
# twice)
RMS_CASES = [(1, 128, 128), (7, 896, 896), (133, 2560, 2560),
             (1001, 4096, 4096), (300, 2560, 2500), (5, 4096, 4000),
             (257, 128, 100), (9, 40_064, 40_000)]
RMS_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32)]


def _rms_inputs(rows, width, d_logical, dtype, sdtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, z = (torch.randn(rows, width, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    scale = (torch.randn(width, generator=gen, device="cuda") + 1).to(sdtype)
    return x, z, scale


@pytest.mark.parametrize("rows,width,d_logical", RMS_CASES)
@pytest.mark.parametrize("dtype,sdtype", RMS_DTYPES)
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("brows", [1, 2, 3, 8])
def test_rmsnorm_paths_match_plain(rows, width, d_logical, dtype, sdtype,
                                   gated, brows):
    x, z, scale = _rms_inputs(rows, width, d_logical, dtype, sdtype, rows)
    if gated:
        got = rkernel.gated_rmsnorm2d(x, z, scale, d_logical=d_logical,
                                      brows=brows)
    else:
        got = rkernel.rmsnorm2d(x, scale, d_logical=d_logical, brows=brows)
    want = rkernel.plain(x, scale, d_logical, 1e-6, z if gated else None)
    torch.testing.assert_close(got, want, **tol(dtype))


@pytest.mark.parametrize("width", [896, 2560, 4096, 40_064])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gated", [False, True])
def test_rmsnorm_row_bits_do_not_depend_on_the_launch(width, dtype, gated):
    """A row normed alone, inside 100 rows and inside 1000, in blocks of
    1, 2, 3 and 8 rows (groups of 1, 2 and 4 rows loaded at once): the same
    bits every time."""
    x, z, scale = _rms_inputs(1000, width, width, dtype, dtype, width)

    def norm(sl, brows):
        if gated:
            return rkernel.gated_rmsnorm2d(x[sl], z[sl], scale,
                                           d_logical=width, brows=brows)
        return rkernel.rmsnorm2d(x[sl], scale, d_logical=width, brows=brows)

    whole = norm(slice(None), 2)
    exact(norm(slice(None), 3), whole)
    exact(norm(slice(None), 8), whole)
    exact(norm(slice(0, 100), 1), whole[:100])
    for r in (0, 1, 517, 999):
        exact(norm(slice(r, r + 1), 1), whole[r:r + 1])


# the split norm's passes at the mesh ranks' shapes (rows, width of a
# rank's block, dtype, the scale's dtype, gated): a zamba2-1.2b rank's
# (2048, 2048) bf16 half of a (2048, 4096) Mamba2 row, an xlstm-1.3b mLSTM
# rank's the same, an sLSTM rank's (2048, 1024) fp32 with the scale in
# fp32; a block with padding past d_logical, and one past 1024 vectors
SPLIT_CASES = [(2048, 2048, 2048, torch.bfloat16, torch.bfloat16, True),
               (2048, 1024, 1024, torch.float32, torch.float32, False),
               (7, 896, 800, torch.bfloat16, torch.float32, True),
               (9, 40_064, 40_000, torch.float32, torch.float32, False)]


@pytest.mark.parametrize("rows,width,d_logical,dtype,sdtype,gated",
                         SPLIT_CASES)
@pytest.mark.parametrize("brows", [1, 3, 8])
def test_rmsnorm_split_passes_match_plain(rows, width, d_logical, dtype,
                                          sdtype, gated, brows):
    """The stats pass against ``plain_sumsq`` (fp32 rtol 1e-5; the gated
    bf16 statistic rtol 1e-4: the kernel's fast silu may round a gate to
    the neighbouring bf16 value where the plain version's exact sigmoid
    does not, which moves that element's square by 2^-7 of it, 1.2e-5 of
    a row's sum at the largest on an NVIDIA H100 80GB HBM3; 1e-4 is below
    one element's share of a row's sum, so a dropped or doubled element
    fails), the apply
    pass against ``plain(..., ss=, d_total=)`` at the dtype's tolerance,
    ``d_total`` twice the block's width (the whole row of two ranks); each
    pass counted once under its own key."""
    x, z, scale = _rms_inputs(rows, width, d_logical, dtype, sdtype, width)
    zz = z if gated else None
    variant = "gated" if gated else "plain"
    before = dict(rkernel.LAUNCHES)
    if gated:
        ss = rkernel.gated_sumsq2d(x, z, d_logical=d_logical, brows=brows)
    else:
        ss = rkernel.sumsq2d(x, d_logical=d_logical, brows=brows)
    rtol = 1e-4 if gated and dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(ss, rkernel.plain_sumsq(x, d_logical, zz),
                               rtol=rtol, atol=1e-6)
    total = ss * 2
    if gated:
        got = rkernel.gated_apply2d(x, z, scale, total, d_logical=d_logical,
                                    d_total=2 * d_logical, brows=brows)
    else:
        got = rkernel.apply2d(x, scale, total, d_logical=d_logical,
                              d_total=2 * d_logical, brows=brows)
    want = rkernel.plain(x, scale, d_logical, 1e-6, zz, ss=total,
                         d_total=2 * d_logical)
    torch.testing.assert_close(got, want, **tol(dtype))
    after = {k: v - before[k] for k, v in rkernel.LAUNCHES.items()}
    assert after == {k: int(k in (f"{variant}.sumsq", f"{variant}.apply"))
                     for k in after}


@pytest.mark.parametrize("gated", [False, True])
def test_rmsnorm_split_over_two_blocks_is_the_one_pass_norm(gated):
    """A (2048, 4096) bf16 row cut into two column blocks, their stats
    summed and each block applied with the whole width: the one-pass
    kernel's norm of the whole row, to the bf16 tolerance."""
    x, z, scale = _rms_inputs(2048, 4096, 4096, torch.bfloat16,
                              torch.bfloat16, 4096)
    halves = [slice(0, 2048), slice(2048, 4096)]
    xs = [x[:, h].contiguous() for h in halves]
    zs = [z[:, h].contiguous() for h in halves]
    if gated:
        ss = sum(rkernel.gated_sumsq2d(a, b, d_logical=2048)
                 for a, b in zip(xs, zs))
        got = torch.cat([rkernel.gated_apply2d(
            a, b, scale[h], ss, d_logical=2048, d_total=4096)
            for a, b, h in zip(xs, zs, halves)], dim=1)
        want = rkernel.gated_rmsnorm2d(x, z, scale, d_logical=4096)
    else:
        ss = sum(rkernel.sumsq2d(a, d_logical=2048) for a in xs)
        got = torch.cat([rkernel.apply2d(a, scale[h], ss, d_logical=2048,
                                         d_total=4096)
                         for a, h in zip(xs, halves)], dim=1)
        want = rkernel.rmsnorm2d(x, scale, d_logical=4096)
    torch.testing.assert_close(got, want, **tol(torch.bfloat16))


def test_rmsnorm_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(4, 256, device="cuda")
    s = torch.ones(256, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        rkernel.rmsnorm2d(torch.zeros(256, 4, device="cuda").T, s,
                          d_logical=256)
    with pytest.raises(ValueError, match="scale"):
        rkernel.rmsnorm2d(x, s.cpu(), d_logical=256)
    with pytest.raises(ValueError, match="gate"):
        rkernel.gated_rmsnorm2d(x, x.cpu(), s, d_logical=256)
    with pytest.raises(ValueError, match="gate"):
        rkernel.gated_rmsnorm2d(x, torch.zeros(256, 8, device="cuda").T, s,
                                d_logical=256)
    with pytest.raises(TypeError):
        rkernel.rmsnorm2d(x.half(), s.half(), d_logical=256)
    with pytest.raises(ValueError, match="16-B"):
        rkernel.rmsnorm2d(torch.zeros(4, 6, device="cuda"),
                          torch.ones(6, device="cuda"), d_logical=6)


def _scale_grad_bound(x, z, g, eps=1e-6):
    """Per-element bound on |card - cpu| of ``GatedRMSNormFn``'s scale
    gradient ds_j = sum_r g_rj n_rj over the rows r, n = v rsqrt(mean(v^2)
    + eps), v = x silu(z) (``blocks._gated_ref``): 2 c u sum_r |g_rj n_rj|,
    the magnitudes in float64 from the inputs, u = 2^-24 fp32's unit
    roundoff.

    Each side rounds each term g n in fp32 with a relative error of at most
    (ceil(log2 d) / 2 + 4) u: the row's mean of d squares summed pairwise
    (ceil(log2 d) u, halved by the rsqrt), and four roundings (the
    sigmoid, the gate's product, the scaling, the product with g).  It
    then sums the rows in an order of its own (the card's reduction and
    the CPU's differ); a pairwise sum of n terms errs by at most
    ceil(log2 n) u times the sum of their magnitudes.  So each side lies
    within c u sum|g n| of the exact value, c = ceil(log2 d) / 2 + 4 +
    ceil(log2 n), and the two within twice that.  The old atol of 1e-5
    held the difference to about 0.07 u sum|g n| at (2048, 4096), below a
    single rounding of the partial sums, and failed on an element whose
    sum cancels to near zero; at elements of a typical size (|ds| about
    45) the old rtol of 1e-4 allowed more than this bound."""
    xf, zf, gf = (t.detach().cpu().double() for t in (x, z, g))
    v = xf * zf * torch.sigmoid(zf)
    n = v * torch.rsqrt((v * v).mean(-1, keepdim=True) + eps)
    rows, d = v.shape
    c = math.ceil(math.log2(d)) / 2 + 4 + math.ceil(math.log2(rows))
    return 2 * c * 2.0 ** -24 * (gf * n).abs().sum(0)


def _gated_grads(x, z, scale, g, device):
    """``GatedRMSNormFn``'s gradients (x, z, scale) on ``device``, fp32."""
    ins = [t.detach().to(device).float().requires_grad_(True)
           for t in (x, z, scale)]
    blocks.GatedRMSNormFn.apply(*ins, 1e-6).backward(g.to(device))
    return [t.grad.cpu() for t in ins]


def _check_gated_grads(x, z, scale, g):
    """The card's gradients against the CPU's: x and z at rtol 1e-4 /
    atol 1e-5, the scale within ``_scale_grad_bound``; returns the scale
    gradient's largest |difference| over its bound."""
    card, cpu = (_gated_grads(x, z, scale, g, dev) for dev in ("cuda", "cpu"))
    for a, b in zip(card[:2], cpu[:2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    err = (card[2] - cpu[2]).abs().double()
    bound = _scale_grad_bound(x, z, g)
    assert bool((err <= bound).all()), float((err / bound).max())
    return float((err / bound).max())


@pytest.mark.parametrize("rows", [8, 2048])
def test_gated_kernel_at_the_zamba2_shapes(rows):
    """B10 at zamba2-1.2b's Mamba2 norm shapes, bf16: (8, 4096), a decode
    step of 8 slots, and (2048, 4096), a prefill of B = 4, S = 512; the
    d_inner of 4096 is a whole number of vectors, so d_logical is the
    width.  Through ``api.launch`` (one launch) and the kernel itself
    against its plain version, and under ``GatedRMSNormFn``, whose
    gradients match the same Function on the CPU: x and z at rtol 1e-4 /
    atol 1e-5, the scale's (a sum over the rows) within the bound that
    ``_scale_grad_bound`` derives.  Every input, the upstream gradient
    included, comes from a seeded generator."""
    x, z, scale = _rms_inputs(rows, 4096, 4096, torch.bfloat16,
                              torch.bfloat16, rows)
    before = rkernel.LAUNCHES["gated"]
    got = api.launch("rmsnorm.gated", x, z, scale)
    assert rkernel.LAUNCHES["gated"] == before + 1
    want = rkernel.plain(x, scale, 4096, 1e-6, z)
    torch.testing.assert_close(got, want, **tol(torch.bfloat16))
    torch.testing.assert_close(
        rkernel.gated_rmsnorm2d(x, z, scale, d_logical=4096), want,
        **tol(torch.bfloat16))
    gen = torch.Generator(device="cuda").manual_seed(1000 + rows)
    g = torch.randn(rows, 4096, generator=gen, device="cuda")
    _check_gated_grads(x, z, scale, g)


def test_gated_scale_gradient_is_deterministic_and_bounded_over_seeds():
    """``GatedRMSNormFn``'s backward at (2048, 4096) over 20 seeds: on the
    card and on the CPU the same inputs give the same bits twice, and the
    card's gradients lie within ``_check_gated_grads``'s bounds of the
    CPU's on every seed."""
    for seed in range(20):
        x, z, scale = _rms_inputs(2048, 4096, 4096, torch.bfloat16,
                                  torch.bfloat16, 5000 + seed)
        gen = torch.Generator(device="cuda").manual_seed(6000 + seed)
        g = torch.randn(2048, 4096, generator=gen, device="cuda")
        for dev in ("cuda", "cpu"):
            first, again = (_gated_grads(x, z, scale, g, dev)
                            for _ in range(2))
            for a, b in zip(first, again):
                exact(a, b)
        _check_gated_grads(x, z, scale, g)


@pytest.mark.parametrize("rows", [8, 2048])
def test_rmsnorm_on_fp32_rows_with_the_bf16_scale_in_fp32(rows):
    """B9 as the xLSTM's sLSTM output norm launches it: fp32 rows of 2048
    (the cell output at xlstm-1.3b's d_model; 8 rows a decode step, 2048 a
    B = 4, S = 512 prefill) with the bf16 ``gnorm`` cast to fp32, through
    ``api.launch`` and the kernel, against its plain version (fp32 rtol
    1e-5 / atol 1e-6)."""
    x, _, scale = _rms_inputs(rows, 2048, 2048, torch.float32,
                              torch.bfloat16, rows)
    s32 = scale.to(torch.float32)
    before = rkernel.LAUNCHES["plain"]
    got = api.launch("rmsnorm", x, s32)
    assert rkernel.LAUNCHES["plain"] == before + 1
    assert got.dtype == torch.float32
    want = rkernel.plain(x, s32, 2048, 1e-6)
    torch.testing.assert_close(got, want, **tol(torch.float32))
    torch.testing.assert_close(rkernel.rmsnorm2d(x, s32, d_logical=2048),
                               want, **tol(torch.float32))


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2-0.5b", "zamba2-1.2b",
                                  "xlstm-1.3b", "qwen3-moe-30b-a3b",
                                  "pixtral-12b"])
def test_reduced_serving_paged_equals_dense(arch):
    # the reduced configs run in fp32: full-precision matmuls (the default)
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(reduce_for_smoke(get_config(arch)))
    params = model.init(0)
    rng = torch.Generator().manual_seed(0)
    reqs = [(torch.randint(1, model.cfg.vocab_size, (3 + 5 * i,),
                           generator=rng).tolist(), 4 + 3 * i)
            for i in range(5)]
    before = rkernel.LAUNCHES["plain"]
    out = {}
    for kv in ("dense", "paged"):
        b = ContinuousBatcher(model, params, slots=2, max_len=48,
                              kv_cache=kv, prefill_chunk=4)
        out[kv] = b.run([Request(i, p, n) for i, (p, n) in enumerate(reqs)])
        assert sorted(out[kv]) == list(range(5))
    assert out["paged"] == out["dense"]
    assert rkernel.LAUNCHES["plain"] > before
    if model.cfg.family in ("hybrid", "ssm"):
        assert rkernel.LAUNCHES["gated"] > 0


def _moe_inputs(cfg, t, seed):
    """One MoE layer's seeded weights (perm: the skew table's row 3) and
    (1, t, d) rows, on the CPU in the config's dtype."""
    from repro_torch.models import moe

    gen = torch.Generator().manual_seed(seed)
    p = {k: (torch.randn(d.shape, generator=gen) / math.sqrt(d.shape[-2]))
         .to(d.dtype) for k, d in moe.moe_defs(cfg).items() if k != "perm"}
    p["perm"] = torch.as_tensor(moe.make_perms(cfg, 4, 16)[3])
    x = torch.randn((1, t, cfg.d_model), generator=gen).to(cfg.adtype)
    return p, x


def test_moe_layer_on_the_card_matches_the_cpu():
    """``models.moe.apply_moe`` at reduced size (8 experts top-2, d 128,
    capacity factor 1.0, so assignments drop), fp32: the card's kept mask
    equals the CPU's, its output and aux agree to rtol 1e-5 / atol 1e-6
    (the products and sums in other orders)."""
    from repro_torch.models import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduce_for_smoke(get_config(
        "qwen3-moe-30b-a3b")), top_k=2, capacity_factor=1.0)
    p, x = _moe_inputs(cfg, 64, 0)
    card = {k: v.cuda() for k, v in p.items()}
    keep = moe.route(p, x[0], cfg)[5]
    assert not bool(keep.all())
    assert torch.equal(moe.route(card, x[0].cuda(), cfg)[5].cpu(), keep)
    want, want_aux = moe.apply_moe(p, x, cfg)
    got, aux = moe.apply_moe(card, x.cuda(), cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=0)


def test_moe_layer_at_full_width_is_deterministic_on_the_card():
    """One qwen3-moe-30b-a3b layer at full width (d 2048, 128 experts of
    d_ff 768, top-8, capacity factor 1.25), bf16, on 8 rows (a decode step
    of 8 slots) and 64: two runs give the same bits (the dispatch and the
    combine use no float atomics), and the output agrees with the CPU's at
    the bf16 tolerance."""
    from repro_torch.models import moe

    cfg = get_config("qwen3-moe-30b-a3b")
    p, xs = _moe_inputs(cfg, 64, 1)
    card = {k: v.cuda() for k, v in p.items()}
    for x in (xs[:, :8], xs):
        with torch.inference_mode():
            first, _ = moe.apply_moe(card, x.cuda(), cfg, with_aux=False)
            again, _ = moe.apply_moe(card, x.cuda(), cfg, with_aux=False)
            want, _ = moe.apply_moe(p, x, cfg, with_aux=False)
        exact(first, again)
        torch.testing.assert_close(first.cpu().float(), want.float(),
                                   **tol(torch.bfloat16))


XENT = dict(rtol=1e-5, atol=1e-5)


# (tokens, width, logical vocab): the main path's width, whole vectors and
# widths at every residue (1001-1007: fp32 v % 4 of 1-3 and 0, bf16 v % 8 of
# 1-7), under one vector (1, 3), one row, and a logical vocab inside a
# row's ragged tail (1004 of 1005) or head (2 of 1005: rows 1-3 start off a
# 16-B boundary, their first elements are the head)
XENT_CASES = [(37, 501, 501), (64, 512, 480), (4, 151936, 151936),
              (5, 1000, 999), (9, 1001, 1001), (9, 1002, 1002),
              (9, 1003, 1003), (9, 1004, 1004), (9, 1005, 1005),
              (9, 1006, 1006), (9, 1007, 1007), (6, 1, 1), (6, 3, 3),
              (1, 1003, 1003), (8, 1005, 1004), (8, 1005, 2)]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("t,v,lv", XENT_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_xent_kernel_matches_plain(t, v, lv, dtype, offset):
    """B11 reads rows of any width in place, at any storage offset: labels
    at a row's first columns (its head where the row starts off a 16-B
    boundary) and last (its tail), in the padding past ``lv`` (-1e30) and
    past the row (no label logit)."""
    gen = torch.Generator(device="cuda").manual_seed(t + v + lv)
    x = at_storage_offset((3 * torch.randn(t, v, generator=gen,
                                           device="cuda")).to(dtype), offset)
    labels = torch.randint(0, lv, (t,), generator=gen, device="cuda",
                           dtype=torch.int32)
    labels[0], labels[-1] = 0, lv - 1
    if t > 3:
        labels[1] = min(1, lv - 1)  # in the head of a row that has one
        labels[2] = v + 7           # past the row: no label logit
        labels[3] = v - 1           # the last column: in the padding if lv < v
    before = xkernel.LAUNCHES["xent"]
    got = xkernel.xent_nll(x, labels, logical_v=lv)
    assert xkernel.LAUNCHES["xent"] == before + 1
    torch.testing.assert_close(got, xkernel.plain(x, labels, lv), **XENT)
    # through the launch path, the logical columns of a ragged width
    ragged = at_storage_offset(x[:, :lv].contiguous(), offset)
    lab = labels.clamp(0, lv - 1)
    torch.testing.assert_close(
        api.launch("xent", ragged, lab),
        xkernel.plain(ragged.cpu(), lab.cpu(), lv).mean().cuda(), **XENT)


def _logits_pointer_spy(monkeypatch):
    """The logits pointers handed to ``xent_launch``, as a list."""
    lib, fn = xkernel._entry()
    seen = []

    def spy(*args):
        seen.append(args[2])            # the logits pointer
        return fn(*args)

    monkeypatch.setattr(xkernel, "_entry", lambda: (lib, spy))
    return seen


@pytest.mark.parametrize("dtype", DTYPES)
def test_xent_reads_whisper_vocab_in_place(dtype, monkeypatch):
    """whisper-tiny's vocab, 51,865, is no whole number of 16-B vectors a
    row at either dtype: the plan keeps the width, ``api.launch("xent")``
    hands the caller's logits to B11 uncopied (the pointer the kernel
    gets is their ``data_ptr``) and launches it once, and the mean NLL
    agrees with the plain version."""
    t, v = 64, 51865
    plan = api.plan_for("xent", (t, v), dtype)
    assert plan.padded_shape == (t, v)
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = (3 * torch.randn(t, v, generator=gen, device="cuda")).to(dtype)
    labels = torch.randint(0, v, (t,), generator=gen, device="cuda",
                           dtype=torch.int32)
    labels[0], labels[-1] = 0, v - 1
    want = xkernel.plain(x, labels, v)
    seen = _logits_pointer_spy(monkeypatch)
    before = xkernel.LAUNCHES["xent"]
    loss = api.launch("xent", x, labels)
    assert xkernel.LAUNCHES["xent"] == before + 1
    assert seen == [x.data_ptr()]
    torch.testing.assert_close(loss, want.mean(), **XENT)


def test_xent_launch_hands_the_callers_logits_to_the_kernel(monkeypatch):
    """(T, 151936) fp32 logits are whole float4 rows: the plan does not pad
    them, and the kernel reads the caller's storage (no copy)."""
    t, v = 64, 151936
    gen = torch.Generator(device="cuda").manual_seed(17)
    x = torch.randn(t, v, generator=gen, device="cuda")
    labels = torch.randint(0, v, (t,), generator=gen, device="cuda",
                           dtype=torch.int32)
    seen = _logits_pointer_spy(monkeypatch)
    loss = api.launch("xent", x, labels)
    assert seen == [x.data_ptr()]
    torch.testing.assert_close(loss, xkernel.plain(x, labels, v).mean(),
                               **XENT)


def test_kernel_wrappers_refuse_inputs_that_require_grad():
    gen = torch.Generator(device="cuda").manual_seed(18)
    x = torch.randn(8, 256, generator=gen, device="cuda", requires_grad=True)
    s = torch.ones(256, device="cuda")
    labels = torch.zeros(8, dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="RMSNormFn"):
        rkernel.rmsnorm2d(x, s, d_logical=256)
    with pytest.raises(RuntimeError, match="RMSNormFn"):
        api.launch("rmsnorm", x, s)
    with pytest.raises(RuntimeError, match="XentFn"):
        xkernel.xent_nll(x, labels, logical_v=256)
    with torch.no_grad():
        rkernel.rmsnorm2d(x, s, d_logical=256)
        xkernel.xent_nll(x, labels, logical_v=256)
    # through the autograd Functions both give gradients
    y = blocks.RMSNormFn.apply(x, s.requires_grad_(True), 1e-6)
    loss = transformer.XentFn.apply(y, labels, 256)
    loss.backward()
    assert x.grad is not None and s.grad is not None
    assert bool(x.grad.abs().sum() > 0) and bool(s.grad.abs().sum() > 0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_xent_grad_on_the_card_matches_the_cpu(dtype):
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = (3 * torch.randn(96, 1000, generator=gen, device="cuda")).to(dtype)
    labels = torch.randint(0, 990, (96,), generator=gen, device="cuda")
    got = xops.xent_grad(x, labels, torch.tensor(1.3, device="cuda"),
                         logical_v=990)
    want = xops.xent_grad(x.cpu(), labels.cpu(), torch.tensor(1.3),
                          logical_v=990)
    tol_ = (dict(rtol=1e-5, atol=1e-9) if dtype == torch.float32
            else dict(rtol=8e-3, atol=1e-9))
    torch.testing.assert_close(got.cpu(), want, **tol_)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-4b", "zamba2-1.2b",
                                  "xlstm-1.3b", "qwen3-moe-30b-a3b",
                                  "pixtral-12b", "whisper-tiny"])
def test_reduced_train_step_on_the_card_matches_the_cpu(arch):
    """Loss and every gradient leaf of a reduced fp32 model: the card
    (B9/B11 kernels, and the hybrid's and the xlstm's B10, under their
    autograd Functions, remat on) against the CPU (their plain versions).
    Every leaf must get a nonzero gradient: a kernel output without
    autograd history would drop the norms'.  The hybrid and the xlstm run
    300 tokens a row, across a chunk boundary of the SSD and past the
    length where the reference's mLSTM gradient is NaN.  The vlm's batch
    carries its 8 image embeddings, the encdec's its 16 frames (its norms
    are LayerNorm, plain torch: B11 is its one kernel)."""
    import dataclasses

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)), remat=True)
    model = build_model(cfg)
    cpu = model.init(0, device="cpu")
    card = map_leaves(lambda t: t.cuda(), cpu)
    from repro_torch.data.pipeline import DataConfig, make_batch

    recurrent = cfg.family in ("hybrid", "ssm")
    data = DataConfig(vocab_size=cfg.vocab_size,
                      seq_len=300 if recurrent else 16, global_batch=4,
                      n_img_tokens=cfg.n_img_tokens,
                      n_frames=cfg.n_frames if cfg.family == "encdec" else 0,
                      d_model=cfg.d_model)
    before = (rkernel.LAUNCHES["plain"], xkernel.LAUNCHES["xent"],
              rkernel.LAUNCHES["gated"])
    loss, grads = steps.value_and_grad(model, card, make_batch(data, 0))
    # ln1 and ln2 a layer and the final norm; an xlstm's ln1 a layer, its
    # sLSTM output norms and the final norm, and B10 in each mLSTM layer
    stages = dict(cfg.stages())
    plain, gated = 2 * cfg.n_layers + 1, cfg.n_layers
    if cfg.family == "ssm":
        plain, gated = cfg.n_layers + stages["slstm"] + 1, stages["mlstm"]
    if cfg.family == "encdec":
        plain = 0
    assert rkernel.LAUNCHES["plain"] - before[0] >= plain
    assert xkernel.LAUNCHES["xent"] == before[1] + 1
    if recurrent:
        assert rkernel.LAUNCHES["gated"] - before[2] >= gated
    want, want_g = steps.value_and_grad(model, cpu,
                                        make_batch(data, 0, device="cpu"))
    torch.testing.assert_close(loss.cpu(), want, rtol=1e-5, atol=0)
    for (path, g), (_, w) in zip(leaves(grads), leaves(want_g)):
        if g is None:           # an MoE layer's perm table: no gradient
            assert w is None and path[-1] == "perm", path
            continue
        assert bool(g.abs().max() > 0), path
        scale = float(w.abs().max())
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-2 * scale,
                                   msg=lambda m, p=path: f"{p}: {m}")


def test_whisper_static_decode_matches_its_forward_on_the_card():
    """The reduced fp32 whisper-tiny on the card: ``launch.serve``'s
    static path's decode steps (``prefill_cross``, then one token a step)
    against the forward of the same tokens within the reference's
    decode-consistency 2e-3, at 16 frames and at 300 (non-causal chunked
    attention in the encoder and the cross attention); the greedy tokens
    of ``serve_static`` twice equal."""
    from repro_torch.launch.serve import serve_static, static_inputs
    from repro_torch.models.params import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    for n_frames in (16, 300):
        cfg = dataclasses.replace(
            reduce_for_smoke(get_config("whisper-tiny")), n_frames=n_frames)
        model = build_model(cfg)
        params = model.init(0)
        frames, prompts = static_inputs(cfg, 2, 12, 0)
        frames = torch.from_numpy(frames).cuda()
        tokens = torch.from_numpy(prompts).cuda()
        with torch.inference_mode():
            fwd, _ = model(params, tokens, frames)
            cache = init_params(0, model.cache_defs(2, 12), device="cuda")
            cache["cross_k"], cache["cross_v"] = model.prefill_cross(params,
                                                                     frames)
            outs = []
            for i in range(12):
                lg, cache = model.decode_step(params, cache,
                                              tokens[:, i:i + 1])
                outs.append(lg)
        assert float((torch.cat(outs, 1) - fwd).abs().max()) < 2e-3
        first = serve_static(model, params, frames, tokens[:, :4], 8)
        assert first.shape == (2, 8)
        assert torch.equal(first, serve_static(model, params, frames,
                                               tokens[:, :4], 8))


# (tokens, width, vl, offset, logical vocab): shards of whole vectors, the
# main path's, widths at every residue (1001-1007), under one vector (1, 3),
# one row, and a limit inside a row's ragged tail (vl 1001 of 1002; the
# vocab ending at local column 1005 of 1006) or head (vl 2 of 1005)
PARTIAL_CASES = [
    (37, 256, 256, 0, 1024), (37, 256, 256, 768, 1000),
    (9, 128, 100, 200, 1000), (16, 128, 128, 1024, 1000),
    (64, 75968, 75968, 75968, 151936),
    (7, 1001, 1001, 1001, 2002), (7, 1002, 1001, 0, 3000),
    (7, 1003, 1003, 2006, 3000), (7, 1004, 1004, 0, 1004),
    (7, 1005, 1004, 1005, 2009), (7, 1006, 1006, 2012, 3017),
    (7, 1007, 1007, 0, 1007), (1, 3, 3, 3, 6), (5, 1, 1, 4, 8),
    (8, 1005, 2, 0, 1000)]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("t,width,vl,off,lv", PARTIAL_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_xent_partial_kernel_matches_plain(t, width, vl, off, lv, dtype,
                                           offset):
    """B12 reads shards of any width in place, at any storage offset:
    labels at the shard's first valid column (a row's head) and its last
    (its tail), in its padding or the next shard, and in other shards."""
    gen = torch.Generator(device="cuda").manual_seed(t + width + off)
    x = at_storage_offset((3 * torch.randn(t, width, generator=gen,
                                           device="cuda")).to(dtype), offset)
    labels = torch.randint(0, lv, (t,), generator=gen, device="cuda",
                           dtype=torch.int32)
    limit = min(vl, lv - off)
    labels[0] = min(off + vl, lv - 1)       # padding of this shard, or next
    if t > 2:
        labels[1] = off + max(limit, 1) - 1  # the last valid column
        labels[2] = off                      # the first
    before = xkernel.LAUNCHES["xent.partial"]
    m, l, ll = xkernel.xent_partials(x, labels, vl=vl, off=off, logical_v=lv)
    assert xkernel.LAUNCHES["xent.partial"] == before + 1
    wm, wl, wll = xkernel.plain_partials(x, labels, vl=vl, off=off,
                                         logical_v=lv)
    exact(m, wm)
    exact(ll, wll)
    torch.testing.assert_close(l, wl, atol=0, rtol=1e-5 if dtype ==
                               torch.float32 else 2e-2)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("t,v", [(64, 51865), (9, 1005)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_xent_kernels_hold_wide_logits(t, v, dtype, offset):
    """B11 and B12 take each exp by ``__expf``, whose error grows with the
    distance from the row's max: logits of 30 x N(0, 1), as spread as a
    trained model's, with one row whose label column dominates by 100 and
    one whose other column does, held at the same tolerances as the 3 x
    N(0, 1) cases (the NLL rtol 1e-5 / atol 1e-5; ``m`` and ``ll`` exact,
    ``l`` rtol 1e-5 fp32 and 2e-2 bf16)."""
    gen = torch.Generator(device="cuda").manual_seed(t + v + offset)
    x = 30 * torch.randn(t, v, generator=gen, device="cuda")
    labels = torch.randint(0, v, (t,), generator=gen, device="cuda",
                           dtype=torch.int32)
    labels[0], labels[1] = 0, v - 1     # a head and a tail column
    x[0, 0] = x[0].max() + 100          # the label's column dominates
    x[1, v // 2] = x[1].max() + 100     # another column dominates
    x = at_storage_offset(x.to(dtype), offset)
    torch.testing.assert_close(xkernel.xent_nll(x, labels, logical_v=v),
                               xkernel.plain(x, labels, v), **XENT)
    vl = v // 2 + 1
    m, l, ll = xkernel.xent_partials(x, labels, vl=vl, off=0, logical_v=v)
    wm, wl, wll = xkernel.plain_partials(x, labels, vl=vl, off=0,
                                         logical_v=v)
    exact(m, wm)
    exact(ll, wll)
    torch.testing.assert_close(l, wl, atol=0, rtol=1e-5 if dtype ==
                               torch.float32 else 2e-2)


def test_xent_partial_wrapper_refuses_what_the_kernel_does_not_take():
    labels = torch.zeros(8, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(19)
    x = torch.randn(8, 256, generator=gen, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="XentFn"):
        xkernel.xent_partials(x, labels, vl=256, off=0, logical_v=512)
    with pytest.raises(TypeError):
        xkernel.xent_partials(torch.randn(8, 256, generator=gen,
                                          device="cuda", dtype=torch.float64),
                              labels, vl=256, off=0, logical_v=512)


def test_spmd_xent_on_two_ranks_of_the_card():
    """``api.launch("xent")`` and ``xent_grad`` on a (1, 2) mesh of two
    ranks on the one card: B12 once a rank, B11 never, the loss and the
    gradient blocks against the plain single-device values on the CPU."""
    import numpy as np

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import mesh_checks

    rng = np.random.default_rng(5)
    x = (3 * rng.standard_normal((64, 1024))).astype(np.float32)
    labels = rng.integers(0, 1000, 64).astype(np.int32)
    out = mesh_lib.spawn(mesh_checks.run, (1, 2), device="cuda", args=(
        [("xent", dict(logits=x, labels=labels, logical_v=1000))],))
    want = xops._ref(torch.from_numpy(x), torch.from_numpy(labels),
                     logical_v=1000)
    want_g = xops.xent_grad(torch.from_numpy(x), torch.from_numpy(labels),
                            1.0, logical_v=1000)
    for r, (res,) in enumerate(out):
        assert res["launches"]["xent.partial"] == 1, res["launches"]
        assert res["launches"]["xent"] == 0, res["launches"]
        torch.testing.assert_close(torch.tensor(res["loss"]), want, **XENT)
        torch.testing.assert_close(res["grad"], want_g[:, r * 512:
                                                       (r + 1) * 512],
                                   rtol=1e-5, atol=1e-9)


def test_reduced_mesh_train_step_on_two_ranks_of_the_card():
    """Reduced fp32 qwen2-0.5b on a (1, 2) mesh of two ranks on the card:
    the first loss against the one-device CPU step, and the replicated
    leaves hold the same bits on both ranks after two steps."""
    from repro_torch import interop
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import mesh_checks
    from repro_torch.optim import adamw

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduce_for_smoke(get_config("qwen2-0.5b"))
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    state = map_leaves(interop.to_numpy, {
        "params": params,
        "opt": adamw.init_state(params, adamw.AdamWConfig())})
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    out = mesh_lib.spawn(mesh_checks.run, (1, 2), device="cuda", args=(
        [("train", dict(cfg=cfg, state=state, data_cfg=data, steps_run=2,
                        schedule=("cosine", 1e-3, 0, 10)))],))
    want, _ = steps.value_and_grad(model, params,
                                   make_batch(data, 0, device="cpu"))
    (a,), (b,) = out
    torch.testing.assert_close(torch.tensor(a["loss0"]), want, rtol=1e-5,
                               atol=0)
    assert a["loss0"] == b["loss0"] and a["losses"] == b["losses"]
    assert a["digests"] == b["digests"] and len(a["digests"]) > 40


HALO_LBM = [(19, 32, 8, 8), (19, 8, 4, 4), (19, 4, 4, 4)]


@pytest.mark.parametrize("shape", HALO_LBM)
def test_soa_and_ivjk_kernels_give_a_site_the_same_bits(shape):
    """B7 and B8 on the same propagated lattice: the same bits at every
    site, so the halo bodies may collide an ivjk lattice's boundary planes
    with B7 (``kernels.lbm.ops._shard_steps``)."""
    gen = torch.Generator(device="cuda").manual_seed(shape[1])
    w = torch.tensor(lkernel.W, dtype=torch.float32, device="cuda")
    f = w[:, None, None, None] * (1 + 0.05 * (torch.rand(
        shape, generator=gen, device="cuda") - 0.5))
    posts = {}
    for layout in ("soa", "ivjk"):
        plan = api.plan_for(f"lbm.{layout}", shape, torch.float32)
        col = lops._Collision(layout, plan, shape, f)
        lops._logical(col.prop, shape).copy_(f)
        before = lkernel.LAUNCHES[layout]
        posts[layout] = lops._logical(col.run(1.7), shape).clone()
        assert lkernel.LAUNCHES[layout] == before + 1
    exact(posts["soa"], posts["ivjk"])


def test_halo_bodies_on_two_ranks_of_the_card():
    """The Jacobi and LBM halo bodies on a (2, 1) mesh of two ranks on the
    one card: each equal to one device on the card bit for bit, the
    overlapped Jacobi body equal to the blocking one, B6, B7 and B8
    launched on the ranks."""
    import numpy as np

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import mesh_checks

    rng = np.random.default_rng(22)
    grids = [rng.random(s).astype(np.float32) for s in [(64, 34), (8, 34)]]
    lattices = [(lkernel.W.astype(np.float32)[:, None, None, None]
                 * (1 + 0.05 * (rng.random(s) - 0.5))).astype(np.float32)
                for s in HALO_LBM]
    mask = rng.random(HALO_LBM[0][1:]) < 0.7
    jobs = [("jacobi", dict(grid=g, sweeps=3)) for g in grids]
    cases = [(f, layout, None) for f in lattices for layout in ("soa", "ivjk")]
    cases += [(lattices[0], layout, mask) for layout in ("soa", "ivjk")]
    jobs += [("lbm", dict(f=f, omega=1.7, layout=layout, mask=m, steps=3))
             for f, layout, m in cases]
    out = mesh_lib.spawn(mesh_checks.run, (2, 1), device="cuda",
                         args=(jobs,))
    for i, g in enumerate(grids):
        src = torch.from_numpy(g).cuda()
        want = api.launch("jacobi", src).cpu()
        exact(torch.cat([r[i]["out"] for r in out]), want)
        exact(torch.cat([r[i]["blocking"] for r in out]), want)
        exact(torch.cat([r[i]["sweeps"] for r in out]),
              jops.jacobi_sweeps(src, 3).cpu())
        assert all(r[i]["report"].n_kernel_launches > 0 for r in out)
    for k, (f, layout, m) in enumerate(cases):
        res = [r[len(grids) + k] for r in out]
        src = torch.from_numpy(f).cuda()
        mk = None if m is None else torch.from_numpy(m).cuda()
        want = api.launch(f"lbm.{layout}", src, omega=1.7, mask=mk).cpu()
        exact(torch.cat([r["out"] for r in res], dim=1), want)
        if m is None:
            exact(torch.cat([r["run"] for r in res], dim=1),
                  lops.lbm_run(src, 1.7, 3, layout=layout).cpu())
    launched = [sum(r[i]["launches"] for i in range(len(jobs))) for r in out]
    assert all(n > 0 for n in launched), launched
    for r in out:
        assert r[0]["launches"] > 0                  # B6
        assert r[len(grids)]["launches"] > 0         # B7 (soa)
        assert r[len(grids) + 1]["launches"] > 0     # B8 and B7 (ivjk)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_reduce_scatter_on_nccl_equals_the_gloo_form(shape):
    """NCCL's ``reduce_scatter_tensor`` takes its input's blocks in the
    group's rank order; ``Mesh.reduce_scatter`` puts them there from the
    order of the index along the axes.  Each rank's block, over every set
    of axes and along every dim that splits, equals the gloo form's on the
    CPU, and both count the same bytes."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import mesh_checks

    n = math.prod(shape)
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards, one a rank")
    xs = np.random.default_rng(7).standard_normal((n, 4, 6, 2)).astype(
        np.float32)
    jobs = ([("reduce_scatter", dict(xs=xs))],)
    got = mesh_lib.spawn(mesh_checks.run, shape, device="cuda",
                         backend="nccl", args=jobs)
    want = mesh_lib.spawn(mesh_checks.run, shape, device="cpu",
                          backend="gloo", args=jobs)
    for (g,), (w,) in zip(got, want):
        assert g["transport"] == "reduce_scatter_tensor"
        assert w["transport"] == "all_reduce, then this rank's block"
        assert g["cases"].keys() == w["cases"].keys()
        assert len(g["cases"]) == (3 if shape == (2, 1) else 7)
        for key, (block, nbytes) in g["cases"].items():
            torch.testing.assert_close(block, w["cases"][key][0],
                                       rtol=1e-6, atol=1e-6)
            assert nbytes == w["cases"][key][1]
