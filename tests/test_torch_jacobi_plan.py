"""The Jacobi sweep's 2-D tiles (``core.planner.stencil_block``) and its
boundary-row entry, on the CPU.

The plan gives Jacobi a strip of rows by a column tile of one 16-B vector a
thread; the tests hold its geometry at the main path's grid, a mesh rank's
boundary slab and stripe, and a narrow bf16 grid.  ``kernel.sweep_row``,
which sweeps a mesh rank's boundary row from three rows where they lie,
must give the bits of the 3-row slab path it replaced; the sweep refuses
rows that are not 16-B aligned, and ``api.launch`` lays such a grid out
first.  Every comparison is bit for bit: both sides do the same rounded
fp32 operations in the same order and round once.
"""
import pytest
import torch

from repro_torch import api
from repro_torch.core import layout, planner
from repro_torch.kernels.jacobi import kernel as jkernel
from repro_torch.kernels.jacobi import ops as jops

SMS = layout.H100_SM_COUNT
FILL = layout.CTAS_PER_SM * SMS


def plan(shape, dtype, **kw):
    return planner.plan_kernel("jacobi", shape, dtype,
                               smem_budget=layout.H100_SMEM_PER_CTA,
                               sm_count=SMS, **kw)


def ctas(n_rows, p):
    """CTAs of the kernel's grid on an (n_rows, width) grid: strips of the
    plan's rows over all rows, by column tiles."""
    return -(-n_rows // p.block_rows) * -(-p.width // p.block_cols)


# (interior rows, cols), dtype, the block the closed form gives: strips as
# tall as a thread's ring of row vectors (4) where the grid fills the SMs
CASES = [
    ((16382, 16384), "float32", (4, 1024)),    # the main path's grid
    ((1, 16384), "float32", (1, 1024)),        # a rank's 3-row boundary slab
    ((8190, 16384), "float32", (4, 1024)),     # a rank's stripe, half rows
    ((16382, 16384), "bfloat16", (4, 2048)),
    ((10, 100), "bfloat16", (1, 256)),         # narrow: fp32 geometry
]


@pytest.mark.parametrize("shape,dtype,block", CASES)
def test_block_is_a_strip_by_a_tile_of_whole_vectors(shape, dtype, block):
    p = plan(shape, dtype, local=shape[0] == 8190)
    size = p.elem_bytes
    assert p.block_shape == block
    # the tile: whole 16-B vectors, whole warps of them, at most a CTA
    assert p.block_cols * size % layout.VEC_BYTES == 0
    threads = p.block_cols * size // layout.VEC_BYTES
    assert threads % layout.WARP == 0 and threads <= layout.CTA_THREADS
    # the strip: at most STRIP_ROWS rows, the ring's depth; the kernel cuts
    # the last strip short, so the rows are the grid's own
    assert planner.STRIP_ROWS == planner.CTA_BUFFERS["jacobi"]
    assert 1 <= p.block_rows <= planner.STRIP_ROWS
    assert p.rows == shape[0]
    assert p.width * size % layout.VEC_BYTES == 0
    assert "2-D tiles" in p.explain()


@pytest.mark.parametrize("shape,dtype,block", CASES)
def test_grid_fills_the_sms_where_the_rows_allow(shape, dtype, block):
    p = plan(shape, dtype)
    tiles = p.grid[1]
    if shape[0] * tiles >= FILL * planner.STRIP_ROWS:
        assert p.grid[0] * p.grid[1] >= FILL
    else:   # too few rows: strips shrink, to one row a strip at least
        assert p.block_rows <= max(1, shape[0] * tiles // FILL)


def test_a_boundary_slab_spreads_over_many_ctas():
    """A rank's 3-row slab at 16384 columns: 16 column tiles of 1024 fp32
    columns, one row a strip, where the old mapping gave it one CTA."""
    p = plan((1, 16384), "float32")
    assert p.grid == (1, 16)
    assert ctas(3, p) == 48
    bf16 = plan((1, 16384), "bfloat16")
    assert ctas(3, bf16) == 24


def test_narrow_bf16_block_follows_its_own_vectors():
    """The narrow-dtype rule takes the fp32 width (128); the tile is
    recomputed in bf16 vectors, one warp of 8 elements a thread."""
    p = plan((10, 100), "bfloat16")
    assert p.width == 128 and p.minor_unit == 128
    assert p.block_cols == layout.WARP * 8


def rows_of(n, m, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((n, m), generator=gen).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,width", [(34, 128), (130, 256), (3, 128),
                                     (2, 128), (256, 256)])
def test_row_entry_equals_the_slab_path(m, width, dtype):
    """The boundary-row entry, the halo row where it was received (m
    columns) and the stripe's rows at its pitch, gives the bits of the slab
    the mesh body used to stack and sweep, padding columns included."""
    halo = rows_of(1, m, dtype, 1)[0]
    stripe = jops.pitched(rows_of(4, m, dtype, 2),
                          plan((2, m), dtype, local=True))
    assert stripe.shape[1] == width
    stripe[:, m:] = 3.0                    # padding is copied, not read
    slab = jops._slab([halo[None], stripe[0:1], stripe[1:2]], width, m)
    slab[1, m:] = 3.0
    block = plan((1, m), dtype).block_shape
    want = jkernel.sweep(slab, torch.empty_like(slab), n_cols=m,
                         block=block)[1]
    out = torch.empty_like(stripe)
    before = jkernel.LAUNCHES["jacobi"]
    got = jkernel.sweep_row(halo, stripe[0], stripe[1], out[0], n_cols=m)
    assert got.data_ptr() == out[0].data_ptr()
    assert torch.equal(got, want)
    assert jkernel.LAUNCHES["jacobi"] == before      # the CPU launches none
    below = rows_of(1, m, dtype, 3)[0]
    slab = jops._slab([stripe[-2:-1], stripe[-1:], below[None]], width, m)
    slab[1, m:] = 3.0
    want = jkernel.sweep(slab, torch.empty_like(slab), n_cols=m,
                         block=block)[1]
    assert torch.equal(jkernel.sweep_row(stripe[-2], stripe[-1], below,
                                         out[-1], n_cols=m), want)


def test_row_entry_refuses_what_it_does_not_take():
    c = torch.zeros(128)
    with pytest.raises(ValueError, match="overlaps"):
        jkernel.sweep_row(c, c, c, c, n_cols=128)
    with pytest.raises(ValueError, match="past"):
        jkernel.sweep_row(torch.zeros(10), c, c, torch.zeros(128), n_cols=34)
    with pytest.raises(ValueError, match="1-D"):
        jkernel.sweep_row(c[None], c, c, torch.zeros(128), n_cols=34)
    with pytest.raises(ValueError, match="elements"):
        jkernel.sweep_row(c, c, c, torch.zeros(64), n_cols=34)


def test_unaligned_rows_are_refused_and_launch_lays_them_out():
    """The sweep reads 16-B vectors: a base or a row pitch off 16 B raises
    (never a silent fall-back), and ``api.launch`` copies such a grid into
    a pitched buffer first, with the same bits as an aligned one."""
    grid = rows_of(6, 130, torch.float32, 4)
    buf = torch.zeros(6 * 130 + 1)
    off = buf[1:].view(6, 130)             # base 4 B past 16 B, pitch 520 B
    off.copy_(grid)
    block = plan((4, 130), "float32").block_shape
    with pytest.raises(ValueError, match="16-B aligned"):
        jkernel.sweep(off, torch.empty(6, 130), n_cols=130, block=block)
    pitch = torch.zeros(6, 131)[:, :130]   # aligned base, pitch 524 B
    with pytest.raises(ValueError, match="16-B aligned"):
        jkernel.sweep(pitch, torch.zeros(6, 131)[:, :130], n_cols=130,
                      block=block)
    assert not jkernel.aligned(off) and jkernel.aligned(jops.pitched(
        grid, plan((4, 130), "float32")))
    assert torch.equal(api.launch("jacobi", off), api.launch("jacobi", grid))
