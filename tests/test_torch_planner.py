"""The port's Hopper planner: invariants, and the conflict model against JAX's.

``repro_torch.core.aliasing``/``autotune`` are copies of ``repro.core``'s
numpy-only modules, so their outputs must equal the reference's exactly
(``==``, no tolerance).  The planner's geometry is the Hopper model's own,
so it is held to invariants, not to the TPU golden plans.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.core import aliasing as jaliasing
from repro.core import autotune as jautotune
from repro_torch.core import aliasing, autotune, layout, planner

FAMILIES = ["stream.copy", "stream.scale", "stream.add", "stream.triad",
            "triad", "jacobi"]
SIZES = [1, 7, 1000, 8191]
DTYPES = ["float32", "bfloat16"]
BUDGET = layout.H100_SMEM_PER_CTA
SMS = layout.H100_SM_COUNT


def shape_for(kernel, n):
    # 1-D streams plan on their length; jacobi on (interior rows, cols=129)
    return (n, 129) if kernel == "jacobi" else (n,)


def plan(kernel, shape, dtype):
    return planner.plan_kernel(kernel, shape, dtype, smem_budget=BUDGET,
                               sm_count=SMS)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", FAMILIES)
def test_plan_invariants(kernel, dtype, n):
    shape = shape_for(kernel, n)
    p = plan(kernel, shape, dtype)
    size = torch.tensor([], dtype=getattr(torch, dtype)).element_size()
    # padded >= logical
    assert p.padded_elems >= p.logical_elems
    if len(shape) == 2:
        assert p.padded_shape[0] >= shape[0] and p.padded_shape[1] >= shape[1]
    # the width is whole vector units: the dtype's, or fp32's when the
    # narrow-dtype rule took the fp32 geometry; either keeps rows 16-B aligned
    assert p.minor_unit in (layout.vector_unit(size), layout.vector_unit(4))
    assert p.width % p.minor_unit == 0
    assert p.width * size % layout.VEC_BYTES == 0
    # block rows divide the padded rows; the block is full-width.  A
    # stencil's block is a 2-D tile whose kernel cuts the last strip short:
    # its rows are not padded
    if kernel in planner.STENCIL:
        assert p.rows == shape[0] and p.block_rows <= p.rows
    else:
        assert p.rows % p.block_rows == 0
        assert p.block_cols == p.width
    # one CTA's in-flight rows fit the budget, unless one row alone exceeds it
    n_buffers = planner.CTA_BUFFERS.get(kernel, p.signature.n_streams + 1)
    per_row = p.width * size * n_buffers
    assert p.block_rows == 1 or p.block_rows * per_row <= BUDGET
    # bf16 pays no more padding bytes than fp32
    if dtype == "bfloat16":
        assert p.waste_bytes <= plan(kernel, shape, "float32").waste_bytes
    # a memo hit on the second call
    before = planner.plan_cache_info()["hits"]
    assert plan(kernel, shape, dtype) is p
    assert planner.plan_cache_info()["hits"] == before + 1


@pytest.mark.parametrize("kernel", ["triad", "stream.copy"])
def test_large_grid_fills_every_sm(kernel):
    """Rows allowing, the grid holds at least CTAS_PER_SM CTAs per SM, and a
    vector that fills whole rows pays no padding."""
    p = plan(kernel, (1 << 27,), "float32")
    assert p.waste_bytes == 0
    assert p.grid[0] >= layout.CTAS_PER_SM * SMS


def test_narrow_dtype_falls_back_to_fp32_geometry():
    """100 columns: the bf16 unit (256) would pad 156 elements = 312 B, the
    fp32 unit (128) pads 28 bf16 elements = 56 B."""
    p = plan("jacobi", (10, 100), "bfloat16")
    assert p.width == 128 and p.minor_unit == 128
    assert p.waste_bytes == 10 * 28 * 2


def test_budget_and_sm_count_shape_the_block():
    p = plan("jacobi", (16382, 16384), "float32")
    # a 2-D tile: a strip of STRIP_ROWS rows by one 16-B vector a thread of
    # a CTA's threads; a thread holds row vectors in registers, so the
    # 64 KiB row puts no budget on the strip
    assert p.block_shape == (planner.STRIP_ROWS,
                             layout.CTA_THREADS * layout.VEC_BYTES // 4)
    wide = planner.plan_kernel("stream.copy", (1 << 22,), "float32",
                               smem_budget=1 << 30, sm_count=1)
    assert wide.block_rows > 1
    with pytest.raises(ValueError):
        planner.plan_kernel("triad", (8,), "float32", smem_budget=0)
    with pytest.raises(KeyError):
        planner.plan_kernel("nope", (8,), "float32")


def test_hopper_limits_default_to_the_data_sheet():
    limits = layout.hopper_limits()
    if not torch.cuda.is_available():
        assert (limits.smem_per_cta, limits.sm_count) == (232_448, 132)
    assert layout.vector_unit(4) == 128 and layout.vector_unit(2) == 256


def test_layout_policy_pads_to_vector_units():
    pol = layout.LayoutPolicy(tp=4)
    dims = pol.plan({"d": (1000, "minor"), "v": (32001, "vocab"),
                     "h": (14, "count_sharded")})
    assert dims["d"].physical == 1024
    assert dims["v"].physical % (4 * 128) == 0
    assert dims["h"].physical == 16
    with pytest.raises(ValueError):
        pol.plan({"x": (3, "sublane")})


# ---- the conflict model equals the reference's exactly -------------------

@pytest.mark.parametrize("n_read,n_write", [(1, 1), (2, 1), (3, 1), (1, 0),
                                            (19, 19)])
def test_plan_streams_equals_reference(n_read, n_write):
    sig = autotune.StreamSignature(n_read, n_write)
    jsig = jautotune.StreamSignature(n_read, n_write)
    for kw in [{}, {"n_threads": 4, "chunk_bytes": 640}]:
        got = autotune.plan_streams(sig, aliasing.InterleavedMemoryModel(), **kw)
        want = jautotune.plan_streams(jsig, jaliasing.InterleavedMemoryModel(),
                                      **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if (n_read, n_write) == (3, 1):
        assert got.offsets_bytes == (0, 128, 256, 384)


def test_conflict_model_equals_reference():
    m, jm = aliasing.InterleavedMemoryModel(), jaliasing.InterleavedMemoryModel()
    streams = [aliasing.Stream(0, "write"), aliasing.Stream(64, "read"),
               aliasing.Stream(512, "read", stride=64)]
    jstreams = [jaliasing.Stream(s.base, s.kind, s.stride) for s in streams]
    assert m.balance(streams) == jm.balance(jstreams)
    assert m.bank_balance(streams) == jm.bank_balance(jstreams)
    assert m.mean_channels_hit(streams, n_threads=3) == jm.mean_channels_hit(
        jstreams, n_threads=3)
    np.testing.assert_array_equal(m.tick_histograms(streams, n_threads=2),
                                  jm.tick_histograms(jstreams, n_threads=2))
    kw = dict(n_elements=4096, offsets=range(0, 70, 7), n_threads=8)
    assert m.stream_triad_curve(**kw) == jm.stream_triad_curve(**kw)
    assert aliasing.analytic_skews(m, 4) == jaliasing.analytic_skews(jm, 4)
    assert (aliasing.exhaustive_best_skews(m, 2)
            == jaliasing.exhaustive_best_skews(jm, 2))
    cands = {"a": ([0, 0, 0], [True, False, False]),
             "b": ([0, 128, 256], [True, False, False])}
    assert autotune.choose_layout(cands, m) == jautotune.choose_layout(cands, jm)
    assert (dataclasses.asdict(autotune.verify_plan_optimal(
        autotune.StreamSignature(1, 1))[0])
        == dataclasses.asdict(jautotune.verify_plan_optimal(
            jautotune.StreamSignature(1, 1))[0]))


# ---- the traffic model: RMSNorm's scale vector ----------------------------

@pytest.mark.parametrize("shape", [(8, 2048), (2048, 2048), (8, 4096),
                                   (3, 100)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["rmsnorm", "rmsnorm.gated"])
def test_rmsnorm_traffic_charges_the_scale_vector(kernel, dtype, shape):
    """A norm moves x (and the gate z) in and y out, and its scale vector
    once: ``predicted_hbm_bytes`` less the major streams is width x
    element bytes, as the reference's ``MINOR_STREAM_BYTES`` charges it,
    and at an unpadded width it equals the count chip_smoke.py takes a
    norm's bound from, (2 or 3) x rows x d + d elements."""
    from repro.core import planner as jplanner
    from repro_torch import api

    p = api.plan_for(kernel, shape, dtype)
    eb = p.elem_bytes
    major = planner.MAJOR_STREAMS[kernel]
    assert major == jplanner.MAJOR_STREAMS[kernel] == (
        3 if kernel.endswith("gated") else 2)
    assert p.predicted_hbm_bytes - major * p.padded_elems * eb == p.width * eb
    rows, d = shape
    assert p.predicted_logical_bytes == (major * rows + 1) * d * eb
    assert planner.MINOR_STREAM_BYTES[kernel](rows, d, eb) == (
        jplanner.MINOR_STREAM_BYTES[kernel](rows, d, eb))
    if p.padded_shape == shape:
        assert p.predicted_hbm_bytes == p.predicted_logical_bytes


# ---- LBM, the six RMSNorm entries and the cross-entropy (ROADMAP A7.5) ----

NORMS = ["rmsnorm", "rmsnorm.gated", "rmsnorm.sumsq", "rmsnorm.gated.sumsq",
         "rmsnorm.apply", "rmsnorm.gated.apply"]


@pytest.mark.parametrize("n", [2, 10, 64, 250, 256])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["lbm.soa", "lbm.ivjk"])
def test_lbm_plan_invariants(kernel, dtype, n):
    """A block gives each of a CTA's threads one site in whole vector-unit
    chunks; the sites pad to whole blocks, less than one block; the
    lattice is read and written once (``MAJOR_STREAMS``)."""
    from repro_torch.api import registry

    registry.resolve(kernel)
    p = plan(kernel, (19, n, n, n), dtype)
    unit = p.minor_unit
    sites = p.padded_elems // 19
    block_sites = p.padded_elems // 19 // math.prod(p.grid)
    assert block_sites == max(layout.CTA_THREADS // unit, 1) * unit
    assert sites % block_sites == 0 and 0 <= sites - n ** 3 < block_sites
    if kernel == "lbm.soa":
        assert p.padded_shape == (19, sites) and p.block_shape[0] == 19
    else:
        assert p.padded_shape == (sites // unit, 19, unit)
    assert p.predicted_hbm_bytes == 2 * p.padded_elems * p.elem_bytes
    assert p.predicted_logical_bytes == 2 * 19 * n ** 3 * p.elem_bytes


@pytest.mark.parametrize("shape", [(1, 7), (8, 896), (300, 1111),
                                   (2048, 2560), (2113, 1024)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", NORMS)
def test_rmsnorm_plan_invariants(kernel, dtype, shape):
    """Every norm entry streams full-width row blocks: rows a whole number
    of blocks, the width whole vector units, one CTA's in-flight rows in
    the budget; bf16 pays no more padding bytes than fp32."""
    from repro_torch.api import registry

    registry.resolve(kernel)
    p = plan(kernel, shape, dtype)
    size = p.elem_bytes
    assert p.width >= shape[1] and p.width % p.minor_unit == 0
    assert p.width * size % layout.VEC_BYTES == 0
    assert p.rows >= shape[0] and p.rows % p.block_rows == 0
    assert p.block_cols == p.width
    n_buffers = planner.CTA_BUFFERS.get(kernel, p.signature.n_streams + 1)
    assert p.block_rows == 1 or p.block_rows * p.width * size * n_buffers \
        <= BUDGET
    if dtype == "bfloat16":
        assert p.waste_bytes <= plan(kernel, shape, "float32").waste_bytes


@pytest.mark.parametrize("kernel", NORMS[2:])
def test_split_norm_geometry_does_not_read_the_byte_tables(kernel,
                                                           monkeypatch):
    """The split passes' ``MAJOR_STREAMS`` / ``MINOR_STREAM_BYTES`` entries
    move their predicted bytes only: planned without them, every cell
    keeps its padded shape and block."""
    from repro_torch.api import registry

    registry.resolve(kernel)
    cells = [((r, d), dt) for r in (8, 300, 2048, 4096)
             for d in (896, 1024, 2048) for dt in DTYPES]
    # (the bytes are read off the tables when asked: keep them now)
    with_tables = [(p.padded_shape, p.block_shape, p.predicted_hbm_bytes)
                   for p in (plan(kernel, s, dt) for s, dt in cells)]
    monkeypatch.delitem(planner.MAJOR_STREAMS, kernel)
    monkeypatch.delitem(planner.MINOR_STREAM_BYTES, kernel)
    planner.clear_plan_cache()
    try:
        for (s, dt), (padded, block, nbytes) in zip(cells, with_tables):
            q = plan(kernel, s, dt)
            assert (q.padded_shape, q.block_shape) == (padded, block)
            assert q.predicted_hbm_bytes != nbytes
    finally:
        planner.clear_plan_cache()


@pytest.mark.parametrize("shape", [(1, 5), (300, 5000), (1000, 32008),
                                   (4096, 151936), (3584, 51865)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_xent_plan_invariants(dtype, shape):
    """The column-tiled loss pads nothing on one device (its kernel reads
    rows of any width in place), walks whole rows a CTA in passes of one
    16-B vector a thread, keeps every SM busy where the rows allow, and
    moves its logits once beside two row-sized fp32/int32 side streams."""
    from repro_torch.api import registry

    registry.resolve("xent")
    p = plan("xent", shape, dtype)
    t, v = shape
    assert p.padded_shape == shape and p.minor_unit == 1 and p.waste == 0
    assert p.block_cols == min(layout.CTA_THREADS * layout.VEC_BYTES
                               // p.elem_bytes, v)
    assert 1 <= p.block_rows <= t
    if t >= layout.CTAS_PER_SM * SMS:
        assert p.grid[0] >= layout.CTAS_PER_SM * SMS or p.block_rows == 1
    # the fewest rows that stream COL_TILED_CTA_BYTES, or fewer
    assert (p.block_rows - 1) * v * p.elem_bytes < \
        planner.COL_TILED_CTA_BYTES
    assert p.predicted_hbm_bytes == t * v * p.elem_bytes + 8 * t
