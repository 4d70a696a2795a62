"""Property tests of the port's Hopper planner (ROADMAP A7.5).

``tests/test_planner_properties.py``'s invariants restated for the
port's geometry, over the whole input space the planner accepts: every
padded extent a whole number of its vector unit (one element for the
column-tiled cross-entropy, which reads rows of any width), the rows a
whole number of blocks for the row-blocked families, nonnegative waste
and none at aligned widths, a bf16 plan paying no more padding bytes than
fp32, and memo keys that are stable and hash mesh contents.  The families:
the 1-D streams, the 2-D ones (the six RMSNorm entries, the cross-entropy,
Jacobi) and the LBM layouts.
"""
import math

from _hypothesis_compat import given, settings
from _hypothesis_compat import strategies as st

from repro_torch import api
from repro_torch.core import layout, planner

# every family registers its streams with the planner on import
api.list_kernels()

FAMILIES_1D = ["stream.copy", "stream.scale", "stream.add", "stream.triad",
               "triad"]
NORMS = ["rmsnorm", "rmsnorm.gated", "rmsnorm.sumsq", "rmsnorm.gated.sumsq",
         "rmsnorm.apply", "rmsnorm.gated.apply"]
FAMILIES_2D = NORMS + ["xent", "jacobi"]
DTYPES = ["float32", "bfloat16"]
# rows up to this many fill the SMs with blocks that divide them: a plan
# of so few rows pads none (above it, a row count with no block-sized
# divisor near the block rounds up one block)
TIGHT_ROWS = 2048


def _shape(kernel, a, b):
    return (a,) if kernel in FAMILIES_1D else (a % 3000 + 1, b)


def _unit(dtype):
    return layout.vector_unit(4 if dtype == "float32" else 2)


class TestVectorUnits:
    @settings(max_examples=60)
    @given(kernel=st.sampled_from(FAMILIES_1D + FAMILIES_2D),
           dtype=st.sampled_from(DTYPES),
           a=st.integers(min_value=1, max_value=50_000),
           b=st.integers(min_value=1, max_value=4_000))
    def test_padded_extents_are_whole_units_and_blocks(self, kernel, dtype,
                                                       a, b):
        plan = planner.plan_kernel(kernel, _shape(kernel, a, b), dtype)
        if kernel in planner.COL_TILED:
            assert plan.minor_unit == 1
            assert plan.padded_shape == plan.logical_shape, plan.explain()
        else:
            assert plan.minor_unit in (_unit(dtype), _unit("float32"))
            assert plan.width % plan.minor_unit == 0
            assert plan.width * plan.elem_bytes % layout.VEC_BYTES == 0
        if kernel in planner.STENCIL or kernel in planner.COL_TILED:
            # the kernel stops at the last row: rows are not padded
            assert plan.rows == plan.logical_shape[0]
            assert plan.block_rows <= plan.rows
        else:
            assert plan.rows % plan.block_rows == 0, plan.explain()
            assert plan.block_cols == plan.width

    @settings(max_examples=20)
    @given(dtype=st.sampled_from(DTYPES),
           layout_=st.sampled_from(["lbm.soa", "lbm.ivjk"]),
           n=st.integers(min_value=2, max_value=40))
    def test_lbm_padded_divisible_by_block(self, dtype, layout_, n):
        plan = planner.plan_kernel(layout_, (19, n, n, n), dtype)
        for padded, block in zip(plan.padded_shape, plan.block_shape):
            assert padded % block == 0, plan.explain()
        # the sites pad up to whole blocks: less than one block's sites
        sites = plan.padded_elems // 19
        block_sites = math.prod(plan.block_shape) // 19
        assert 0 <= sites - n ** 3 < block_sites, plan.explain()


class TestWaste:
    @settings(max_examples=60)
    @given(kernel=st.sampled_from(FAMILIES_1D + FAMILIES_2D),
           dtype=st.sampled_from(DTYPES),
           a=st.integers(min_value=1, max_value=50_000),
           b=st.integers(min_value=1, max_value=4_000))
    def test_waste_bytes_nonnegative(self, kernel, dtype, a, b):
        plan = planner.plan_kernel(kernel, _shape(kernel, a, b), dtype)
        assert plan.waste_bytes >= 0
        assert plan.predicted_hbm_bytes >= plan.predicted_logical_bytes

    @settings(max_examples=40)
    @given(kernel=st.sampled_from(NORMS + ["xent", "jacobi"]),
           dtype=st.sampled_from(DTYPES),
           r=st.integers(min_value=1, max_value=TIGHT_ROWS),
           c=st.integers(min_value=1, max_value=8))
    def test_zero_waste_on_aligned_2d_shapes(self, kernel, dtype, r, c):
        """A width of whole vector units pays nothing, and neither do the
        rows while the fill rule cuts blocks that divide them."""
        plan = planner.plan_kernel(kernel, (r, c * _unit(dtype)), dtype)
        assert plan.waste_bytes == 0, plan.explain()
        assert plan.padded_shape == plan.logical_shape

    @settings(max_examples=20)
    @given(kernel=st.sampled_from(FAMILIES_1D),
           dtype=st.sampled_from(DTYPES),
           k=st.integers(min_value=1, max_value=TIGHT_ROWS))
    def test_zero_waste_on_aligned_1d_shapes(self, kernel, dtype, k):
        """Whole rows of ``MAX_WIDTH`` elements, or one row of whole vector
        units, pad nothing."""
        for n in (k * planner.MAX_WIDTH,
                  (k % (planner.MAX_WIDTH // _unit(dtype)) + 1)
                  * _unit(dtype)):
            plan = planner.plan_kernel(kernel, (n,), dtype)
            assert plan.waste_bytes == 0, plan.explain()

    @settings(max_examples=40)
    @given(kernel=st.sampled_from(["triad", "stream.copy", "rmsnorm",
                                   "rmsnorm.gated.apply", "jacobi", "xent"]),
           a=st.integers(min_value=1, max_value=30_000),
           b=st.integers(min_value=1, max_value=3_000))
    def test_bf16_waste_bytes_at_most_fp32(self, kernel, a, b):
        """On identical odd shapes the bf16 plan never pays more padding
        *bytes* than fp32: its wider vector unit can pad more elements, but
        the fp32 geometry is legal at bf16 and the planner takes the
        cheaper one."""
        shape = ((2 * a + 1,) if kernel in FAMILIES_1D
                 else (a % 2000 + 1, 2 * b + 1))
        p32 = planner.plan_kernel(kernel, shape, "float32")
        p16 = planner.plan_kernel(kernel, shape, "bfloat16")
        assert p16.waste_bytes <= p32.waste_bytes, (p16.explain(),
                                                    p32.explain())


class TestCacheKeyStability:
    @settings(max_examples=20)
    @given(kernel=st.sampled_from(FAMILIES_1D + NORMS),
           n=st.integers(min_value=1, max_value=100_000))
    def test_repeated_calls_hit_the_memo(self, kernel, n):
        shape = (n,) if kernel in FAMILIES_1D else (n % 4096 + 1, 1024)
        planner.clear_plan_cache()
        first = planner.plan_kernel(kernel, shape, "float32")
        keys_after_first = planner.plan_cache_keys()
        again = planner.plan_kernel(kernel, shape, "float32")
        assert again is first                      # same object, not equal
        assert planner.plan_cache_keys() == keys_after_first

    @settings(max_examples=20)
    @given(tp=st.integers(min_value=1, max_value=8),
           r=st.integers(min_value=1, max_value=2_000),
           local=st.sampled_from([False, True]))
    def test_mesh_equality_not_identity(self, tp, r, local):
        """Two distinct but equal mesh mappings share one memo entry: the
        key hashes mesh *contents*, never object identity; a local plan
        never shares a global plan's entry."""
        planner.clear_plan_cache()
        a = planner.plan_kernel("rmsnorm", (r, 1111), "float32",
                                mesh={"model": tp, "data": 2}, local=local)
        b = planner.plan_kernel("rmsnorm", (r, 1111), "float32",
                                mesh={"data": 2, "model": tp}, local=local)
        assert b is a
        assert len([k for k in planner.plan_cache_keys()
                    if k[0] == "rmsnorm"]) == 1
        c = planner.plan_kernel("rmsnorm", (r, 1111), "float32",
                                mesh={"data": 2, "model": tp},
                                local=not local)
        assert c is not a
