"""The segmented container and the segmented triad: the port against the
JAX package.

``SegmentedArray``'s geometry (lengths, phases, physical blocks) and
``PageGeometry`` are integer bookkeeping and must equal the reference's
exactly.  The segmented triad runs one triad launch per segment on both
sides (Pallas in interpret mode there, the kernel's plain version here),
compared at tests/test_kernels.py's fp32 tolerance (rtol 1e-5 / atol 1e-6;
both sides round the product and the sum separately).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import segmented as jseg
from repro.kernels.triad import ops as jtops
from repro_torch import api, interop
from repro_torch.core.segmented import (
    PageGeometry,
    SegmentedArray,
    seg_map,
    seg_triad,
    split_lengths,
)
from repro_torch.kernels.triad import kernel as tkernel
from repro_torch.kernels.triad import ops as tops

FP32 = dict(rtol=1e-5, atol=1e-6)


def vectors(n, count, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(count)]


@pytest.mark.parametrize("n,segs,align,shift", [
    (1000, 4, 128, 16), (777, 5, 128, 32), (10, 3, 1, 0), (2000, 9, 64, 40),
    (5, 8, 8, 3), (1 << 12, 8, 128, 16)])
def test_geometry_and_roundtrip_match_reference(n, segs, align, shift):
    (x,) = vectors(n, 1)
    assert split_lengths(n, segs) == jseg.split_lengths(n, segs)
    got = SegmentedArray.from_flat(interop.to_torch(x, device="cpu"), segs,
                                   align=align, shift=shift)
    want = jseg.SegmentedArray.from_flat(jnp.asarray(x), segs, align=align,
                                         shift=shift)
    assert (got.lengths, got.phases) == (want.lengths, want.phases)
    assert (got.logical_size, got.physical_size, got.waste) == (
        want.logical_size, want.physical_size, want.waste)
    for k in range(segs):
        np.testing.assert_array_equal(interop.to_numpy(got.segments[k]),
                                      np.asarray(want.segments[k]))
        np.testing.assert_array_equal(interop.to_numpy(got.seg_view(k)),
                                      np.asarray(want.seg_view(k)))
    np.testing.assert_array_equal(interop.to_numpy(got.to_flat()), x)


def test_seg_map_is_functional_and_checks_lengths():
    b, c, d = vectors(777, 3, seed=1)

    def mk(v):
        return SegmentedArray.from_flat(interop.to_torch(v, device="cpu"), 5,
                                        align=128, shift=32)

    out = mk(np.full(777, 7.0, np.float32))
    # padding the output template carries over, whatever it holds
    for blk in out.segments:
        blk[:] = -1.0
    before = [blk.clone() for blk in out.segments]
    res = seg_triad(out, mk(b), mk(c), mk(d))
    np.testing.assert_allclose(interop.to_numpy(res.to_flat()), b + c * d,
                               rtol=1e-6)
    for k in range(out.n_segments):
        assert torch.equal(out.segments[k], before[k])   # never written
        p, n = res.phases[k], res.lengths[k]
        assert (res.segments[k][:p] == -1).all()
        assert (res.segments[k][p + n:] == -1).all()
    short = SegmentedArray.from_flat(torch.zeros(776), 5)
    with pytest.raises(ValueError, match="mismatch"):
        seg_map(lambda x: x, out, short)
    with pytest.raises(ValueError, match="1-D"):
        SegmentedArray([torch.zeros(2, 2)], [4], [0])
    with pytest.raises(ValueError, match="positive"):
        split_lengths(10, 0)


@pytest.mark.parametrize("n", [1500, 8 * 4096, 100_003])
def test_vector_triad_segmented_matches_reference(n):
    b, c, d = vectors(n, 3, seed=n)

    def jmk(v):
        return jseg.SegmentedArray.from_flat(jnp.asarray(v), 8, align=128,
                                             shift=16)

    def tmk(v):
        return SegmentedArray.from_flat(interop.to_torch(v, device="cpu"), 8,
                                        align=128, shift=16)

    zeros = np.zeros(n, np.float32)
    want = jtops.vector_triad_segmented(jmk(zeros), jmk(b), jmk(c), jmk(d))
    ins = [tmk(v) for v in (zeros, b, c, d)]
    before = [[blk.clone() for blk in a.segments] for a in ins]
    got = tops.vector_triad_segmented(*ins)
    np.testing.assert_allclose(interop.to_numpy(got.to_flat()),
                               np.asarray(want.to_flat()), **FP32)
    for k in range(8):
        np.testing.assert_allclose(interop.to_numpy(got.segments[k]),
                                   np.asarray(want.segments[k]), **FP32)
    # the caller's segments are never written
    for a, old in zip(ins, before):
        assert all(torch.equal(x, y) for x, y in zip(a.segments, old))
    # and the flat triad gives the same values
    flat = api.launch("triad", *(interop.to_torch(v, device="cpu")
                                 for v in (b, c, d)))
    assert torch.equal(got.to_flat(), flat)


def test_triad_out_writes_in_place_or_refuses():
    b, c, d = (interop.to_torch(v, device="cpu").view(4, 1024)
               for v in vectors(4096, 3, seed=7))
    out = torch.empty(4, 1024)
    assert tkernel.triad2d(b, c, d, out=out) is out
    assert torch.equal(out, tkernel.plain(b, c, d))
    with pytest.raises(ValueError, match="shape, strides"):
        tkernel.triad2d(b, c, d, out=torch.empty(4, 2048)[:, :1024])
    with pytest.raises(ValueError, match="shape, strides"):
        tkernel.triad2d(b, c, d, out=torch.empty(4, 1024, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="overlaps"):
        tkernel.triad2d(b, c, d, out=c)
    # through the launch path: whole tiles in place, a ragged length too
    for n in (4096, 1000):
        x = [t.reshape(-1)[:n] for t in (b, c, d)]
        o = torch.full((n,), 5.0)
        assert api.launch("triad", *x, out=o) is o
        assert torch.equal(o, api.launch("triad", *x))
    with pytest.raises(ValueError, match="out has shape"):
        api.launch("triad", *x, out=torch.empty(n + 1))


def test_page_geometry_matches_reference():
    for kw in [dict(page_len=8, n_pages=5), dict(page_len=8, n_pages=9, banks=4),
               dict(page_len=16, n_pages=11, banks=3)]:
        got, want = PageGeometry(**kw), jseg.PageGeometry(**kw)
        assert got.alloc_order() == want.alloc_order()
        assert got.live_pages == want.live_pages
        for length in (0, 1, 8, 9, 100):
            assert got.pages_for(length) == want.pages_for(length)
        for pos in (0, 7, 8, 33):
            assert (got.page_of(pos), got.offset_of(pos)) == (
                want.page_of(pos), want.offset_of(pos))
    for bad in [dict(page_len=0, n_pages=4), dict(page_len=8, n_pages=1),
                dict(page_len=8, n_pages=4, banks=0)]:
        with pytest.raises(ValueError):
            PageGeometry(**bad)
