"""The CPU emulation of the conv kernel's tiling
(`kernels/conv2d.conv2d_emulated`) and its tile order (`tile_order`).

The emulation follows `plan` and `tile_order` as `csrc/conv2d.cu` does:
C and F zero padding, pixel tiles in the kernel's order with their
partial-tile masks, split-K's per-split fp32 partials summed in split
order, one rounding to x's dtype.  It is held against the reference's
Pallas kernel in interpret mode and the plain version at the shapes the
card's tests use (`test_torch_cuda.SHAPES`), at their tolerances (f32
2e-5, bf16 3e-2: one bf16 rounding of the output).  `interior_first` is a
pure reorder: every tile once, the ones that read the halo rows last,
and a bit-identical result.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d import conv2d as pallas_conv2d
from repro_torch.kernels import conv2d as tconv
from repro_torch.kernels.ref import conv2d_ref
from repro_torch.utils import same_pads
from test_torch_cuda import SHAPES, TOL, _inputs

torch.set_num_threads(2)


@pytest.mark.parametrize("h,w,c,f,k,s", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulation_matches_pallas_and_plain(h, w, c, f, k, s, dtype):
    x, wt = _inputs(h, w, c, f, k)
    tdt = getattr(torch, dtype)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(wt).to(tdt)
    got = tconv.conv2d_emulated(tx, tw, stride=s)
    assert got.dtype == tdt and not torch.isnan(got.float()).any()
    want = pallas_conv2d(jnp.asarray(x, dtype), jnp.asarray(wt, dtype),
                         stride=s, interpret=True)
    for ref in (np.asarray(want, np.float32),
                conv2d_ref(tx, tw, stride=s).float().numpy()):
        np.testing.assert_allclose(got.float().numpy(), ref,
                                   rtol=TOL[dtype], atol=TOL[dtype],
                                   err_msg=str(tconv.plan(
                                       tuple(tx.shape), tuple(tw.shape), s,
                                       tdt)))
    first = tconv.conv2d_emulated(tx, tw, stride=s, interior_first=True)
    assert torch.equal(first, got)


def _edge_tiles(x_shape, w_shape, s, dtype):
    """Pixel tiles holding an output row that reads a halo row (the first
    lo or last hi input rows of a sample), counted pixel by pixel."""
    n, h, wd, _ = x_shape
    kh, kw = w_shape[:2]
    p = tconv.plan(x_shape, w_shape, s, dtype)
    ho, wo = (h - kh) // s + 1, (wd - kw) // s + 1
    lo, hi = same_pads(kh, s)
    edge = set()
    for m in range(n * ho * wo):
        oh = (m % (ho * wo)) // wo
        rows = range(oh * s, oh * s + kh)
        if any(r < lo or r >= h - hi for r in rows):
            edge.add(m // p.tile_m)
    return edge, -(-n * ho * wo // p.tile_m)


@pytest.mark.parametrize("shape", [
    (2, 34, 34, 8, 3, 8, 1), (2, 33, 33, 16, 3, 16, 2),
    (2, 130, 130, 64, 3, 64, 1), (1, 65, 64, 18, 3, 64, 2),
    (2, 23, 9, 6, 7, 128, 2), (2, 16, 16, 32, 1, 1, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_interior_first_visits_every_tile_once_edges_last(shape, dtype):
    n, h, w, c, k, f, s = shape
    xs, ws = (n, h, w, c), (k, k, c, f)
    assert tconv.tile_order(xs, ws, s, dtype, False) is None
    order = tconv.tile_order(xs, ws, s, dtype, True)
    edge, tiles = _edge_tiles(xs, ws, s, dtype)
    assert sorted(order) == list(range(tiles))
    n_in = tiles - len(edge)
    assert set(order[n_in:]) == edge
    assert list(order[:n_in]) == sorted(order[:n_in])
    if k == 1:
        assert not edge and list(order) == list(range(tiles))


def test_emulation_pads_and_masks_at_a_ragged_split_k_shape():
    """bf16 at C=72 in 64-channel steps (a ragged last slice), F=200 (a
    ragged filter tile) and split-K: every element written (an unwritten
    tile would stay NaN), and within one bf16 rounding of the plain
    version."""
    x, wt = _inputs(12, 12, 72, 200, 3, seed=3)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw = torch.from_numpy(wt).to(torch.bfloat16)
    p = tconv.plan(tuple(tx.shape), tuple(tw.shape), 1, torch.bfloat16)
    assert p.splits > 1 and p.f_pad == 200 and 72 % p.tile_k
    got = tconv.conv2d_emulated(tx, tw)
    assert not torch.isnan(got.float()).any()
    np.testing.assert_allclose(got.float().numpy(),
                               conv2d_ref(tx, tw).float().numpy(),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
