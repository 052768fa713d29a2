"""The CPU emulation of the flash-attention kernel's tiling
(`kernels/flash_attention.flash_attention_emulated`).

The emulation walks `plan` as `csrc/flash_attention.cu` does: 128-query x
64-key tiles (64-query on the fma path at D 256), query tiles longest
first under causality, key tiles from
the first one the window admits to the last one causality admits, fp32
running max and sum rescaled per key tile in log2 units, masked logits at
-1e30 on the tiles a diagonal or window edge crosses, the softcap, P
rounded to bf16 before P.V on the `wgmma` path, l clamped at 1e-30.  It
is held against the reference's Pallas kernel in interpret mode and the
plain version at test_torch_kernels' tolerances (f32 2e-5; bf16 3e-2,
one bf16 rounding of the output), and the bf16 rows element by element
to one bf16 ulp of softmax(S).|v| + |o32|, the limit the card's kernel is
held to (tests/test_torch_cuda.py).  `tests/test_torch_cuda.py::
test_flash_emulation_matches_the_kernel` holds it against the card's
kernel (that file imports no jax, so it runs on the card's machine).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ring_attention as jra
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref

TOL = {"float32": 2e-5, "bfloat16": 3e-2}

# (b, sq, hq, hkv, d, causal, window, softcap): several 128-query and
# 64-key tiles with ragged ends, GQA g = 1, 2, 3, 5; a window inside one
# key tile (5) and one straddling two (70); softcap; D = 128 (two swizzle
# atoms on wgmma), D = 20 (bf16 on the fma path) and D = 8; then gemma2's
# D = 256 (four atoms on wgmma, 64-query tiles on fma) under causality, a
# window and its softcap of 50, bidirectional, and D = 250 (bf16 on fma,
# f32 rows of element copies)
ATTN = [
    (1, 300, 4, 2, 16, True, None, None),
    (2, 200, 6, 3, 32, True, 70, None),
    (1, 260, 5, 1, 64, True, 5, 30.0),
    (1, 150, 2, 2, 128, False, None, None),
    (1, 129, 3, 1, 20, True, None, 20.0),
    (1, 64, 2, 1, 8, False, 5, None),
    (1, 200, 4, 2, 256, True, 70, 50.0),
    (1, 130, 2, 1, 256, False, None, None),
    (1, 90, 2, 2, 250, True, None, None),
]


def _inputs(b, sq, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, sq, hkv, d), (b, sq, hkv, d))]


def _ulp_worst(got, q, k, v, opts) -> float:
    """The largest |got - o32| over one bf16 ulp of softmax(S).|v| +
    |o32|, o32 the plain version in fp32 on the same bf16 inputs."""
    q, k, v = q.float(), k.float(), v.float()
    o32 = flash_attention_ref(q, k, v, **opts)
    limit = 2.0 ** -7 * (flash_attention_ref(q, k, v.abs(), **opts)
                         + o32.abs())
    return float(((got.float() - o32).abs() / limit).max())


@pytest.mark.parametrize("b,sq,hq,hkv,d,causal,window,cap", ATTN)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulation_matches_pallas_and_plain(b, sq, hq, hkv, d, causal,
                                            window, cap, dtype):
    arrays = _inputs(b, sq, hq, hkv, d)
    opts = dict(causal=causal, window=window, softcap=cap)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays)
    got = tfa.flash_attention_emulated(q, k, v, **opts)
    assert got.dtype == tdt and got.shape == q.shape
    assert not torch.isnan(got.float()).any(), "a query tile unwritten"
    kernel = pallas_flash(*(jnp.asarray(a, dtype) for a in arrays),
                          interpret=True, **opts)
    plan = tfa.plan(tuple(q.shape), tuple(k.shape), tdt, causal, window)
    for want in (np.asarray(kernel, np.float32),
                 flash_attention_ref(q, k, v, **opts).float().numpy()):
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=TOL[dtype], atol=TOL[dtype],
                                   err_msg=str(plan))
    if dtype == "bfloat16":
        assert _ulp_worst(got, q, k, v, opts) <= 1.0


def test_emulation_rounds_p_on_the_wgmma_path_only():
    """bf16 at D = 64 takes `wgmma`, whose P is rounded to bf16 before
    P.V: the emulation then differs from the same tiling with P kept in
    fp32 (the plain version's), and at D = 20 (the fma path) it does
    not round."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(1, 192, 2, 1, 64, seed=3))
    assert tfa.plan(tuple(q.shape), tuple(k.shape), torch.bfloat16, True,
                    None).path == "wgmma"
    got = tfa.flash_attention_emulated(q, k, v).float()
    f32 = tfa.flash_attention_emulated(q.float(), k.float(), v.float())
    assert not torch.equal(got, f32.to(torch.bfloat16).float())
    assert _ulp_worst(got, q, k, v, {}) <= 1.0
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(1, 192, 2, 1, 20, seed=3))
    assert tfa.plan(tuple(q.shape), tuple(k.shape), torch.bfloat16, True,
                    None).path == "fma"
    got = tfa.flash_attention_emulated(q, k, v)
    f32 = tfa.flash_attention_emulated(q.float(), k.float(), v.float())
    assert torch.equal(got, f32.to(torch.bfloat16))


@pytest.mark.parametrize("d,dtype,want", [
    (256, torch.bfloat16, ("wgmma", 128, 64, 256, 2)),
    (200, torch.bfloat16, ("wgmma", 128, 64, 256, 2)),
    (256, torch.float32, ("fma", 64, 64, 256, 1)),
    (252, torch.bfloat16, ("fma", 64, 64, 256, 1)),
    (128, torch.float32, ("fma", 128, 64, 128, 1)),
])
def test_plan_at_head_dims_up_to_256(d, dtype, want):
    """D up to 256 pads to four swizzle atoms: bf16 (D a multiple of 8)
    keeps `wgmma`'s 128 x 64 tiles and two stages; the `fma` path takes
    64-query tiles with one stage there (128 x 64 at D <= 128)."""
    p = tfa.plan((1, 300, 4, d), (1, 300, 2, d), dtype, True, None)
    assert (p.path, p.tile_q, p.tile_k, p.d_pad, p.stages) == want


def test_emulation_refuses_what_the_kernel_refuses():
    q = torch.zeros(1, 8, 2, 264)
    with pytest.raises(ValueError, match="head dim 264 > 256"):
        tfa.flash_attention_emulated(q, q, q)
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="see no"):
        tfa.flash_attention_emulated(q, q[:, :2], q[:, :2], causal=False,
                                     window=1)


# ---------------------------------------------------------------------------
# the block call (ring attention's tile): delta and lse
# ---------------------------------------------------------------------------

BLOCK_TOL = 1e-5

# (b, sq, sk, hq, hkv, d, q_off, k_off, causal, window, softcap): the
# ring's blocks at the reference's q/k offsets: the causal diagonal, a full
# off-diagonal block, window blocks whose last rows see no key (q_off -
# k_off = Sk, window <= Sk), a window inside one key tile, the softcap,
# bidirectional blocks behind and ahead, and a block entirely past the
# window (no row sees a key)
BLOCKS = [
    (1, 96, 96, 4, 2, 16, 0, 0, True, None, None),
    (2, 80, 80, 6, 3, 32, 80, 0, True, None, None),
    (1, 64, 64, 4, 2, 16, 64, 0, True, 64, None),
    (1, 130, 130, 5, 1, 64, 130, 0, True, 100, 30.0),
    (1, 70, 70, 2, 2, 16, 140, 70, True, 5, None),
    (1, 50, 50, 4, 4, 8, 100, 0, True, 40, None),
    (1, 72, 40, 3, 1, 20, 0, 40, False, None, 20.0),
    (1, 72, 40, 3, 1, 20, 40, 0, False, None, None),
    (1, 130, 130, 4, 2, 256, 130, 0, True, 100, 50.0),
]


def _block_attend_ref(q, k, v, q_off, k_off, causal, window, cap):
    """The reference's `_block_attend` from empty accumulators: (o, lse,
    seen) with o = o_acc / l, lse = m + log l and seen the rows that see a
    key of the block."""
    b, sq, hq, d = q.shape
    m = jnp.full((b, hq, sq), jra.NEG_INF, jnp.float32)
    l = jnp.zeros((b, hq, sq), jnp.float32)
    o = jnp.zeros((b, sq, hq, d), jnp.float32)
    attend = jax.jit(functools.partial(
        jra._block_attend, q_off=q_off, k_off=k_off, scale=1.0 / np.sqrt(d),
        causal=causal, window=window, softcap=cap))
    m, l, o = attend(q, k, v, m=m, l=l, o=o)
    qpos = q_off + np.arange(sq)[:, None]
    kpos = k_off + np.arange(k.shape[1])[None, :]
    keep = np.ones((sq, k.shape[1]), bool)
    if causal:
        keep &= qpos >= kpos
    if window is not None:
        keep &= qpos - kpos < window
    return (np.asarray(o / l.transpose(0, 2, 1)[..., None]),
            np.asarray(m + jnp.log(l)), keep.any(1))


def _check_block(got_o, got_lse, want_o, want_lse, seen, tol, what):
    got_o, got_lse = got_o.float().numpy(), got_lse.numpy()
    assert got_o.dtype == np.float32 and got_lse.dtype == np.float32
    assert np.isfinite(got_o).all(), what
    np.testing.assert_allclose(got_o[:, seen], want_o[:, seen], rtol=tol,
                               atol=tol, err_msg=what)
    np.testing.assert_allclose(got_lse[..., seen], want_lse[..., seen],
                               rtol=BLOCK_TOL, atol=BLOCK_TOL, err_msg=what)
    assert (got_lse[..., ~seen] <= -1e29).all(), what


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,q_off,k_off,causal,window,cap",
                         BLOCKS)
def test_block_matches_the_reference_block_attend(b, sq, sk, hq, hkv, d,
                                                  q_off, k_off, causal,
                                                  window, cap):
    """The plain version and the emulation with delta = q_off - k_off and
    lse against the reference's `_block_attend` at q_off / k_off: o and
    lse at 1e-5 on the rows that see a key; on the others lse <= -1e29
    and o finite."""
    rng = np.random.default_rng(sq + sk + q_off)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))]
    want_o, want_lse, seen = _block_attend_ref(*arrays, q_off, k_off,
                                               causal, window, cap)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    opts = dict(causal=causal, window=window, softcap=cap,
                delta=q_off - k_off, return_lse=True)
    for name, fn in (("plain", flash_attention_ref),
                     ("emulation", tfa.flash_attention_emulated)):
        o, lse = fn(q, k, v, **opts)
        assert lse.shape == (b, hq, sq)
        _check_block(o, lse, want_o, want_lse, seen, BLOCK_TOL, name)
    if window is not None and q_off > k_off:
        assert 0 < seen.sum() < sq or not seen.any()


@pytest.mark.parametrize("window,cap", [(24, None), (40, 30.0), (16, None)])
def test_window_blocks_merge_to_the_one_device_result(window, cap):
    """A sequence of 3 blocks of 32 under a window: each query block's
    diagonal block and the off-diagonal ones the ring visits (rows near
    their end see no key), merged by `core.ring_attention.merge_blocks`,
    give the reference's one-device attention at 1e-5; the plain version
    and the emulation alike."""
    from repro_torch.core.ring_attention import merge_blocks, ring_steps
    n, sl, hq, hkv, d = 3, 32, 4, 2, 16
    rng = np.random.default_rng(window)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((1, n * sl, hq, d), (1, n * sl, hkv, d),
                        (1, n * sl, hkv, d))]
    want = np.asarray(jra.ring_attention(*arrays, mesh=None, seq_axis=None,
                                         window=window, softcap=cap))
    q, k, v = (torch.from_numpy(a) for a in arrays)
    no_key = 0
    for fn in (flash_attention_ref, tfa.flash_attention_emulated):
        got = []
        for i in range(n):
            outs, lses = [], []
            for t in range(ring_steps(n, sl, window)):
                src = i - t
                if src < 0:
                    continue
                o, lse = fn(q[:, i * sl:(i + 1) * sl],
                            k[:, src * sl:(src + 1) * sl].contiguous(),
                            v[:, src * sl:(src + 1) * sl].contiguous(),
                            delta=t * sl, window=window, softcap=cap,
                            return_lse=True)
                no_key += int((lse <= -1e29).sum())
                outs.append(o)
                lses.append(lse)
            got.append(merge_blocks(outs, lses))
        np.testing.assert_allclose(torch.cat(got, 1).numpy(), want,
                                   rtol=BLOCK_TOL, atol=BLOCK_TOL)
    assert no_key > 0


# (b, sq, sk, hq, hkv, d, delta, causal, window, softcap): tile edges, Sq
# not a multiple of 128 nor Sk of 64, deltas that move the tile range
# across tiles and past either end
BLOCK_EDGES = [
    (1, 200, 150, 4, 2, 16, 150, True, None, None),
    (1, 300, 300, 2, 1, 64, 300, True, 257, None),
    (2, 129, 65, 3, 3, 32, 64, True, 70, 20.0),
    (1, 130, 200, 2, 2, 20, -50, True, None, None),
    (1, 260, 70, 2, 1, 8, 0, False, 5, None),
    (1, 150, 150, 4, 2, 128, 150, True, 151, None),
    (1, 150, 150, 4, 2, 256, 150, True, 151, 50.0),
    (1, 100, 100, 2, 1, 256, 0, True, None, None),
]


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,delta,causal,window,cap",
                         BLOCK_EDGES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_emulation_matches_plain_at_tile_edges(b, sq, sk, hq, hkv, d,
                                                     delta, causal, window,
                                                     cap, dtype):
    rng = np.random.default_rng(sq * 7 + sk)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(tdt) for s in ((b, sq, hq, d), (b, sk, hkv, d),
                                  (b, sk, hkv, d)))
    opts = dict(causal=causal, window=window, softcap=cap, delta=delta,
                return_lse=True)
    want_o, want_lse = flash_attention_ref(q, k, v, **opts)
    seen = (want_lse > -1e29)[0, 0].numpy()
    o, lse = tfa.flash_attention_emulated(q, k, v, **opts)
    _check_block(o, lse, want_o.numpy(), want_lse.numpy(), seen,
                 TOL[dtype], str(tfa.plan(tuple(q.shape), tuple(k.shape),
                                          tdt, causal, window)))


def test_only_block_calls_take_rows_that_see_no_key():
    """A one-device call still refuses rows with no key (the kernel's
    output there would be a mean of V); a block call takes them."""
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="see no"):
        tfa.check_args(q, q[:, :2], q[:, :2], 1, None, None)
    tfa.check_args(q, q[:, :2], q[:, :2], 1, None, None, block=True)
    o, lse = ops.flash_attention_block(q, q[:, :2].contiguous(),
                                       q[:, :2].contiguous(), delta=0,
                                       causal=False, window=1)
    assert o.dtype == torch.float32 and (lse[..., 2:] <= -1e29).all()
