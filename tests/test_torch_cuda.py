"""The port's compiled kernels on the card.  Every test here needs CUDA
and `nvcc`, is marked `cuda`, and skips where there is no card.  This file
imports neither jax nor the reference, so it runs on a machine without
them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 2e-5 / bf16 3e-2 on every kernel's output (the reference
sweep's: sums in another order in f32, one bf16 rounding of the output);
dx/dw 1e-4 of the largest gradient (cuDNN's reductions in another order,
TF32 off); the attention and SSD Functions' gradients 1e-5 of the largest
(the same plain version recomputed, so only the cotangent's path
differs); smoke-training losses rtol 1e-4 against the CPU run.  bf16
attention is also held element by element to one bf16 ulp of
softmax(S).|v| + |o32| (see `test_flash_kernel_matches_plain`), bf16 SSD
to 2^-7 |y32| + 2^-12 |M|.|xdt| (`test_ssd_bf16_within_the_element_limit`).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import conv2d as tconv
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd as tssd
from repro_torch.kernels.ref import (conv2d_ref, flash_attention_ref,
                                     ssd_chunked_ref)
from repro_torch.launch import train as train_cli

torch.set_num_threads(2)

# the reference sweep and the meshnet edge shapes (C=18 at stride 2, the
# F=1 1x1 pred conv, prime H_out / W_out, odd extents at stride 2), then
# the edges of the kernel's tiles: C=18 at stride 2 into F=72 (not a
# multiple of the filter tile) over a prime 23x23 output of more than one
# 128-pixel tile; a prime H_out of 137 into F=130 (two filter tiles, the
# second ragged); split-K at conv6_2's shape (18,18,512) -> 512; split-K
# with a ragged channel slice (C=72) and F=200; bf16's 256-pixel tile,
# ragged in pixels and filters (2 x 132 x 132 outputs, F=72)
SHAPES = [
    (18, 16, 8, 16, 3, 1), (33, 16, 4, 8, 3, 2), (16, 12, 3, 5, 1, 1),
    (23, 9, 6, 128, 7, 2), (12, 8, 16, 256, 3, 1), (9, 9, 2, 3, 5, 1),
    (17, 17, 18, 8, 3, 2), (8, 8, 32, 1, 1, 1), (15, 19, 5, 7, 3, 1),
    (21, 13, 6, 9, 3, 2),
    (47, 47, 18, 72, 3, 2), (139, 9, 16, 130, 3, 1),
    (18, 18, 512, 512, 3, 1), (12, 12, 72, 200, 3, 1),
    (134, 134, 8, 72, 3, 1),
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(h, w, c, f, k, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((k, k, c, f)) * 0.1).astype(np.float32)
    return x, wt


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,f,k,s", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain(cuda, h, w, c, f, k, s, dtype):
    x, wt = _inputs(h, w, c, f, k)
    tdt = getattr(torch, dtype)
    xd = torch.from_numpy(x).to(cuda, tdt)
    wd = torch.from_numpy(wt).to(cuda, tdt)
    p = tconv.plan(xd.shape, wd.shape, s, tdt)
    before = tconv.conv2d.launches
    got = ops.conv2d(xd, wd, stride=s)
    torch.cuda.synchronize()
    assert tconv.conv2d.launches == before + 1
    assert got.dtype == tdt and got.is_cuda
    want = conv2d_ref(xd, wd, stride=s)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype],
                               err_msg=str(p))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,f,k,s", [
    (17, 17, 18, 8, 3, 2), (8, 8, 32, 1, 1, 1), (21, 13, 6, 9, 3, 2),
    (18, 18, 512, 512, 3, 1)])
def test_function_grads_match_plain(cuda, h, w, c, f, k, s):
    x, wt = _inputs(h, w, c, f, k, seed=1)
    grads = []
    for fwd in (lambda a, b: tconv.Conv2d.apply(a, b, s),
                lambda a, b: conv2d_ref(a, b, stride=s)):
        a = torch.from_numpy(x).to(cuda).requires_grad_()
        b = torch.from_numpy(wt).to(cuda).requires_grad_()
        y = fwd(a, b)
        g = torch.linspace(-1, 1, y.numel(), device=cuda).reshape(y.shape)
        (y * g).sum().backward()
        grads.append((a.grad.cpu().numpy(), b.grad.cpu().numpy()))
    for got, want in zip(grads[0], grads[1]):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", [1, 2])
def test_interior_first_is_bit_identical_at_mesh1k_shapes(cuda, dtype,
                                                          model):
    """The tile order is a pure reorder: at every mesh1k conv, batch 2, on
    one device and on a 2-way H shard (halo rows included), the output
    with `interior_first` equals the plain order's bit for bit."""
    from repro_torch.models.cnn import meshnet
    from repro_torch.utils import same_pads
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(7)
    for name, c, hw, f, k, s in meshnet.layer_geometry(meshnet.MESH1K):
        lo, hi = same_pads(k, s)
        x = torch.randn((2, hw // model + lo + hi, hw + lo + hi, c),
                        generator=gen, device=cuda).to(tdt)
        w = (torch.randn((k, k, c, f), generator=gen, device=cuda)
             * 0.1).to(tdt)
        plain = tconv.conv2d(x, w, stride=s)
        first = tconv.conv2d(x, w, stride=s, interior_first=True)
        torch.cuda.synchronize()
        assert torch.equal(plain, first), name


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,f,k,s", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulation_matches_the_kernel(cuda, h, w, c, f, k, s, dtype):
    """The CPU emulation of the tiling against the kernel on the card, at
    the kernel's tolerance."""
    x, wt = _inputs(h, w, c, f, k)
    tdt = getattr(torch, dtype)
    xd = torch.from_numpy(x).to(cuda, tdt)
    wd = torch.from_numpy(wt).to(cuda, tdt)
    got = tconv.conv2d(xd, wd, stride=s, interior_first=True)
    torch.cuda.synchronize()
    emu = tconv.conv2d_emulated(xd.cpu(), wd.cpu(), stride=s,
                                interior_first=True)
    np.testing.assert_allclose(got.float().cpu().numpy(), emu.float().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(1, 6, 6, 4, device=cuda)
    w = torch.zeros(3, 3, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tconv.conv2d(x.permute(0, 2, 1, 3), w)
    with pytest.raises(TypeError):
        tconv.conv2d(x.half(), w.half())
    with pytest.raises(ValueError):
        tconv.conv2d(x, w.cpu())


@pytest.mark.cuda
def test_smoke_training_runs_through_the_kernel(cuda):
    argv = ["--arch", "mesh1k", "--smoke", "--steps", "2", "--batch", "2",
            "--log-every", "1"]
    ops.reset_launch_counts()
    on_card = train_cli.main(argv + ["--device", "cuda"])
    assert ops.launch_counts()["conv2d"] == 4 * 2     # 4 convs x 2 steps
    on_cpu = train_cli.main(argv + ["--device", "cpu"])
    assert ops.launch_counts()["conv2d"] == 4 * 2
    np.testing.assert_allclose(on_card["losses"], on_cpu["losses"],
                               rtol=1e-4)


# (b, sq, hq, hkv, d, causal, window, softcap): hymba's smoke and GQA g=5
# with its window at a cut length, ragged S, D up to 128, no causality;
# then hymba's full shape (causal, and window 1024), Sq at the 128-query
# tile's edges (127, 129), a window smaller than one key tile (5) and one
# that straddles two (70), and head dims that are not whole 16-byte rows
# (bf16 D = 20 and f32 D = 6 take the fma path with element copies); then
# gemma2's D = 256 (four swizzle atoms on wgmma, 64-query tiles on fma):
# its heads 16 / 8 under causality, window and its softcap of 50, ragged
# and bidirectional, D = 200 (padded to 256) and D = 250 (bf16 on fma)
ATTN = [
    (1, 128, 4, 2, 16, True, 16, None), (2, 100, 6, 3, 32, True, None, None),
    (1, 200, 25, 5, 64, True, 64, None), (1, 96, 5, 1, 64, True, 37, 30.0),
    (1, 64, 4, 4, 128, False, None, None), (2, 70, 2, 1, 8, False, 5, None),
    (1, 1, 2, 2, 64, True, None, None),
    (1, 2048, 25, 5, 64, True, None, None),
    (1, 2048, 25, 5, 64, True, 1024, None),
    (1, 127, 5, 1, 64, True, None, None), (2, 129, 4, 2, 128, True, 70, None),
    (1, 129, 25, 5, 64, True, 5, None), (1, 200, 2, 1, 64, False, 70, None),
    (1, 65, 3, 1, 20, True, None, None), (1, 33, 2, 2, 6, False, None, 20.0),
    (1, 1024, 16, 8, 256, True, None, 50.0),
    (1, 1024, 16, 8, 256, True, 300, 50.0),
    (2, 129, 4, 2, 256, True, 70, None), (1, 200, 2, 1, 256, False, None, None),
    (1, 130, 3, 1, 200, True, None, 30.0), (1, 70, 2, 2, 250, True, 5, None),
]


def _attn_inputs(b, sq, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, sq, hkv, d), (b, sq, hkv, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,hq,hkv,d,causal,window,cap", ATTN)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain(cuda, b, sq, hq, hkv, d, causal, window,
                                    cap, dtype):
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(cuda, tdt)
               for a in _attn_inputs(b, sq, hq, hkv, d))
    opts = dict(causal=causal, window=window, softcap=cap)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, **opts)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    assert got.dtype == tdt and got.shape == q.shape
    want = flash_attention_ref(q, k, v, **opts)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    if dtype == "bfloat16":
        # element by element: rounding each P (relative 2^-8) and the
        # output (2^-8 |o|) to bf16 moves an element by at most 2^-8 (A +
        # |o32|), o32 the plain version in fp32 on the same bf16 inputs
        # and A = softmax(S).|v|; the limit is one bf16 ulp of that sum.
        # Unlike TOL's 3e-2 it sees a lost key in a long row, where the
        # output is a small average.
        q, k, v = q.float(), k.float(), v.float()
        o32 = flash_attention_ref(q, k, v, **opts)
        limit = 2.0 ** -7 * (flash_attention_ref(q, k, v.abs(), **opts)
                             + o32.abs())
        worst = float(((got.float() - o32).abs() / limit).max())
        assert worst <= 1.0, f"an element is {worst} x its limit"


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,hq,hkv,d,causal,window,cap", ATTN)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_emulation_matches_the_kernel(cuda, b, sq, hq, hkv, d, causal,
                                            window, cap, dtype):
    """`flash_attention_emulated`, the CPU emulation of the kernel's
    tiling (tests/test_torch_attention_emulation.py), run on the card on
    the kernel's inputs, agrees with the kernel at TOL."""
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(cuda, tdt)
               for a in _attn_inputs(b, sq, hq, hkv, d))
    opts = dict(causal=causal, window=window, softcap=cap)
    got = tfa.flash_attention(q, k, v, **opts)
    emu = tfa.flash_attention_emulated(q, k, v, **opts)
    torch.cuda.synchronize()
    assert not torch.isnan(emu.float()).any()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               emu.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,hq,hkv,d,causal,window,cap",
                         [a for a in ATTN if a[4] == 64])
def test_flash_bf16_at_d64_runs_on_wgmma(cuda, b, sq, hq, hkv, d, causal,
                                         window, cap):
    """The bf16 rows at D = 64 take the tensor-core path, and it agrees
    with the plain version within the bf16 tolerance."""
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16)
               for a in _attn_inputs(b, sq, hq, hkv, d, seed=3))
    p = tfa.plan(tuple(q.shape), tuple(k.shape), torch.bfloat16, causal,
                 window)
    assert (p.path, p.d_pad, p.tile_q, p.tile_k) == ("wgmma", 64, 128, 64)
    opts = dict(causal=causal, window=window, softcap=cap)
    got = tfa.flash_attention(q, k, v, **opts)
    want = flash_attention_ref(q, k, v, **opts)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,hq,hkv,d,causal,window,cap",
                         [ATTN[0], ATTN[2], ATTN[3]])
def test_flash_function_grads_match_plain(cuda, b, sq, hq, hkv, d, causal,
                                          window, cap):
    arrays = _attn_inputs(b, sq, hq, hkv, d, seed=1)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (b, sq, hq, d)).astype(np.float32)).to(cuda)
    grads = []
    for fwd in (ops.flash_attention, flash_attention_ref):
        ts = [torch.from_numpy(a).to(cuda).requires_grad_() for a in arrays]
        (fwd(*ts, causal=causal, window=window, softcap=cap) * g).sum() \
            .backward()
        grads.append([t.grad.cpu().numpy() for t in ts])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


# (b, l, h, p, n, chunk): hymba's smoke, the chunk shrink (96 -> 48),
# hymba's 50 heads over blocks of 2, mamba2's cl 128 x n 128, tiny extents,
# a chunk of 40 (a masked partial tile) at p 4 (no 16-byte bf16 rows), a
# chunk of 96 in the 128-row CTA
SSD = [
    (2, 128, 8, 16, 8, 64), (1, 96, 5, 64, 16, 48), (1, 128, 50, 64, 16, 64),
    (1, 256, 6, 64, 128, 128), (2, 64, 3, 8, 4, 16), (1, 8, 1, 1, 1, 1),
    (1, 80, 3, 4, 4, 40), (1, 192, 5, 64, 64, 96),
]


# the block call (ring attention's tile): (b, s, hq, hkv, d, delta,
# window, softcap) with Sq = Sk = s; the off-diagonal window blocks have
# rows that see no key, and at delta -s (a later shard's block) none does
BLOCKS = [
    (1, 300, 4, 2, 64, 0, None, None),
    (2, 200, 6, 3, 32, 200, None, None),
    (1, 256, 5, 1, 64, 256, 200, 30.0),
    (1, 129, 3, 1, 20, 129, 129, None),
    (1, 150, 2, 2, 128, -150, None, None),
    (1, 256, 16, 8, 256, 256, 200, 50.0),
    (1, 130, 4, 2, 256, 0, None, 50.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hq,hkv,d,delta,window,cap", BLOCKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_block_kernel_matches_plain_and_emulation(cuda, b, s, hq, hkv,
                                                        d, delta, window,
                                                        cap, dtype):
    """`flash_attention_block`: o in fp32 and lse against the plain
    version and the emulation on the rows that see a key (o at TOL, lse at
    2e-5); every other row's lse <= -1e29 and its o finite; one launch."""
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(cuda, tdt)
               for a in _attn_inputs(b, s, hq, hkv, d, seed=4))
    opts = dict(delta=delta, window=window, softcap=cap)
    before = tfa.flash_attention.launches
    o, lse = tfa.flash_attention_block(q, k, v, **opts)
    assert tfa.flash_attention.launches == before + 1
    assert o.dtype == lse.dtype == torch.float32
    assert lse.shape == (b, hq, s)
    want_o, want_lse = flash_attention_ref(q, k, v, return_lse=True, **opts)
    emu_o, emu_lse = tfa.flash_attention_emulated(q, k, v, return_lse=True,
                                                  **opts)
    seen = (want_lse[0, 0] > -1e29).cpu()
    assert bool(torch.isfinite(o).all())
    assert bool((lse[..., ~seen.to(cuda)] <= -1e29).all())
    for wo, wl in ((want_o, want_lse), (emu_o, emu_lse)):
        np.testing.assert_allclose(o[:, seen].cpu().numpy(),
                                   wo[:, seen].cpu().numpy(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
        np.testing.assert_allclose(lse[..., seen].cpu().numpy(),
                                   wl[..., seen].cpu().numpy(),
                                   rtol=2e-5, atol=2e-5)


def _ssd_inputs(b, l, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, h, p)).astype(np.float32) * 0.5,
            -rng.uniform(0.01, 0.5, (b, l, h)).astype(np.float32),
            rng.standard_normal((b, l, n)).astype(np.float32) * 0.5,
            rng.standard_normal((b, l, n)).astype(np.float32) * 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,p,n,chunk", SSD)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_matches_plain(cuda, b, l, h, p, n, chunk, dtype):
    tdt = getattr(torch, dtype)
    xdt, la, B, C = _ssd_inputs(b, l, h, p, n)
    xdt, B, C = (torch.from_numpy(a).to(cuda, tdt) for a in (xdt, B, C))
    la = torch.from_numpy(la).to(cuda)
    before = tssd.ssd_chunk.launches
    y, S = tssd.ssd_chunk(xdt, la, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert tssd.ssd_chunk.launches == before + 1
    assert y.dtype == tdt and S.dtype == torch.float32
    assert S.shape == (b, l // chunk, h, p, n)
    yr, Sr = ssd_chunked_ref(xdt, la, B, C, chunk)
    for got, want in ((y, yr), (S, Sr)):
        want = want.float().cpu().numpy()
        # at mamba2's cl 128 x n 128 an output sums ~16k products in
        # another order, so the absolute floor scales with the largest
        np.testing.assert_allclose(
            got.float().cpu().numpy(), want, rtol=TOL[dtype],
            atol=TOL[dtype] * max(1.0, float(np.abs(want).max())))


@pytest.mark.cuda
@pytest.mark.parametrize("h,n,chunk", [(50, 16, 64), (48, 128, 128)])
def test_ssd_bf16_within_the_element_limit(cuda, h, n, chunk):
    """hymba's and mamba2's shapes at batch 1 x 2048 on the model's inputs
    (la = softplus(dt) * -A, A over linspace(1, 16)): every bf16 output
    element within 2^-7 |y32| + 2^-12 |M|.|xdt| (`ssd.elem_limit`), y32
    the plain version in fp32 on the same inputs, beside the unchanged
    TOL; S within the f32 tolerance.  Rounding M to bf16 alone would break
    the first, the hi/lo split keeps to it."""
    rng = np.random.default_rng(4)
    b, l, p = 1, 2048, 64
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h))))
    la = torch.from_numpy((-dt * np.linspace(1.0, 16.0, h))
                          .astype(np.float32)).to(cuda)
    xdt, B, C = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                  * 0.5).to(cuda, torch.bfloat16)
                 for s in ((b, l, h, p), (b, l, n), (b, l, n)))
    assert tssd.plan(chunk, n, torch.bfloat16).path == "mma"
    y, S = tssd.ssd_chunk(xdt, la, B, C, chunk=chunk)
    yr, Sr = ssd_chunked_ref(xdt, la, B, C, chunk)
    y32, limit = tssd.elem_limit(xdt, la, B, C, chunk)
    worst = float(((y.float() - y32).abs() / limit).max())
    assert worst <= 1.0, f"an element is {worst} x its limit"
    for got, want, tol in ((y, yr, TOL["bfloat16"]),
                           (S, Sr, TOL["float32"])):
        want = want.float().cpu().numpy()
        np.testing.assert_allclose(
            got.float().cpu().numpy(), want, rtol=tol,
            atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,p,n,chunk", [SSD[0], SSD[1], SSD[3]])
def test_ssd_function_grads_match_plain(cuda, b, l, h, p, n, chunk):
    arrays = _ssd_inputs(b, l, h, p, n, seed=1)
    rng = np.random.default_rng(2)
    gy = torch.from_numpy(rng.standard_normal((b, l, h, p)).astype(
        np.float32)).to(cuda)
    gS = torch.from_numpy(rng.standard_normal((b, l // chunk, h, p, n))
                          .astype(np.float32)).to(cuda)
    grads = []
    for fwd in (lambda *a: ops.ssd_chunk(*a, chunk=chunk),
                lambda *a: ssd_chunked_ref(*a, chunk)):
        ts = [torch.from_numpy(a).to(cuda).requires_grad_() for a in arrays]
        y, S = fwd(*ts)
        ((y * gy).sum() + (S * gS).sum()).backward()
        grads.append([t.grad.cpu().numpy() for t in ts])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.cuda
def test_attention_and_ssd_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                            q.transpose(1, 2))
    with pytest.raises(ValueError, match="head dim 264 > 256"):
        big = torch.zeros(1, 8, 2, 264, device=cuda)
        tfa.flash_attention(big, big, big)
    with pytest.raises(TypeError):
        tfa.flash_attention(q.half(), q.half(), q.half())
    x = torch.zeros(1, 8, 2, 4, device=cuda)
    la = torch.zeros(1, 8, 2, device=cuda)
    bc = torch.zeros(1, 8, 3, device=cuda)
    with pytest.raises(ValueError, match="chunk"):
        tssd.ssd_chunk(x, la, bc, bc, chunk=3)
    with pytest.raises(ValueError, match="state"):
        wide = torch.zeros(1, 8, 129, device=cuda)
        tssd.ssd_chunk(x, la, wide, wide, chunk=8)


@pytest.mark.cuda
def test_hymba_smoke_training_runs_through_the_kernels(cuda):
    argv = ["--arch", "hymba-1.5b", "--smoke", "--steps", "2", "--batch",
            "2", "--seq", "128", "--log-every", "1"]
    ops.reset_launch_counts()
    on_card = train_cli.main(argv + ["--device", "cuda"])
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 5 * 2    # 5 layers x 2 steps
    assert counts["ssd_chunk"] == 5 * 2
    on_cpu = train_cli.main(argv + ["--device", "cpu"])
    assert ops.launch_counts() == counts
    np.testing.assert_allclose(on_card["losses"], on_cpu["losses"],
                               rtol=1e-4)
