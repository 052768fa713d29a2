"""The port's kernel modules against the reference's Pallas kernels.

On the CPU, `repro_torch.kernels.ops` runs each kernel's plain version;
the same numpy inputs go through the reference's Pallas kernel in
`interpret=True` mode and through its jnp oracle.  Tolerances are the
reference's own sweep's: 2e-5 in f32, 3e-2 in bf16 (one bf16 rounding of
the output).  The compiled kernels are held against the plain versions in
tests/test_torch_cuda.py, which needs the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.conv2d import conv2d as pallas_conv2d
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.ssd import ssd_chunk as pallas_ssd
from repro_torch.kernels import _build, ops
from repro_torch.kernels import conv2d as tconv
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssd as tssd
from repro_torch.kernels.ref import conv2d_ref, ssd_chunk_ref

torch.set_num_threads(2)

# tests/test_kernels.py's sweep, then the meshnet edge shapes: C=18 at
# stride 2 (first layer), the F=1 1x1 pred conv, a prime H_out and W_out,
# and a stride-2 layer with odd extents
SHAPES = [
    (18, 16, 8, 16, 3, 1), (33, 16, 4, 8, 3, 2), (16, 12, 3, 5, 1, 1),
    (23, 9, 6, 128, 7, 2), (12, 8, 16, 256, 3, 1), (9, 9, 2, 3, 5, 1),
    (17, 17, 18, 8, 3, 2), (8, 8, 32, 1, 1, 1), (15, 19, 5, 7, 3, 1),
    (21, 13, 6, 9, 3, 2),
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(h, w, c, f, k, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((k, k, c, f)) * 0.1).astype(np.float32)
    return x, wt


@pytest.mark.parametrize("h,w,c,f,k,s", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv2d_matches_pallas(h, w, c, f, k, s, dtype):
    x, wt = _inputs(h, w, c, f, k)
    want = pallas_conv2d(jnp.asarray(x, dtype), jnp.asarray(wt, dtype),
                         stride=s, interpret=True)
    tdt = getattr(torch, dtype)
    got = ops.conv2d(torch.from_numpy(x).to(tdt),
                     torch.from_numpy(wt).to(tdt), stride=s)
    assert got.dtype == tdt
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("h,w,c,f,k,s", [
    (18, 16, 8, 16, 3, 1), (17, 17, 18, 8, 3, 2), (8, 8, 32, 1, 1, 1),
    (21, 13, 6, 9, 3, 2)])
def test_conv2d_function_grads_match_jax(h, w, c, f, k, s):
    """The autograd Function's dx and dw (PyTorch's conv gradients) against
    jax.grad of the reference oracle, through a random cotangent.  fp32
    sums of at most K*K*max(C, F) terms: rtol/atol 2e-5."""
    x, wt = _inputs(h, w, c, f, k, seed=1)
    ho, wo = (h - k) // s + 1, (w - k) // s + 1
    g = np.random.default_rng(2).standard_normal((2, ho, wo, f)) \
        .astype(np.float32)
    jdx, jdw = jax.grad(
        lambda a, b: jnp.sum(jref.conv2d_ref(a, b, stride=s) * g),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(wt))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(wt).requires_grad_()
    y = tconv.Conv2d.apply(tx, tw, s)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw),
                               rtol=2e-5, atol=2e-5)


def test_conv2d_ref_matches_jax_oracle():
    """The plain version against the reference's plain version at a
    stride-2 SAME-padded meshnet head shape."""
    x, wt = _inputs(33, 33, 18, 16, 3, seed=3)
    want = jref.conv2d_ref(jnp.asarray(x), jnp.asarray(wt), stride=2)
    got = conv2d_ref(torch.from_numpy(x), torch.from_numpy(wt), stride=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bad", ["rank", "dtype", "channels", "layout",
                                 "stride", "small"])
def test_conv2d_checks_raise(bad):
    x = torch.zeros(1, 6, 6, 4)
    w = torch.zeros(3, 3, 4, 8)
    s = 1
    if bad == "rank":
        x = x[0]
    elif bad == "dtype":
        x, w = x.double(), w.double()
    elif bad == "channels":
        w = torch.zeros(3, 3, 5, 8)
    elif bad == "layout":
        x = x.permute(0, 2, 1, 3)
    elif bad == "stride":
        s = 0
    elif bad == "small":
        w = torch.zeros(7, 7, 4, 8)
    with pytest.raises((ValueError, TypeError)):
        ops.conv2d(x, w, stride=s)


# mesh1k's first conv (C = 18 at stride 2), conv1_2, conv3_2, conv6_2 and
# the 1x1 pred conv (F = 1), at batch 2 with the SAME padding applied
CONV1_1 = ((2, 1025, 1025, 18), (3, 3, 18, 64), 2)
CONV1_2 = ((2, 514, 514, 64), (3, 3, 64, 64), 1)
CONV3_2 = ((2, 130, 130, 256), (3, 3, 256, 256), 1)
CONV6_2 = ((2, 18, 18, 512), (3, 3, 512, 512), 1)
PRED = ((2, 16, 16, 512), (1, 1, 512, 1), 1)


@pytest.mark.parametrize("dtype,c_pad,f_pad,path", [
    (torch.bfloat16, 24, 8, "wgmma"), (torch.float32, 20, 4, "fma")])
def test_conv2d_plan_pads_channels_and_filters(dtype, c_pad, f_pad, path):
    """C pads to a multiple of 8 (bf16) or 4 (f32), and so does the 1x1
    pred weight's F = 1, so that every copy is 16 aligned bytes."""
    p = tconv.plan(*CONV1_1[:2], CONV1_1[2], dtype)
    assert (p.path, p.c_pad, p.f_pad, p.tile_n) == (path, c_pad, 64, 64)
    q = tconv.plan(*PRED[:2], PRED[2], dtype)
    assert (q.c_pad, q.f_pad, q.tile_n) == (512, f_pad, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv2d_plan_splits_k_only_where_tiles_underfill(dtype):
    """conv6_2 at batch 2 makes 16 tiles of 128 x 128: its K steps are
    split until the CTAs fill a wave; conv1_2's 4096 tiles are not."""
    p = tconv.plan(*CONV6_2[:2], CONV6_2[2], dtype)
    tiles = -(-2 * 16 * 16 // p.tile_m) * -(-512 // p.tile_n)
    assert tiles == 16 and p.splits > 1
    assert tiles * p.splits >= tconv.SMS
    ksteps = 9 * 512 // p.tile_k
    assert ksteps // p.splits >= 8
    assert tconv.plan(*CONV1_2[:2], CONV1_2[2], dtype).splits == 1
    # bf16 takes 256 x 128 tiles where they still fill a wave (conv3_2)
    q = tconv.plan(*CONV3_2[:2], CONV3_2[2], dtype)
    assert (q.tile_m, q.tile_n) == (256 if dtype == torch.bfloat16 else 128,
                                    128)
    assert p.tile_m == 128


@pytest.mark.parametrize("h,w,c,f,k,s", [
    (17, 17, 18, 8, 3, 2), (8, 8, 32, 1, 1, 1), (15, 19, 5, 7, 3, 1),
    (12, 12, 3, 72, 3, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero_padding_leaves_the_plain_result_bit_equal(h, w, c, f, k, s,
                                                        dtype):
    """The wrapper's zero channels and filters change nothing: the plain
    version on the padded operands, cut back to F, equals it on the
    originals bit for bit.  Integer-valued inputs keep every partial sum
    exact, so no summation order can tell the two apart."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(-3, 4, (2, h, w, c))
                         .astype(np.float32)).to(dtype)
    wt = torch.from_numpy(rng.integers(-3, 4, (k, k, c, f))
                          .astype(np.float32)).to(dtype)
    p = tconv.plan(tuple(x.shape), tuple(wt.shape), s, dtype)
    xp, wp = tconv.pad_operands(x, wt, p)
    assert xp.shape[3] == wp.shape[2] == p.c_pad and wp.shape[3] == p.f_pad
    assert (p.c_pad, p.f_pad) != (c, f)
    want = conv2d_ref(x, wt, stride=s)
    got = conv2d_ref(xp, wp, stride=s)[..., :f]
    assert torch.equal(got, want)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never falls back to the plain version: a CPU
    tensor raises, and the launch count stays put."""
    before = tconv.conv2d.launches
    with pytest.raises(ValueError, match="CUDA"):
        tconv.conv2d(torch.zeros(1, 4, 4, 4), torch.zeros(3, 3, 4, 4))
    assert tconv.conv2d.launches == before
    ops.conv2d(torch.zeros(1, 4, 4, 4), torch.zeros(3, 3, 4, 4))
    assert ops.launch_counts()["conv2d"] == before


def test_build_command_and_cache_key(monkeypatch, tmp_path):
    """nvcc is asked for sm_90a, a shared library, and the ptxas report;
    the library name changes with the source."""
    cmd = _build.nvcc_command("nvcc", _build.CSRC / "conv2d.cu",
                              tmp_path / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    p1 = _build.library_path("conv2d")
    assert p1.parent == _build.BUILD_DIR and p1.suffix == ".so"
    src = tmp_path / "conv2d.cu"
    src.write_text("// changed\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.library_path("conv2d") != p1


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


# (b, sq, hq, hkv, d, causal, window, softcap): GQA g = 1, 2, 5; ragged S
# (the Pallas kernel shrinks its blocks to divisors); both masks; softcap
ATTN = [
    (2, 64, 4, 4, 16, True, None, None), (1, 50, 4, 2, 32, True, 7, None),
    (1, 70, 10, 2, 16, True, 16, 30.0), (2, 48, 5, 1, 8, False, None, None),
    (1, 33, 6, 3, 16, False, 5, 20.0),
]


def _attn_inputs(b, sq, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, sq, hkv, d), (b, sq, hkv, d))]


@pytest.mark.parametrize("b,sq,hq,hkv,d,causal,window,cap", ATTN)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas_and_oracle(b, sq, hq, hkv, d, causal,
                                                   window, cap, dtype):
    arrays = _attn_inputs(b, sq, hq, hkv, d)
    opts = dict(causal=causal, window=window, softcap=cap)
    jin = [jnp.asarray(a, dtype) for a in arrays]
    kernel = pallas_flash(*jin, block_q=32, block_k=32, interpret=True,
                          **opts)
    oracle = jref.flash_attention_ref(*jin, **opts)
    tdt = getattr(torch, dtype)
    got = ops.flash_attention(*(torch.from_numpy(a).to(tdt)
                                for a in arrays), **opts)
    assert got.dtype == tdt and tuple(got.shape) == kernel.shape
    for want in (kernel, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype,d,path,tile_q,tile_k,d_pad,stages", [
    (torch.bfloat16, 8, "wgmma", 128, 64, 64, 2),
    (torch.bfloat16, 16, "wgmma", 128, 64, 64, 2),
    (torch.bfloat16, 64, "wgmma", 128, 64, 64, 2),
    (torch.bfloat16, 80, "wgmma", 128, 64, 128, 2),
    (torch.bfloat16, 128, "wgmma", 128, 64, 128, 2),
    (torch.bfloat16, 20, "fma", 128, 64, 64, 2),
    (torch.bfloat16, 126, "fma", 128, 64, 128, 1),
    (torch.float32, 8, "fma", 128, 64, 64, 2),
    (torch.float32, 16, "fma", 128, 64, 64, 2),
    (torch.float32, 64, "fma", 128, 64, 64, 2),
    (torch.float32, 80, "fma", 128, 64, 128, 1),
    (torch.float32, 128, "fma", 128, 64, 128, 1),
])
def test_flash_attention_plan_path_and_tiles(dtype, d, path, tile_q, tile_k,
                                             d_pad, stages):
    """bf16 with 16-byte rows (D % 8 == 0) runs on wgmma, D padded to one
    64-column swizzle atom or two; f32 and any other bf16 D run on FMAs,
    with one K/V stage where D pads to 128 (shared memory).  Both tile
    128 queries x 64 keys."""
    p = tfa.plan((1, 2048, 25, d), (1, 2048, 5, d), dtype, True, 1024)
    assert (p.path, p.tile_q, p.tile_k, p.d_pad, p.stages) == \
        (path, tile_q, tile_k, d_pad, stages)
    assert p.d_pad >= d


def test_flash_attention_plan_is_cached_and_orders_causal_tiles():
    """The plan is pure and cached: the same arguments give the same
    object without recomputing; only causality changes the launch order,
    and the window changes nothing."""
    tfa.plan.cache_clear()
    args = ((1, 2048, 25, 64), (1, 2048, 5, 64), torch.bfloat16)
    p = tfa.plan(*args, True, 1024)
    assert tfa.plan(*args, True, 1024) is p
    info = tfa.plan.cache_info()
    assert (info.hits, info.misses) == (1, 1)
    assert p.order == "longest-first"
    assert tfa.plan(*args, True, None) == p
    assert tfa.plan(*args, False, None).order == "in-order"
    assert dataclasses.replace(tfa.plan(*args, False, None),
                               order="longest-first") == p


# (b, l, h, p, n, chunk): the reference sweep's shapes and a 48-step chunk
SSD = [(2, 64, 4, 16, 8, 16), (1, 96, 3, 8, 4, 48), (2, 48, 2, 32, 4, 8),
       (1, 32, 8, 8, 16, 32)]


def _ssd_inputs(b, l, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, h, p)).astype(np.float32) * 0.5,
            -rng.uniform(0.01, 0.5, (b, l, h)).astype(np.float32),
            rng.standard_normal((b, l, n)).astype(np.float32) * 0.5,
            rng.standard_normal((b, l, n)).astype(np.float32) * 0.5)


@pytest.mark.parametrize("b,l,h,p,n,chunk", SSD)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_matches_pallas_and_oracle(b, l, h, p, n, chunk, dtype):
    """ops.ssd_chunk (the plain version on the CPU) against the Pallas
    kernel over the whole sequence, and the single-chunk plain version
    against the reference's oracle chunk by chunk."""
    xdt, la, B, C = _ssd_inputs(b, l, h, p, n)
    tdt = getattr(torch, dtype)
    jx, jB, jC = (jnp.asarray(a, dtype) for a in (xdt, B, C))
    ky, ks = pallas_ssd(jx, jnp.asarray(la), jB, jC, chunk=chunk,
                        interpret=True)
    tx, tB, tC = (torch.from_numpy(a).to(tdt) for a in (xdt, B, C))
    tla = torch.from_numpy(la)
    y, S = ops.ssd_chunk(tx, tla, tB, tC, chunk=chunk)
    assert y.dtype == tdt and S.dtype == torch.float32
    assert tuple(y.shape) == ky.shape and tuple(S.shape) == ks.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(y.float().numpy(), np.asarray(ky, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(S.numpy(), np.asarray(ks), rtol=tol, atol=tol)
    for i in range(l // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        ry, rs = jref.ssd_chunk_ref(jx[:, sl], jnp.asarray(la)[:, sl],
                                    jB[:, sl], jC[:, sl])
        oy, os_ = ssd_chunk_ref(tx[:, sl], tla[:, sl], tB[:, sl], tC[:, sl])
        np.testing.assert_allclose(oy.float().numpy(),
                                   np.asarray(ry, np.float32),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(os_.numpy(), np.asarray(rs, np.float32),
                                   rtol=tol, atol=tol)


# (b, l, h, p, n, chunk) of the emulation: hymba's chunk 64, the chunk
# shrink's 40 (a masked partial tile), mamba2's chunk 128 at n 128, and
# one head or a few
SSD_EMU = [(1, 128, 2, 16, 16, 64), (1, 80, 3, 8, 8, 40),
           (1, 128, 1, 16, 128, 128), (2, 96, 1, 64, 16, 48)]


def _model_ssd_inputs(b, l, h, p, n, dtype, seed=0):
    """The model's SSD inputs at init: la = softplus(dt) * -A with A over
    linspace(1, 16), fp32 under bf16 too."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h))))
    la = torch.from_numpy((-dt * np.linspace(1.0, 16.0, h))
                          .astype(np.float32))
    xdt, B, C = (torch.from_numpy(
        rng.standard_normal(s).astype(np.float32) * 0.5).to(dtype)
        for s in ((b, l, h, p), (b, l, n), (b, l, n)))
    return xdt, la, B, C


@pytest.mark.parametrize("b,l,h,p,n,chunk", SSD_EMU)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_emulation_matches_pallas_and_oracle(b, l, h, p, n, chunk,
                                                 dtype):
    """The CPU emulation of the kernel's tiling (16-row tiles, upper tiles
    skipped, the partial tile masked, bf16 hi/lo splits) against the
    Pallas kernel in interpret mode and the plain version, at TOL; bf16
    also within the element-wise limit the kernel is held to on the
    card."""
    tdt = getattr(torch, dtype)
    xdt, la, B, C = _ssd_inputs(b, l, h, p, n)
    jx, jB, jC = (jnp.asarray(a, dtype) for a in (xdt, B, C))
    ky, ks = pallas_ssd(jx, jnp.asarray(la), jB, jC, chunk=chunk,
                        interpret=True)
    tx, tB, tC = (torch.from_numpy(a).to(tdt) for a in (xdt, B, C))
    tla = torch.from_numpy(la)
    y, S = tssd.ssd_chunk_emulated(tx, tla, tB, tC, chunk)
    assert y.dtype == tdt and S.dtype == torch.float32
    assert tuple(y.shape) == ky.shape and tuple(S.shape) == ks.shape
    yr, Sr = ops.ssd_chunk(tx, tla, tB, tC, chunk=chunk)
    tol = TOL[dtype]
    for want in (np.asarray(ky, np.float32), yr.float().numpy()):
        np.testing.assert_allclose(y.float().numpy(), want, rtol=tol,
                                   atol=tol)
    for want in (np.asarray(ks), Sr.numpy()):
        np.testing.assert_allclose(S.numpy(), want, rtol=TOL["float32"],
                                   atol=TOL["float32"])
    if dtype == "bfloat16":
        y32, limit = tssd.elem_limit(tx, tla, tB, tC, chunk)
        assert float(((y.float() - y32).abs() / limit).max()) <= 1.0


@pytest.mark.parametrize("b,l,h,p,n,chunk", [(1, 128, 4, 64, 16, 64),
                                             (1, 128, 2, 64, 128, 128)])
def test_ssd_emulation_without_the_low_part_exceeds_the_limit(b, l, h, p,
                                                              n, chunk):
    """Rounding M and xdt * w to bf16 alone (no low part) breaks the
    element-wise limit on y and the fp32 tolerance on S at hymba's and
    mamba2's chunk and state on the model's inputs; the split stays
    inside both."""
    xdt, la, B, C = _model_ssd_inputs(b, l, h, p, n, torch.bfloat16)
    y32, limit = tssd.elem_limit(xdt, la, B, C, chunk)
    _, Sr = ops.ssd_chunk(xdt, la, B, C, chunk=chunk)
    s_tol = TOL["float32"] * max(1.0, float(Sr.abs().max()))
    worst = {}
    for split in (True, False):
        y, S = tssd.ssd_chunk_emulated(xdt, la, B, C, chunk, split=split)
        worst[split] = (float(((y.float() - y32).abs() / limit).max()),
                        float((S - Sr).abs().max()))
    assert worst[True][0] <= 1.0 and worst[True][1] <= s_tol
    assert worst[False][0] > 1.0 and worst[False][1] > s_tol


@pytest.mark.parametrize("chunk,n,dtype,want", [
    (64, 16, torch.float32, ("fma", 64, 256, 4, 2, 2)),
    (64, 16, torch.bfloat16, ("mma", 64, 256, 4, 2, 2)),
    (48, 16, torch.bfloat16, ("mma", 64, 256, 3, 2, 2)),
    (40, 16, torch.float32, ("fma", 64, 256, 3, 2, 2)),
    (128, 128, torch.float32, ("fma", 128, 512, 8, 4, 2)),
    (128, 128, torch.bfloat16, ("mma", 128, 512, 8, 4, 2)),
    (96, 64, torch.bfloat16, ("mma", 128, 512, 6, 4, 2)),
    (1, 1, torch.float32, ("fma", 64, 256, 1, 2, 2)),
])
def test_ssd_plan_path_tiles_and_heads(chunk, n, dtype, want):
    """bf16 runs on mma.sync, f32 on FMAs; the CTA is built for a chunk of
    64 or 128 with four threads a row, 16-row tiles cover the chunk, two
    heads share G where it is cheap (n <= 32), else four."""
    p = tssd.plan(chunk, n, dtype)
    assert (p.path, p.chunk_tile, p.threads, p.row_tiles, p.heads,
            p.stages) == want
    assert tssd.plan(chunk, n, dtype) is p


@pytest.mark.parametrize("bad", ["rank", "gqa", "dtype", "layout", "window",
                                 "softcap", "head_dim", "unseen_rows"])
def test_flash_attention_checks_raise(bad):
    q = torch.zeros(1, 8, 4, 16)
    k = v = torch.zeros(1, 8, 2, 16)
    opts = dict(causal=True, window=None, softcap=None)
    if bad == "rank":
        q = q[0]
    elif bad == "gqa":
        k = v = torch.zeros(1, 8, 3, 16)
    elif bad == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "layout":
        q = torch.zeros(1, 4, 8, 16).transpose(1, 2)
    elif bad == "window":
        opts["window"] = 0
    elif bad == "softcap":
        opts["softcap"] = -1.0
    elif bad == "head_dim":     # every D is taken, q's and k's alike
        q = torch.zeros(1, 8, 4, 264)
        k = v = torch.zeros(1, 8, 2, 256)
    elif bad == "unseen_rows":  # rows that see no key as there is none:
        k = v = torch.zeros(1, 0, 2, 16)    # no mean of V to give them,
        opts["window"] = 4                  # the zero-extent refusal's one
        # case here (rows that the window alone leaves keyless are taken)
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention(q, k, v, **opts)


@pytest.mark.parametrize("bad", ["rank", "shape", "chunk", "big_chunk",
                                 "dtype", "state"])
def test_ssd_chunk_checks_raise(bad):
    x, la = torch.zeros(1, 16, 2, 4), torch.zeros(1, 16, 2)
    B = C = torch.zeros(1, 16, 3)
    chunk = 8
    if bad == "rank":
        la = la[0]
    elif bad == "shape":
        C = torch.zeros(1, 16, 5)
    elif bad == "chunk":
        chunk = 5
    elif bad == "big_chunk":    # any chunk that divides l; 256 does not
        chunk = 256
    elif bad == "dtype":
        B = B.to(torch.bfloat16)
    elif bad == "state":        # any n >= 1 is taken
        B = C = torch.zeros(1, 16, 0)
    with pytest.raises((ValueError, TypeError)):
        ops.ssd_chunk(x, la, B, C, chunk=chunk)


def test_attention_and_ssd_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never fall back to the plain version: a CPU
    tensor raises, and the launch counts stay put."""
    ops.reset_launch_counts()
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q, q)
    x, la, B = torch.zeros(1, 8, 2, 4), torch.zeros(1, 8, 2), \
        torch.zeros(1, 8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_chunk(x, la, B, B, chunk=8)
    ops.flash_attention(q, q, q)
    ops.ssd_chunk(x, la, B, B, chunk=8)
    assert ops.launch_counts() == {"conv2d": 0, "flash_attention": 0,
                                   "ssd_chunk": 0}


@pytest.mark.parametrize("name", ["flash_attention", "ssd"])
def test_every_kernel_source_builds_into_its_own_library(name):
    p = _build.library_path(name)
    assert p.name.startswith(name + "-") and p.parent == _build.BUILD_DIR
    assert (_build.CSRC / f"{name}.cu").exists()
