"""The kernels over every shape the Pallas kernels take: the SSD-chunk
kernel past chunk 128, head dim 64 and state 128 (its `wide` path) and
attention past head dim 256 (its `split` path), on the CPU.

The CPU emulations of the two new tilings (`ssd_chunk_emulated`,
`flash_attention_emulated`) are held against the reference's Pallas
kernels in `interpret=True` mode and against the plain versions, on the
same numpy inputs, at tests/test_torch_kernels.py's tolerances: 2e-5 in
f32, 3e-2 in bf16 (one bf16 rounding of the output), bf16 also element by
element within the limit the card's kernel is held to (`ssd.elem_limit`;
one bf16 ulp of softmax(S).|v| + |o32| for attention).  Then the slice at
SMOKE width: mamba2's loss at SSD chunk 256 and one attention layer at
head dim 320, the port against the reference on the reference's own
params carried over (loss rtol 1e-5 as tests/test_torch_moe.py; the
layer at 2e-5).  The kernels themselves are held against the plain
versions on the card in tests/test_torch_cuda.py (`SSD_WIDE`,
`ATTN_SPLIT`) and `chip_smoke.py`.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import registry as jreg
from repro.configs import hymba_1_5b as jhymba
from repro.data import pipeline as jpipe
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.ssd import ssd_chunk as pallas_ssd
from repro.models.lm import modules as jM
from repro.models.lm import transformer as jT
from repro_torch.configs.registry import get as treg_get
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd as tssd
from repro_torch.kernels.ref import flash_attention_ref, ssd_chunked_ref
from repro_torch.launch import train as train_cli
from repro_torch.models.lm import config as tconfig
from repro_torch.models.lm import modules as tM
from repro_torch.models.lm import transformer as tT

torch.set_num_threads(2)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}

# (b, l, h, p, n, chunk): mamba_ssm's chunk 256 at mamba2's p 64 / n 128;
# chunk 160 at p 128 / n 256 (two p slices, eight n slices, the last row
# block masked); chunk 136, not a multiple of 16
SSD = [(1, 512, 2, 64, 128, 256), (1, 320, 2, 128, 256, 160),
       (1, 272, 2, 16, 32, 136)]


def _ssd_inputs(b, l, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, h, p)).astype(np.float32) * 0.5,
            -rng.uniform(0.01, 0.5, (b, l, h)).astype(np.float32),
            rng.standard_normal((b, l, n)).astype(np.float32) * 0.5,
            rng.standard_normal((b, l, n)).astype(np.float32) * 0.5)


@pytest.mark.parametrize("b,l,h,p,n,chunk", SSD)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_ssd_emulation_matches_pallas_and_plain(b, l, h, p, n, chunk,
                                                     dtype):
    tdt = getattr(torch, dtype)
    xdt, la, B, C = _ssd_inputs(b, l, h, p, n)
    jx, jB, jC = (jnp.asarray(a, dtype) for a in (xdt, B, C))
    ky, ks = pallas_ssd(jx, jnp.asarray(la), jB, jC, chunk=chunk,
                        interpret=True)
    tx, tB, tC = (torch.from_numpy(a).to(tdt) for a in (xdt, B, C))
    tla = torch.from_numpy(la)
    pl = tssd.plan(chunk, n, tdt, p)
    assert (pl.path, pl.row_tiles) == ("wide", -(-chunk // 64))
    y, S = tssd.ssd_chunk_emulated(tx, tla, tB, tC, chunk)
    assert y.dtype == tdt and S.dtype == torch.float32
    assert tuple(y.shape) == ky.shape and tuple(S.shape) == ks.shape
    yr, Sr = ops.ssd_chunk(tx, tla, tB, tC, chunk=chunk)
    # at n 256 x chunk 160 an output sums some 40k products in another
    # order, so the absolute floor scales with the largest magnitude (as
    # tests/test_torch_cuda.py's SSD rows do)
    for got, want, tol in (
            (y, np.asarray(ky, np.float32), TOL[dtype]),
            (y, yr.float().numpy(), TOL[dtype]),
            (S, np.asarray(ks), TOL["float32"]),
            (S, Sr.numpy(), TOL["float32"])):
        np.testing.assert_allclose(
            got.float().numpy(), want, rtol=tol,
            atol=tol * max(1.0, float(np.abs(want).max())))
    if dtype == "bfloat16":
        y32, limit = tssd.elem_limit(tx, tla, tB, tC, chunk)
        assert float(((y.float() - y32).abs() / limit).max()) <= 1.0


@pytest.mark.parametrize("chunk,p,n,dtype,want", [
    (256, 64, 128, torch.float32, ("wide", 64, 256, 4, 1, 1, 1, 4)),
    (256, 64, 128, torch.bfloat16, ("wide", 64, 256, 4, 1, 1, 1, 4)),
    (160, 128, 256, torch.float32, ("wide", 64, 256, 3, 1, 1, 2, 8)),
    (136, 16, 32, torch.bfloat16, ("wide", 64, 256, 3, 1, 1, 1, 1)),
    (8, 65, 16, torch.float32, ("wide", 64, 256, 1, 1, 1, 2, 1)),
    (8, 4, 129, torch.bfloat16, ("wide", 64, 256, 1, 1, 1, 1, 5)),
    (128, 64, 128, torch.bfloat16, ("mma", 128, 512, 8, 4, 2, 1, 1)),
    (64, 1, 16, torch.float32, ("fma", 64, 256, 4, 2, 2, 1, 1)),
])
def test_ssd_plan_over_the_range(chunk, p, n, dtype, want):
    """The first path keeps every shape it was built for, p not changing
    its plan; a chunk past 128, p past 64 or n past 128 plans `wide`:
    64-row blocks, 256 threads, 64-column slices of p, 32 of n."""
    pl = tssd.plan(chunk, n, dtype, p)
    assert dataclasses.astuple(pl) == want
    assert tssd.first_path(chunk, p, n) == (want[0] != "wide")
    if want[0] != "wide":
        assert pl == tssd.plan(chunk, n, dtype)


def test_ssd_checks_take_the_range_and_refuse_the_rest():
    """chunk 256, p 65 and n 129 are taken; a chunk that does not divide
    l, an extent of 0, dtypes and contiguity are still refused."""
    x, la = torch.zeros(1, 512, 2, 65), torch.zeros(1, 512, 2)
    B = torch.zeros(1, 512, 129)
    tssd.check_args(x, la, B, B, 256)
    for chunk in (3, 0, 1024, 256.0):
        with pytest.raises(ValueError, match="divisor"):
            tssd.check_args(x, la, B, B, chunk)
    with pytest.raises(ValueError, match="extent"):
        tssd.check_args(x[..., :0], la, B, B, 256)
    with pytest.raises(TypeError):
        tssd.check_args(x.double(), la, B.double(), B.double(), 256)
    with pytest.raises(ValueError, match="contiguous"):
        tssd.check_args(x, la, B[..., ::2], B[..., ::2], 256)


# (b, sq, sk, hq, hkv, d, causal, window, softcap): D 264 causal with a
# window, D 320 bidirectional with Sq != Sk and GQA, D 512 with the
# softcap (two output slices each)
ATTN = [(1, 130, 130, 2, 2, 264, True, 70, None),
        (1, 100, 77, 6, 2, 320, False, None, None),
        (1, 96, 96, 4, 1, 512, True, None, 30.0)]


def _attn_inputs(b, sq, sk, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))]


def _ulp_worst(got, q, k, v, opts, rows=slice(None)) -> float:
    """The largest |got - o32| over one bf16 ulp of softmax(S).|v| +
    |o32|, o32 the plain version in fp32 on the same bf16 inputs."""
    q, k, v = q.float(), k.float(), v.float()
    o32 = flash_attention_ref(q, k, v, **opts)
    limit = 2.0 ** -7 * (flash_attention_ref(q, k, v.abs(), **opts)
                         + o32.abs())
    return float(((got.float() - o32).abs() / limit)[:, rows].max())


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,window,cap", ATTN)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_attention_emulation_matches_pallas_and_plain(
        b, sq, sk, hq, hkv, d, causal, window, cap, dtype):
    arrays = _attn_inputs(b, sq, sk, hq, hkv, d)
    opts = dict(causal=causal, window=window, softcap=cap)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays)
    p = tfa.plan(tuple(q.shape), tuple(k.shape), tdt, causal, window)
    assert (p.path, p.tile_q, p.tile_k, p.out_slices) == ("split", 64, 64, 2)
    got = tfa.flash_attention_emulated(q, k, v, **opts)
    assert got.dtype == tdt and got.shape == q.shape
    want = pallas_flash(*(jnp.asarray(a, dtype) for a in arrays),
                        interpret=True, **opts)
    plain = ops.flash_attention(q, k, v, **opts)
    for w in (np.asarray(want, np.float32), plain.float().numpy()):
        np.testing.assert_allclose(got.float().numpy(), w, rtol=TOL[dtype],
                                   atol=TOL[dtype])
    if dtype == "bfloat16":
        assert _ulp_worst(got, q, k, v, opts) <= 1.0


# (b, sq, hq, hkv, d, window, delta): the block entry at D 512 with the
# ring's offset, and one whose first 30 rows see no key of the block
BLOCKS = [(1, 96, 4, 2, 512, 150, 96), (1, 80, 2, 1, 320, 20, -30)]


@pytest.mark.parametrize("b,sq,hq,hkv,d,window,delta", BLOCKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_block_emulation_matches_plain(b, sq, hq, hkv, d, window,
                                             delta, dtype):
    """o (fp32) and each row's lse of a ring block on the split path
    against the plain version on the rows that see a key; the rest come
    back with lse <= -1e29 and a finite o."""
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(tdt)
               for a in _attn_inputs(b, sq, sq, hq, hkv, d, seed=1))
    opts = dict(causal=True, window=window, delta=delta)
    o, lse = tfa.flash_attention_emulated(q, k, v, return_lse=True, **opts)
    wo, wl = ops.flash_attention_block(q, k, v, **opts)
    assert o.dtype == lse.dtype == torch.float32
    seen = wl[0, 0] > -1e29
    assert bool(seen.any())
    assert bool((lse[..., ~seen] <= -1e29).all())
    assert bool(torch.isfinite(o).all())
    np.testing.assert_allclose(o[:, seen].numpy(), wo[:, seen].numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(lse[..., seen].numpy(), wl[..., seen].numpy(),
                               rtol=TOL["float32"], atol=TOL["float32"])
    if dtype == "bfloat16":
        assert _ulp_worst(o, q, k, v, opts, seen) <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_keyless_rows_match_the_reference(dtype):
    """A one-device call at D 320 whose rows 99.. see no key under the
    window: the mean of V there, as the reference's -1e30 masking gives
    (Pallas in interpret mode and the plain version)."""
    tdt = getattr(torch, dtype)
    arrays = _attn_inputs(1, 150, 60, 4, 2, 320, seed=2)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays)
    assert tfa.keyless_from(150, 60, 40) == 99
    got = tfa.flash_attention_emulated(q, k, v, window=40)
    want = pallas_flash(*(jnp.asarray(a, dtype) for a in arrays),
                        window=40, interpret=True)
    for w in (np.asarray(want, np.float32),
              ops.flash_attention(q, k, v, window=40).float().numpy()):
        np.testing.assert_allclose(got.float().numpy(), w, rtol=TOL[dtype],
                                   atol=TOL[dtype])


@pytest.mark.parametrize("d,want", [(257, (320, 2)), (264, (320, 2)),
                                    (512, (512, 2)), (513, (576, 3)),
                                    (1024, (1024, 4))])
def test_attention_plan_past_256(d, want):
    """D > 256 plans `split` in both dtypes and either causality: 64 x 64
    tiles, one stage, D staged in 64-column slices, ceil(D / 256) output
    slices; D 256 keeps its plan."""
    for dtype in (torch.float32, torch.bfloat16):
        p = tfa.plan((1, 300, 4, d), (1, 300, 2, d), dtype, True, None)
        assert (p.path, p.tile_q, p.tile_k, p.stages,
                (p.d_pad, p.out_slices)) == ("split", 64, 64, 1, want)
        assert tfa.plan((1, 300, 4, d), (1, 300, 2, d), dtype, False,
                        None).order == "in-order"
    assert tfa.plan((1, 300, 4, 256), (1, 300, 2, 256), torch.bfloat16,
                    True, None) == tfa.Plan("wgmma", 128, 64, 256, 2,
                                            "longest-first")


def _fake_flops(fn, *args):
    """(outputs, FLOPs, launches) of fn(*args) under FakeTensorMode on
    fake copies of the CPU tensors `args`."""
    ops.reset_launch_counts()
    with FakeTensorMode() as mode:
        fargs = [mode.from_tensor(a) for a in args]
        with FlopCounterMode(display=False) as counter:
            out = fn(*fargs)
    return out, counter.get_total_flops(), sum(ops.launch_counts().values())


def test_ops_trace_the_new_shapes():
    """The custom ops' fake implementations and FLOP formulas at chunk
    256 / p 128 / n 256 and D 512: a dry run's trace sees the plain
    versions' shapes and the formulas' FLOPs, and no launch."""
    g = torch.Generator().manual_seed(0)
    xdt, B = torch.randn(1, 512, 2, 128, generator=g), \
        torch.randn(1, 512, 256, generator=g)
    la = -torch.rand(1, 512, 2, generator=g)
    (y, S), flops, launches = _fake_flops(
        lambda *a: torch.ops.repro.ssd_chunk(*a, 256), xdt, la, B, B)
    want = ssd_chunked_ref(xdt, la, B, B, 256)
    assert [tuple(t.shape) for t in (y, S)] == \
        [tuple(t.shape) for t in want]
    assert (flops, launches) == (tssd.ssd_flops((1, 512, 2, 128), 256,
                                                256), 0)
    q = torch.randn(1, 80, 4, 512, generator=g)
    k = torch.randn(1, 80, 2, 512, generator=g)
    o, flops, launches = _fake_flops(
        lambda *a: torch.ops.repro.flash_attention(*a, True, 30, None, None),
        q, k, k)
    assert tuple(o.shape) == (1, 80, 4, 512)
    assert (flops, launches) == (4 * 4 * 512 * tfa.admitted_pairs(
        80, 80, True, 30), 0)
    (o, lse), flops, _ = _fake_flops(
        lambda *a: torch.ops.repro.flash_attention_block(
            *a, 40, True, None, None, None), q, k, k)
    assert (tuple(o.shape), tuple(lse.shape)) == ((1, 80, 4, 512),
                                                  (1, 4, 80))
    assert flops == 4 * 4 * 512 * tfa.admitted_pairs(80, 80, True, None, 40)


# ---------------------------------------------------------------- slice --

def _tcfg(jcfg):
    return tconfig.LMConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _mamba_params():
    return jax.tree.map(np.asarray, jT.init(
        jax.random.PRNGKey(0), jreg.get("mamba2_780m", smoke=True)))


@pytest.mark.parametrize("chunk", [256, 160])
def test_mamba2_smoke_loss_at_a_wide_chunk_matches_jax(chunk):
    """mamba2 SMOKE with its SSD chunk raised from 16 to 256 (the whole
    sequence's half; 160 leaves the scan the largest divisor of 512 below
    it, 128), seq 512: the port's loss against the reference's on the
    reference's params, and against the port at the registry's chunk (the
    chunked scan is exact for any chunk)."""
    smoke = jreg.get("mamba2_780m", smoke=True)
    jcfg = dataclasses.replace(smoke, ssm_chunk=chunk)
    jp = _mamba_params()
    nb = jpipe.synthetic_lm_batch(0, 1, 512, smoke.vocab)
    want = jax.jit(functools.partial(jT.loss_fn, cfg=jcfg))(
        jp, {k: jnp.asarray(v) for k, v in nb.items()})
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in nb.items()}
    got = {c.ssm_chunk: tT.loss_fn(tT.params_from_jax(jp, c), tb, c).item()
           for c in (_tcfg(jcfg), _tcfg(smoke))}
    np.testing.assert_allclose(got[chunk], float(want), rtol=1e-5)
    np.testing.assert_allclose(got[chunk], got[smoke.ssm_chunk], rtol=1e-5)


@pytest.mark.parametrize("window", [None, 16])
def test_attention_layer_at_head_dim_320_matches_jax(window):
    """One attention layer (projections, rope, GQA attention, output
    projection) at hymba SMOKE's widths with head dim 320."""
    cfg = dataclasses.replace(jhymba.SMOKE, head_dim=320)
    p = jax.tree.map(np.asarray, jM.attn_init(jax.random.PRNGKey(4), cfg,
                                              jnp.float32))
    x = np.random.default_rng(5).standard_normal((2, 40, 64)) \
        .astype(np.float32)
    want = jax.jit(functools.partial(
        jM.attn_apply, cfg=cfg, ctx=jM.ShardCtx(), window=window))(
        p, jnp.asarray(x), positions=jnp.arange(40))
    got = tM.attn_apply({k: torch.tensor(v) for k, v in p.items()},
                        torch.from_numpy(x), cfg=_tcfg(cfg),
                        positions=torch.arange(40), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_trainer_takes_another_ssd_chunk(capsys):
    """`train.main(argv, cfg=...)` takes the registry's config with
    another SSD chunk (chip_smoke's mamba2 at 256 goes this way) and says
    so; the first step's loss is the registry chunk's (the same params
    and batch); a change in any width still raises."""
    smoke = treg_get("mamba2-780m", smoke=True)
    argv = ["--arch", "mamba2-780m", "--smoke", "--batch", "1", "--seq",
            "128", "--steps", "1", "--device", "cpu"]
    wide = dataclasses.replace(smoke, ssm_chunk=128)
    got = train_cli.main(argv, cfg=wide)
    assert got["cfg"] is wide
    assert "arch=mamba2-smoke at SSD chunk 128 (the registry's 16)" in \
        capsys.readouterr().out
    want = train_cli.main(argv)
    np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                               rtol=1e-5)
    with pytest.raises(ValueError, match="more than its depth"):
        train_cli.main(argv, cfg=dataclasses.replace(wide, ssm_state=32))
