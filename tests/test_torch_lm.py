"""The port's one-device LM path (hymba-1.5b's hybrid attention + SSD
blocks) against the JAX reference on the CPU.

The same numpy inputs, and the reference's own `init` params carried
across by `transformer.params_from_jax`, go through both packages; on the
CPU the port's attention and SSD run their kernels' plain versions.  The
JAX oracles are jitted (eager hymba SMOKE loss+grad takes 18 s).
Tolerances and their reasons:

* modules, ring attention and the chunked SSD: 2e-5 (the kernel sweeps'
  f32 tolerance: the same sums in another order);
* hymba SMOKE loss rtol 1e-5 and every gradient rtol 1e-4 / atol 1e-6:
  five hybrid blocks whose backward divides by rms norms of order 1e-1,
  which amplifies the forward's rounding, with an absolute floor for tiny
  gradients;
* BF16 loss rtol 3e-2: bf16 rounds at other places in the two packages;
* the 3-step AdamW trajectory: losses and grad norms rtol 1e-4, params
  rtol 1e-4 / atol 1e-6 (the gradients' tolerance through three steps;
  Adam's update divides by sqrt(nu), which is as exact as the gradient);
* `--remat` against the plain loss: bit for bit (the recompute runs the
  same operations on the same inputs).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import utils as jutils
from repro.configs import hymba_1_5b as jhymba
from repro.core import ring_attention as jra
from repro.data import pipeline as jpipe
from repro.models.lm import config as jconfig
from repro.models.lm import modules as jM
from repro.models.lm import transformer as jT
from repro.optim import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import utils as tutils
from repro_torch.configs import hymba_1_5b as thymba
from repro_torch.configs import registry as treg
from repro_torch.core import ring_attention as tra
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as train_cli
from repro_torch.models.lm import config as tconfig
from repro_torch.models.lm import modules as tM
from repro_torch.models.lm import transformer as tT
from repro_torch.optim import optimizer as topt
from repro_torch.train import train_loop as ttl

torch.set_num_threads(2)

F32 = 2e-5
SEQ = 128           # > the smoke window 16 and two SSD chunks of 64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _tcfg(jcfg):
    """The port's LMConfig with the reference config's fields."""
    return tconfig.LMConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _hymba_smoke():
    """The reference's hymba SMOKE params (seed 0) as numpy arrays."""
    jp = jax.tree.map(np.asarray,
                      jT.init(jax.random.PRNGKey(0), jhymba.SMOKE))
    return jp


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad():
    return jax.jit(jax.value_and_grad(functools.partial(
        jT.loss_fn, cfg=jhymba.SMOKE, remat=False)))


# ---------------------------------------------------------------------------
# config, registry, batches
# ---------------------------------------------------------------------------

def test_config_copy_matches_reference():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.LMConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.LMConfig)}
    assert jf == tf
    assert dataclasses.asdict(thymba.CONFIG) == \
        dataclasses.asdict(jhymba.CONFIG)
    assert dataclasses.asdict(thymba.SMOKE) == \
        dataclasses.asdict(jhymba.SMOKE)
    for j in (jhymba.CONFIG, jhymba.SMOKE):
        t = _tcfg(j)
        assert t.layer_types() == j.layer_types()
        assert t.total_params() == j.total_params()
        assert (t.d_inner, t.ssm_heads) == (j.d_inner, j.ssm_heads)
    # full width: 1.59 B params, layers {0, 16, 31} global, 50 SSD heads
    assert abs(thymba.CONFIG.total_params() - 1.59e9) < 0.01e9
    assert thymba.CONFIG.ssm_heads == 50
    assert [i for i, t in enumerate(thymba.CONFIG.layer_types())
            if t == "hybrid_g"] == [0, 16, 31]


@pytest.mark.parametrize("types", [
    None, ["attn"] * 4, ["swa", "attn"] * 3, ["ssm"] * 3,
    ["hybrid_g", "hybrid_s", "hybrid_s", "hybrid_g"]])
def test_plan_matches_reference(types):
    for j in (jhymba.CONFIG, jhymba.SMOKE):
        assert tT.plan(_tcfg(j), types) == jT.plan(j, types)


def test_registry_ports_hymba_only_among_lms():
    assert treg.get("hymba-1.5b") is thymba.CONFIG
    assert treg.get("hymba_1_5b", smoke=True) is thymba.SMOKE
    # gemma2 and qwen2.5 came with the vocab-parallel slice
    assert treg.get("gemma2_9b").name == "gemma2-9b"
    assert treg.get("qwen2.5-14b", smoke=True).name == "qwen2.5-smoke"
    # olmo, mamba2 and the MoE archs came with the MoE slice
    for arch in ("mamba2-780m", "olmo_1b", "mixtral-8x7b", "olmoe_1b_7b"):
        assert treg.get(arch, smoke=True).name.endswith("-smoke")
    for arch in ("pixtral-12b", "seamless_m4t_large_v2"):
        with pytest.raises(ValueError, match="not ported yet"):
            treg.get(arch)


@pytest.mark.parametrize("step,batch,seq,vocab", [
    (0, 1, 64, 32001), (3, 2, 128, 256), (7, 4, 5, 11)])
def test_synthetic_lm_batch_bit_identical(step, batch, seq, vocab):
    a = jpipe.synthetic_lm_batch(step, batch, seq, vocab)
    b = tpipe.synthetic_lm_batch(step, batch, seq, vocab)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_norm_apply_matches_jax(norm):
    cfg = dataclasses.replace(jhymba.SMOKE, norm=norm)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 64)) * 3 + 1).astype(np.float32)
    w = np.asarray(jM.norm_init(cfg, 64)) + rng.standard_normal(
        np.asarray(jM.norm_init(cfg, 64)).shape).astype(np.float32)
    want = jM.norm_apply(cfg, jnp.asarray(w), jnp.asarray(x))
    got = tM.norm_apply(_tcfg(cfg), _t(w), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32,
                               atol=F32)


@pytest.mark.parametrize("pos_shape", ["1d", "2d"])
def test_rope_matches_jax(pos_shape):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(9) if pos_shape == "1d" else \
        rng.integers(0, 100, (2, 9))
    want = jM.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = tM.rope(_t(x), torch.from_numpy(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32,
                               atol=F32)


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "gelu"])
def test_mlp_apply_matches_jax(mlp):
    cfg = dataclasses.replace(jhymba.SMOKE, mlp=mlp)
    p = jax.tree.map(np.asarray, jM.mlp_init(jax.random.PRNGKey(2), cfg,
                                             jnp.float32))
    x = np.random.default_rng(3).standard_normal((2, 7, 64)) \
        .astype(np.float32)
    want = jM.mlp_apply(p, jnp.asarray(x), cfg)
    got = tM.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), _tcfg(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32,
                               atol=F32)


@pytest.mark.parametrize("window,qkv_bias", [(None, False), (16, True)])
def test_attn_apply_matches_jax(window, qkv_bias):
    """q/k/v projections, rope, GQA attention through ring_attention and
    the output projection, on hymba SMOKE's widths."""
    cfg = dataclasses.replace(jhymba.SMOKE, qkv_bias=qkv_bias)
    p = jax.tree.map(np.asarray, jM.attn_init(jax.random.PRNGKey(4), cfg,
                                              jnp.float32))
    if qkv_bias:
        p = {k: v + 0.1 if k.startswith("b") else v for k, v in p.items()}
    x = np.random.default_rng(5).standard_normal((2, 40, 64)) \
        .astype(np.float32)
    want = jax.jit(functools.partial(
        jM.attn_apply, cfg=cfg, ctx=jM.ShardCtx(), window=window))(
        p, jnp.asarray(x), positions=jnp.arange(40))
    got = tM.attn_apply({k: _t(v) for k, v in p.items()}, _t(x),
                        cfg=_tcfg(cfg), positions=torch.arange(40),
                        window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32,
                               atol=F32)


@pytest.mark.parametrize("b,s,hq,hkv,d,window,cap,scale", [
    (1, 40, 4, 2, 16, None, None, None), (2, 33, 10, 2, 8, 5, None, None),
    (1, 64, 5, 5, 32, 16, 30.0, 0.2)])
def test_ring_attention_matches_jax(b, s, hq, hkv, d, window, cap, scale):
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    want = jra.ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              mesh=None, seq_axis=None, scale=scale,
                              window=window, softcap=cap)
    got = tra.ring_attention(_t(q), _t(k), _t(v), seq_axis=None,
                             scale=scale, window=window, softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32,
                               atol=F32)
    # a sequence axis without a mesh (one shard) is the one-device path;
    # the ring over a mesh is tests/test_torch_ring_dist.py's
    one = tra.ring_attention(_t(q), _t(k), _t(v), seq_axis="model",
                             scale=scale, window=window, softcap=cap)
    assert torch.equal(one, got)
    with pytest.raises(ValueError, match="one mesh axis"):
        tra.ring_attention(_t(q), _t(k), _t(v), seq_axis=("data", "model"))


@pytest.mark.parametrize("b,l,h,p,n,chunk,with_h0", [
    (2, 128, 4, 16, 8, 64, False), (1, 96, 3, 8, 4, 64, False),
    (1, 64, 2, 8, 16, 16, True), (2, 40, 3, 4, 4, 64, False)])
def test_ssd_chunked_matches_jax(b, l, h, p, n, chunk, with_h0):
    """Including the chunk shrink: l = 96 with chunk 64 runs 48-step
    chunks, l = 40 one chunk of 40."""
    rng = np.random.default_rng(7)
    xdt = rng.standard_normal((b, l, h, p)).astype(np.float32) * 0.5
    la = -rng.uniform(0.01, 0.5, (b, l, h)).astype(np.float32)
    B = rng.standard_normal((b, l, n)).astype(np.float32) * 0.5
    C = rng.standard_normal((b, l, n)).astype(np.float32) * 0.5
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32) \
        if with_h0 else None
    jy, jh = jM._ssd_chunked(jnp.asarray(xdt), jnp.asarray(la),
                             jnp.asarray(B), jnp.asarray(C), chunk,
                             None if h0 is None else jnp.asarray(h0))
    ty, th = tM._ssd_chunked(_t(xdt), _t(la), _t(B), _t(C), chunk,
                             None if h0 is None else _t(h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=F32,
                               atol=F32)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=F32,
                               atol=F32)


def _long_ssd_inputs(b, l, h, p, n, seed, with_h0):
    """Log-decays over hymba's range, -0.01 to -11 per step: over a
    16-step chunk some totals pass -104, where exp underflows to 0."""
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((b, l, h, p)).astype(np.float32) * 0.5
    la = -rng.uniform(0.01, 11.0, (b, l, h)).astype(np.float32)
    B = rng.standard_normal((b, l, n)).astype(np.float32) * 0.5
    C = rng.standard_normal((b, l, n)).astype(np.float32) * 0.5
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32) \
        if with_h0 else None
    return xdt, la, B, C, h0


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_closed_form_matches_jax_scan_fwd_and_grads(with_h0):
    """32 chunks of 16 steps: the closed-form recurrence against the
    reference's `lax.scan`, forward and the gradients of every input
    (jax.grad against autograd) through one random cotangent."""
    b, l, h, p, n, chunk = 1, 512, 3, 4, 4, 16
    xdt, la, B, C, h0 = _long_ssd_inputs(b, l, h, p, n, 11, with_h0)
    tot = la.reshape(b, l // chunk, chunk, h).sum(2)
    assert (np.exp(tot) == 0).any() and (np.exp(tot) > 0).any()
    rng = np.random.default_rng(12)
    gy = rng.standard_normal((b, l, h, p)).astype(np.float32)
    gh = rng.standard_normal((b, h, p, n)).astype(np.float32)
    args = [xdt, la, B, C] + ([h0] if with_h0 else [])

    def jloss(*a):
        y, hf = jM._ssd_chunked(*a[:4], chunk, a[4] if with_h0 else None)
        return jnp.sum(y * gy) + jnp.sum(hf * gh), (y, hf)
    (_, (jy, jh)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(len(args))), has_aux=True))(
            *(jnp.asarray(a) for a in args))
    ts = [_t(a).requires_grad_() for a in args]
    ty, th = tM._ssd_chunked(*ts[:4], chunk, ts[4] if with_h0 else None)
    ((ty * _t(gy)).sum() + (th * _t(gh)).sum()).backward()
    for got, want in [(ty, jy), (th, jh)] + \
            [(t.grad, g) for t, g in zip(ts, jg)]:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=F32, atol=F32)


def _inter_chunk_loop(a_tot, S, h0=None):
    """The recurrence as a loop over chunks (the port's form before the
    closed form): h_z = h_{z-1} * a_tot[z-1] + S[z-1]."""
    b, nc, h, p, n = S.shape
    hprev = torch.zeros((b, h, p, n)) if h0 is None else h0
    h_in = []
    for z in range(nc):
        h_in.append(hprev)
        hprev = hprev * a_tot[:, z, :, None, None] + S[:, z]
    return torch.stack(h_in, dim=1), hprev


@pytest.mark.parametrize("nc,with_h0", [(1, False), (5, True), (33, False),
                                        (40, True)])
def test_inter_chunk_states_matches_the_loop(nc, with_h0):
    """The closed form against the loop it replaced, at chunk totals of
    hymba's range (-0.16 to -700, exp underflowing to 0 past -104), and
    its gradients finite where decays underflow."""
    rng = np.random.default_rng(nc)
    b, h, p, n = 2, 3, 4, 5
    log_a = _t(-np.exp(rng.uniform(np.log(0.16), np.log(700.0),
                                   (b, nc, h))))
    S = _t(rng.standard_normal((b, nc, h, p, n)))
    h0 = _t(rng.standard_normal((b, h, p, n))) if with_h0 else None
    want_in, want_fin = _inter_chunk_loop(torch.exp(log_a), S, h0)
    la = log_a.clone().requires_grad_()
    got_in, got_fin = tM.inter_chunk_states(la, S, h0)
    np.testing.assert_allclose(got_in.detach().numpy(), want_in.numpy(),
                               rtol=F32, atol=F32)
    np.testing.assert_allclose(got_fin.detach().numpy(), want_fin.numpy(),
                               rtol=F32, atol=F32)
    (got_in.sum() + got_fin.sum()).backward()
    assert torch.isfinite(la.grad).all()


def test_ssm_apply_matches_jax():
    """The whole SSD block: in_proj, depthwise causal conv, softplus dt,
    the chunked scan (two chunks), D skip, gated rms norm, out_proj."""
    cfg = jhymba.SMOKE
    p = jax.tree.map(np.asarray, jM.ssm_init(jax.random.PRNGKey(8), cfg,
                                             jnp.float32))
    rng = np.random.default_rng(9)
    p["conv_b"] = rng.standard_normal(p["conv_b"].shape).astype(np.float32)
    p["dt_bias"] = rng.standard_normal(p["dt_bias"].shape) \
        .astype(np.float32)
    x = rng.standard_normal((2, SEQ, 64)).astype(np.float32)
    want = jax.jit(functools.partial(jM.ssm_apply, cfg=cfg,
                                     ctx=jM.ShardCtx()))(p, jnp.asarray(x))
    got = tM.ssm_apply({k: _t(v) for k, v in p.items()}, _t(x), _tcfg(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32,
                               atol=F32)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def test_params_from_jax_unstacks_segments_in_order():
    jp = _hymba_smoke()
    params = tT.params_from_jax(jp, thymba.SMOKE)
    assert len(params["layers"]) == jhymba.SMOKE.n_layers
    # [g]x1, [s]x1, [g]x1, [s]x1, [g]x1: segment i holds layer i
    for i, seg in enumerate(jp["segments"]):
        np.testing.assert_array_equal(
            params["layers"][i]["attn"]["wq"].detach().numpy(),
            seg[0]["attn"]["wq"][0])
    full = jT.plan(jhymba.CONFIG)
    assert full == [(("hybrid_g",), 1), (("hybrid_s",), 15),
                    (("hybrid_g",), 1), (("hybrid_s",), 14),
                    (("hybrid_g",), 1)]
    # the port's own init has the same tree and shapes
    mine = tT.init(torch.Generator().manual_seed(0), thymba.SMOKE,
                   device="cpu")
    assert [tuple(t.shape) for t in tutils.tree_leaves(mine)] == \
        [tuple(t.shape) for t in tutils.tree_leaves(params)]
    assert all(t.requires_grad for t in tutils.tree_leaves(mine))


def test_init_needs_a_device():
    """The LM init is an entry point: it names its device, as `MeshNet`
    does, and runs on no default one."""
    with pytest.raises(TypeError, match="device"):
        tT.init(torch.Generator().manual_seed(0), thymba.SMOKE)


def test_params_from_jax_unstacks_a_repeated_segment():
    """A 4-layer hymba (g, s, g, g) at the smoke widths: its middle
    segments are [s] x 1 and [g] x 2."""
    cfg = dataclasses.replace(jhymba.SMOKE, n_layers=4)
    assert jT.plan(cfg) == [
        (("hybrid_g",), 1), (("hybrid_s",), 1), (("hybrid_g",), 2)]
    smoke = _hymba_smoke()["segments"]          # [g], [s], [g], [s], [g]
    jp = dict(_hymba_smoke(), segments=[smoke[0], smoke[1], tuple(
        jax.tree.map(lambda a, b: np.concatenate([a, b]), x, y)
        for x, y in zip(smoke[2], smoke[4]))])
    params = tT.params_from_jax(jp, _tcfg(cfg))
    for li, (si, c) in enumerate([(0, 0), (1, 0), (2, 0), (2, 1)]):
        np.testing.assert_array_equal(
            params["layers"][li]["ssm"]["in_proj"].detach().numpy(),
            jp["segments"][si][0]["ssm"]["in_proj"][c])


def test_params_from_jax_rejects_mismatch():
    jp = _hymba_smoke()
    with pytest.raises(ValueError, match="segments"):
        tT.params_from_jax(dict(jp, segments=jp["segments"][:-1]),
                           thymba.SMOKE)
    bad = list(jp["segments"])
    bad[1] = tuple(jax.tree.map(lambda a: np.concatenate([a, a]), b)
                   for b in bad[1])
    with pytest.raises(ValueError, match="leading"):
        tT.params_from_jax(dict(jp, segments=bad), thymba.SMOKE)


def test_hymba_smoke_loss_and_grads_match_jax():
    """hymba SMOKE at seq 128 (window 16 and chunk 64 both bite): the loss
    and every gradient against jax.value_and_grad(T.loss_fn)."""
    jp = _hymba_smoke()
    nb = tpipe.synthetic_lm_batch(0, 2, SEQ, jhymba.SMOKE.vocab)
    jloss, jgrads = _jax_value_and_grad()(
        jp, {k: jnp.asarray(v) for k, v in nb.items()})
    params = tT.params_from_jax(jp, thymba.SMOKE)
    tb = tpipe.to_device(nb, torch.device("cpu"))
    loss = tT.loss_fn(params, tb, thymba.SMOKE)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    leaves = tutils.tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves)
    want = tutils.tree_leaves(tT.params_from_jax(
        jax.tree.map(np.asarray, jgrads), thymba.SMOKE))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.detach().numpy(),
                                   rtol=1e-4, atol=1e-6)


def test_hymba_smoke_remat_equals_the_plain_loss_and_grads(monkeypatch):
    """`loss_fn(remat=True)` (each unit of `plan(cfg)` a
    torch.utils.checkpoint region, the reference's jax.checkpoint of its
    scan body): the same loss and gradients, bit for bit on the CPU, and
    every block's forward run twice (the recompute)."""
    params = tT.params_from_jax(_hymba_smoke(), thymba.SMOKE)
    tb = tpipe.to_device(tpipe.synthetic_lm_batch(0, 2, SEQ,
                                                  jhymba.SMOKE.vocab),
                         torch.device("cpu"))
    calls, block = [], tT._block_apply

    def counted(*a, **k):
        calls.append(1)
        return block(*a, **k)
    monkeypatch.setattr(tT, "_block_apply", counted)
    leaves = tutils.tree_leaves(params)
    out = {}
    for remat in (False, True):
        calls.clear()
        loss = tT.loss_fn(params, tb, thymba.SMOKE, remat=remat)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves),
                      len(calls))
    n = thymba.SMOKE.n_layers
    assert out[False][2] == n and out[True][2] == 2 * n
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)


def test_train_step_remat_recomputes_the_loss(monkeypatch):
    """`TrainStepConfig(remat=True)` (the reference's jax.checkpoint of the
    whole loss fn in make_train_step): one step's loss, gradient norm and
    updated params equal the plain step's bit for bit on the CPU, and
    every block's forward runs twice."""
    tb = tpipe.to_device(tpipe.synthetic_lm_batch(0, 2, SEQ,
                                                  jhymba.SMOKE.vocab),
                         torch.device("cpu"))
    calls, block = [], tT._block_apply

    def counted(*a, **k):
        calls.append(1)
        return block(*a, **k)
    monkeypatch.setattr(tT, "_block_apply", counted)
    out = {}
    for remat in (False, True):
        params = tT.params_from_jax(_hymba_smoke(), thymba.SMOKE)
        opt = topt.adamw(1e-3)
        step = ttl.make_train_step(
            functools.partial(tT.loss_fn, cfg=thymba.SMOKE), opt,
            ttl.TrainStepConfig(precision=tutils.FP32, remat=remat))
        calls.clear()
        params, _, _, m = step(params, opt.init(params), None, tb)
        out[remat] = (m, tutils.tree_leaves(params), len(calls))
    n = thymba.SMOKE.n_layers
    assert out[False][2] == n and out[True][2] == 2 * n
    for key in ("loss", "grad_norm"):
        assert torch.equal(out[True][0][key], out[False][0][key])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)


def test_remat_and_pod_compression_flags():
    args = train_cli.parse_args(["--arch", "hymba-1.5b", "--smoke",
                                 "--remat", "--pod-compression", "int8_ef",
                                 "--device", "cpu"])
    assert args.remat and args.pod_compression == "int8_ef"
    cfg = train_cli.step_config(args, tutils.FP32)
    # --remat goes to the LM loss, as the reference's trainer passes it
    assert not cfg.remat and cfg.pod_compression == "int8_ef"
    loss = train_cli.build(args, torch.device("cpu"), echo=False)[3]
    assert loss.keywords["remat"] is True
    assert train_cli.parse_args(["--arch", "mesh1k"]).pod_compression == \
        "none"
    for bad in (["--arch", "mesh1k", "--remat"],
                ["--arch", "resnet50", "--remat"],
                ["--arch", "mesh1k", "--pod-compression", "fp8"]):
        with pytest.raises(SystemExit):
            train_cli.parse_args(bad)


def test_hymba_smoke_bf16_loss_matches_jax():
    jp = _hymba_smoke()
    nb = tpipe.synthetic_lm_batch(1, 2, SEQ, jhymba.SMOKE.vocab)
    jloss = jax.jit(functools.partial(jT.loss_fn, cfg=jhymba.SMOKE,
                                      remat=False))(
        jutils.BF16.cast_compute(jp),
        {k: jnp.asarray(v) for k, v in nb.items()})
    params = tutils.BF16.cast_compute(tT.params_from_jax(jp, thymba.SMOKE))
    loss = tT.loss_fn(params, tpipe.to_device(nb, torch.device("cpu")),
                      thymba.SMOKE)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=3e-2)


def test_three_step_adamw_trajectory_matches_jax():
    """The reference's make_train_step + adamw(warmup_cosine(lr, 20, 3))
    on synthetic_lm_batch, from the same params, against the port's."""
    jp = _hymba_smoke()
    cfg, lr, steps = jhymba.SMOKE, 3e-3, 3
    jo = jopt.adamw(jopt.warmup_cosine(lr, 20, steps))
    jstep = jtl.make_train_step(
        functools.partial(jT.loss_fn, cfg=cfg, remat=False), jo, None,
        jtl.TrainStepConfig(precision=jutils.FP32))
    jparams = jax.tree.map(jnp.asarray, jp)
    jstate = jo.init(jparams)
    opt = topt.adamw(topt.warmup_cosine(lr, 20, steps))
    tstep = ttl.make_train_step(
        functools.partial(tT.loss_fn, cfg=thymba.SMOKE), opt,
        ttl.TrainStepConfig(precision=tutils.FP32))
    params = tT.params_from_jax(jp, thymba.SMOKE)
    state = opt.init(params)
    for s in range(steps):
        nb = tpipe.synthetic_lm_batch(s, 2, SEQ, cfg.vocab)
        jparams, jstate, _, jm = jstep(
            jparams, jstate, None, {k: jnp.asarray(v) for k, v in nb.items()})
        params, state, _, m = tstep(params, state, None,
                                 tpipe.to_device(nb, torch.device("cpu")))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert state.step == steps
    want = tT.params_from_jax(jax.tree.map(np.asarray, jparams), cfg=_tcfg(
        cfg))
    # Adam moves an element by about lr whatever its gradient's size, so
    # an element whose gradient is at rounding level (within the grads'
    # atol) may step either way: all but 1e-3 of the elements within the
    # gradients' tolerance, every one within twice the summed lr
    lr_sum = sum(topt.warmup_cosine(lr, 20, steps)(s + 1)
                 for s in range(steps))
    n_off = n_all = 0
    for p, w in zip(tutils.tree_leaves(params), tutils.tree_leaves(want)):
        diff = (p - w).abs().detach()
        n_off += int((diff > 1e-6 + 1e-4 * w.detach().abs()).sum())
        n_all += diff.numel()
        assert float(diff.max()) <= 2 * lr_sum
    assert n_off <= 1e-3 * n_all, (n_off, n_all)


def test_train_cli_hymba_smoke_on_cpu():
    res = train_cli.main(["--arch", "hymba-1.5b", "--smoke", "--steps", "2",
                          "--batch", "2", "--seq", "32", "--device", "cpu",
                          "--bf16", "--log-every", "1"])
    assert res["cfg"] is thymba.SMOKE and len(res["losses"]) == 2
    assert all(np.isfinite(res["losses"]))
    with pytest.raises(SystemExit):
        train_cli.parse_args(["--arch", "mesh1k", "--bf16"])
    assert train_cli.parse_args(["--arch", "hymba-1.5b", "--remat"]).remat
    with pytest.raises(SystemExit):                 # the LM archs' flag
        train_cli.parse_args(["--arch", "mesh1k", "--remat"])


@pytest.mark.parametrize("entry", ["train", "serve"])
def test_entry_points_take_a_config_cut_in_depth(entry, capsys):
    """`cfg`, the arch's config cut in depth, runs in place of the
    registry's and is announced; a config that differs in more than its
    depth raises."""
    from repro_torch.launch import serve
    cut = dataclasses.replace(thymba.SMOKE, n_layers=2)
    argv = ["--arch", "hymba-1.5b", "--smoke", "--batch", "2",
            "--device", "cpu"]
    if entry == "train":
        def run(cfg):
            return train_cli.main(argv + ["--steps", "1", "--seq", "32"],
                                  cfg=cfg)
    else:
        def run(cfg):
            return serve.main(argv + ["--prompt-len", "4", "--gen", "2"],
                              cfg=cfg)
    res = run(cut)
    assert res["cfg"] is cut and len(res["params"]["layers"]) == 2
    assert (f"arch={cut.name} cut to 2 of its {thymba.SMOKE.n_layers} "
            f"layers") in capsys.readouterr().out
    with pytest.raises(ValueError, match="more than its depth"):
        run(dataclasses.replace(cut, d_model=2 * cut.d_model))


# ---------------------------------------------------------------------------
# the sequence split (the multi-rank runs are tests/test_torch_lm_dist.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [{"data": 1, "model": 2},
                                   {"data": 2, "model": 2},
                                   {"pod": 2, "data": 1, "model": 4}])
def test_shard_lm_batch_is_the_reference_placement(shape):
    """Each rank's block of a global token batch is its block under the
    reference's `P(batch_axes, "model")`: B cut over the batch axes
    (major-to-minor), S over model; the blocks tile the global batch."""
    from repro_torch.launch.mesh import Mesh, batch_axes
    nb = tpipe.synthetic_lm_batch(2, 4, 16, 97)
    n = int(np.prod(list(shape.values())))
    seen = {k: np.zeros(v.shape, int) for k, v in nb.items()}
    for r in range(n):
        mesh = Mesh(shape, rank=r)
        ba = batch_axes(mesh)
        got = tpipe.shard_lm_batch(nb, mesh, "model", ba)
        bi, bn = mesh.index(ba), mesh.axis_size(ba)
        si, sn = mesh.index("model"), mesh.axis_size("model")
        rows = slice(bi * 4 // bn, (bi + 1) * 4 // bn)
        cols = slice(si * 16 // sn, (si + 1) * 16 // sn)
        for k, v in nb.items():
            np.testing.assert_array_equal(got[k], v[rows, cols])
            assert got[k].flags.c_contiguous
            seen[k][rows, cols] += 1
    reps = n // (mesh.axis_size(ba) * mesh.axis_size("model"))
    assert all((s == reps).all() for s in seen.values())
    assert tpipe.shard_lm_batch(nb, None) is nb


def test_positions_are_global_on_a_sequence_shard():
    from repro_torch.launch.mesh import Mesh
    for r in range(4):
        ctx = tM.ShardCtx(mesh=Mesh({"data": 2, "model": 2}, rank=r),
                          seq_axis="model", batch_axes=("data",))
        assert ctx.sharded and ctx.seq_index == r % 2
        np.testing.assert_array_equal(tT.positions_of(ctx, 8, "cpu"),
                                      np.arange(8) + 8 * (r % 2))
    assert not tM.ShardCtx().sharded
    np.testing.assert_array_equal(tT.positions_of(tM.ShardCtx(), 5, "cpu"),
                                  np.arange(5))


@pytest.mark.parametrize("delta,window", [(0, None), (32, None), (32, 16),
                                          (-8, 4)])
def test_flash_attention_block_on_the_cpu_is_the_plain_version(delta,
                                                               window):
    """`ops.flash_attention_block` on CPU tensors is the plain version's
    block call (o in fp32 and lse), differentiable in both."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .requires_grad_() for s in ((1, 32, 4, 16), (1, 32, 2, 16),
                                           (1, 32, 2, 16)))
    o, lse = ops.flash_attention_block(q, k, v, delta=delta, window=window)
    want = flash_attention_ref(q, k, v, delta=delta, window=window,
                               return_lse=True)
    assert torch.equal(o, want[0]) and torch.equal(lse, want[1])
    assert o.dtype == lse.dtype == torch.float32
    seen = lse > -1e29
    (o.sum() + lse[seen].sum()).backward()
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


def test_train_cli_sequence_split_flags():
    """An LM arch on a mesh needs --seq divisible by --model; --elastic
    takes it (its remesh re-shards the sequence) but, as for every arch,
    only with --ckpt-dir; --audit and --profile stay the meshnet archs'."""
    ok = train_cli.parse_args(["--arch", "hymba-1.5b", "--smoke", "--model",
                               "2", "--seq", "128", "--device", "cpu"])
    assert ok.model == 2
    assert train_cli.parse_args(["--arch", "hymba-1.5b", "--smoke",
                                 "--model", "2", "--elastic", "--ckpt-dir",
                                 "x"]).elastic
    for bad in (["--seq", "127", "--model", "2"],
                ["--model", "2", "--elastic"],
                ["--model", "2", "--audit"], ["--model", "2", "--profile"]):
        with pytest.raises(SystemExit):
            train_cli.parse_args(["--arch", "hymba-1.5b", "--smoke"] + bad)
