"""The port's serving path on one device against the JAX reference on the
CPU: `core.decode_attention`, `ssm_decode_step`, `prefill`,
`init_decode_state` / `decode_step`, `kv_cache_specs`, the qwen1.5-0.5b
config and the `serve` entry point.

The same numpy inputs, and the reference's own `init` params carried
across by `transformer.params_from_jax` (qwen's QKV biases drawn nonzero
first, so that they count), go through both packages.  Tolerances and
their reasons:

* `decode_attention` at one shard: 2e-5, as `tests/dist_checks.py`
  holds the reference's sharded decode to its one-shard path (f32 sums
  of up to 32 keys in another order); `cache_append`: exact (a copy);
* `ssm_decode_step`: 2e-5 (test_torch_lm.py's module tolerance);
* 8 teacher-forced `decode_step`s of hymba and qwen1.5 SMOKE: logits and
  the caches converted to the reference's stacks within 2e-5 (the
  module tolerance: the same operations in another order, through five
  blocks and eight steps of a recurrence that only decays);
* `prefill` against the reference's `prefill` and against the port's own
  `forward`: 1e-5, as `tests/test_archs_smoke.py:85-95`;
* the port's replay (one token a step) against its `forward`, logits at
  every position and the caches against prefill's K/V: 1e-4 of the
  largest magnitude (the kernels' f32 tolerance: the chunked SSD and the
  recurrence sum the same terms in other orders);
* qwen1.5 SMOKE's loss: rtol 1e-5 (test_torch_lm.py's hymba loss).
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import hymba_1_5b as jhymba
from repro.configs import qwen1_5_0_5b as jqwen
from repro.configs import registry as jreg
from repro.core import decode_attention as jda
from repro.launch import shardings as jsh
from repro.models.lm import modules as jM
from repro.models.lm import transformer as jT
from repro_torch.configs import qwen1_5_0_5b as tqwen
from repro_torch.configs import registry as treg
from repro_torch.core import decode_attention as tda
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import serve
from repro_torch.launch import shardings
from repro_torch.launch.mesh import Mesh
from repro_torch.models.lm import config as tconfig
from repro_torch.models.lm import modules as tM
from repro_torch.models.lm import transformer as tT

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = 2e-5
PREFILL_TOL = 1e-5
REPLAY_TOL = 1e-4
B, STEPS, MAX_LEN = 2, 8, 16
REPLAY_SEQ = 24          # past hymba SMOKE's window of 16
ARCHS = {"hymba": jhymba.SMOKE, "qwen": jqwen.SMOKE}


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _tcfg(jcfg):
    return tconfig.LMConfig(**dataclasses.asdict(jcfg))


def _close(got, want, tol):
    """|got - want| <= tol x the largest |want| (REPLAY_TOL's measure)."""
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The reference's SMOKE params (seed 0) as numpy arrays; qwen's QKV
    biases (zeros at init) drawn from a numpy seed."""
    cfg = ARCHS[arch]
    jp = jax.tree.map(np.asarray, jT.init(jax.random.PRNGKey(0), cfg))
    if cfg.qkv_bias:
        rng = np.random.default_rng(5)
        for seg in jp["segments"]:
            for block in seg:
                for b in ("bq", "bk", "bv"):
                    a = block["attn"][b]
                    block["attn"][b] = (0.5 * rng.standard_normal(a.shape)
                                        ).astype(np.float32)
    return jp


def _port_params(arch):
    return tT.params_from_jax(_params(arch), _tcfg(ARCHS[arch]))


def _tokens(arch, seq, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(1, ARCHS[arch].vocab, (B, seq), dtype=np.int32)


# ---------------------------------------------------------------------------
# decode attention and the cache
# ---------------------------------------------------------------------------

def _decode_inputs(hq=8, hkv=4, s=32, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((B, 1, hq, d), (B, s, hkv, d), (B, s, hkv, d),
             (B, 1, hkv, d), (B, 1, hkv, d))]


@pytest.mark.parametrize("length", [1, 9, 23, 32])
@pytest.mark.parametrize("window,cap", [(None, None), (6, None),
                                        (None, 30.0), (6, 30.0)])
def test_decode_attention_one_shard_matches_jax(length, window, cap):
    """GQA g = 2, the filled-length mask, the window around the tip and
    the softcap."""
    q, k, v, _, _ = _decode_inputs()
    want = jda.decode_attention(q, k, v, jnp.int32(length), mesh=None,
                                seq_axis=None, window=window, softcap=cap)
    got = tda.decode_attention(_t(q), _t(k), _t(v), length, window=window,
                               softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32,
                               atol=F32)


def test_decode_attention_scale_and_mha():
    q, k, v, _, _ = _decode_inputs(hq=4, hkv=4)
    want = jda.decode_attention(q, k, v, jnp.int32(17), mesh=None,
                                seq_axis=None, scale=0.3)
    got = tda.decode_attention(_t(q), _t(k), _t(v), 17, scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32,
                               atol=F32)


@pytest.mark.parametrize("length", [0, 23, 31])
def test_cache_append_matches_jax_in_place(length):
    _, k, v, kn, vn = _decode_inputs()
    kr, vr = jda.cache_append(k, v, kn, vn, length, mesh=None,
                              seq_axis=None)
    kt, vt = _t(k), _t(v)
    kg, vg = tda.cache_append(kt, vt, _t(kn), _t(vn), length)
    assert kg is kt and vg is vt                      # written in place
    np.testing.assert_array_equal(kg.numpy(), np.asarray(kr))
    np.testing.assert_array_equal(vg.numpy(), np.asarray(vr))


def test_cache_append_refuses_a_position_outside():
    _, k, v, kn, vn = _decode_inputs()
    with pytest.raises(IndexError, match="outside"):
        tda.cache_append(_t(k), _t(v), _t(kn), _t(vn), 32)


def test_ssm_decode_step_matches_jax():
    """The rolling conv buffer, the state update, the readout, D and the
    gated rms norm, from a nonzero state and buffer."""
    cfg = jhymba.SMOKE
    p = jax.tree.map(np.asarray, jM.ssm_init(jax.random.PRNGKey(8), cfg,
                                             jnp.float32))
    rng = np.random.default_rng(9)
    p["conv_b"] = rng.standard_normal(p["conv_b"].shape).astype(np.float32)
    p["dt_bias"] = rng.standard_normal(p["dt_bias"].shape) \
        .astype(np.float32)
    tcfg = _tcfg(cfg)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    state = rng.standard_normal((B, tcfg.ssm_heads, cfg.ssm_head_dim,
                                 cfg.ssm_state)).astype(np.float32)
    buf = rng.standard_normal((B, cfg.ssm_conv - 1, tcfg.d_inner
                               + 2 * cfg.ssm_state)).astype(np.float32)
    want = jM.ssm_decode_step(p, x, cfg, state, buf)
    got = tM.ssm_decode_step({k: _t(v) for k, v in p.items()}, _t(x), tcfg,
                             _t(state), _t(buf))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32,
                                   atol=F32)


# ---------------------------------------------------------------------------
# the model: decode steps, prefill, replay
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_decode(arch):
    cfg = ARCHS[arch]
    return jax.jit(lambda p, t, c, L: jT.decode_step(p, cfg, t, c, L))


def _assert_tree_close(got, want, tol):
    """A converted port tree (tensors) against the reference's (arrays),
    leaf by leaf in the same structure."""
    gl, wl = jax.tree.leaves(jax.tree.map(
        lambda t: t.numpy(), got, is_leaf=torch.is_tensor)), \
        jax.tree.leaves(want)
    assert len(gl) == len(wl) > 0
    for g, w in zip(gl, wl):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["hymba", "qwen"])
def test_decode_steps_match_jax(arch):
    """8 teacher-forced steps from empty caches: each step's logits, then
    every cache (K/V, SSM state, conv buffer) in the reference's stacked
    layout."""
    jcfg, tcfg = ARCHS[arch], _tcfg(ARCHS[arch])
    jp, params = _params(arch), _port_params(arch)
    toks = _tokens(arch, STEPS)
    jc = jT.init_decode_state(jp, jcfg, B, MAX_LEN, dtype=jnp.float32)
    tc = tT.init_decode_state(tcfg, B, MAX_LEN, device="cpu")
    assert [[{k: v.shape[1:] for k, v in b.items()} for b in seg]
            for seg in jc] == \
        [[{k: tuple(v.shape[1:]) for k, v in b.items()} for b in seg]
         for seg in tT.tree_to_jax({"layers": tc}, tcfg)["segments"]]
    for i in range(STEPS):
        jl, jc = _jax_decode(arch)(jp, toks[:, i:i + 1], jc, jnp.int32(i))
        tl, tc = tT.decode_step(params, tcfg, torch.as_tensor(
            toks[:, i:i + 1]), tc, i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=F32,
                                   atol=F32)
    _assert_tree_close(tT.tree_to_jax({"layers": tc}, tcfg)["segments"],
                       [list(seg) for seg in jc], F32)


def test_decode_state_round_trips_the_reference_layout():
    tcfg = _tcfg(jhymba.SMOKE)
    tc = tT.init_decode_state(tcfg, B, MAX_LEN, device="cpu")
    for entry in tc:
        for t in entry.values():
            t.normal_()
    back = tT.tree_from_jax(tT.tree_to_jax({"layers": tc}, tcfg), tcfg)
    for a, b in zip(tc, back["layers"]):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k])
    assert tc[0]["ssm"].dtype == torch.float32
    assert tc[0]["conv"].shape == (B, 3, tcfg.d_inner + 2 * tcfg.ssm_state)


@pytest.mark.parametrize("arch", ["hymba", "qwen"])
def test_prefill_matches_jax_and_forward(arch):
    jcfg, tcfg = ARCHS[arch], _tcfg(ARCHS[arch])
    jp, params = _params(arch), _port_params(arch)
    toks = _tokens(arch, 16)
    jlast, jkv, _ = jax.jit(lambda p, t: jT.prefill(p, jcfg, t))(jp, toks)
    last, kv = tT.prefill(params, tcfg, torch.as_tensor(toks))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                               rtol=PREFILL_TOL, atol=PREFILL_TOL)
    assert len(kv) == jcfg.n_layers
    _assert_tree_close(tT.tree_to_jax({"layers": kv}, tcfg)["segments"],
                       [list(seg) for seg in jkv], PREFILL_TOL)
    with torch.no_grad():
        full = tT.forward(params, tcfg, torch.as_tensor(toks))
    np.testing.assert_allclose(last.numpy(), full[:, -1:].numpy(),
                               rtol=PREFILL_TOL, atol=PREFILL_TOL)


def test_forward_refuses_collect_kv_under_remat():
    with pytest.raises(ValueError, match="remat"):
        tT.forward(_port_params("qwen"), _tcfg(jqwen.SMOKE),
                   torch.zeros((1, 4), dtype=torch.long), remat=True,
                   collect_kv=True)


@pytest.mark.parametrize("arch", ["hymba", "qwen"])
def test_replay_matches_forward_and_prefill(arch):
    """The serve loop's replay, one token a step, against the whole
    prompt at once: the logits at every position, and the caches' first
    REPLAY_SEQ positions against prefill's K/V (windows act past 16)."""
    tcfg = _tcfg(ARCHS[arch])
    params = _port_params(arch)
    toks = torch.as_tensor(_tokens(arch, REPLAY_SEQ))
    caches = tT.init_decode_state(tcfg, B, REPLAY_SEQ + 2, device="cpu")
    steps = []
    for i in range(REPLAY_SEQ):
        lg, caches = tT.decode_step(params, tcfg, toks[:, i:i + 1], caches,
                                    i)
        steps.append(lg)
    with torch.no_grad():
        full = tT.forward(params, tcfg, toks)
    _close(torch.cat(steps, 1), full, REPLAY_TOL)
    _, kv = tT.prefill(params, tcfg, toks)
    for c, layer_kv in zip(caches, kv):
        for name, want in zip(("k", "v"), layer_kv):
            _close(c[name][:, :REPLAY_SEQ], want, REPLAY_TOL)
            assert not c[name][:, REPLAY_SEQ:].any()


# ---------------------------------------------------------------------------
# cache specs, qwen1.5-0.5b, the entry point
# ---------------------------------------------------------------------------

def _norm_spec(spec):
    """A spec entry as a tuple of axes or None (jax may write a one-axis
    tuple as the bare name)."""
    return tuple(None if a is None else
                 (a,) if isinstance(a, str) else tuple(a) for a in spec)


@pytest.mark.parametrize("shape,batch_sharded,seq", [
    ({"data": 1, "model": 2}, False, "model"),
    ({"data": 2, "model": 2}, True, "model"),
    ({"data": 2, "model": 2}, False, ("data", "model")),
    ({"pod": 2, "data": 2, "model": 2}, True, "model")])
def test_kv_cache_specs_match_jax(shape, batch_sharded, seq):
    """On the reference's stacked caches (leaf for leaf against its
    PartitionSpecs), and on the port's per-layer ones (the same without
    the stacked dim)."""
    mesh = Mesh(shape, rank=0)
    jp = _params("hymba")
    jc = jax.tree.map(np.asarray, jT.init_decode_state(
        jp, jhymba.SMOKE, 4, MAX_LEN, dtype=jnp.float32))
    want = jsh.kv_cache_specs(jc, mesh, batch_sharded, seq)
    got = shardings.kv_cache_specs(jc, mesh, batch_sharded, seq)
    wl = jax.tree.leaves(want, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    gl = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple) and
                         not any(isinstance(e, dict) for e in x))
    assert len(wl) == len(gl) == 4 * jhymba.SMOKE.n_layers
    assert [_norm_spec(w) for w in wl] == [_norm_spec(g) for g in gl]
    tc = tT.init_decode_state(_tcfg(jhymba.SMOKE), 4, MAX_LEN, device="cpu")
    per_layer = shardings.kv_cache_specs(tc, mesh, batch_sharded, seq)
    assert [_norm_spec(s[1:]) for s in wl] == [
        _norm_spec(per_layer[i][k]) for i in range(len(tc))
        for k in sorted(tc[i])]


def test_cache_blocks_of_one_rank_cut_b_and_s():
    """Rank 3 of data 2 x model 2: B block 1 and S block 1 of the K/V,
    B block 1 of the SSM entries; new contiguous tensors."""
    mesh = Mesh({"data": 2, "model": 2}, rank=3)
    tc = tT.init_decode_state(_tcfg(jhymba.SMOKE), 4, MAX_LEN, device="cpu")
    for entry in tc:
        for t in entry.values():
            t.normal_()
    specs = shardings.kv_cache_specs(tc, mesh, True, "model")
    blocks = shardings.cache_blocks(tc, specs, mesh)
    for g, b in zip(tc, blocks):
        assert torch.equal(b["k"], g["k"][2:, 8:])
        assert torch.equal(b["ssm"], g["ssm"][2:])
        assert torch.equal(b["conv"], g["conv"][2:])
        assert b["v"].is_contiguous() and \
            b["v"].data_ptr() != g["v"].data_ptr()


def test_qwen_config_matches_the_reference():
    assert dataclasses.asdict(tqwen.CONFIG) == dataclasses.asdict(jqwen.CONFIG)
    assert dataclasses.asdict(tqwen.SMOKE) == dataclasses.asdict(jqwen.SMOKE)
    assert treg.get("qwen1.5-0.5b") is tqwen.CONFIG
    assert treg.get("qwen1_5_0_5b", smoke=True) is tqwen.SMOKE
    assert tqwen.CONFIG.total_params() == \
        jreg.get("qwen1_5_0_5b").total_params()
    assert tT.plan(tqwen.CONFIG) == jT.plan(jqwen.CONFIG) == \
        [(("attn",), 24)]
    # the port's init draws the reference's tree (norms and biases, which
    # total_params leaves out, included)
    mine = tT.init(torch.Generator().manual_seed(0), tqwen.SMOKE,
                   device="cpu")
    assert [tuple(t.shape) for t in tT.tree_leaves(mine)] == [
        tuple(t.shape) for t in tT.tree_leaves(_port_params("qwen"))]


def test_qwen_smoke_loss_matches_jax():
    jp = _params("qwen")
    nb = tpipe.synthetic_lm_batch(0, B, 32, jqwen.SMOKE.vocab)
    want = jax.jit(functools.partial(jT.loss_fn, cfg=jqwen.SMOKE,
                                     remat=False))(
        jp, {k: jnp.asarray(v) for k, v in nb.items()})
    with torch.no_grad():
        got = tT.loss_fn(_port_params("qwen"),
                         tpipe.to_device(nb, torch.device("cpu")),
                         _tcfg(jqwen.SMOKE))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_serve_prompts_are_the_reference_s_and_the_cache_pads():
    rng = np.random.default_rng(7)
    want = rng.integers(1, jqwen.SMOKE.vocab, (3, 5), dtype=np.int32)
    np.testing.assert_array_equal(serve.prompts_for(tqwen.SMOKE, 3, 5, 7),
                                  want)
    assert serve.cache_len(32, 16, 1) == 48
    assert serve.cache_len(32, 17, 2) == 50
    assert serve.cache_len(1088, 32, 4) == 1120


def test_serve_run_is_the_replay_then_greedy():
    """`serve.run` on the CPU: the ids are the argmax of the kept logits
    from the last prompt step on, and each step's logits are the decode
    step's on the same params and prompts."""
    args = serve.parse_args(["--arch", "hymba-1.5b", "--smoke", "--device",
                             "cpu", "--batch", "2", "--prompt-len", "6",
                             "--gen", "4"])
    res = serve.run(args, keep=range(9))
    assert res["ids"].shape == (2, 4)
    np.testing.assert_array_equal(
        res["ids"], np.stack([res["logits"][i].argmax(-1).numpy()
                              for i in range(5, 9)], 1))
    cfg, params = res["cfg"], res["params"]
    toks = torch.as_tensor(res["prompts"])
    seq = torch.cat([toks, torch.as_tensor(res["ids"][:, :3])], 1)
    caches = tT.init_decode_state(cfg, 2, res["max_len"], device="cpu")
    for i in range(9):
        lg, caches = tT.decode_step(params, cfg, seq[:, i:i + 1], caches, i)
        assert torch.equal(lg[:, 0], res["logits"][i])
    assert len(res["step_ms"]) == 9


def test_serve_cli_on_the_cpu_and_its_refusals():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    argv = ["--arch", "qwen1.5-0.5b", "--smoke", "--batch", "2",
            "--prompt-len", "4", "--gen", "3"]
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"]
                       + argv + ["--device", "cpu"], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "arch=qwen1.5-smoke mesh={'data': 1, 'model': 1} 6 decode " \
        "steps" in r.stdout
    ids = serve.run(serve.parse_args(argv + ["--device", "cpu"]))["ids"]
    assert str(ids) in r.stdout
    assert serve.parse_args(argv).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(argv)
    for bad in (["--arch", "mesh1k"], argv + ["--batch", "3", "--data", "2"],
                argv + ["--gen", "0"]):
        with pytest.raises(SystemExit):
            serve.parse_args(bad)
