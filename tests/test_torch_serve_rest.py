"""Serving in the dry run's placement: params at rest in bf16 and bf16
caches (`transformer.init(dtype=)` / `in_dtype`, `init_decode_state(dtype=)`,
`decode_step` and `prefill` under `ShardCtx.rest` and `model_blocks`).

- The reference's dtype rule: the port's `init(dtype=bfloat16)` gives
  every leaf the reference's `init(dtype=bfloat16)` dtype (the norms, the
  hybrid fuse scales, the SSD's scalars and the router fp32), and one
  seed's values in every dtype, rounded; `init_decode_state` gives the
  reference's cache shapes and dtypes (`k`, `v`, `conv` in the dtype,
  `ssm` fp32), and a decode step writes the K/V caches in place and keeps
  every entry's dtype.
- bf16 against the reference on one device: the reference's own bf16
  params (`init(dtype=bfloat16)`, carried over exactly), the last logits
  of a prefill and 4 teacher-forced decode steps from empty bf16 caches,
  for qwen1.5, hymba, mamba2, olmoe and seamless SMOKE, each in the
  reference's dtype.  Tolerance: the logits, and the caches after the
  steps, within max(3e-2, 2 e) of the reference's largest magnitude
  (BF16_TOL), e the distance of the reference's own bf16 run from its
  fp32 run on the same bf16-valued params.  Every product of both
  packages rounds its output to bf16 (8 bits), and the two round
  different sums (another order; XLA's fused element-wise ops against
  eager ones, which round at each op), so each run lies about e from the
  exact values: 1-3 % of the largest logit here (the SSM archs' most),
  more where a rounding flips a MoE routing choice, which the
  reference's bf16 run flips against its fp32 run as well.
- On 2 x 2 gloo ranks (`python tests/torch_dist_cases.py serve_rest 2,2
  DIR`), a prefill and 4 greedy decode steps with the params at rest (a
  vocabulary and expert blocks over "model" too, for olmoe) against the
  same run on whole params: equal ids, logits and caches within 1e-6
  (the gathers move the blocks, bit for bit), for attention, sliding
  window, hybrid, SSM, MoE, the xattn decoder over an encoder and a
  patch prefix.  The gathers over "data" at use a decode step (and a
  prefill) makes are the count the layers derive from `rest_dims`, and
  those over "model" the count of the blocks `model_blocks` names.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from repro.configs import registry as jreg
from repro.models.lm import transformer as jT
from repro_torch.configs import registry as treg
from repro_torch.core.decode_attention import cache_append
from repro_torch.launch import shardings
from repro_torch.launch.mesh import Mesh
from repro_torch.models.lm import modules as tM
from repro_torch.models.lm import transformer as tT
from repro_torch.utils import leaves_with_path, tree_leaves

torch.set_num_threads(2)

BF16_TOL = 3e-2
REST_TOL = 1e-6
ARCHS = ["qwen1_5_0_5b", "hymba_1_5b", "mamba2_780m", "olmoe_1b_7b",
         "seamless_m4t_large_v2"]
B, S, STEPS, MAX_LEN = 2, 16, 4, 8
DIMS = (2, 2)


def _dtypes(tree) -> list[str]:
    return [str(t.dtype).split(".")[-1] for t in tree_leaves(tree)]


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err, top = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * top, (what, err, top)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's SMOKE config and its own bf16 params (seed 0),
    and the port's copy of them: the values carried over exactly
    (`params_from_jax` in fp32, then the port's dtype rule)."""
    jcfg, tcfg = jreg.get(arch, smoke=True), treg.get(arch, smoke=True)
    jp = jT.init(jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16)
    tp = tT.in_dtype(tT.params_from_jax(jax.tree.map(
        lambda a: np.asarray(a, np.float32), jp), tcfg), torch.bfloat16)
    return jcfg, tcfg, jp, tp


# ------------------------------------------------------- the dtype rules --

@pytest.mark.parametrize("arch", ARCHS + ["gemma2_9b"])
def test_init_dtypes_are_the_references(arch):
    jcfg, tcfg = jreg.get(arch, smoke=True), treg.get(arch, smoke=True)
    want = jax.eval_shape(lambda k: jT.init(k, jcfg, dtype=jnp.bfloat16),
                          jax.random.PRNGKey(0))
    p16 = tT.init(torch.Generator().manual_seed(0), tcfg, device="cpu",
                  dtype=torch.bfloat16)
    got = tT.tree_to_jax(p16, tcfg)
    assert [p for p, _ in leaves_with_path(got)] == \
        [jax.tree_util.keystr(p) for p, _ in
         jax.tree_util.tree_leaves_with_path(want)]
    assert _dtypes(got) == [str(x.dtype) for x in jax.tree.leaves(want)]
    assert {"float32", "bfloat16"} <= set(_dtypes(p16))
    p32 = tT.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    for a, b in zip(tree_leaves(p32), tree_leaves(p16)):
        assert torch.equal(a.to(b.dtype), b) and b.requires_grad
    # the default is the fp32 draw itself, and a cast leaf is a new one
    assert all(t.dtype == torch.float32 for t in tree_leaves(p32))


@pytest.mark.parametrize("arch", ["hymba_1_5b", "seamless_m4t_large_v2"])
def test_decode_state_dtypes_are_the_references(arch):
    jcfg, tcfg = jreg.get(arch, smoke=True), treg.get(arch, smoke=True)
    want = jax.eval_shape(lambda: jT.init_decode_state(
        None, jcfg, B, MAX_LEN, jnp.bfloat16))
    got = tT.tree_to_jax({"layers": tT.init_decode_state(
        tcfg, B, MAX_LEN, device="cpu", dtype=torch.bfloat16)},
        tcfg)["segments"]
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
            for _, t in leaves_with_path(got)] == \
        [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(want)]
    fp32 = tT.init_decode_state(tcfg, B, MAX_LEN, device="cpu")
    assert set(_dtypes(fp32)) == {"float32"}


def test_cache_writes_keep_their_dtype_in_place():
    """cache_append into bf16 caches, ssm_decode_step on a bf16 conv
    buffer and an fp32 state, and a whole decode step of hymba (every
    entry kind): the K/V caches written in place, each entry in its
    dtype."""
    rng = np.random.default_rng(1)
    kc = torch.zeros((B, MAX_LEN, 2, 16), dtype=torch.bfloat16)
    vc = torch.zeros_like(kc)
    kn, vn = (torch.from_numpy(rng.standard_normal((B, 1, 2, 16)).astype(
        np.float32)).to(torch.bfloat16) for _ in "kv")
    ptrs = kc.data_ptr(), vc.data_ptr()
    k2, v2 = cache_append(kc, vc, kn, vn, 3)
    assert (k2.data_ptr(), v2.data_ptr()) == ptrs
    assert k2.dtype == v2.dtype == torch.bfloat16
    assert torch.equal(k2[:, 3], kn[:, 0]) and not k2[:, 4:].any()
    _, tcfg, _, tp = _reference("hymba_1_5b")
    caches = tT.init_decode_state(tcfg, B, MAX_LEN, device="cpu",
                                  dtype=torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((B, 1, tcfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        _, st, buf = tM.ssm_decode_step(tp["layers"][0]["ssm"], x, tcfg,
                                        caches[0]["ssm"], caches[0]["conv"])
    assert (st.dtype, buf.dtype) == (torch.float32, torch.bfloat16)
    before = [{k: (t.data_ptr(), t.dtype) for k, t in e.items()}
              for e in caches]
    tok = torch.tensor([[3], [5]])
    for step in range(2):
        _, caches = tT.decode_step(tp, tcfg, tok, caches, step)
    for e, was in zip(caches, before):
        for k, t in e.items():
            assert t.dtype == was[k][1], k
            if k in ("k", "v"):
                assert t.data_ptr() == was[k][0] and t[:, :2].any()


# -------------------------------------------- bf16 against the reference --

def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _reference_runs(jcfg, jp, toks, frames):
    """The reference's prefill and STEPS teacher-forced decode steps on
    `jp`, caches in `jp`'s weights' dtype: (last logits, each step's
    logits, the final caches' leaves)."""
    dt = jp["embed"].dtype
    f = None if frames is None else jnp.asarray(frames, dt)
    last, _, mem = jax.jit(lambda p, t, f: jT.prefill(
        p, jcfg, t, frames=f))(jp, toks, f)
    caches = jT.init_decode_state(jp, jcfg, B, MAX_LEN, dt)
    step_fn = jax.jit(lambda p, t, c, L, m: jT.decode_step(
        p, jcfg, t, c, L, memory=m))
    steps = []
    for i in range(STEPS):
        lg, caches = step_fn(jp, toks[:, i:i + 1], caches, jnp.int32(i), mem)
        steps.append(lg)
    return last, steps, jax.tree.leaves([list(seg) for seg in caches])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_and_decode_match_the_reference(arch):
    """The port's bf16 run against the reference's, each value within
    max(BF16_TOL, 2 e) of the reference's largest magnitude, where e is
    the reference's own bf16 run's distance from its fp32 run on the same
    (bf16-valued) params: two bf16 runs that round differently lie each
    within about e of the exact values, so within 2 e of each other."""
    jcfg, tcfg, jp, tp = _reference(arch)
    rng = np.random.default_rng(7)
    toks = rng.integers(1, jcfg.vocab, (B, S), dtype=np.int32)
    frames = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32) \
        if jcfg.is_encdec else None
    want = _reference_runs(jcfg, jp, toks, frames)
    exact = _reference_runs(jcfg, jax.tree.map(
        lambda a: a.astype(jnp.float32), jp), toks, frames)

    def check(got, i, what):
        w, x = np.asarray(want[i] if what == "prefill" else want[i][what],
                          np.float32), \
            exact[i] if what == "prefill" else exact[i][what]
        assert str(got.dtype).split(".")[-1] == str(
            (want[i] if what == "prefill" else want[i][what]).dtype), what
        tol = max(BF16_TOL, 2 * _rel(w, x))
        assert _rel(got.float(), w) <= tol, (what, _rel(got.float(), w), tol)
    tf = None if frames is None else torch.from_numpy(frames).to(
        torch.bfloat16)
    last, _, mem = tT.prefill(tp, tcfg, torch.from_numpy(toks), frames=tf)
    check(last, 0, "prefill")
    tc = tT.init_decode_state(tcfg, B, MAX_LEN, device="cpu",
                              dtype=torch.bfloat16)
    for i in range(STEPS):
        tl, tc = tT.decode_step(tp, tcfg, torch.from_numpy(
            toks[:, i:i + 1]), tc, i, memory=mem)
        check(tl, 1, i)
    got = tT.tree_to_jax({"layers": tc}, tcfg)["segments"]
    leaves = [g for _, g in leaves_with_path(got)]
    assert len(leaves) == len(want[2]) > 0
    for j, g in enumerate(leaves):
        check(g, 2, j)


# ------------------------------------------- at rest on 2 x 2 gloo ranks --

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("serve_rest"))
    return cases.run("serve_rest", DIMS, d)


RUNS = [r[0] for r in cases.SERVE_REST_RUNS]


@pytest.mark.parametrize("name", RUNS)
def test_at_rest_serving_is_the_whole_param_run(ranks, name):
    for r in ranks:
        np.testing.assert_array_equal(r[f"{name}/rest/ids"],
                                      r[f"{name}/whole/ids"])
        keys = [k[len(f"{name}/rest/"):] for k in r
                if k.startswith(f"{name}/rest/") and "gathers" not in k]
        assert {"prefill", "logits", "ids"} <= set(keys)
        assert any(k.startswith("cache.") for k in keys)
        for k in keys:
            got, want = r[f"{name}/rest/{k}"], r[f"{name}/whole/{k}"]
            assert got.shape == want.shape, k
            assert float(np.abs(got - want).max()) <= REST_TOL, (name, k)
        assert r[f"{name}/held_bytes"] < r[f"{name}/whole_bytes"]


def _derived_gathers(name, arch, blocks):
    """(prefill, decode step) gathers over "data" at use and over
    "model" that `rest_dims` and `model_blocks` derive: one over "data"
    a layer that holds a block, and one a use of the embedding, the final
    norms and the unembedding (or the tied embedding) that are blocks;
    one over "model" a vocabulary block's use, three a MoE layer's
    experts (the MoE routing's own gathers come on top, in both runs)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = cases.serve_rest_cfg(name, arch)
    with FakeTensorMode():
        params = tT.init(torch.Generator(), cfg, device="cpu")
        mesh = Mesh(dict(zip(("data", "model"), DIMS)), rank=0)
        held = params
        if "vocab" in blocks:
            held = shardings.vocab_blocks(held, mesh)
        if "experts" in blocks:
            held = shardings.expert_blocks(held, mesh)
        rest = shardings.rest_dims(held, mesh, tT.stack_counts(params, cfg))

    def cut(r):
        return any(d is not None for d in tree_leaves(r))
    table = "unembed" if "unembed" in rest else "embed"
    top = cut(rest["embed"]) + cut(rest["final_norm"]) + cut(rest[table])
    decode = top + sum(cut(r) for r in rest["layers"])
    prefill = decode + sum(cut(r) for r in rest.get("enc_layers", [])) \
        + cut(rest.get("enc_final_norm"))
    vocab = 2 * ("vocab" in blocks)
    experts = 3 * sum("moe" in lp for lp in params["layers"]) \
        * ("experts" in blocks)
    return (prefill, vocab + experts), (decode, vocab + experts)


@pytest.mark.parametrize("name", RUNS)
def test_gathers_a_step_are_what_the_layers_derive(ranks, name):
    arch, blocks = next((a, b) for n, a, b in cases.SERVE_REST_RUNS
                        if n == name)
    (p_data, p_model), (d_data, d_model) = _derived_gathers(name, arch,
                                                            blocks)
    assert d_data > 0
    for r in ranks:
        rest, whole = r[f"{name}/rest/gathers"], r[f"{name}/whole/gathers"]
        assert rest.shape == (1 + cases.SERVE_REST_STEPS, 2)
        assert not whole[:, 0].any()
        # the routing's own gathers over "model" are the whole run's too
        assert rest[0].tolist() == [p_data, p_model + whole[0, 1]]
        for step in range(1, 1 + cases.SERVE_REST_STEPS):
            assert rest[step].tolist() == [d_data, d_model + whole[step, 1]]
