"""The mixture-of-experts slice against the JAX reference on the CPU:
`models/lm/modules.py` `moe_route` / `moe_apply` (GShard capacity
routing), the MoE blocks of `transformer`, expert parallelism over
`ShardCtx.tp_axis` with `launch/shardings.py` `expert_blocks` /
`gather_experts`, and the mixtral-8x7b, olmoe-1b-7b, olmo-1b and
mamba2-780m configs.

Params are the reference's own `init` (seed 0) carried over by
`params_from_jax`; inputs are numpy draws from fixed seeds.  Routing is
discrete, so each routing test prints the smallest margin between a
token's k-th and (k+1)-th router probability in its inputs and holds the
routing itself (each pair's expert, its slot, whether it is kept) equal
to the reference's, with no tolerance.  Tolerances:

* `moe_apply`'s output and its gradients (in x and the four leaves): 2e-5
  of each one's largest magnitude (f32; the port sums a token's k kept
  outputs by an index add, the reference over every expert and slot of
  an einsum: the same sums in another order);
* under bf16 (every leaf bf16, the router too, x bf16): the output
  within 2^-7 of its largest magnitude (one bf16 rounding of a value
  that may land on the neighbouring one, as `chip_smoke.py`'s bf16
  kernel rows);
* the SMOKE `loss_fn`: rtol 1e-5, every gradient within 1e-4 of its
  leaf's largest magnitude (`chip_smoke.py`'s gradient rule: backward
  through rms norms amplifies the forward's rounding, and mamba2's
  embedding gradient has elements 1e-3 of its largest that differ by
  5e-4 of themselves);
* prefill's last logits and K/V, and 8 decode steps' logits: 2e-5 (the
  decode tests' F32);
* on gloo ranks (`torch_dist_cases.py` case `moe` on model 2, data 2 x
  model 2 and model 4, where mixtral's group of 64 spans every shard):
  the routing equal, y and dx within 2e-5 of their largest magnitude,
  the layer's gradients summed over the ranks within 1e-4 of each one's
  largest magnitude; olmoe's expert-parallel loss shares summed at rtol
  2e-5 (the sharded dense loss's) and its gradients whole within 1e-4 of
  each one's largest magnitude, the all-to-all bytes exact.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import jax_mesh_oracles as oracles
import torch_dist_cases as cases
from repro.configs import registry as jreg
from repro.data import pipeline as jpipe
from repro.models.lm import modules as jM
from repro.models.lm import transformer as jT
from repro_torch import utils as tutils
from repro_torch.configs import registry as treg
from repro_torch.launch import shardings
from repro_torch.models.lm import config as tconfig
from repro_torch.models.lm import modules as tM
from repro_torch.models.lm import transformer as tT
from repro_torch.train.train_loop import TrainStepConfig, make_grad_fn
from repro_torch.utils import FP32

torch.set_num_threads(2)

ARCHS = ["mixtral_8x7b", "olmoe_1b_7b", "olmo_1b", "mamba2_780m"]
MOE_ARCHS = ["mixtral_8x7b", "olmoe_1b_7b"]
F32 = 2e-5
BF16 = 2.0 ** -7
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
DIST_LOSS_RTOL = 2e-5
MESHES = [(1, 2), (2, 2), (1, 4)]
EP_MESHES = [(1, 2), (2, 2)]
STEPS = 8


def _tcfg(jcfg):
    return tconfig.LMConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _jparams(arch: str):
    return jax.tree.map(np.asarray, jT.init(jax.random.PRNGKey(0),
                                            jreg.get(arch, smoke=True)))


def _tparams(arch: str):
    return tT.params_from_jax(_jparams(arch), treg.get(arch, smoke=True))


def _moe_leaves(arch: str) -> dict:
    """The reference's layer-0 MoE leaves (numpy)."""
    return {k: v[0] for k, v in _jparams(arch)["segments"][0][0]["moe"]
            .items()}


def _x(seed: int, b: int, s: int, d: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def _jax_routing(p, x, cfg):
    """The reference's routing, the lines of its `moe_apply` that form
    it: each pair's expert, its slot in its expert's group buffer,
    whether it is kept, and the smallest margin between a token's k-th
    and (k+1)-th router probability."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    gs = min(s, jM.MOE_GROUP)
    ns = s // gs
    xt = jnp.asarray(x).reshape(b, ns, gs, d)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ p["router"], -1)
    _, idx = lax.top_k(probs, k)
    cap = max(1, int(cfg.capacity_factor * k * gs / e))
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.float32)
    pos = jnp.cumsum(onehot.reshape(b, ns, gs * k, e), 2) \
        .reshape(b, ns, gs, k, e) - 1.0
    pos_sel = jnp.sum(pos * onehot, axis=-1)
    top = lax.top_k(probs, min(k + 1, e))[0]
    margin = float((top[..., k - 1] - top[..., k]).min()) if k < e \
        else float("inf")
    return (np.asarray(idx).reshape(b, s, k),
            np.asarray(pos_sel).reshape(b, s, k).astype(np.int64),
            np.asarray(pos_sel < cap).reshape(b, s, k), margin)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def _assert_routing(r, want):
    idx, slot, keep, margin = want
    print(f"smallest top-k margin of the inputs: {margin:.3e}")
    np.testing.assert_array_equal(r.idx.numpy(), idx)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_allclose(float(r.margin.min()), margin, atol=1e-6)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for smoke in (False, True):
        j, t = jreg.get(arch, smoke=smoke), treg.get(arch, smoke=smoke)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.layer_types() == j.layer_types()
        assert t.total_params() == j.total_params()
        assert t.params_per_token() == j.params_per_token()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_and_params_from_jax_round_trip(arch):
    """The port's `init` draws the reference's leaves and shapes (the
    router (d, e), `wi` / `wg` (e, d, f), `wo` (e, f, d) stacked per
    layer), and `tree_to_jax` of `params_from_jax` gives the reference's
    tree back bit for bit."""
    tcfg = treg.get(arch, smoke=True)
    jp = _jparams(arch)
    back = tT.tree_to_jax(_tparams(arch), tcfg)
    jl, bl = jax.tree.leaves(jp), jax.tree.leaves(jax.tree.map(
        lambda t: t.detach().numpy(), back, is_leaf=torch.is_tensor))
    assert len(jl) == len(bl)
    for a, b in zip(jl, bl):
        np.testing.assert_array_equal(a, b)
    mine = tT.tree_to_jax(tT.init(torch.Generator().manual_seed(0), tcfg,
                                  device="cpu"), tcfg)
    assert jax.tree.map(np.shape, jp) == jax.tree.map(
        lambda t: tuple(t.shape), mine, is_leaf=torch.is_tensor)
    moe = mine["segments"][0][0]["moe"]
    e, d, f = tcfg.n_experts, tcfg.d_model, tcfg.d_ff
    assert tuple(moe["router"].shape[1:]) == (d, e)
    assert tuple(moe["wo"].shape[1:]) == (e, f, d)


# ---------------------------------------------------------------------------
# the layer on one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [64, 512])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_jax(arch, seq):
    """One group of 64, or two of 256: routing equal, output and
    gradients (jax.vjp) within F32."""
    jcfg, tcfg = jreg.get(arch, smoke=True), treg.get(arch, smoke=True)
    p = _moe_leaves(arch)
    x = _x(1, 2, seq, jcfg.d_model)
    g = _x(2, 2, seq, jcfg.d_model)
    y, vjp = jax.vjp(jax.jit(lambda p, x: jM.moe_apply(
        p, x, jcfg, jM.ShardCtx())), p, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    ty = tM.moe_apply(tp, tx, tcfg)
    _close(ty.detach(), y, F32, "y")
    names = sorted(tp)
    grads = torch.autograd.grad((ty * torch.from_numpy(g)).sum(),
                                [tx] + [tp[n] for n in names])
    _close(grads[0], jgx, F32, "dx")
    for n, gt in zip(names, grads[1:]):
        _close(gt, jgp[n], F32, n)
    _assert_routing(tM.moe_route(tp["router"], tx, tcfg),
                    _jax_routing(p, x, jcfg))


def test_moe_capacity_drops_match_jax():
    """olmoe SMOKE at a capacity factor of 0.5 (cap 8 slots for an average
    load of 16 a group of 64): the dropped pairs are the reference's, a
    token whose every choice is dropped gets exactly 0, and the output
    is the reference's."""
    jcfg = dataclasses.replace(jreg.get("olmoe_1b_7b", smoke=True),
                               capacity_factor=0.5)
    tcfg = _tcfg(jcfg)
    p = _moe_leaves("olmoe_1b_7b")
    x = _x(3, 2, 64, jcfg.d_model)
    want = jM.moe_apply(p, jnp.asarray(x), jcfg, jM.ShardCtx())
    tp = {k: torch.tensor(v) for k, v in p.items()}
    r = tM.moe_route(tp["router"], torch.from_numpy(x), tcfg)
    _assert_routing(r, _jax_routing(p, x, jcfg))
    assert r.cap == 8 and int((~r.keep).sum()) > 0
    y = tM.moe_apply(tp, torch.from_numpy(x), tcfg)
    _close(y, want, F32, "y")
    gone = ~r.keep.any(-1)
    assert int(gone.sum()) > 0
    assert torch.equal(y[gone], torch.zeros_like(y[gone]))
    np.testing.assert_array_equal(np.asarray(want)[gone.numpy()], 0.0)


def test_moe_top1_matches_per_token_mlp():
    """Top-1 with capacity_factor = n_experts (nothing dropped): each
    token's output is its argmax expert's SwiGLU MLP (the reference's
    test_moe_top1_routes_all_tokens) at 2e-5."""
    cfg = dataclasses.replace(treg.get("mixtral_8x7b", smoke=True), top_k=1,
                              capacity_factor=4.0)
    p = {k: torch.tensor(v) for k, v in _moe_leaves("mixtral_8x7b").items()}
    x = torch.from_numpy(_x(4, 2, 64, cfg.d_model))
    r = tM.moe_route(p["router"], x, cfg)
    assert bool(r.keep.all())
    y = tM.moe_apply(p, x, cfg)
    xt = x.reshape(-1, cfg.d_model)
    idx = (xt @ p["router"]).argmax(-1)
    want = torch.stack([tM.mlp_apply({n: p[n][e] for n in ("wi", "wg",
                                                           "wo")},
                                     xt[t], cfg)
                        for t, e in enumerate(idx.tolist())])
    _close(y.reshape(-1, cfg.d_model), want, F32, "top-1")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_bf16_matches_jax(arch):
    """Every leaf in bf16, the router too, and x in bf16: the logits are
    x in fp32 against the bf16-rounded router in an fp32 product (the
    reference's `x.astype(f32) @ router`), so the routing is the
    reference's, and differs from the unrounded router's; the output
    within BF16 of its largest magnitude."""
    jcfg, tcfg = jreg.get(arch, smoke=True), treg.get(arch, smoke=True)
    p32 = _moe_leaves(arch)
    p = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p32)
    x = jnp.asarray(_x(5, 2, 64, jcfg.d_model), jnp.bfloat16)
    want = jM.moe_apply(p, x, jcfg, jM.ShardCtx())
    assert want.dtype == jnp.bfloat16
    tp = {k: torch.tensor(v).to(torch.bfloat16) for k, v in p32.items()}
    tx = torch.tensor(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    r = tM.moe_route(tp["router"], tx, tcfg)
    _assert_routing(r, _jax_routing(p, np.asarray(x.astype(jnp.float32)),
                                    jcfg))
    unrounded = tM.moe_route(torch.tensor(p32["router"]), tx, tcfg)
    assert not torch.equal(r.gate, unrounded.gate)
    y = tM.moe_apply(tp, tx, tcfg)
    assert y.dtype == torch.bfloat16
    _close(y.float(), np.asarray(want.astype(jnp.float32)), BF16, "bf16 y")


def test_moe_group_must_divide_the_sequence():
    """S 300 is not a multiple of the group of 256: the reference's
    reshape fails, and the port raises rather than pad."""
    jcfg, tcfg = jreg.get("olmoe_1b_7b", smoke=True), \
        treg.get("olmoe_1b_7b", smoke=True)
    p = _moe_leaves("olmoe_1b_7b")
    x = _x(6, 1, 300, jcfg.d_model)
    with pytest.raises(TypeError):
        jM.moe_apply(p, jnp.asarray(x), jcfg, jM.ShardCtx())
    tp = {k: torch.tensor(v) for k, v in p.items()}
    with pytest.raises(ValueError, match="routing group"):
        tM.moe_apply(tp, torch.from_numpy(x), tcfg)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_loss_and_grads_match_jax(arch):
    """SMOKE `loss_fn` on synthetic batch 0 (2 x 64) and every gradient,
    through the train step's gradient function (`make_grad_fn`), against
    `jax.value_and_grad` of the reference's (olmo's empty non-parametric
    norms get empty gradients)."""
    jcfg, tcfg = jreg.get(arch, smoke=True), treg.get(arch, smoke=True)
    nb = jpipe.synthetic_lm_batch(0, 2, 64, jcfg.vocab)
    loss, grads = jax.jit(jax.value_and_grad(functools.partial(
        jT.loss_fn, cfg=jcfg, remat=False)))(
        _jparams(arch), {k: jnp.asarray(v) for k, v in nb.items()})
    params = _tparams(arch)
    tl, got = make_grad_fn(functools.partial(tT.loss_fn, cfg=tcfg),
                           TrainStepConfig(precision=FP32))(
        params, {k: torch.from_numpy(v) for k, v in nb.items()})
    want = tutils.tree_leaves(tT.params_from_jax(
        jax.tree.map(np.asarray, grads), tcfg))
    np.testing.assert_allclose(tl.item(), float(loss), rtol=LOSS_RTOL)
    assert len(got) == len(want)
    for i, (g, w, p) in enumerate(zip(got, want,
                                      tutils.tree_leaves(params))):
        assert g.shape == p.shape, f"leaf {i}"
        if p.numel():
            _close(g, w.detach(), GRAD_TOL, f"leaf {i}")


def test_grad_fn_refuses_a_leaf_the_loss_does_not_reach():
    """Only an empty leaf may be left out of the loss: the gradient
    function gives it an empty gradient, and raises for any other."""
    def loss_fn(p, batch):
        return (p["w"] * batch).sum()

    w, empty = torch.ones(3, requires_grad=True), torch.ones(0)
    grad_fn = make_grad_fn(loss_fn, TrainStepConfig(precision=FP32))
    loss, grads = grad_fn({"w": w, "norm": empty}, torch.arange(3.0))
    assert [tuple(g.shape) for g in grads] == [(0,), (3,)]
    assert torch.equal(grads[1], torch.arange(3.0))
    with pytest.raises(RuntimeError):
        grad_fn({"w": w, "u": torch.ones(2, requires_grad=True)},
                torch.arange(3.0))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_decode_match_jax(arch):
    """`prefill` of a 64-token prompt (its last logits and every layer's
    K/V) and 8 teacher-forced `decode_step`s from empty caches (each
    step's token routed alone: a group of 1, capacity 1, nothing
    dropped) against the reference's, within F32."""
    jcfg, tcfg = jreg.get(arch, smoke=True), treg.get(arch, smoke=True)
    jp, params = _jparams(arch), _tparams(arch)
    toks = np.random.default_rng(7).integers(
        1, jcfg.vocab, (2, 64)).astype(np.int32)
    jlast, jkv, _ = jax.jit(lambda p, t: jT.prefill(p, jcfg, t))(jp, toks)
    last, kv, _ = tT.prefill(params, tcfg, torch.as_tensor(toks))
    _close(last, jlast, F32, "prefill logits")
    got = tT.tree_to_jax({"layers": kv}, tcfg)["segments"]
    for si, (gs, ws) in enumerate(zip(got, jkv)):
        for (gk, gv), (wk, wv) in zip(gs, ws):
            _close(gk, wk, F32, f"segment {si} k")
            _close(gv, wv, F32, f"segment {si} v")
    jc = jT.init_decode_state(jp, jcfg, 2, 16, dtype=jnp.float32)
    tc = tT.init_decode_state(tcfg, 2, 16, device="cpu")
    step = jax.jit(lambda p, t, c, n: jT.decode_step(p, jcfg, t, c, n))
    for i in range(STEPS):
        jl, jc = step(jp, toks[:, i:i + 1], jc, jnp.int32(i))
        tl, tc = tT.decode_step(params, tcfg, torch.as_tensor(
            toks[:, i:i + 1]), tc, i)
        _close(tl, jl, F32, f"decode step {i}")
        np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                      np.asarray(jl).argmax(-1))


def test_expert_blocks_without_a_mesh_are_the_params():
    params = _tparams("olmoe_1b_7b")
    blocks = shardings.expert_blocks(params, None)
    for a, b in zip(tutils.tree_leaves(params), tutils.tree_leaves(blocks)):
        assert torch.equal(a, b)
    whole = shardings.gather_experts(blocks, None)
    assert all(torch.equal(a, b) for a, b in zip(
        tutils.tree_leaves(params), tutils.tree_leaves(whole)))


# ---------------------------------------------------------------------------
# on gloo ranks
# ---------------------------------------------------------------------------

def _stitch(blocks: list, dims: tuple) -> np.ndarray:
    """The global (B, S, ...) array from each rank's block: B over data,
    S over model (ranks holding the same block must agree)."""
    b0 = blocks[0]
    out = np.zeros((b0.shape[0] * dims[0], b0.shape[1] * dims[1])
                   + b0.shape[2:], b0.dtype)
    seen = np.zeros(out.shape[:2], bool)
    for r, blk in enumerate(blocks):
        bi = cases.shard(r, dims, ("data",))[0]
        si = cases.shard(r, dims, "model")[0]
        sl = (slice(bi * blk.shape[0], (bi + 1) * blk.shape[0]),
              slice(si * blk.shape[1], (si + 1) * blk.shape[1]))
        if seen[sl].all():
            np.testing.assert_array_equal(out[sl], blk)
        out[sl], seen[sl] = blk, True
    assert seen.all()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's ranks of case `moe`, started at once."""
    d = str(tmp_path_factory.mktemp("moe_dist"))
    flat = {}
    for arch in (cases.MOE_ROUTE_ARCH, cases.MOE_EP_ARCH):
        _, jp = oracles.lm_reference_params(arch)
        tp = tT.params_from_jax(jax.tree.map(np.asarray, jp),
                                treg.get(arch, smoke=True))
        flat.update({f"{arch}/{i}": t.detach().numpy()
                     for i, t in enumerate(tutils.tree_leaves(tp))})
    started = {}
    for dims in MESHES:
        sub = os.path.join(d, f"{dims[0]}x{dims[1]}")
        os.makedirs(sub)
        np.savez(os.path.join(sub, "inputs.npz"), **flat)
        started[dims] = (cases.start("moe", dims, sub), sub)
    return {dims: cases.collect(p, dims, sub)
            for dims, (p, sub) in started.items()}


@functools.lru_cache(maxsize=None)
def _layer_reference():
    """The reference's mixtral SMOKE layer-0 MoE on the whole of
    `moe_inputs`: y, its vjp of g in x and the leaves, the routing."""
    jcfg = jreg.get(cases.MOE_ROUTE_ARCH.replace("-", "_"), smoke=True)
    p = _moe_leaves("mixtral_8x7b")
    x = cases.moe_inputs(jcfg.d_model)
    y, vjp = jax.vjp(jax.jit(lambda p, x: jM.moe_apply(
        p, x, jcfg, jM.ShardCtx())), p, jnp.asarray(x["x"]))
    gp, gx = vjp(jnp.asarray(x["g"]))
    return {"y": np.asarray(y), "dx": np.asarray(gx),
            "grads": {k: np.asarray(v) for k, v in gp.items()},
            "routing": _jax_routing(p, x["x"], jcfg)}


@pytest.mark.parametrize("dims", MESHES)
def test_sharded_routing_matches_jax(dims, runs):
    """Groups of 64 over S 64 split over the model axis: every shard's
    slots continue the counts of the group's earlier shards."""
    ranks = runs[dims]
    idx, slot, keep, margin = _layer_reference()["routing"]
    print(f"smallest top-k margin of the inputs: {margin:.3e}")
    for name, want in (("idx", idx), ("slot", slot), ("keep", keep)):
        np.testing.assert_array_equal(
            _stitch([r[f"route.{name}"] for r in ranks], dims), want)
    assert int((~keep).sum()) >= 0


@pytest.mark.parametrize("dims", MESHES)
def test_sharded_moe_matches_jax(dims, runs):
    ranks, ref = runs[dims], _layer_reference()
    _close(_stitch([r["moe.y"] for r in ranks], dims), ref["y"], F32, "y")
    _close(_stitch([r["moe.dx"] for r in ranks], dims), ref["dx"], F32,
           "dx")
    for n, want in ref["grads"].items():
        _close(sum(r[f"moe.grad.{n}"] for r in ranks), want, GRAD_TOL, n)


@functools.lru_cache(maxsize=None)
def _ep_reference():
    cfg, params = oracles.lm_reference_params(cases.MOE_EP_ARCH)
    nb = jpipe.synthetic_lm_batch(0, cases.MOE_BATCH, cases.MOE_EP_SEQ,
                                  cfg.vocab)
    loss, grads = jax.jit(jax.value_and_grad(functools.partial(
        jT.loss_fn, cfg=cfg, remat=False)))(
        params, {k: jnp.asarray(v) for k, v in nb.items()})
    tcfg = treg.get(cases.MOE_EP_ARCH, smoke=True)
    return float(loss), [g.detach().numpy() for g in tutils.tree_leaves(
        tT.params_from_jax(jax.tree.map(np.asarray, grads), tcfg))]


@pytest.mark.parametrize("dims", EP_MESHES)
def test_expert_parallel_loss_matches_jax(dims, runs):
    """olmoe SMOKE at batch 2 x seq 512 with its 8 experts over model 2
    (4 a rank): the summed shares against the reference's one-device
    loss, every gradient whole against `jax.grad`, and each all-to-all's
    bytes: a rank's (e, B_local x groups x cap, d) fp32 buffer, half of
    it sent, once a layer forward and once backward, for the dispatch
    and for the combine."""
    ranks = runs[dims]
    loss, grads = _ep_reference()
    np.testing.assert_allclose(sum(float(r["ep.loss_share"]) for r in ranks),
                               loss, rtol=DIST_LOSS_RTOL)
    assert len(grads) == sum(k.startswith("ep.grad.") for k in ranks[0])
    for i, want in enumerate(grads):
        for r in ranks:
            _close(r[f"ep.grad.{i}"], want, GRAD_TOL, f"leaf {i}")
    cfg = treg.get(cases.MOE_EP_ARCH, smoke=True)
    cap = int(cfg.capacity_factor * cfg.top_k * tM.MOE_GROUP
              / cfg.n_experts)
    rows = cases.MOE_BATCH // dims[0] * (cases.MOE_EP_SEQ // dims[1]
                                         // tM.MOE_GROUP) * cap
    half = cfg.n_experts * rows * cfg.d_model * 4 // 2
    for r in ranks:
        for name in ("moe_dispatch", "moe_combine"):
            assert int(r[f"ep.sent.{name}"]) == 2 * cfg.n_layers * half


def test_expert_parallel_refuses_groups_spanning_shards(runs):
    """On model 4 a group of 256 spans two shards of 128: expert
    parallelism raises there (ROADMAP Queue 3) while the non-EP layer
    routes the same groups (test_sharded_moe_matches_jax)."""
    for r in runs[(1, 4)]:
        assert "span sequence shards" in str(r["ep.error"])
        assert not any(k.startswith("ep.grad.") for k in r)
