"""The encoder-decoder (seamless-m4t-large-v2: `encode`, the `enc` and
`xattn` blocks, their decode, the serve entry point) and the VLM prefix
frontend (pixtral-12b) against the JAX reference on the CPU.

Params come from the reference's own `init` (seed 0), carried over by
`params_from_jax`; inputs are `synthetic_lm_batch(0, 2, 64, vocab)` and
numpy draws of seed 16 (`torch_dist_cases.encdec_inputs`: seamless's
frames, pixtral's patch prefix, the xattn block's x and memory).  On
gloo CPU ranks (`torch_dist_cases.py` case `encdec`, one spawned group
for model 2 and one for data 2 x model 2) the frames, and the prefix +
text, are split over "model".  Tolerances and their reasons:

* one device, f32 (`encode`'s memory, prefill, decode, the xattn block):
  2e-5, the same sums in another order;
* the SMOKE losses rtol 1e-5, every gradient rtol 1e-4 / atol 1e-6 (the
  LM slices' tolerance: the backward divides by norms);
* the mesh: seamless's loss rtol 2e-5 (`tests/dist_checks.py:193`), the
  pixtral vocab-parallel loss rtol 3e-5 (`:211`), their gradients rtol
  1e-4 / atol 1e-6 (tighter than dist_checks' 5e-3 / 5e-5), the ring's
  memory, prefill and the decode steps 2e-4 (`:242`'s decode tolerance);
  the xattn block on the mesh against one device 2e-5;
* the 3-step AdamW trajectory: losses and grad norms rtol 1e-4, params as
  `test_torch_lm.py`'s;
* the encoder's gradients: exactly 0 in both packages, as no layer of the
  reference's `layer_types()` is `xattn` (ROADMAP Queue 3: the memory is
  never read).
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from repro import utils as jutils
from repro.checkpoint import checkpoint as jck
from repro.configs import pixtral_12b as jpixtral
from repro.configs import seamless_m4t_large_v2 as jseamless
from repro.models.lm import transformer as jT
from repro.models.lm.modules import ShardCtx as JCtx
from repro.optim import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import utils as tutils
from repro_torch.checkpoint import checkpoint as tck
from repro_torch.configs import registry as treg
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import serve
from repro_torch.launch import shardings
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import Mesh
from repro_torch.models.lm import transformer as tT
from repro_torch.optim import optimizer as topt
from repro_torch.train import train_loop as ttl

torch.set_num_threads(2)

F32 = 2e-5
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
MESH_LOSS_RTOL = {"seamless": 2e-5, "pixtral": 3e-5}
MESH_TOL = 2e-4
MESHES = [(1, 2), (2, 2)]
ARCHS = {"seamless": (cases.ENCDEC_ARCH, jseamless.SMOKE),
         "pixtral": (cases.PREFIX_ARCH, jpixtral.SMOKE)}
CPU = torch.device("cpu")


def _tcfg(name: str):
    return treg.get(ARCHS[name][0], smoke=True)


@functools.lru_cache(maxsize=None)
def _jparams(name: str):
    """The reference's SMOKE params (seed 0) as numpy arrays."""
    return jax.tree.map(np.asarray, jT.init(jax.random.PRNGKey(0),
                                            ARCHS[name][1]))


def _params(name: str) -> dict:
    return tT.params_from_jax(_jparams(name), _tcfg(name))


def _batch(name: str) -> dict:
    return cases.encdec_batch(_tcfg(name))


def _jbatch(name: str) -> dict:
    return {k: jnp.asarray(v) for k, v in _batch(name).items()}


@functools.lru_cache(maxsize=None)
def _reference(name: str) -> dict:
    """The reference's one-device loss and gradients (in the port's leaf
    order) on `_batch(name)`; seamless's memory, prefill and decode steps
    (the tokens of `ENCDEC_DECODE_TOKENS`, with the memory)."""
    jcfg, jp = ARCHS[name][1], _jparams(name)
    nb = _jbatch(name)
    loss, grads = jax.jit(jax.value_and_grad(functools.partial(
        jT.loss_fn, cfg=jcfg, remat=False)))(jp, nb)
    out = {"loss": float(loss), "grads": [
        g.detach().numpy() for g in tutils.tree_leaves(tT.params_from_jax(
            jax.tree.map(np.asarray, grads), _tcfg(name)))]}
    if name == "seamless":
        out["memory"] = np.asarray(jT.encode(jp, jcfg, nb["frames"], JCtx(),
                                             remat=False))
        last, kv, memory = jax.jit(lambda p, t, f: jT.prefill(
            p, jcfg, t, frames=f))(jp, nb["tokens"], nb["frames"])
        out["prefill"] = (np.asarray(last), jax.tree.map(np.asarray, kv),
                          np.asarray(memory))
        caches = jT.init_decode_state(jp, jcfg, cases.ENCDEC_BATCH,
                                      cases.ENCDEC_DECODE_LEN,
                                      dtype=jnp.float32)
        step = jax.jit(lambda p, t, c, n, m: jT.decode_step(
            p, jcfg, t, c, n, memory=m))
        for i, tok in enumerate(cases.ENCDEC_DECODE_TOKENS):
            logits, caches = step(jp, jnp.asarray(tok, jnp.int32), caches,
                                  jnp.int32(i), out["memory"])
            out[f"decode.{i}"] = np.asarray(logits)
    else:
        logits = jT.forward(jp, jcfg, nb["tokens"],
                            extra_embeds=nb["patch_embeds"], remat=False)
        out["logits"] = np.asarray(logits)
    return out


def _close(got, want, tol, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


def _grads_close(grads, want):
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"leaf {i}")


def _enc_leaf_indices(params: dict) -> list[int]:
    """Indices in `tree_leaves(params)` of the encoder's leaves."""
    enc = {id(t) for t in tutils.tree_leaves([params["enc_final_norm"],
                                              params["enc_layers"]])}
    return [i for i, t in enumerate(tutils.tree_leaves(params))
            if id(t) in enc]


# --------------------------------------------------------- one device --

def test_seamless_encode_matches_jax():
    cfg, params = _tcfg("seamless"), _params("seamless")
    with torch.no_grad():
        memory = tT.encode(params, cfg, torch.from_numpy(
            _batch("seamless")["frames"]))
    assert memory.shape == (cases.ENCDEC_BATCH, cases.ENCDEC_SEQ,
                            cfg.d_model)
    _close(memory, _reference("seamless")["memory"], F32)


@pytest.mark.parametrize("name", list(ARCHS))
def test_loss_and_grads_match_jax(name):
    """seamless with its frames (the encoder's gradients exactly 0 in both
    packages), pixtral with its patch prefix (the text tail scored)."""
    cfg, params = _tcfg(name), _params(name)
    loss = tT.loss_fn(params, tpipe.to_device(_batch(name), CPU), cfg)
    grads = [g.numpy() for g in torch.autograd.grad(
        loss, tutils.tree_leaves(params))]
    ref = _reference(name)
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=LOSS_RTOL)
    _grads_close(grads, ref["grads"])
    if name == "seamless":
        enc = _enc_leaf_indices(params)
        assert len(enc) == 1 + 8 * cfg.n_enc_layers
        for i in enc:
            assert not grads[i].any() and not ref["grads"][i].any()


def test_seamless_loss_runs_no_dead_encoder(monkeypatch):
    """No layer reads the memory: the loss never calls `encode`, and the
    frames do not move it (the reference's figures: the same loss for
    frames f and 3 f + 1)."""
    cfg, params = _tcfg("seamless"), _params("seamless")
    batch = tpipe.to_device(_batch("seamless"), CPU)
    want = tT.loss_fn(params, batch, cfg).item()
    jb = _jbatch("seamless")
    jloss = functools.partial(jT.loss_fn, cfg=jseamless.SMOKE, remat=False)
    assert float(jloss(_jparams("seamless"), jb)) == float(jloss(
        _jparams("seamless"), dict(jb, frames=3 * jb["frames"] + 1)))

    def refuse(*a, **k):
        raise AssertionError("encode ran")
    monkeypatch.setattr(tT, "encode", refuse)
    batch["frames"] = 3 * batch["frames"] + 1
    assert tT.loss_fn(params, batch, cfg).item() == want
    del batch["frames"]
    with pytest.raises(ValueError, match="frames"):
        tT.loss_fn(params, batch, cfg)


def test_seamless_prefill_matches_jax():
    """prefill's last logits, every layer's K/V and the memory (the
    reference's third value), and the last logits against `forward`."""
    cfg, params = _tcfg("seamless"), _params("seamless")
    nb = _batch("seamless")
    tokens, frames = torch.from_numpy(nb["tokens"]), \
        torch.from_numpy(nb["frames"])
    last, kv, memory = tT.prefill(params, cfg, tokens, frames=frames)
    jlast, jkv, jmem = _reference("seamless")["prefill"]
    _close(last, jlast, F32)
    _close(memory, jmem, F32)
    for seg, jseg in zip(tT.tree_to_jax({"layers": kv}, cfg)["segments"],
                         jkv):
        for got, want in zip(jax.tree.leaves(jax.tree.map(
                lambda t: t.numpy(), seg, is_leaf=torch.is_tensor)),
                jax.tree.leaves(jseg)):
            _close(got, want, F32)
    with torch.no_grad():
        full = tT.forward(params, cfg, tokens, frames=frames)
    _close(last, full[:, -1:], F32)


def test_seamless_decode_steps_match_jax():
    """Three decode steps from empty caches with the memory, as
    `tests/test_archs_smoke.py`'s decode path runs them."""
    cfg, params = _tcfg("seamless"), _params("seamless")
    ref = _reference("seamless")
    memory = torch.from_numpy(np.array(ref["memory"]))
    caches = tT.init_decode_state(cfg, cases.ENCDEC_BATCH,
                                  cases.ENCDEC_DECODE_LEN, device="cpu")
    assert all(set(c) == {"k", "v"} for c in caches)
    for i, tok in enumerate(cases.ENCDEC_DECODE_TOKENS):
        logits, caches = tT.decode_step(params, cfg, torch.tensor(tok),
                                        caches, i, memory=memory)
        _close(logits, ref[f"decode.{i}"], F32, f"step {i}")


def test_seamless_three_step_adamw_trajectory_matches_jax():
    """The reference's make_train_step + adamw on batch s (with its
    frames) against the port's, from the same params: the loss, the
    grad norm, the params after 3 steps; the encoder's leaves move by
    AdamW's decay alone, as the reference's do."""
    jcfg, tcfg = jseamless.SMOKE, _tcfg("seamless")
    lr, steps = 3e-3, 3
    jo = jopt.adamw(jopt.warmup_cosine(lr, 20, steps))
    jstep = jtl.make_train_step(
        functools.partial(jT.loss_fn, cfg=jcfg, remat=False), jo, None,
        jtl.TrainStepConfig(precision=jutils.FP32))
    jparams = jax.tree.map(jnp.asarray, _jparams("seamless"))
    jstate = jo.init(jparams)
    opt = topt.adamw(topt.warmup_cosine(lr, 20, steps))
    tstep = ttl.make_train_step(functools.partial(tT.loss_fn, cfg=tcfg),
                                opt, ttl.TrainStepConfig(
                                    precision=tutils.FP32))
    params = _params("seamless")
    before = [t.detach().clone() for t in tutils.tree_leaves(params)]
    state = opt.init(params)
    frames = _batch("seamless")["frames"]
    for s in range(steps):
        nb = dict(tpipe.synthetic_lm_batch(s, cases.ENCDEC_BATCH,
                                           cases.ENCDEC_SEQ, tcfg.vocab),
                  frames=frames)
        jparams, jstate, _, jm = jstep(
            jparams, jstate, None, {k: jnp.asarray(v) for k, v in nb.items()})
        params, state, _, m = tstep(params, state, None,
                                    tpipe.to_device(nb, CPU))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    want = tT.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    lr_sum = sum(topt.warmup_cosine(lr, 20, steps)(s + 1)
                 for s in range(steps))
    n_off = n_all = 0
    for p, w in zip(tutils.tree_leaves(params), tutils.tree_leaves(want)):
        diff = (p - w).abs().detach()
        n_off += int((diff > 1e-6 + 1e-4 * w.detach().abs()).sum())
        n_all += diff.numel()
        assert float(diff.max()) <= 2 * lr_sum
    assert n_off <= 1e-3 * n_all, (n_off, n_all)
    leaves = tutils.tree_leaves(params)
    for i in _enc_leaf_indices(params):
        np.testing.assert_allclose(leaves[i].detach().numpy(),
                                   tutils.tree_leaves(want)[i].detach()
                                   .numpy(),
                                   rtol=1e-6, atol=1e-7)
        if before[i].abs().max() > 0:      # decay moves the nonzero ones
            assert not torch.equal(leaves[i].detach(), before[i])


def _xattn_params():
    """The reference's xattn block (seed 5) and the port's copy of it."""
    jcfg = jseamless.SMOKE
    jp = jax.tree.map(np.asarray, jT._block_init(jax.random.PRNGKey(5), jcfg,
                                                 "xattn", jnp.float32))
    tp = tutils.tree_map(lambda a: torch.from_numpy(np.array(a))
                         .requires_grad_(), jp)
    assert set(tp) == {"ln1", "attn", "ln_cross", "cross", "ln2", "mlp"}
    return jp, tp


def test_xattn_block_matches_jax():
    """`_block_apply` on an xattn block in both packages, called directly
    with the same x and a memory of another length: the causal
    self-attention, the cross call (q roped, the memory's K/V not),
    the MLP; and its gradients in x, the memory and the params."""
    jcfg, cfg = jseamless.SMOKE, _tcfg("seamless")
    jp, tp = _xattn_params()
    inp = cases.encdec_inputs(cfg.d_model, cfg.frontend_len)
    x, mem, g = inp["x"], inp["memory"], inp["g"]

    def jfn(p, x, m):
        return jT._block_apply(p, x, "xattn", jcfg, JCtx(),
                               jnp.arange(x.shape[1]), memory=m)[0]
    jy, jvjp = jax.vjp(jfn, jp, x, mem)
    jgp, jgx, jgm = jvjp(g)
    xs = torch.from_numpy(x).requires_grad_()
    ms = torch.from_numpy(mem).requires_grad_()
    y = tT._block_apply(tp, xs, "xattn", cfg,
                        torch.arange(x.shape[1]), memory=ms)
    grads = torch.autograd.grad((y * torch.from_numpy(g)).sum(),
                                [xs, ms] + tutils.tree_leaves(tp))
    _close(y, jy, F32)
    _close(grads[0], jgx, F32)
    _close(grads[1], jgm, F32)
    for got, want in zip(grads[2:], jax.tree.leaves(jgp)):
        _close(got, want, 1e-4)
    with pytest.raises(ValueError, match="memory"):
        tT._block_apply(tp, xs, "xattn", cfg, torch.arange(x.shape[1]))


def test_xattn_decode_block_matches_jax():
    """`_decode_block` on the xattn block in both packages, two steps
    with the same memory: the self-attention through its cache, the cross
    query unroped (the reference's decode, which differs from its
    forward by that rope); without a memory both skip the cross call."""
    jcfg, cfg = jseamless.SMOKE, _tcfg("seamless")
    jp, tp = _xattn_params()
    inp = cases.encdec_inputs(cfg.d_model, cfg.frontend_len)
    b = cases.ENCDEC_BATCH
    scale = 1.0 / np.sqrt(cfg.head_dim)
    for memory in (inp["memory"], None):
        jc = {k: jnp.zeros((b, cases.ENCDEC_DECODE_LEN, cfg.n_kv_heads,
                            cfg.head_dim)) for k in ("k", "v")}
        tc = tT.init_decode_state(cfg, b, cases.ENCDEC_DECODE_LEN,
                                  device="cpu")[0]
        tm = None if memory is None else torch.from_numpy(memory)
        for step in range(2):
            xd = inp["x_dec"][:, step:step + 1]
            pos = np.full((b, 1), step, np.int32)
            jy, jc = jT._decode_block(jp, jnp.asarray(xd), "xattn", jcfg,
                                      JCtx(), pos, jnp.int32(step), jc,
                                      scale, memory)
            with torch.no_grad():
                y = tT._decode_block(tp, torch.from_numpy(xd), "xattn", cfg,
                                     tT.ShardCtx(), torch.from_numpy(pos)
                                     .long(), step, tc, scale, tm)
            _close(y, jy, F32, f"step {step}, memory {memory is not None}")
            _close(tc["k"], jc["k"], F32)


def test_xattn_decode_differs_from_its_forward_as_the_reference():
    """The reference's fault, mirrored: its forward ropes the cross query
    and its decode step does not, so the decode of the last token of x
    differs from the forward's last row by what the rope moves, in both
    packages alike (their differences agree to 2e-5)."""
    jcfg, cfg = jseamless.SMOKE, _tcfg("seamless")
    jp, tp = _xattn_params()
    inp = cases.encdec_inputs(cfg.d_model, cfg.frontend_len)
    x, mem = inp["x_dec"], inp["memory"]
    b, s = x.shape[:2]
    jfwd = jT._block_apply(jp, x, "xattn", jcfg, JCtx(), jnp.arange(s),
                           memory=mem)[0][:, -1]
    with torch.no_grad():
        tfwd = tT._block_apply(tp, torch.from_numpy(x), "xattn", cfg,
                               torch.arange(s),
                               memory=torch.from_numpy(mem))[:, -1]
    scale = 1.0 / np.sqrt(cfg.head_dim)
    jc = {k: jnp.zeros((b, s, cfg.n_kv_heads, cfg.head_dim))
          for k in ("k", "v")}
    tc = tT.init_decode_state(cfg, b, s, device="cpu")[0]
    for step in range(s):
        pos = np.full((b, 1), step, np.int32)
        jdec, jc = jT._decode_block(jp, jnp.asarray(x[:, step:step + 1]),
                                    "xattn", jcfg, JCtx(), pos,
                                    jnp.int32(step), jc, scale, mem)
        with torch.no_grad():
            tdec = tT._decode_block(tp, torch.from_numpy(
                x[:, step:step + 1]), "xattn", cfg, tT.ShardCtx(),
                torch.from_numpy(pos).long(), step, tc, scale,
                torch.from_numpy(mem))
    jgap = np.asarray(jdec[:, 0]) - np.asarray(jfwd)
    tgap = (tdec[:, 0] - tfwd).numpy()
    assert np.abs(jgap).max() > 1e-2
    _close(tgap, jgap, F32)


def test_pixtral_logits_and_prefill_match_jax():
    """The forward over prefix + text (72 positions) and prefill with
    `extra_embeds` (its last logits, its K/V over all 72)."""
    cfg, params = _tcfg("pixtral"), _params("pixtral")
    nb = _batch("pixtral")
    tokens = torch.from_numpy(nb["tokens"])
    extra = torch.from_numpy(nb["patch_embeds"])
    with torch.no_grad():
        logits = tT.forward(params, cfg, tokens, extra_embeds=extra)
    want = _reference("pixtral")["logits"]
    assert logits.shape == want.shape == (
        cases.ENCDEC_BATCH, cfg.frontend_len + cases.ENCDEC_SEQ, cfg.vocab)
    _close(logits, want, F32)
    last, kv, memory = tT.prefill(params, cfg, tokens, extra_embeds=extra)
    assert memory is None
    _close(last, want[:, -1:], F32)
    assert all(k.shape[1] == cfg.frontend_len + cases.ENCDEC_SEQ
               for k, _ in kv)


# ---------------------------------------------------------- the batch --

@pytest.mark.parametrize("n", [1, 2, 3, 4, 6])
def test_shard_lm_batch_splits_prefix_and_text(n):
    """Each rank's block of the prefix + text sequence: its prefix rows
    and text tokens concatenated in rank order are the whole sequence,
    every block is (8 + 64) / n long, and the labels are -1 over the
    prefix and the text labels after it."""
    cfg = _tcfg("pixtral")
    nb = _batch("pixtral")
    s_img = cfg.frontend_len
    total = s_img + cases.ENCDEC_SEQ
    parts = [tpipe.shard_lm_batch(nb, Mesh({"data": 1, "model": n}, rank=r),
                                  "model", ("data",)) for r in range(n)]
    for p in parts:
        assert p["patch_embeds"].shape[1] + p["tokens"].shape[1] == \
            p["labels"].shape[1] == total // n
    np.testing.assert_array_equal(
        np.concatenate([p["patch_embeds"] for p in parts], 1),
        nb["patch_embeds"])
    np.testing.assert_array_equal(
        np.concatenate([p["tokens"] for p in parts], 1), nb["tokens"])
    labels = np.concatenate([p["labels"] for p in parts], 1)
    assert (labels[:, :s_img] == -1).all()
    np.testing.assert_array_equal(labels[:, s_img:], nb["labels"])
    with pytest.raises(ValueError, match="divide"):
        tpipe.shard_lm_batch(nb, Mesh({"data": 1, "model": 5}, rank=0),
                             "model", ("data",))


# ------------------------------------------------------- checkpoints --

def test_seamless_tree_round_trips_bit_for_bit():
    """The reference's tree through `params_from_jax` and `tree_to_jax`,
    `enc_segments` included, and `tree_from_jax` back: bit for bit."""
    cfg, jp = _tcfg("seamless"), _jparams("seamless")
    params = tT.params_from_jax(jp, cfg)
    assert len(params["enc_layers"]) == cfg.n_enc_layers
    ref = tT.tree_to_jax(params, cfg)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, ref)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, jp))
    for a, b in zip(tck.flatten(ref), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    back = tT.tree_from_jax(ref, cfg)
    for a, b in zip(tutils.tree_leaves(back), tutils.tree_leaves(params)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="enc_segments"):
        tT.params_from_jax({k: v for k, v in jp.items()
                            if k != "enc_segments"}, cfg)


def test_seamless_checkpoint_loads_in_either_package(tmp_path):
    """The port's `repro/ckpt@1` save of seamless SMOKE's params (its own
    init) restores bit for bit in the port and in the reference; the
    reference's save restores bit for bit in the port."""
    cfg = _tcfg("seamless")
    to_ref, from_ref = train_cli.checkpoint_layout(cfg)
    params = tT.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    ck = tck.CheckpointManager(str(tmp_path / "port"), async_save=True)
    ck.save(1, to_ref(params), extra={"step": 1})
    ck.wait()
    other = tT.init(torch.Generator().manual_seed(4), cfg, device="cpu")
    tree, manifest = tck.CheckpointManager(
        str(tmp_path / "port"), writer=False).restore(to_ref(other))
    assert manifest["extra"]["step"] == 1
    for a, b in zip(tutils.tree_leaves(from_ref(tree)),
                    tutils.tree_leaves(params)):
        assert torch.equal(a.detach(), b.detach())
    jtree, _ = jck.CheckpointManager(str(tmp_path / "port"),
                                     async_save=False).restore(
        _jparams("seamless"))
    for a, b in zip(jax.tree.leaves(jtree), tck.flatten(to_ref(params))):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())
    jck.CheckpointManager(str(tmp_path / "jax"), async_save=False).save(
        2, _jparams("seamless"), extra={"step": 2})
    tree, _ = tck.CheckpointManager(str(tmp_path / "jax"),
                                    writer=False).restore(to_ref(other))
    for a, b in zip(tutils.tree_leaves(from_ref(tree)),
                    tutils.tree_leaves(_params("seamless"))):
        assert torch.equal(a.detach(), b.detach())


# ------------------------------------------------------ entry points --

def test_serve_seamless_smoke_matches_the_reference_decode():
    """`launch.serve` on seamless SMOKE: the frames from --seed, the
    encoder once, every step's logits and the generated ids against the
    reference's encode + decode loop on the same params and frames."""
    argv = ["--arch", "seamless-m4t-large-v2", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--gen", "4"]
    steps = 8 + 4 - 1
    res = serve.run(serve.parse_args(argv), keep=range(steps))
    cfg = res["cfg"]
    assert res["frames"].shape == (2, 8, cfg.d_model)
    np.testing.assert_array_equal(res["frames"],
                                  serve.frames_for(cfg, 2, 8, 0))
    assert res["encode_ms"] > 0
    jcfg = jseamless.SMOKE
    jp = jax.tree.map(lambda t: np.asarray(t.detach()),
                      tT.tree_to_jax(res["params"], cfg),
                      is_leaf=torch.is_tensor)
    memory = jT.encode(jp, jcfg, jnp.asarray(res["frames"]), JCtx(),
                       remat=False)
    _close(res["memory"], memory, F32)
    caches = jT.init_decode_state(jp, jcfg, 2, 12, dtype=jnp.float32)
    step = jax.jit(lambda p, t, c, n, m: jT.decode_step(p, jcfg, t, c, n,
                                                        memory=m))
    tokens, ids = res["prompts"], []
    tok = jnp.asarray(tokens[:, :1])
    for i in range(steps):
        logits, caches = step(jp, tok, caches, jnp.int32(i), memory)
        _close(res["logits"][i], logits[:, 0], F32, f"step {i}")
        if i + 1 < 8:
            tok = jnp.asarray(tokens[:, i + 1:i + 2])
        else:
            tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
            ids.append(np.asarray(tok)[:, 0])
    np.testing.assert_array_equal(res["ids"], np.stack(ids, 1))


def test_serve_pixtral_smoke_text_only():
    res = serve.main(["--arch", "pixtral-12b", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    assert res["ids"].shape == (2, 3) and res["memory"] is None


def test_train_refuses_an_encoder_decoder(capsys):
    with pytest.raises(SystemExit, match="encoder frames"):
        train_cli.parse_args(["--arch", "seamless-m4t-large-v2", "--smoke",
                              "--device", "cpu"])
    args = train_cli.parse_args(["--arch", "pixtral-12b", "--smoke",
                                 "--device", "cpu"])
    assert args.arch == "pixtral-12b"


# ------------------------------------------------------------ the mesh --

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both meshes' ranks (params from the reference's init), the
    one-device xattn block's results, computed at once."""
    d = str(tmp_path_factory.mktemp("encdec_dist"))
    flat, params = {}, {}
    for name, (arch, _) in ARCHS.items():
        params[name] = _params(name)
        flat.update({f"{arch}/{i}": t.detach().numpy() for i, t in
                     enumerate(tutils.tree_leaves(params[name]))})
    np.savez(os.path.join(d, "inputs.npz"), **flat)
    started = {}
    for dims in MESHES:
        sub = os.path.join(d, f"{dims[0]}x{dims[1]}")
        os.makedirs(sub)
        os.link(os.path.join(d, "inputs.npz"),
                os.path.join(sub, "inputs.npz"))
        started[dims] = (cases.start("encdec", dims, sub), sub)
    for name in ARCHS:
        _reference(name)
    return {"ranks": {dims: cases.collect(p, dims, sub)
                      for dims, (p, sub) in started.items()},
            "xattn": _xattn_one_device(), "params": params}


def _xattn_one_device() -> dict:
    """The xattn block of `cases.xattn_block` on the whole x and memory,
    as `case_encdec` runs it on the ranks' blocks."""
    cfg = _tcfg("seamless")
    p = cases.xattn_block(cfg)
    inp = {n: torch.from_numpy(a) for n, a in cases.encdec_inputs(
        cfg.d_model, cfg.frontend_len).items()}
    x = inp["x"].clone().requires_grad_()
    m = inp["memory"].clone().requires_grad_()
    y = tT._block_apply(p, x, "xattn", cfg, torch.arange(x.shape[1]),
                        memory=m)
    grads = torch.autograd.grad((y * inp["g"]).sum(),
                                [x, m] + tutils.tree_leaves(p))
    out = {"y": y.detach().numpy(), "dx": grads[0].numpy(),
           "dmemory": grads[1].numpy(),
           "grads": [g.numpy() for g in grads[2:]]}
    cache = tT.init_decode_state(cfg, cases.ENCDEC_BATCH,
                                 cases.ENCDEC_DECODE_LEN, device="cpu")[0]
    with torch.no_grad():
        for step in range(2):
            out[f"decode.{step}"] = tT._decode_block(
                p, inp["x_dec"][:, step:step + 1], "xattn", cfg,
                tT.ShardCtx(), torch.full((cases.ENCDEC_BATCH, 1), step),
                step, cache, 1.0 / np.sqrt(cfg.head_dim),
                inp["memory"]).numpy()
    return out


def _stitch(blocks, dims, seq=True):
    """The global (B, S, ...) array from every rank's block (B over data,
    S over model where `seq`)."""
    return cases.stitch(blocks, dims, ("data",), "model" if seq else None)


def _rows(ranks, dims, key):
    """The global rows of a per-rank (B_rank, ...) array replicated over
    model."""
    return _stitch([r[key] for r in ranks], dims, seq=False)


@pytest.mark.parametrize("dims", MESHES)
def test_seamless_loss_on_the_mesh_matches_jax(dims, runs):
    """dist_checks' models-group case: the ranks' loss shares with the
    frames split, their gradients summed (the encoder's 0)."""
    ranks, ref = runs["ranks"][dims], _reference("seamless")
    loss = sum(float(r["seamless.loss_share"]) for r in ranks)
    np.testing.assert_allclose(loss, ref["loss"],
                               rtol=MESH_LOSS_RTOL["seamless"])
    grads = [sum(r[f"seamless.grad.{i}"] for r in ranks)
             for i in range(len(ref["grads"]))]
    _grads_close(grads, ref["grads"])
    for i in _enc_leaf_indices(runs["params"]["seamless"]):
        assert not any(r[f"seamless.grad.{i}"].any() for r in ranks)


@pytest.mark.parametrize("dims", MESHES)
def test_seamless_encoder_ring_matches_jax(dims, runs):
    """`encode` with the frames split over model: the bidirectional ring's
    full sweep, each rank's memory block stitched against the reference's
    one-device memory; prefill's memory the same."""
    ranks, ref = runs["ranks"][dims], _reference("seamless")
    for key in ("seamless.memory", "seamless.prefill.memory"):
        _close(_stitch([r[key] for r in ranks], dims), ref["memory"],
               MESH_TOL, key)


@pytest.mark.parametrize("dims", MESHES)
def test_seamless_prefill_and_decode_on_the_mesh_match_jax(dims, runs):
    """Sharded prefill (last logits, each layer's K/V blocks) and three
    decode steps with the memory split over model (the cross call's
    decode_attention would merge over the memory's shards), against the
    reference's one device."""
    ranks, ref = runs["ranks"][dims], _reference("seamless")
    jlast, jkv, _ = ref["prefill"]
    _close(_rows(ranks, dims, "seamless.prefill.logits"), jlast, MESH_TOL)
    cfg = _tcfg("seamless")
    kv = [(_stitch([r[f"seamless.prefill.{li}.k"] for r in ranks], dims),
           _stitch([r[f"seamless.prefill.{li}.v"] for r in ranks], dims))
          for li in range(cfg.n_layers)]
    for seg, jseg in zip(tT.tree_to_jax(
            {"layers": [tuple(map(torch.from_numpy, t)) for t in kv]},
            cfg)["segments"], jkv):
        for got, want in zip(jax.tree.leaves(jax.tree.map(
                lambda t: t.numpy(), seg, is_leaf=torch.is_tensor)),
                jax.tree.leaves(jseg)):
            _close(got, want, MESH_TOL)
    for step in range(len(cases.ENCDEC_DECODE_TOKENS)):
        _close(_rows(ranks, dims, f"seamless.decode.{step}"),
               ref[f"decode.{step}"], MESH_TOL, f"step {step}")


@pytest.mark.parametrize("dims", MESHES)
@pytest.mark.parametrize("kind", ["dense", "vp"])
def test_pixtral_loss_on_the_mesh_matches_jax(dims, kind, runs):
    """dist_checks' vocab-parallel VLM case (and the dense loss): each
    rank holds its block of the 72 prefix + text positions; the shares
    summed against the reference's one-device loss, the gradients (the
    vocab-parallel tables gathered whole, the rest summed)."""
    ranks, ref = runs["ranks"][dims], _reference("pixtral")
    loss = sum(float(r[f"pixtral.{kind}.loss_share"]) for r in ranks)
    np.testing.assert_allclose(loss, ref["loss"],
                               rtol=MESH_LOSS_RTOL["pixtral"])
    params = runs["params"]["pixtral"]
    leaves = tutils.tree_leaves(params)
    tables = {i for i, t in enumerate(leaves) if kind == "vp" and any(
        t is params[n] for n in shardings.VOCAB_DIMS)}
    grads = [ranks[0][f"pixtral.{kind}.grad.{i}"] if i in tables else
             sum(r[f"pixtral.{kind}.grad.{i}"] for r in ranks)
             for i in range(len(leaves))]
    _grads_close(grads, ref["grads"])


@pytest.mark.parametrize("dims", MESHES)
def test_pixtral_ranks_hold_their_block_of_prefix_and_text(dims, runs):
    """Each model rank holds (8 + 64) / model positions of prefix + text,
    not the prefix and its own text block: rank 0 of model 2 holds the 8
    prefix rows and 28 tokens, rank 1 36 tokens; the labels -1 over the
    prefix."""
    cfg = _tcfg("pixtral")
    total = cfg.frontend_len + cases.ENCDEC_SEQ
    for r, rk in enumerate(runs["ranks"][dims]):
        i, n = cases.shard(r, dims, "model")
        lo = i * total // n
        n_img = max(0, min(cfg.frontend_len - lo, total // n))
        assert rk["pixtral.batch.patch_embeds"].shape[1] == n_img
        assert rk["pixtral.batch.tokens"].shape[1] == total // n - n_img
        labels = rk["pixtral.batch.labels"]
        assert labels.shape[1] == total // n
        assert (labels[:, :n_img] == -1).all()
        assert (labels[:, n_img:] >= 0).all()


@pytest.mark.parametrize("dims", MESHES)
def test_xattn_block_on_the_mesh_matches_one_device(dims, runs):
    """The xattn block with x and the memory split over model: its output,
    dx and dmemory blocks stitched, its params' gradients summed, and its
    two decode steps (the memory split), against one device."""
    ranks, want = runs["ranks"][dims], runs["xattn"]
    for key in ("y", "dx", "dmemory"):
        _close(_stitch([r[f"xattn.{key}"] for r in ranks], dims), want[key],
               F32, key)
    for i, w in enumerate(want["grads"]):
        _close(sum(r[f"xattn.grad.{i}"] for r in ranks), w, 1e-4,
               f"leaf {i}")
    for step in range(2):
        _close(_rows(ranks, dims, f"xattn.decode.{step}"),
               want[f"decode.{step}"], F32, f"step {step}")
