"""The vocab-parallel loss (`models/lm/vocab_parallel.py`,
`transformer.loss_fn(vocab_parallel=True)`) and the gemma2-9b and
qwen2.5-14b configs, against the JAX reference.

Params come from the reference's own `init`, carried over by
`params_from_jax`; batches are `synthetic_lm_batch(0, 2, 64, vocab)`.
On gloo CPU ranks (`torch_dist_cases.py` case `vocab`, one spawned group
for model 2 and one for data 2 x model 2), for gemma2 SMOKE (tied,
softcaps), qwen2.5 SMOKE (untied) and gemma2 SMOKE with its vocabulary
cut to 255 (padded to the shard count):

- the ranks' loss shares summed against the reference's one-device dense
  loss at rtol 3e-5 (`tests/dist_checks.py:216`), and against the
  reference's own vocab-parallel loss on a host mesh of the same shape
  (`jax_mesh_oracles.py vocab`);
- the gradients against `jax.grad` of the dense loss at rtol 1e-4 / atol
  1e-6 (tighter than dist_checks' 5e-3 / 5e-5; test_torch_lm_dist's
  tolerance for the sharded dense loss): the table's gathered whole by
  `shardings.gather_vocab` (equal on every rank, and to the raw blocks
  stitched, the padding's rows 0), every other gradient summed over the
  ranks;
- the table rotations each rank sends (4 (P - 1) + P messages);
- the embedding lookup alone against the plain `embed[tokens]` (exact)
  with its gradient, and the cross entropy alone with unscored labels
  against the plain masked mean and its gradients (2e-5);
- the sharded dense loss (rtol 2e-5, dist_checks' `:193`) and the
  sequence-sharded decode (2 steps, rtol / atol 2e-4, `:242`) on gemma2
  and qwen2.5 SMOKE.

Without a mesh `loss_fn(vocab_parallel=True)` is the dense loss, its
gradients the dense ones.
"""
import dataclasses
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_mesh_oracles as oracles
import torch_dist_cases as cases
from repro.configs import gemma2_9b as jgemma
from repro.configs import qwen2_5_14b as jqwen
from repro.data import pipeline as jpipe
from repro.models.lm import transformer as jT
from repro_torch import utils as tutils
from repro_torch.configs import gemma2_9b as tgemma
from repro_torch.configs import qwen2_5_14b as tqwen
from repro_torch.configs import registry as treg
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import shardings
from repro_torch.launch.mesh import Mesh
from repro_torch.models.lm import transformer as tT
from repro_torch.models.lm import vocab_parallel as VP

MESHES = [(1, 2), (2, 2)]
KEYS = [cases.vocab_key(a, v) for a, v in cases.VOCAB_RUNS]
ARCHS = [k for k in KEYS if "@" not in k]
LOSS_RTOL = 3e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
DENSE_RTOL = 2e-5
DECODE_TOL = 2e-4
F32 = 2e-5


def _stitch(blocks: list, dims: tuple) -> np.ndarray:
    """The global (B, S, ...) array from each rank's block: B over data,
    S over model (ranks holding the same block must agree)."""
    b0 = blocks[0]
    out = np.full((b0.shape[0] * dims[0], b0.shape[1] * dims[1])
                  + b0.shape[2:], np.nan, b0.dtype)
    for r, blk in enumerate(blocks):
        bi = cases.shard(r, dims, ("data",))[0]
        si = cases.shard(r, dims, "model")[0]
        sl = (slice(bi * blk.shape[0], (bi + 1) * blk.shape[0]),
              slice(si * blk.shape[1], (si + 1) * blk.shape[1]))
        if not np.isnan(out[sl]).all():
            np.testing.assert_array_equal(out[sl], blk)
        out[sl] = blk
    assert not np.isnan(out).any()
    return out


def _stitch_vocab(blocks: list, dims: tuple, dim: int) -> np.ndarray:
    """The padded table from each rank's block along `dim` (its model
    index's); ranks of one model index must agree."""
    by_index = {}
    for r, blk in enumerate(blocks):
        i = cases.shard(r, dims, "model")[0]
        if i in by_index:
            np.testing.assert_array_equal(by_index[i], blk)
        by_index[i] = blk
    return np.concatenate([by_index[i] for i in range(dims[1])], dim)


def _batch(cfg) -> dict:
    return jpipe.synthetic_lm_batch(0, cases.VOCAB_BATCH, cases.VOCAB_SEQ,
                                    cfg.vocab)


def _reference(key: str) -> dict:
    """The reference's one-device dense loss and gradients (in the port's
    leaf order) on batch 0 and, for a registered config, its 2-step
    decode."""
    cfg, params = oracles.vocab_reference_params(key)
    nb = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    loss, grads = jax.jit(jax.value_and_grad(functools.partial(
        jT.loss_fn, cfg=cfg, remat=False)))(params, nb)
    tcfg = cases.vocab_cfg(key)
    out = {"loss": float(loss),
           "grads": [g.detach().numpy() for g in tutils.tree_leaves(
               tT.params_from_jax(jax.tree.map(np.asarray, grads), tcfg))]}
    if "@" not in key:
        caches = jT.init_decode_state(params, cfg, cases.VOCAB_BATCH,
                                      cases.VOCAB_DECODE_LEN,
                                      dtype=jnp.float32)
        step = jax.jit(lambda p, t, c, n: jT.decode_step(p, cfg, t, c, n))
        for i, tok in enumerate(cases.VOCAB_DECODE_TOKENS):
            logits, caches = step(params, jnp.asarray(tok, jnp.int32),
                                  caches, jnp.int32(i))
            out[f"decode.{i}"] = np.asarray(logits)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both meshes' ranks, the reference's vocab-parallel losses on both
    mesh shapes and the one-device references, computed at once."""
    torch.set_num_threads(2)
    d = str(tmp_path_factory.mktemp("vocab_dist"))
    flat, params = {}, {}
    for key in KEYS:
        _, jp = oracles.vocab_reference_params(key)
        params[key] = tT.params_from_jax(jax.tree.map(np.asarray, jp),
                                         cases.vocab_cfg(key))
        flat.update({f"{key}/{i}": t.detach().numpy() for i, t in
                     enumerate(tutils.tree_leaves(params[key]))})
    np.savez(os.path.join(d, "inputs.npz"), **flat)
    oracle = oracles.popen("vocab", d)
    started = {}
    for dims in MESHES:
        sub = os.path.join(d, f"{dims[0]}x{dims[1]}")
        os.makedirs(sub)
        shutil.copy(os.path.join(d, "inputs.npz"), sub)
        started[dims] = (cases.start("vocab", dims, sub), sub)
    refs = {key: _reference(key) for key in KEYS}
    ranks = {dims: cases.collect(p, dims, sub)
             for dims, (p, sub) in started.items()}
    oracles.wait(oracle)
    vp = dict(np.load(os.path.join(d, "vocab.npz")))
    return {"ranks": ranks, "refs": refs, "vp": vp, "params": params}


# ---------------------------------------------------------------- configs --

@pytest.mark.parametrize("tmod,jmod", [(tgemma, jgemma), (tqwen, jqwen)])
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_the_reference_field_by_field(tmod, jmod, smoke):
    name = jmod.CONFIG.name
    got = treg.get(name, smoke=smoke)
    want = jmod.SMOKE if smoke else jmod.CONFIG
    assert got is (tmod.SMOKE if smoke else tmod.CONFIG)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.layer_types() == want.layer_types()
    assert tT.plan(got) == jT.plan(want)


# ----------------------------------------------------------- one device --

@pytest.mark.parametrize("key", KEYS)
def test_one_device_vocab_parallel_is_the_dense_loss(key, runs):
    """Without a mesh the lookup is `embed[tokens]` and the cross entropy
    one block: the loss and every gradient equal the dense path's, and
    the loss the reference's."""
    cfg, params = cases.vocab_cfg(key), runs["params"][key]
    batch = tpipe.to_device(_batch(cfg), torch.device("cpu"))
    leaves = tutils.tree_leaves(params)
    dense = tT.loss_fn(params, batch, cfg)
    want = torch.autograd.grad(dense, leaves)
    blocks = shardings.vocab_blocks(params, None)
    got = tT.loss_fn(blocks, batch, cfg, vocab_parallel=True)
    grads = torch.autograd.grad(got, tutils.tree_leaves(blocks))
    np.testing.assert_allclose(got.item(), dense.item(), rtol=1e-6)
    np.testing.assert_allclose(got.item(), runs["refs"][key]["loss"],
                               rtol=LOSS_RTOL)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def test_vocab_parallel_refuses_a_frontend():
    cfg = dataclasses.replace(tgemma.SMOKE, frontend="vit_stub",
                              frontend_len=4)
    params = tT.init(torch.Generator().manual_seed(0), tgemma.SMOKE,
                     device="cpu")
    batch = tpipe.to_device(_batch(cfg), torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="frontends"):
        tT.loss_fn(params, batch, cfg, vocab_parallel=True)


@pytest.mark.parametrize("vocab,n", [(255, 2), (256, 4), (10, 3), (7, 1)])
def test_vocab_blocks_pad_cut_and_gather(vocab, n):
    """Each rank's block: V padded with zero rows (columns of `unembed`)
    to the shard count, cut in shard order; the blocks concatenated are
    the padded table, and `gather_vocab` without a mesh trims a whole
    table back."""
    rng = np.random.default_rng(vocab)
    params = {"embed": torch.from_numpy(
        rng.standard_normal((vocab, 3)).astype(np.float32)),
        "unembed": torch.from_numpy(
            rng.standard_normal((3, vocab)).astype(np.float32)),
        "final_norm": torch.ones(3)}
    vp = shardings.vocab_padded(vocab, n)
    assert vp % n == 0 and vocab <= vp < vocab + n
    got = [shardings.vocab_blocks(params, Mesh({"data": 1, "model": n},
                                               rank=r)) for r in range(n)]
    for name, dim in shardings.VOCAB_DIMS.items():
        whole = torch.cat([g[name] for g in got], dim)
        assert whole.shape[dim] == vp
        assert all(g[name].is_contiguous() and g[name].requires_grad
                   for g in got)
        np.testing.assert_array_equal(whole.narrow(dim, 0, vocab).detach(),
                                      params[name])
        assert not whole.narrow(dim, vocab, vp - vocab).any()
        back = shardings.gather_vocab({name: whole}, None, vocab)[name]
        np.testing.assert_array_equal(back, params[name])
    assert got[0]["final_norm"] is params["final_norm"]


def test_xent_one_device_scores_only_labels_that_are_not_negative():
    """`xent_loss` alone on one device, labels with -1: the mean over the
    scored tokens of the plain softcapped cross entropy, and its
    gradients."""
    cfg = cases.vocab_cfg("gemma2-9b@255")
    aux = cases.vocab_aux_inputs(cfg.d_model)
    table = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (cfg.vocab, cfg.d_model)).astype(np.float32)).requires_grad_()
    x = torch.from_numpy(aux["x"]).requires_grad_()
    labels = torch.from_numpy(aux["labels"])
    got = VP.xent_loss(table, cfg, x, labels, tT.ShardCtx())
    g_got = torch.autograd.grad(got, [x, table])
    want = _plain_xent(x, table, labels, cfg.final_softcap)
    g_want = torch.autograd.grad(want, [x, table])
    np.testing.assert_allclose(got.item(), want.item(), rtol=F32)
    for a, b in zip(g_got, g_want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=F32, atol=1e-7)


def _plain_xent(x, table, labels, softcap):
    """The plain masked mean: softcapped logits of the whole (real)
    table, scored where labels >= 0."""
    logits = x @ table.T
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    valid = labels >= 0
    lbl = labels.clamp_min(0).long()
    per = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, lbl[..., None])[..., 0]
    return (per * valid).sum() / valid.sum()


# ------------------------------------------------------------ the mesh --

@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("dims", MESHES)
def test_vocab_parallel_loss_matches_the_dense_reference(dims, key, runs):
    loss = sum(float(r[f"{key}.vp.loss_share"]) for r in runs["ranks"][dims])
    np.testing.assert_allclose(loss, runs["refs"][key]["loss"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("dims", MESHES)
def test_vocab_parallel_loss_matches_the_reference_on_its_mesh(dims, key,
                                                               runs):
    loss = sum(float(r[f"{key}.vp.loss_share"]) for r in runs["ranks"][dims])
    np.testing.assert_allclose(
        loss, float(runs["vp"][f"{key}/{dims[0]}x{dims[1]}"]),
        rtol=LOSS_RTOL)


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("dims", MESHES)
def test_vocab_parallel_grads_match_jax_grad(dims, key, runs):
    ranks, ref = runs["ranks"][dims], runs["refs"][key]
    cfg = cases.vocab_cfg(key)
    names = {n: int(ranks[0][f"{key}.vp.table_leaf.{n}"])
             for n in shardings.VOCAB_DIMS
             if f"{key}.vp.table_leaf.{n}" in ranks[0]}
    assert sorted(names) == (["embed"] if cfg.tie_embeddings
                             else ["embed", "unembed"])
    tables = set(names.values())
    assert len(ref["grads"]) == sum(
        k.startswith(f"{key}.vp.grad.") for k in ranks[0])
    for i, want in enumerate(ref["grads"]):
        if i in tables:
            got = ranks[0][f"{key}.vp.grad.{i}"]
            for r in ranks[1:]:
                np.testing.assert_array_equal(r[f"{key}.vp.grad.{i}"], got)
        else:
            got = sum(r[f"{key}.vp.grad.{i}"] for r in ranks)
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"leaf {i}")
    # the raw blocks stitched: the gathered tables, then zero rows
    for name, i in names.items():
        g, dim = ranks[0][f"{key}.vp.grad.{i}"], shardings.VOCAB_DIMS[name]
        whole = _stitch_vocab([r[f"{key}.vp.block.{name}"] for r in ranks],
                              dims, dim)
        np.testing.assert_array_equal(
            np.take(whole, range(cfg.vocab), dim), g)
        assert not np.take(whole, range(cfg.vocab, whole.shape[dim]),
                           dim).any()


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("dims", MESHES)
def test_vocab_parallel_sends_one_table_a_rotation(dims, key, runs):
    """The lookup's forward and backward and the cross entropy's forward
    rotate P - 1 times each, its backward the table P - 1 times and the
    cotangent P times: 4 (P - 1) + P messages a rank, tied or not."""
    p = dims[1]
    for r in runs["ranks"][dims]:
        assert int(r[f"{key}.vp.messages"]) == 4 * (p - 1) + p


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dims", MESHES)
def test_sharded_dense_loss_matches_jax(dims, arch, runs):
    loss = sum(float(r[f"{arch}.dense.loss_share"])
               for r in runs["ranks"][dims])
    np.testing.assert_allclose(loss, runs["refs"][arch]["loss"],
                               rtol=DENSE_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dims", MESHES)
def test_sharded_decode_matches_jax(dims, arch, runs):
    """Two decode steps with the cache's 32 positions over model and the
    batch over data: each rank's rows of the logits (equal on every rank
    of its model group) against the reference's one-device decode."""
    ranks, ref = runs["ranks"][dims], runs["refs"][arch]
    for step in range(len(cases.VOCAB_DECODE_TOKENS)):
        rows = []
        for bi in range(dims[0]):
            group = [r for i, r in enumerate(ranks)
                     if cases.shard(i, dims, ("data",))[0] == bi]
            for r in group[1:]:
                np.testing.assert_array_equal(r[f"{arch}.decode.{step}"],
                                              group[0][f"{arch}.decode.{step}"])
            rows.append(group[0][f"{arch}.decode.{step}"])
        np.testing.assert_allclose(np.concatenate(rows),
                                   ref[f"decode.{step}"], rtol=DECODE_TOL,
                                   atol=DECODE_TOL)


@pytest.mark.parametrize("dims", MESHES)
def test_embedding_lookup_matches_the_plain_gather(dims, runs):
    """`embed_lookup` on the padded gemma2's table blocks: each rank's
    (B, S) block of x is exactly `embed[tokens]`, and the table block's
    gradient of sum(x * g) is the scatter-add of g into its rows (the
    padding's rows 0)."""
    ranks = runs["ranks"][dims]
    cfg = cases.vocab_cfg("gemma2-9b@255")
    embed = runs["params"]["gemma2-9b@255"]["embed"].detach().numpy()
    tokens = _batch(cfg)["tokens"]
    np.testing.assert_array_equal(_stitch([r["lookup.x"] for r in ranks],
                                          dims), embed[tokens])
    g = cases.vocab_aux_inputs(cfg.d_model)["g"]
    want = np.zeros((shardings.vocab_padded(cfg.vocab, dims[1]),
                     cfg.d_model), np.float32)
    np.add.at(want, tokens, g)
    got = _stitch_vocab([r["lookup.dtable"] for r in ranks], dims, 0)
    np.testing.assert_allclose(got, want, rtol=F32, atol=1e-6)


@pytest.mark.parametrize("dims", MESHES)
def test_cross_entropy_alone_with_unscored_labels(dims, runs):
    """`xent_loss` on the padded gemma2's table blocks, x and labels with
    every fifth one -1: the shares summed, dx (stitched) and the table's
    gradient (stitched, the padding's row 0) against the plain masked
    mean over the real vocabulary."""
    ranks = runs["ranks"][dims]
    cfg = cases.vocab_cfg("gemma2-9b@255")
    aux = cases.vocab_aux_inputs(cfg.d_model)
    table = runs["params"]["gemma2-9b@255"]["embed"].detach() \
        .clone().requires_grad_()
    x = torch.from_numpy(aux["x"]).requires_grad_()
    want = _plain_xent(x, table, torch.from_numpy(aux["labels"]),
                       cfg.final_softcap)
    dx, dtable = torch.autograd.grad(want, [x, table])
    np.testing.assert_allclose(sum(float(r["xent.loss_share"])
                                   for r in ranks), want.item(), rtol=F32)
    np.testing.assert_allclose(_stitch([r["xent.dx"] for r in ranks], dims),
                               dx.numpy(), rtol=F32, atol=1e-7)
    got = _stitch_vocab([r["xent.dtable"] for r in ranks], dims, 0)
    np.testing.assert_allclose(got[:cfg.vocab], dtable.numpy(), rtol=F32,
                               atol=1e-7)
    assert not got[cfg.vocab:].any()
