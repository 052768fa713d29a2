"""The LM on a mesh (`torch_dist_cases.py` case `lm`) on gloo CPU ranks
against the JAX reference and the port's one-device run.

hymba-1.5b, qwen1.5-0.5b, mixtral-8x7b and mamba2-780m SMOKE at batch 2
x seq 64 (past hymba's and mixtral's window of 16; mixtral's MoE routes
groups of 64 that span the sequence shards), the sequence over `model`
and the batch over `data`, on model 2 and on data 2 x model 2, from the
reference's own `init` params carried over by `params_from_jax`:

- the sharded SSD block (layer 0's of hymba and mamba2, the conv's 3-row
  halo and the state prefix over the shards) against the reference's
  one-device
  `ssm_apply`, and its gradient in x against `jax.grad`, at 2e-5 (the
  same sums in another order);
- the ranks' loss shares summed against the reference's one-device
  `loss_fn` at rtol 2e-5 (`tests/dist_checks.py:193`'s tolerance), and
  every parameter's gradient, summed over the ranks, against `jax.grad`
  at test_torch_lm's tolerance for the one-device port (rtol 1e-4 /
  atol 1e-6: five hybrid blocks whose backward divides by rms norms;
  mamba2's within 1e-4 of each leaf's largest magnitude,
  `LEAF_SCALE_GRADS`);
- `prefill`'s last logits and every layer's K/V blocks, stitched, against
  the reference's `T.prefill` under a mesh ctx on data 2 x model 2 host
  devices (`jax_mesh_oracles.py lm_prefill`) at 2e-5 of the largest
  magnitude;
- 3 steps of `launch.train` (AdamW; ZeRO over data 2 on the 2 x 2 mesh)
  against the port's one-device run of the same global batches: losses
  and gradient norms at 1e-5 relative, equal on every rank, and the final
  params with test_torch_lm's Adam rule at 1e-5 (all but 1e-3 of the
  elements within 1e-7 + 1e-5 |p|, every one within twice the summed lr:
  Adam moves an element whose gradient is at rounding level by about lr
  either way).
"""
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
from repro.data import pipeline as jpipe
from repro.models.lm import modules as jM
from repro.models.lm import transformer as jT
from repro_torch import utils as tutils
from repro_torch.configs import registry as treg
from repro_torch.launch import train as train_cli
from repro_torch.models.lm import transformer as tT
from repro_torch.optim import optimizer as topt

MESHES = [(1, 2), (2, 2)]
F32 = 2e-5
LOSS_RTOL = 2e-5
TRAIN_RTOL = 1e-5
# archs whose gradients are held within 1e-4 of each leaf's largest
# magnitude: mamba2's tied embedding has elements 1e-3 of its largest
# that differ from the reference's by 5e-4 of themselves on one device
# too (test_torch_moe's SMOKE loss test)
LEAF_SCALE_GRADS = ("mamba2-780m",)


def _stitch(blocks: list, dims: tuple) -> np.ndarray:
    """The global (B, S, ...) array from each rank's block: B over data,
    S over model (ranks holding the same block must agree)."""
    b0 = blocks[0]
    nb, ns = dims
    out = np.full((b0.shape[0] * nb, b0.shape[1] * ns) + b0.shape[2:],
                  np.nan, b0.dtype)
    for r, blk in enumerate(blocks):
        bi, si = cases.shard(r, dims, ("data",))[0], \
            cases.shard(r, dims, "model")[0]
        sl = (slice(bi * blk.shape[0], (bi + 1) * blk.shape[0]),
              slice(si * blk.shape[1], (si + 1) * blk.shape[1]))
        prev = out[sl]
        if not np.isnan(prev).all():
            np.testing.assert_array_equal(prev, blk)
        out[sl] = blk
    assert not np.isnan(out).any()
    return out


def _reference(arch: str) -> dict:
    """The reference's one-device loss and gradients on batch 0, and
    (hymba, mamba2) its SSD block of layer 0 with the gradient in x."""
    cfg, params = oracles.lm_reference_params(arch)
    nb = jpipe.synthetic_lm_batch(0, cases.LM_BATCH, cases.LM_SEQ, cfg.vocab)
    loss, grads = jax.jit(jax.value_and_grad(functools.partial(
        jT.loss_fn, cfg=cfg, remat=False)))(
        params, {k: jnp.asarray(v) for k, v in nb.items()})
    tcfg = treg.get(arch, smoke=True)
    out = {"loss": float(loss),
           "grads": [g.detach().numpy() for g in tutils.tree_leaves(
               tT.params_from_jax(jax.tree.map(np.asarray, grads), tcfg))]}
    if "ssm" in params["segments"][0][0]:
        x = cases.lm_ssd_inputs(cfg.d_model)
        p0 = params["segments"][0][0]["ssm"]
        p0 = jax.tree.map(lambda a: a[0], p0)

        def ssd(x):
            return jM.ssm_apply(p0, x, cfg, jM.ShardCtx())
        y, vjp = jax.vjp(jax.jit(ssd), jnp.asarray(x["x"]))
        out["ssd_y"] = np.asarray(y)
        out["ssd_dx"] = np.asarray(vjp(jnp.asarray(x["g"]))[0])
    return out


def _one_device(arch: str) -> dict:
    res = train_cli.main(cases.lm_argv(arch, (1, 1)))
    return {"losses": res["losses"], "grad_norms": res["grad_norms"],
            "params": [p.detach().numpy()
                       for p in tutils.tree_leaves(res["params"])]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's ranks, the reference's prefill on the 2 x 2 mesh, and
    the one-device references, computed at once."""
    torch.set_num_threads(2)
    d = str(tmp_path_factory.mktemp("lm_dist"))
    flat = {}
    for arch in cases.LM_ARCHS:
        _, params = oracles.lm_reference_params(arch)
        tp = tT.params_from_jax(jax.tree.map(np.asarray, params),
                                treg.get(arch, smoke=True))
        flat.update({f"{arch}/{i}": t.detach().numpy()
                     for i, t in enumerate(tutils.tree_leaves(tp))})
    np.savez(os.path.join(d, "inputs.npz"), **flat)
    oracle = oracles.popen("lm_prefill", d)
    started = {}
    for dims in MESHES:
        sub = os.path.join(d, f"{dims[0]}x{dims[1]}")
        os.makedirs(sub)
        shutil.copy(os.path.join(d, "inputs.npz"), sub)
        started[dims] = (cases.start("lm", dims, sub), sub)
    refs = {arch: _reference(arch) for arch in cases.LM_ARCHS}
    one = {arch: _one_device(arch) for arch in cases.LM_ARCHS}
    ranks = {dims: cases.collect(p, dims, sub)
             for dims, (p, sub) in started.items()}
    oracles.wait(oracle)
    prefill = dict(np.load(os.path.join(d, "lm_prefill.npz")))
    return {"ranks": ranks, "refs": refs, "one": one, "prefill": prefill}


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-780m"])
@pytest.mark.parametrize("dims", MESHES)
def test_sharded_ssd_block_matches_jax(dims, arch, runs):
    ranks, ref = runs["ranks"][dims], runs["refs"][arch]
    for name in ("y", "dx"):
        got = _stitch([r[f"{arch}.ssd.{name}"] for r in ranks], dims)
        np.testing.assert_allclose(got, ref[f"ssd_{name}"], rtol=F32,
                                   atol=F32)


@pytest.mark.parametrize("arch", cases.LM_ARCHS)
@pytest.mark.parametrize("dims", MESHES)
def test_sharded_loss_and_grads_match_jax(dims, arch, runs):
    ranks, ref = runs["ranks"][dims], runs["refs"][arch]
    loss = sum(float(r[f"{arch}.loss_share"]) for r in ranks)
    np.testing.assert_allclose(loss, ref["loss"], rtol=LOSS_RTOL)
    assert len(ref["grads"]) == sum(k.startswith(f"{arch}.grad.")
                                    for k in ranks[0])
    for i, want in enumerate(ref["grads"]):
        got = sum(r[f"{arch}.grad.{i}"] for r in ranks)
        if arch in LEAF_SCALE_GRADS:
            assert np.abs(got - want).max(initial=0) <= \
                1e-4 * np.abs(want).max(initial=0), f"leaf {i}"
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                       err_msg=f"leaf {i}")


@pytest.mark.parametrize("arch", cases.LM_ARCHS)
@pytest.mark.parametrize("dims", MESHES)
def test_sharded_prefill_matches_jax_under_a_mesh(dims, arch, runs):
    ranks, want = runs["ranks"][dims], runs["prefill"]
    # each rank's last logits are its block of the batch, on every shard
    # of the sequence axis
    logits = np.concatenate([ranks[r * dims[1]][f"{arch}.prefill.logits"]
                             for r in range(dims[0])])
    for r, x in enumerate(ranks):
        np.testing.assert_array_equal(
            x[f"{arch}.prefill.logits"],
            ranks[cases.shard(r, dims, ("data",))[0] * dims[1]][
                f"{arch}.prefill.logits"])
    ref = want[f"{arch}/logits"]
    assert np.abs(logits - ref).max() <= F32 * np.abs(ref).max()
    head = f"{arch}.prefill."
    layers = sorted(int(k[len(head):-2]) for k in ranks[0]
                    if k.startswith(head) and k.endswith(".k"))
    assert layers == sorted(int(k[len(arch) + 1:-2]) for k in want
                            if k.startswith(f"{arch}/") and k.endswith(".k"))
    # every layer but an SSM one has a K/V cache
    assert len(layers) == sum(t != "ssm" for t in treg.get(
        arch, smoke=True).layer_types())
    for li in layers:
        for name in "kv":
            ref = want[f"{arch}/{li}.{name}"]
            got = _stitch([r[f"{arch}.prefill.{li}.{name}"] for r in ranks],
                          dims)
            assert np.abs(got - ref).max() <= F32 * np.abs(ref).max(), \
                (li, name)


@pytest.mark.parametrize("arch", cases.LM_ARCHS)
@pytest.mark.parametrize("dims", MESHES)
def test_sharded_training_matches_one_device(dims, arch, runs):
    ranks, one = runs["ranks"][dims], runs["one"][arch]
    for key in ("losses", "grad_norms"):
        for r in ranks:
            np.testing.assert_array_equal(r[f"{arch}.train.{key}"],
                                          ranks[0][f"{arch}.train.{key}"])
        np.testing.assert_allclose(ranks[0][f"{arch}.train.{key}"],
                                   one[key], rtol=TRAIN_RTOL)
    lr = topt.warmup_cosine(3e-3, 20, cases.LM_STEPS)
    lr_sum = sum(lr(s + 1) for s in range(cases.LM_STEPS))
    n_off = n_all = 0
    for i, want in enumerate(one["params"]):
        got = ranks[0][f"{arch}.train.param.{i}"]
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"{arch}.train.param.{i}"], got)
        diff = np.abs(got - want)
        n_off += int((diff > 1e-7 + TRAIN_RTOL * np.abs(want)).sum())
        n_all += diff.size
        assert diff.max() <= 2 * lr_sum
    assert n_off <= 1e-3 * n_all, (n_off, n_all)
