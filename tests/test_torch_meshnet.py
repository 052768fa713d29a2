"""The port's single-device mesh-tangling CNN against the JAX reference.

The same numpy params (the reference's `meshnet.init`, carried across by
`MeshNet.params_from_jax`) and the same synthetic batches go through both
packages on the CPU.  Tolerances and their reasons:

* loss rtol 1e-5: fp32 forward through a few conv-BN-ReLU layers whose
  sums run in another order (matmul taps vs XLA conv, BN reductions);
* grads rtol 1e-4 / atol 1e-6: the backward adds the BN normalisation's
  division by a per-channel std of order 1e-1..1, which amplifies the
  forward's rounding by about ten, and tiny grads need an absolute floor;
* 3-step trajectory: losses rtol 1e-4 and params rtol 1e-4 / atol 1e-6,
  the grads' tolerance carried through three SGD steps.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import utils as jutils
from repro.core import spatial_conv as jsc
from repro.core import spatial_norm as jsn
from repro.data import pipeline as jpipe
from repro.models.cnn import meshnet as jmesh
from repro.optim import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import utils as tutils
from repro_torch.configs import mesh1k as tmesh1k
from repro_torch.configs import registry as treg
from repro_torch.core import spatial_conv as tsc
from repro_torch.core import spatial_norm as tsn
from repro_torch.data import pipeline as tpipe
from repro_torch.models.cnn import meshnet as tmesh
from repro_torch.optim import optimizer as topt
from repro_torch.train import metrics as tmetrics
from repro_torch.train import train_loop as ttl

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW18 = jmesh.MeshNetConfig("narrow18", input_hw=64, in_channels=18,
                               convs_per_block=2, widths=(8, 16))
CONFIGS = ["mesh1k_smoke", "narrow18"]


def _cfgs(name):
    """(reference config, port config) of one name."""
    if name == "mesh1k_smoke":
        from repro.configs import mesh1k as jmesh1k
        return jmesh1k.SMOKE, tmesh1k.SMOKE
    return NARROW18, tmesh.MeshNetConfig(**{
        f: getattr(NARROW18, f) for f in
        ("name", "input_hw", "in_channels", "convs_per_block", "widths",
         "n_classes", "bn_scope")})


def _setup(name, batch=2):
    jcfg, tcfg = _cfgs(name)
    jparams = jmesh.init(jax.random.PRNGKey(0), jcfg)
    model = tmesh.MeshNet(tcfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    model.params_from_jax(jax.tree.map(np.asarray, jparams))
    nb = tpipe.synthetic_mesh_batch(0, batch, tcfg.input_hw,
                                    tcfg.in_channels, out_hw=tcfg.out_hw)
    return jcfg, tcfg, jparams, model, nb


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_grads_match_jax(name):
    jcfg, tcfg, jparams, model, nb = _setup(name)
    jloss, jgrads = jax.value_and_grad(jmesh.loss_fn)(
        jparams, {k: jnp.asarray(v) for k, v in nb.items()}, jcfg)
    tb = tpipe.to_device(nb, torch.device("cpu"))
    params = model.params()
    loss = tmesh.loss_fn(params, tb, tcfg)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    leaves = tutils.tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves)
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for g, jg in zip(grads, jleaves):
        assert tuple(g.shape) == jg.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(jg),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", CONFIGS)
def test_three_step_sgd_trajectory_matches_jax(name):
    jcfg, tcfg, jparams, model, _ = _setup(name)
    lr, steps = 0.1, 3
    jstep = jtl.make_train_step(
        functools.partial(jmesh.loss_fn, cfg=jcfg),
        jopt.sgd(jopt.warmup_cosine(lr, 1, steps), momentum=0.9), None,
        jtl.TrainStepConfig(precision=jutils.FP32))
    jo = jopt.sgd(jopt.warmup_cosine(lr, 1, steps), momentum=0.9)
    jstate = jo.init(jparams)
    opt = topt.sgd(topt.warmup_cosine(lr, 1, steps), momentum=0.9)
    tstep = ttl.make_train_step(
        functools.partial(tmesh.loss_fn, cfg=tcfg), opt,
        ttl.TrainStepConfig(precision=tutils.FP32))
    params = model.params()
    state = opt.init(params)
    for s in range(steps):
        nb = tpipe.synthetic_mesh_batch(s, 2, tcfg.input_hw,
                                        tcfg.in_channels, out_hw=tcfg.out_hw)
        jparams, jstate, _, jm = jstep(
            jparams, jstate, None, {k: jnp.asarray(v) for k, v in nb.items()})
        params, state, _, m = tstep(params, state, None,
                                 tpipe.to_device(nb, torch.device("cpu")))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert state.step == steps
    for p, jp in zip(tutils.tree_leaves(params), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   rtol=1e-4, atol=1e-6)


def test_grad_accum_matches_jax():
    """A batch of 4 as two micro-batches of 2, each normalised by its own
    BN statistics as in the reference's grad_accum step."""
    jcfg, tcfg, jparams, model, _ = _setup("mesh1k_smoke")
    nb = tpipe.synthetic_mesh_batch(0, 4, tcfg.input_hw, tcfg.in_channels,
                                    out_hw=tcfg.out_hw)
    jstep = jtl.make_train_step(
        functools.partial(jmesh.loss_fn, cfg=jcfg),
        jopt.sgd(0.05, momentum=0.9), None,
        jtl.TrainStepConfig(grad_accum=2, precision=jutils.FP32))
    jo = jopt.sgd(0.05, momentum=0.9)
    _, _, _, jm = jstep(jparams, jo.init(jparams), None,
                        {k: jnp.asarray(v) for k, v in nb.items()})
    opt = topt.sgd(0.05, momentum=0.9)
    tstep = ttl.make_train_step(
        functools.partial(tmesh.loss_fn, cfg=tcfg), opt,
        ttl.TrainStepConfig(grad_accum=2, precision=tutils.FP32))
    params = model.params()
    _, _, _, m = tstep(params, opt.init(params), None,
                       tpipe.to_device(nb, torch.device("cpu")))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)


@pytest.mark.parametrize("step,batch,hw,c,out_hw", [
    (0, 2, 64, 18, 1), (3, 1, 32, 4, 4), (7, 3, 64, 18, None)])
def test_synthetic_mesh_batch_bit_identical(step, batch, hw, c, out_hw):
    a = jpipe.synthetic_mesh_batch(step, batch, hw, c, out_hw=out_hw)
    b = tpipe.synthetic_mesh_batch(step, batch, hw, c, out_hw=out_hw)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("h,w,c,f,k,s", [
    (16, 16, 4, 8, 3, 1), (32, 16, 3, 8, 7, 2), (16, 8, 4, 4, 1, 1),
    (16, 16, 6, 6, 3, 2), (34, 34, 18, 8, 3, 2)])
def test_spatial_conv2d_same_padding_matches_jax(h, w, c, f, k, s):
    """SAME padding is asymmetric at stride 2 (same_pads(3, 2) == (0, 1));
    the port pads explicitly and must land on XLA's SAME conv."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((k, k, c, f)) * 0.1).astype(np.float32)
    want = jsc.spatial_conv2d(jnp.asarray(x), jnp.asarray(wt),
                              strides=(s, s), sharding=jsc.ConvSharding())
    got = tsc.spatial_conv2d(torch.from_numpy(x), torch.from_numpy(wt),
                             strides=(s, s), sharding=tsc.ConvSharding())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("scope", ["local", "spatial", "global"])
def test_batch_norm_matches_jax(scope):
    """Non-spatial sharding: every scope takes the statistics of the
    whole tensor.  Offset inputs exercise E[x^2] - mean^2."""
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 8, 8, 5)) * 2 + 3).astype(np.float32)
    g = rng.standard_normal(5).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    want = jsn.batch_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                          sharding=jsc.ConvSharding(), scope=scope)
    got = tsn.batch_norm(torch.from_numpy(x), torch.from_numpy(g),
                         torch.from_numpy(b), sharding=tsc.ConvSharding(),
                         scope=scope)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_conv_sharding_fit_matches_jax():
    shape = {"model": 4, "data": 2}
    for h, k, s in [(16, 3, 1), (6, 3, 2), (8, 3, 2), (4, 7, 1)]:
        for axis in ("model", ("data", "model"), None):
            j = jsc.fit_spatial_axis(h, axis, k, s, shape)
            t = tsc.fit_spatial_axis(h, axis, k, s, shape)
            assert j == t, (h, k, s, axis)
    sh = tsc.ConvSharding(h_axis="model", w_axis="data")
    assert sh.spatial_axes == ("model", "data")
    assert sh.fit(16, 16, 3, 1, None) is sh


def test_utils_match_reference():
    for k, s in [(3, 1), (3, 2), (1, 1), (7, 2), (5, 1), (1, 2)]:
        assert tutils.same_pads(k, s) == jutils.same_pads(k, s)
    for a, b in [(7, 2), (8, 2), (1, 5), (0, 3)]:
        assert tutils.cdiv(a, b) == jutils.cdiv(a, b)
    for n in [0, 1023, 1024, 3.5e9, 7e15]:
        assert tutils.human_bytes(n) == jutils.human_bytes(n)
        assert tutils.human_count(n) == jutils.human_count(n)
    assert tutils.fingerprint(tmesh.MESH1K) == \
        jutils.fingerprint(jmesh.MESH1K)
    assert tutils.FP32.compute_dtype == torch.float32
    assert tutils.BF16.compute_dtype == torch.bfloat16
    assert tutils.BF16.param_dtype == torch.float32


def test_time_fn_on_host():
    calls = []
    t = tutils.time_fn(lambda: calls.append(1), reps=3, warmup=2)
    assert len(calls) == 5 and t >= 0


def test_warmup_cosine_and_clip_match_jax():
    jl = jopt.warmup_cosine(0.1, 5, 20)
    tl = topt.warmup_cosine(0.1, 5, 20)
    for s in [0, 1, 4, 5, 6, 12, 20, 25]:
        np.testing.assert_allclose(tl(s), float(jl(jnp.asarray(s))),
                                   rtol=1e-6)
    rng = np.random.default_rng(7)
    gs = [rng.standard_normal(sh).astype(np.float32)
          for sh in [(3, 3, 4, 8), (8,), (1, 1, 8, 1)]]
    jc, jn = jopt.clip_by_global_norm([jnp.asarray(g) for g in gs], 1.0)
    tc, tn = topt.clip_by_global_norm([torch.from_numpy(g) for g in gs], 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_meshnet_layout_matches_reference():
    cfg = tmesh1k.CONFIG
    assert tmesh.layer_names(cfg) == jmesh.layer_names(jmesh.MESH1K)
    assert len(tmesh.layer_names(cfg)) == 19
    model = tmesh.MeshNet(tmesh1k.SMOKE,
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    jp = jmesh.init(jax.random.PRNGKey(0), jmesh.MeshNetConfig(
        "mesh1k-smoke", input_hw=64, in_channels=4, convs_per_block=1,
        widths=(8, 16, 16)))
    ref_shapes = [tuple(a.shape) for a in jax.tree.leaves(jp)]
    assert [tuple(p.shape) for p in tutils.tree_leaves(model.params())] \
        == ref_shapes
    assert "conv1_1.bn.gamma" in {n.removeprefix("layers.")
                                  for n, _ in model.named_parameters()}
    # He-normal std sqrt(2 / fan_in) on the first conv
    w = model.params()[0]["conv"]["w"]
    assert abs(float(w.detach().std()) - (2.0 / (9 * 4)) ** 0.5) < 0.1


def test_params_from_jax_rejects_mismatch():
    model = tmesh.MeshNet(tmesh1k.SMOKE,
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    tree = [{k: {pk: v.detach().numpy() for pk, v in sub.items()}
             for k, sub in layer.items()} for layer in model.params()]
    tree[0]["conv"]["w"] = np.zeros((3, 3, 4, 9), np.float32)
    with pytest.raises(ValueError, match="shape"):
        model.params_from_jax(tree)
    with pytest.raises(ValueError, match="layers"):
        model.params_from_jax(tree[:-1])


def test_registry_refuses_unported_archs():
    assert treg.get("mesh2k").name == "mesh2k"
    assert treg.get("mesh1k", smoke=True).input_hw == 64
    with pytest.raises(ValueError, match="not ported yet"):
        treg.get("pixtral-12b")
    with pytest.raises(ValueError, match="not ported yet"):
        treg.get("seamless-m4t-large-v2")
    assert treg.get("qwen2.5-14b").head_dim == 128
    assert treg.get("gemma2-9b", smoke=True).vocab == 256


def test_prefetcher_is_step_addressable():
    pf = tpipe.Prefetcher(lambda s: {"s": s}, start_step=0)
    try:
        assert pf.get(0)["s"] == 0
        assert pf.get(3)["s"] == 3          # skips forward
        assert pf.get(1)["s"] == 1          # rewinds
        assert pf.get(2)["s"] == 2
    finally:
        pf.close()
    assert not pf._t.is_alive()


def test_metrics_logger_writes_jsonl(tmp_path):
    path = tmp_path / "m.jsonl"
    with tmetrics.MetricsLogger(str(path), echo=False) as ml:
        ml.log_run(arch="x")
        ml.log_step(0, 0.5, step_time_s=0.1, samples_per_s=20.0)
        ml.log_done(1, loss=0.5)
    recs = [json.loads(l) for l in path.read_text().splitlines()]
    assert [r["kind"] for r in recs] == ["run", "step", "done"]
    assert recs[0]["schema"] == "repro/metrics@1"
    assert recs[1]["loss"] == 0.5


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        tutils.resolve_device("cuda")
    assert tutils.resolve_device("cpu").type == "cpu"


def test_train_cli_smoke_on_cpu(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "2"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mesh1k", "--smoke", "--steps", "2", "--device", "cpu",
         "--metrics", str(tmp_path / "m.jsonl")],
        capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "done at step 2; final loss" in r.stdout
    recs = [json.loads(l) for l in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    assert sum(r["kind"] == "step" for r in recs) == 2
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--strategy", "auto", "--search", "dfs"],
        capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path)
    assert bad.returncode == 2 and "unknown search mode" in bad.stderr
