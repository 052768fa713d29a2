"""The port's checkpoints (`checkpoint/checkpoint.py`, the optimizer's
`state_tree` / `load_state_tree`) against the JAX reference's.

- The reference's checkpoint cases (`tests/test_fault_tolerance.py`):
  malformed `step-*` names ignored, `tmp-*` swept, the plan recorded in
  the manifest, a torn manifest refused, the restore errors' wording.
- Across the packages, both ways: one package trains 2 steps and saves
  `(params, OptState, None)`, the other restores it into a template drawn
  from another seed and takes step 3, whose loss must match the saving
  package's own step 3 within the one-device trajectory tolerance of
  `test_torch_meshnet.py` / `test_torch_lm.py` (rtol 1e-4: the grads'
  tolerance carried through SGD or AdamW steps).  mesh1k SMOKE and the
  tiny ResNet under SGD, hymba SMOKE under AdamW (so `nu`, and the LM's
  stacked segments, are exercised).
- An async save copies: the tensors it saved, updated in place by two
  more steps before the write, restore with the saved step's values.
- `assert_no_nans` and `debug_nan_check` name the same layer and keypath
  as the reference's.
"""
import functools
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import utils as jutils
from repro.checkpoint import checkpoint as jck
from repro.configs import hymba_1_5b as jhymba
from repro.configs import mesh1k as jmesh1k
from repro.data import pipeline as jpipe
from repro.models.cnn import meshnet as jmesh
from repro.models.cnn import resnet as jres
from repro.models.lm import transformer as jT
from repro.optim import optimizer as jopt
from repro.train import metrics as jmetrics
from repro.train import train_loop as jtl
from repro_torch import utils as tutils
from repro_torch.checkpoint import checkpoint as tck
from repro_torch.configs import hymba_1_5b as thymba
from repro_torch.configs import mesh1k as tmesh1k
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as train_cli
from repro_torch.models.cnn import meshnet as tmesh
from repro_torch.models.cnn import resnet as tres
from repro_torch.models.lm import transformer as tT
from repro_torch.optim import optimizer as topt
from repro_torch.train import metrics as tmetrics
from repro_torch.train import train_loop as ttl

torch.set_num_threads(2)

TRAJ_RTOL = 1e-4
TINY = {"name": "tiny", "input_hw": 32, "n_classes": 10, "stages": (1, 1),
        "widths": (8, 16)}
SEQ = 128           # as test_torch_lm: > the smoke window, two SSD chunks


# ---------------------------------------------------- reference's cases --

def test_checkpoint_ignores_malformed_entries_and_sweeps_tmp(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "step-garbage"))
    os.makedirs(os.path.join(d, "step-"))
    os.makedirs(os.path.join(d, "tmp-7"))
    with open(os.path.join(d, "step-123"), "w") as f:
        f.write("a plain file, not a checkpoint dir")
    ck = tck.CheckpointManager(d, keep=2, async_save=False)
    assert not [x for x in os.listdir(d) if x.startswith("tmp-")]
    assert ck.latest_step() is None
    ck.save(5, {"w": torch.arange(3.0)})
    ck.save(9, {"w": torch.arange(3.0)})
    assert ck.latest_step() == 9
    got, manifest = ck.restore({"w": torch.zeros(3)})
    assert manifest["schema"] == tck.SCHEMA == jck.SCHEMA
    np.testing.assert_allclose(got["w"].numpy(), [0, 1, 2])
    ck.save(11, {"w": torch.arange(3.0)})
    steps = sorted(x for x in os.listdir(d) if x.startswith("step-")
                   and os.path.isdir(os.path.join(d, x)))
    assert steps == ["step-", "step-11", "step-9", "step-garbage"]


def test_checkpoint_manifest_records_plan(tmp_path):
    ck = tck.CheckpointManager(str(tmp_path), async_save=False)
    spec = {"schema": "repro/plan@1", "mesh": {"data": 2, "model": 2},
            "mem_limit": 1e6, "layers": {}}
    ck.save(3, {"w": np.zeros(2, np.float32)}, extra={"step": 3}, plan=spec)
    m = ck.read_manifest()
    assert m["plan"]["mesh"] == {"data": 2, "model": 2}
    assert m["extra"]["step"] == 3
    assert set(m) == {"schema", "step", "treedef", "shapes", "dtypes",
                      "extra", "plan", "time"}
    with pytest.raises(tck.CheckpointError, match="data"):
        ck.restore({"w": np.zeros(2), "x": np.zeros(1)})


def test_checkpoint_torn_manifest_raises(tmp_path):
    d = str(tmp_path)
    ck = tck.CheckpointManager(d, async_save=False)
    os.makedirs(os.path.join(d, "step-4"))
    with open(os.path.join(d, "step-4", "manifest.json"), "w") as f:
        f.write("{not json")
    with pytest.raises(tck.CheckpointError, match="torn"):
        ck.read_manifest(4)


@pytest.mark.parametrize("bad", ["count", "shape"])
def test_restore_errors_word_as_the_reference(tmp_path, bad):
    """Both packages refuse the same template with the same message."""
    plan = {"schema": "repro/plan@1", "mesh": {"data": 1, "model": 3}}
    tree = {"a": np.zeros((2, 3), np.float32), "b": np.ones(4, np.float32)}
    like = dict(tree, c=np.zeros(1)) if bad == "count" else \
        dict(tree, b=np.zeros(5))
    msgs = []
    for mod in (tck, jck):
        d = str(tmp_path / mod.__name__.split(".")[0])
        ck = mod.CheckpointManager(d, async_save=False)
        ck.save(2, tree, extra={"step": 2}, plan=plan)
        with pytest.raises(mod.CheckpointError) as e:
            ck.restore(like)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "{'data': 1, 'model': 3}" in msgs[0]


def test_async_write_error_surfaces_at_next_save_and_wait(tmp_path):
    ck = tck.CheckpointManager(str(tmp_path), async_save=True)
    ck.save(1, [np.zeros(2)])
    ck.wait()
    boom = RuntimeError("disk gone")
    ck._write = lambda *a: (_ for _ in ()).throw(boom)
    ck.save(2, [np.zeros(2)])
    with pytest.raises(RuntimeError, match="disk gone"):
        ck.wait()
    ck.save(3, [np.zeros(2)])
    ck._q.join()                   # the thread has failed step 3's write
    with pytest.raises(RuntimeError, match="disk gone"):
        ck.save(4, [np.zeros(2)])
    assert ck.latest_step() == 1


def test_flatten_matches_jax_tree_order():
    tree = ({"b": [np.zeros(1), None], "a": (np.ones(2),)},
            (np.int32(3), None), None)
    ours = tck.flatten(tree)
    ref = jax.tree.leaves(tree)
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    back = tck.unflatten(tree, iter(["x", "y", "z"]))
    assert back == ({"b": ["y", None], "a": ("x",)}, ("z", None), None)
    assert tck.treedef_str(tree) == \
        "({'a': (*,), 'b': [*, None]}, (*, None), None)"


def test_writer_false_reads_and_never_writes(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "tmp-3"))
    w = tck.CheckpointManager(d, async_save=False)
    w.save(2, [np.arange(2.0)])
    os.makedirs(os.path.join(d, "tmp-5"))
    r = tck.CheckpointManager(d, writer=False)
    assert os.path.isdir(os.path.join(d, "tmp-5"))      # not swept
    r.save(4, [np.arange(2.0)])
    r.wait()
    assert r.latest_step() == 2
    got, _ = r.restore([np.zeros(2)])
    np.testing.assert_array_equal(got[0], [0.0, 1.0])


# ------------------------------------------------------ across packages --

def _mesh_rig(seed):
    jcfg, tcfg = jmesh1k.SMOKE, tmesh1k.SMOKE
    jparams = jmesh.init(jax.random.PRNGKey(seed), jcfg)
    model = tmesh.MeshNet(tcfg, generator=torch.Generator(), device="cpu")
    model.params_from_jax(jax.tree.map(np.asarray, jparams))

    def batch(s):
        return tpipe.synthetic_mesh_batch(s, 2, tcfg.input_hw,
                                          tcfg.in_channels,
                                          out_hw=tcfg.out_hw)
    return (jparams, functools.partial(jmesh.loss_fn, cfg=jcfg),
            model.params(), functools.partial(tmesh.loss_fn, cfg=tcfg),
            batch, train_cli.checkpoint_layout(tcfg))


def _resnet_rig(seed):
    jcfg, tcfg = jres.ResNetConfig(**TINY), tres.ResNetConfig(**TINY)
    jparams = jres.init(jax.random.PRNGKey(seed), jcfg)
    model = tres.ResNet(tcfg, generator=torch.Generator(), device="cpu")
    model.params_from_jax(jax.tree.map(np.asarray, jparams))

    def batch(s):
        return tpipe.synthetic_imagenet_batch(s, 2, tcfg.input_hw,
                                              tcfg.n_classes)
    return (jparams, lambda p, b: jres.loss_fn(p, b, jcfg), model.params(),
            lambda p, b: tres.loss_fn(p, b, tcfg), batch,
            train_cli.checkpoint_layout(tcfg))


def _hymba_rig(seed):
    jcfg, tcfg = jhymba.SMOKE, thymba.SMOKE
    jparams = jT.init(jax.random.PRNGKey(seed), jcfg)
    params = tT.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)

    def batch(s):
        return tpipe.synthetic_lm_batch(s, 2, SEQ, tcfg.vocab)
    return (jparams, functools.partial(jT.loss_fn, cfg=jcfg, remat=False),
            params, functools.partial(tT.loss_fn, cfg=tcfg), batch,
            train_cli.checkpoint_layout(tcfg))


RIGS = {"mesh1k_smoke": (_mesh_rig, "sgd"), "resnet_tiny": (_resnet_rig, "sgd"),
        "hymba_smoke": (_hymba_rig, "adamw")}


def _opts(kind):
    if kind == "sgd":
        return (jopt.sgd(jopt.warmup_cosine(0.1, 1, 3), momentum=0.9),
                topt.sgd(topt.warmup_cosine(0.1, 1, 3), momentum=0.9))
    return (jopt.adamw(jopt.warmup_cosine(3e-3, 20, 3)),
            topt.adamw(topt.warmup_cosine(3e-3, 20, 3)))


def _jax_steps(jparams, jloss, jo, batch, state, steps):
    jstep = jtl.make_train_step(jloss, jo, None,
                                jtl.TrainStepConfig(precision=jutils.FP32))
    jparams = jax.tree.map(jnp.asarray, jparams)
    losses = []
    for s in steps:
        jparams, state, _, m = jstep(jparams, state, None, {
            k: jnp.asarray(v) for k, v in batch(s).items()})
        losses.append(float(m["loss"]))
    return jparams, state, losses


def _port_steps(params, tloss, to, batch, state, steps):
    tstep = ttl.make_train_step(tloss, to, ttl.TrainStepConfig(
        precision=tutils.FP32))
    losses = []
    for s in steps:
        params, state, _, m = tstep(params, state, None, tpipe.to_device(
            batch(s), torch.device("cpu")))
        losses.append(float(m["loss"]))
    return params, state, losses


@pytest.mark.parametrize("name", list(RIGS))
def test_jax_checkpoint_resumes_in_the_port(tmp_path, name):
    rig, kind = RIGS[name]
    jo, to = _opts(kind)
    jparams, jloss, _, _, batch, _ = rig(0)
    jparams, jstate, _ = _jax_steps(jparams, jloss, jo, batch,
                                    jo.init(jparams), range(2))
    jck.CheckpointManager(str(tmp_path), async_save=False).save(
        2, (jparams, jstate, None), extra={"step": 2})
    _, _, (want,) = _jax_steps(jparams, jloss, jo, batch, jstate, [2])

    _, _, params, tloss, _, (to_ref, from_ref) = rig(1)   # other weights
    state = to.init(params)
    ck = tck.CheckpointManager(str(tmp_path), writer=False)
    tree, manifest = ck.restore(topt.state_tree(params, state, to_ref))
    state = topt.load_state_tree(tree, params, state, from_ref)
    assert manifest["extra"]["step"] == 2 and state.step == 2
    _, _, (got,) = _port_steps(params, tloss, to, batch, state, [2])
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)


@pytest.mark.parametrize("name", list(RIGS))
def test_port_checkpoint_resumes_in_jax(tmp_path, name):
    rig, kind = RIGS[name]
    jo, to = _opts(kind)
    _, _, params, tloss, batch, (to_ref, _) = rig(0)
    params, state, _ = _port_steps(params, tloss, to, batch,
                                   to.init(params), range(2))
    ck = tck.CheckpointManager(str(tmp_path), async_save=True)
    ck.save(2, topt.state_tree(params, state, to_ref), extra={"step": 2})
    ck.wait()
    _, _, (want,) = _port_steps(params, tloss, to, batch, state, [2])

    jparams, jloss, _, _, _, _ = rig(1)
    (jparams, jstate, _), manifest = jck.CheckpointManager(
        str(tmp_path), async_save=False).restore(
        (jparams, jo.init(jparams), None))
    assert manifest["treedef"].startswith("(")     # the port's own form
    assert int(jstate.step) == 2
    _, _, (got,) = _jax_steps(jparams, jloss, jo, batch, jstate, [2])
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)


def test_lm_layout_round_trips_in_place():
    _, _, params, _, _, (to_ref, from_ref) = _hymba_rig(0)
    ref = to_ref(params)
    jref = jax.tree.map(np.asarray, jT.init(jax.random.PRNGKey(0),
                                            jhymba.SMOKE))
    assert jax.tree.structure(jax.tree.map(lambda t: 0, ref)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, jref))
    for a, b in zip(tck.flatten(ref), jax.tree.leaves(jref)):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    back = from_ref(ref)
    for a, b in zip(tutils.tree_leaves(back), tutils.tree_leaves(params)):
        assert torch.equal(a, b)


# ------------------------------------------------------- snapshot copy --

def test_async_save_snapshots_before_in_place_steps(tmp_path):
    """The port's SGD updates the params in place: the async write, held
    back until two more steps have run, must still hold the saved step's
    values."""
    _, _, params, tloss, batch, _ = _mesh_rig(0)
    _, to = _opts("sgd")
    params, state, _ = _port_steps(params, tloss, to, batch,
                                   to.init(params), range(1))
    saved = [p.detach().clone() for p in tutils.tree_leaves(params)]
    ck = tck.CheckpointManager(str(tmp_path), async_save=True)
    gate, write = threading.Event(), ck._write

    def held(*a):
        gate.wait(30)
        write(*a)
    ck._write = held
    ck.save(1, topt.state_tree(params, state), extra={"step": 1})
    params, state, _ = _port_steps(params, tloss, to, batch, state, [1, 2])
    gate.set()
    ck.wait()
    now = tutils.tree_leaves(params)
    assert any(not torch.equal(a, b) for a, b in zip(now, saved))
    tree, _ = ck.restore(topt.state_tree(params, state))
    for got, want in zip(tutils.tree_leaves(tree[0]), saved):
        assert torch.equal(got, want)
    assert int(tree[1][0]) == 1


# ---------------------------------------------------------- NaN naming --

def _nan_trees():
    """The reference's mesh1k SMOKE params with a NaN in conv2_1's BN
    gamma, and the port's copy of them."""
    jparams = jax.tree.map(np.asarray,
                           jmesh.init(jax.random.PRNGKey(0), jmesh1k.SMOKE))
    i = jmesh.layer_names(jmesh1k.SMOKE).index("conv2_1")
    jparams[i]["bn"]["gamma"] = jparams[i]["bn"]["gamma"].copy()
    jparams[i]["bn"]["gamma"][1] = np.nan
    model = tmesh.MeshNet(tmesh1k.SMOKE, generator=torch.Generator(),
                          device="cpu")
    model.params_from_jax(jparams)
    return jparams, model.params()


def test_assert_no_nans_names_the_reference_keypath():
    jparams, params = _nan_trees()
    for tree_j, tree_t in ((jparams, params),
                           ({"net": jparams}, {"net": params}),
                           ((jparams[:2], jparams[2:]),
                            (params[:2], params[2:]))):
        with pytest.raises(AssertionError) as ej:
            jutils.assert_no_nans(tree_j, where="x ")
        with pytest.raises(AssertionError) as et:
            tutils.assert_no_nans(tree_t, where="x ")
        assert str(et.value) == str(ej.value)
    tutils.assert_no_nans(topt.OptState(3, [torch.ones(2)], None))
    with pytest.raises(AssertionError, match=r"NaN in \.mu\[0\]"):
        tutils.assert_no_nans(topt.OptState(3, [torch.tensor([np.nan])],
                                            None))


def test_debug_nan_check_names_the_same_layer():
    jparams, params = _nan_trees()
    names = jmesh.layer_names(jmesh1k.SMOKE)
    msgs = []
    for check, p in ((jmetrics.debug_nan_check, jparams),
                     (tmetrics.debug_nan_check, params)):
        check(3, {"loss": 0.5, "grad_norm": 1.0}, p, names)   # finite
        with pytest.raises(FloatingPointError) as e:
            check(3, {"loss": float("nan"), "grad_norm": 1.0}, p, names)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "layer 'conv2_1' ['bn']['gamma']" in msgs[1]
    with pytest.raises(FloatingPointError, match="all finite"):
        tmetrics.debug_nan_check(0, {"grad_norm": float("inf")},
                                 tmesh.MeshNet(
                                     tmesh1k.SMOKE,
                                     generator=torch.Generator(),
                                     device="cpu").params(), names)


def test_metrics_logger_log_event(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with tmetrics.MetricsLogger(path, echo=False) as m:
        m.log_event("rollback", step=4)
    rec = json.loads(open(path).read())
    assert rec["kind"] == "rollback" and rec["step"] == 4 and "time" in rec
