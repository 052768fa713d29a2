"""The chaos lane on the port: `tests/dist_checks.py` check_elastic on 4
gloo CPU ranks (`torch_dist_cases.py` case `elastic`), and a mesh on a
subset of the ranks (case `subset`).

check_elastic's run: the tiny mesh net (24², 6 channels, widths 12, 24,
global BN), batch 4, 10 SGD steps, a checkpoint every 3, a fault at step
7, in each mode:

- step-fault: raise at 7, roll back to step 6 on the same mesh;
- kill-device: lose 1 of 4 ranks at 7, remesh onto the 3 survivors
  (data 1 x model 3) with the checkpoint's plan record (plan_from_spec,
  a PlanError re-solving under the same memory limit), restore, resume;
  the rank that left returns at step 7;
- corrupt-tmp: plant mid-save debris at 4, then fault at 7: the rollback
  picks step-6, gc sweeps the tmp, the garbage name stays and is ignored.

The losses are held against the reference's trajectory on one device (a
4-device reference run of a sample-parallel plan is off by its own
gradients, ROADMAP Queue 3), with check_elastic's post-restore
tolerances: 5e-3 after a kill-device rollback (the 3-rank decomposition
reorders the sums), else 1e-5, before the rollback point too.
check_elastic holds its pre-fault steps to 1e-6, but there two runs of
one program on one mesh meet; here 4 gloo ranks meet one JAX device,
and their pre-fault steps differ by up to 8.2e-7 (on a CPU), too
close to 1e-6 to hold across machines.

The subset case: a halo exchange, a ring shift and the collectives on
`Mesh(members=[1, 3])` of a 4-rank world give, mesh rank by mesh rank,
exactly what they give on a 2-rank world.
"""
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import utils as jutils
from repro.data import pipeline as jpipe
from repro.models.cnn import meshnet as jmesh
from repro.optim import optimizer as jopt
from repro.train import train_loop as jtl

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_cases as cases  # noqa: E402

FAULT, NUM = cases.ELASTIC_FAULT, cases.ELASTIC_NUM


@functools.lru_cache(maxsize=None)
def _oracle():
    """The reference's params and its one-device loss trajectory."""
    cfg = jmesh.MeshNetConfig("t", **cases.ELASTIC)
    params = jmesh.init(jax.random.PRNGKey(0), cfg)
    opt = jopt.sgd(0.05, momentum=0.9)
    step = jtl.make_train_step(functools.partial(jmesh.loss_fn, cfg=cfg),
                               opt, None,
                               jtl.TrainStepConfig(precision=jutils.FP32))
    flat = {f"{i}.{k}.{pk}": np.asarray(v) for i, layer in enumerate(params)
            for k, sub in layer.items() for pk, v in sub.items()}
    p, o, losses = params, opt.init(params), []
    for s in range(NUM):
        b = jpipe.synthetic_mesh_batch(s, cases.ELASTIC_BATCH, cfg.input_hw,
                                       cfg.in_channels, out_hw=cfg.out_hw)
        p, o, _, m = step(p, o, None, {k: jnp.asarray(v)
                                       for k, v in b.items()})
        losses.append(float(m["loss"]))
    return flat, np.array(losses)


@pytest.mark.parametrize("mode", ["step-fault", "kill-device",
                                  "corrupt-tmp"])
def test_elastic_matches_the_one_device_reference(tmp_path, mode):
    flat, oracle = _oracle()
    np.savez(tmp_path / "inputs.npz", **flat)
    (tmp_path / "elastic.json").write_text(json.dumps({"mode": mode}))
    ranks = cases.run("elastic", (2, 2), str(tmp_path), timeout=240)
    events = [json.loads(ln) for ln in
              (tmp_path / "metrics.jsonl").read_text().splitlines()]
    kinds = [e["kind"] for e in events]
    assert "fault" in kinds, kinds
    rollbacks = [e for e in events if e["kind"] == "rollback"]
    assert rollbacks and rollbacks[0]["step"] == FAULT - 1, rollbacks

    survivors = ranks[:3] if mode == "kill-device" else ranks
    for r in survivors:
        assert int(r["final_step"]) == NUM and int(r["left_at"]) == -1
        assert list(r["steps"]) == list(range(NUM))
        np.testing.assert_array_equal(r["losses"], survivors[0]["losses"])
    got = survivors[0]["losses"]
    np.testing.assert_allclose(got[:FAULT - 1], oracle[:FAULT - 1],
                               rtol=1e-5)
    if mode == "kill-device":
        left = ranks[3]
        assert int(left["left_at"]) == FAULT
        assert list(left["steps"]) == list(range(FAULT))
        rm = next(e for e in events if e["kind"] == "remesh")
        assert rm["n_devices"] == 3, rm
        assert str(survivors[0]["how"]) in ("plan_from_spec", "re-solved")
        np.testing.assert_allclose(got[FAULT - 1:], oracle[FAULT - 1:],
                                   rtol=5e-3)
    else:
        assert "remesh" not in kinds
        np.testing.assert_allclose(got[FAULT - 1:], oracle[FAULT - 1:],
                                   rtol=1e-5)
    listing = json.loads(str(ranks[0]["listing"]))
    assert not [x for x in listing if x.startswith("tmp-")], listing
    assert int(ranks[0]["latest"]) == NUM - 1
    if mode == "corrupt-tmp":
        assert "step-garbage" in listing, listing


def test_a_mesh_on_ranks_1_and_3_works_as_a_two_rank_world(tmp_path):
    (tmp_path / "four").mkdir()
    (tmp_path / "two").mkdir()
    four = cases.run("subset", (1, 4), str(tmp_path / "four"), timeout=120)
    two = cases.run("subset", (1, 2), str(tmp_path / "two"), timeout=120)
    assert [bool(r["member"]) for r in four] == [False, True, False, True]
    for sub, whole in zip((four[1], four[3]), two):
        assert int(sub["mesh_rank"]) == int(whole["mesh_rank"])
        for key in ("ext", "dx", "ring", "sum", "bcast", "max"):
            np.testing.assert_array_equal(sub[key], whole[key], err_msg=key)
    assert int(two[0]["bcast"]) == int(two[1]["bcast"]) == 10
    np.testing.assert_array_equal(two[0]["max"], [1.0, 0.0])
