"""The single-process examples of the port, `examples/quickstart_torch.py`
and `examples/train_mesh_e2e_torch.py`, at `--device cpu` against their
references (`examples/quickstart.py`, `examples/train_mesh_e2e.py`'s
loop), which run meanwhile in one subprocess on one host device
(`jax_mesh_oracles.py examples DIR`).  The reference's params (`init`
from `PRNGKey(0)`, computed here and checked against the subprocess's)
are carried over by `MeshNet.params_from_jax`.

- quickstart: the reference script runs as it is, with
  `perfmodel.TPU_V5E` set to `LASSEN`, the preset the port's CPU run
  solves on.  Every plan's `describe()` text (the hypothetical 2x2, the
  hand mix, the 4x2x2 solve, the 16-device mix, sample at batch 2, the
  `mem_limit` solve and the executing one-device plan) equals the
  reference's, and the limit too; the audit finds 0 errors on both; the
  10 training losses and the resilient run's 10 (steps 0-4, the fault at
  5, the rollback to 3, steps 3-7) are within rtol 1e-5 of the
  reference's (fp32 sums in another order; `tests/test_torch_meshnet.py`
  holds a step at this rtol), and the replayed steps 3-4 equal their
  first run exactly (the rollback restores every bit).
- train_mesh_e2e: E2E_STEPS steps of the counterpart's loop
  (`main(cfg=)` at `torch_dist_cases.E2E_NET`) within rtol 1e-5 of the
  reference's `make_train_step` + `warmup_cosine`.
- `utils.tree_num_params` against the reference's on both scripts'
  configs (the full 1K-family net's 21.99M), and every example refuses
  to run without CUDA unless given `--device cpu`.
"""
import os

import jax
import numpy as np
import pytest
import torch

import jax_mesh_oracles as oracles
import torch_dist_cases as cases
from repro.models.cnn import meshnet as jmesh
from repro.utils import tree_num_params as jtree_num_params
from repro_torch.models.cnn import meshnet as tmesh
from repro_torch.utils import load_example, tree_num_params

quickstart = load_example("quickstart_torch")
e2e = load_example("train_mesh_e2e_torch")

torch.set_num_threads(2)

RTOL = 1e-5
PLANS = ["hypo", "mixed", "auto16", "mixed16", "sample2", "fit2", "plan"]
EXAMPLES = ["quickstart_torch", "train_mesh_e2e_torch", "serve_lm_torch",
            "spatial_parallel_cnn_torch"]


def _jinit(cfg: jmesh.MeshNetConfig) -> list:
    return jax.tree.map(np.asarray, jmesh.init(jax.random.PRNGKey(0), cfg))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's side started, the port's run meanwhile, then the
    reference's results."""
    d = str(tmp_path_factory.mktemp("examples"))
    p = oracles.popen("examples", d, devices=1)
    qcfg = jmesh.MeshNetConfig(**vars(quickstart.CONFIG))
    ecfg = jmesh.MeshNetConfig("mesh-e2e", **cases.E2E_NET)
    params = {"quickstart": _jinit(qcfg), "e2e": _jinit(ecfg)}
    port = {"quickstart": quickstart.main(["--device", "cpu"],
                                          params=params["quickstart"]),
            "e2e": e2e.main(["--device", "cpu", "--steps",
                             str(cases.E2E_STEPS), "--batch",
                             str(cases.E2E_BATCH)],
                            cfg=tmesh.MeshNetConfig("mesh-e2e",
                                                    **cases.E2E_NET),
                            params=params["e2e"])}
    oracles.wait(p)
    return port, dict(np.load(os.path.join(d, "examples.npz"))), params


@pytest.mark.parametrize("which", ["quickstart", "e2e"])
def test_reference_params_are_the_ones_carried_over(runs, which):
    _, ref, params = runs
    got = cases.meshnet_params(ref, f"{which}/param/")
    assert len(got) == len(params[which])
    for a, b in zip(got, params[which]):
        for k in b:
            for pk in b[k]:
                np.testing.assert_array_equal(a[k][pk], b[k][pk])


@pytest.mark.parametrize("name", PLANS)
def test_quickstart_plans_match_the_reference_on_lassen(runs, name):
    port, ref, _ = runs
    q = port["quickstart"]
    assert q["machine"] == "lassen-v100"
    assert q["plans"][name].describe() == \
        str(ref[f"quickstart/describe/{name}"])


def test_quickstart_memory_pair_matches_the_reference(runs):
    """The limit is 3/4 of the sample plan's peak, the reference's; the
    sample plan's peak lies above it and the solve under it fits."""
    q = runs[0]["quickstart"]
    assert q["limit"] == float(runs[1]["quickstart/limit"])
    assert q["plans"]["sample2"].predicted["memory"]["peak_bytes"] > \
        q["limit"] >= q["plans"]["fit2"].predicted["memory"]["peak_bytes"]


def test_quickstart_audit_has_no_errors(runs):
    q, ref = runs[0]["quickstart"], runs[1]
    assert q["errors"] == 0 == int(ref["quickstart/errors"])
    assert q["mesh"] == {"data": 1, "model": 1}


def test_quickstart_training_losses_match_the_reference(runs):
    q, ref = runs[0]["quickstart"], runs[1]["quickstart/losses"]
    np.testing.assert_allclose(q["losses"], ref[:10], rtol=RTOL)


def test_quickstart_rollback_replays_the_uninterrupted_run(runs):
    """Steps 0-4, the fault at 5, the rollback to the step-3 checkpoint,
    steps 3-7: the replayed 3 and 4 equal their first run bit for bit,
    and the run's losses and final loss are the reference's."""
    q, ref = runs[0]["quickstart"], runs[1]
    steps = [i for i, _ in q["resilient"]]
    losses = np.array([l for _, l in q["resilient"]])
    assert steps == [0, 1, 2, 3, 4, 3, 4, 5, 6, 7]
    assert losses[3] == losses[5] and losses[4] == losses[6]
    np.testing.assert_allclose(losses, ref["quickstart/losses"][10:],
                               rtol=RTOL)
    assert q["end"] == int(ref["quickstart/end"]) == 8
    np.testing.assert_allclose(q["final_loss"],
                               float(ref["quickstart/final_loss"]),
                               rtol=RTOL)
    assert q["manifest_plan"]["mesh"] == {"data": 1, "model": 1}
    assert set(q["manifest_plan"]["layers"]) == set(
        tmesh.layer_names(quickstart.CONFIG))


def test_quickstart_trace_attributes_every_layer(runs):
    q = runs[0]["quickstart"]
    names = tmesh.layer_names(quickstart.CONFIG)
    assert list(q["trace"].layers) == names
    assert list(q["report"]["per_layer"]) == names
    assert q["report"]["worst_term"] in q["report"]["terms"]


def test_train_mesh_e2e_loop_matches_the_reference(runs):
    got, ref = runs[0]["e2e"], runs[1]["e2e/losses"]
    assert got["steps"] == cases.E2E_STEPS
    np.testing.assert_allclose(got["losses"], ref, rtol=RTOL)


@pytest.mark.parametrize("cfg", [
    tmesh.MeshNetConfig("mesh-e2e", input_hw=128, in_channels=18,
                        convs_per_block=3),
    quickstart.CONFIG])
def test_tree_num_params_matches_the_reference(cfg):
    want = jtree_num_params(jax.eval_shape(
        lambda: jmesh.init(jax.random.PRNGKey(0),
                           jmesh.MeshNetConfig(**vars(cfg)))))
    assert tree_num_params(tmesh.global_params(cfg)) == want
    assert tree_num_params(tmesh.init(torch.Generator(), cfg)) == want


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_refuse_to_run_without_cuda(name):
    ex = load_example(name)
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        ex.main([])
