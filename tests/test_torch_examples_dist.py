"""The multi-rank examples of the port, `examples/serve_lm_torch.py` and
`examples/spatial_parallel_cnn_torch.py`, each on 8 gloo ranks at
`--device cpu` (`torch_dist_cases.py serve_lm_example 2,4 DIR` and
`spatial_example 2,2,2 DIR`), against the reference scripts themselves on
8 host devices (`jax_mesh_oracles.py serve_lm|spatial_example DIR`), all
four started at once.  The reference's params (`init` from
`PRNGKey(0)`, computed here and checked against each script's) are
carried over.

- serve_lm: the 2 x 12 generated ids equal the reference's.
- spatial_parallel_cnn: the steps run are 0-7, the fault at 8, the
  rollback to the step-5 checkpoint, 5-19, on every rank alike; the
  replayed steps 5-7 equal their first run bit for bit (the params, the
  momentum and the int8 error-feedback residuals roll back with the
  checkpoint), in the port and in the reference.  Against the reference
  the run is held within the int8 compression's reach, not at rtol 1e-5:
  the port sends each pod's own gradient over the pod axis in int8, the
  reference rounds the gradient already reduced over every axis (ROADMAP
  Queue 3, "Compression"), so from step 0 on each step's gradient
  differs by up to 2 u G an element, u = 2/254 of G, the largest
  element, itself at most the gradient norm (`test_torch_zero_dist.py`'s
  unit).  Step 0's loss comes before any update and is held at rtol
  1e-5.  The losses are held at rtol 1e-4 and the gradient norms at
  5e-3, the largest seen here being 3.0e-5 and 1.0e-3 (a step's
  rounding alone moves step 0's norm by 1.3e-4).  The final params are
  held at atol 1.5e-3, set between two readings: the largest difference
  of the sound run, 3.51e-4 (the error feedback carrying each rounding
  into the next step), and what a fault planted in the port gives on
  the leaf that moves least over the 20 steps (the second layer's BN
  beta, 1.155e-2 from its start): 5.88e-3 with its updates halved,
  1.155e-2 with them skipped.  A checkpoint restore that skips the int8
  residuals gives 2.84e-4 and is caught by the replay test instead.
"""
import os

import jax
import numpy as np
import pytest

import jax_mesh_oracles as oracles
import torch_dist_cases as cases
from repro.models.cnn import meshnet as jmesh
from repro_torch.configs import registry as treg
from repro_torch.models.lm import transformer as tT
from repro_torch.utils import tree_leaves

SERVE_DIMS, SPATIAL_DIMS = (2, 4), (2, 2, 2)
STEPS = list(range(8)) + list(range(5, 20))
RTOL = 1e-5
LOSS_RTOL, NORM_RTOL = 1e-4, 5e-3
FINAL_ATOL = 1.5e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("examples_dist"))
    sub = {k: os.path.join(d, k) for k in ("serve", "spatial", "ref")}
    for p in sub.values():
        os.makedirs(p)
    oracle = {w: oracles.popen(w, sub["ref"])
              for w in ("serve_lm", "spatial_example")}
    cfg, jp = oracles.lm_reference_params("qwen1.5-0.5b")
    arch = "qwen1.5-0.5b"
    tp = tT.params_from_jax(jax.tree.map(np.asarray, jp),
                            treg.get(arch, smoke=True))
    np.savez(os.path.join(sub["serve"], "inputs.npz"),
             **{f"{arch}/{i}": t.detach().numpy()
                for i, t in enumerate(tree_leaves(tp))})
    spatial_cfg = jmesh.MeshNetConfig("spatial-demo", input_hw=64,
                                      in_channels=4, convs_per_block=1,
                                      widths=(8, 16, 16))
    params = jmesh.init(jax.random.PRNGKey(0), spatial_cfg)
    np.savez(os.path.join(sub["spatial"], "inputs.npz"),
             **oracles._flat_meshnet(params, "param/"))
    started = {"serve": cases.start("serve_lm_example", SERVE_DIMS,
                                    sub["serve"]),
               "spatial": cases.start("spatial_example", SPATIAL_DIMS,
                                      sub["spatial"])}
    port = {"serve": cases.collect(started["serve"], SERVE_DIMS,
                                   sub["serve"]),
            "spatial": cases.collect(started["spatial"], SPATIAL_DIMS,
                                     sub["spatial"])}
    for p in oracle.values():
        oracles.wait(p)
    ref = {w: dict(np.load(os.path.join(sub["ref"], f"{w}.npz")))
           for w in oracle}
    return port, ref, {"serve": jax.tree.leaves(jp), "spatial": params}


def test_serve_lm_params_are_the_scripts(runs):
    _, ref, params = runs
    leaves = params["serve"]
    assert len(leaves) == sum(k.startswith("param/")
                              for k in ref["serve_lm"])
    for i, want in enumerate(leaves):
        np.testing.assert_array_equal(ref["serve_lm"][f"param/{i}"],
                                      np.asarray(want))


def test_serve_lm_ids_match_the_reference(runs):
    port, ref, _ = runs
    want = ref["serve_lm"]["ids"]
    assert want.shape == (2, 12)
    for r in port["serve"]:
        np.testing.assert_array_equal(r["ids"], want)


def test_spatial_params_are_the_scripts(runs):
    _, ref, params = runs
    got = cases.meshnet_params(ref["spatial_example"], "param/")
    for a, b in zip(got, params["spatial"]):
        for k in b:
            for pk in b[k]:
                np.testing.assert_array_equal(a[k][pk], np.asarray(b[k][pk]))


def test_spatial_steps_fault_and_ranks_agree(runs):
    port, ref, _ = runs
    r0 = port["spatial"][0]
    assert list(r0["steps"]) == STEPS and int(r0["end"]) == 20
    assert int(ref["spatial_example"]["end"]) == 20
    assert len(ref["spatial_example"]["losses"]) == len(STEPS)
    for r in port["spatial"][1:]:
        for k, v in r0.items():
            np.testing.assert_array_equal(r[k], v, err_msg=k)


@pytest.mark.parametrize("side", ["port", "reference"])
def test_spatial_replayed_steps_equal_the_uninterrupted_run(runs, side):
    """Steps 5-7 after the rollback against their first run: the state at
    the step-5 checkpoint, residuals included, comes back exactly."""
    port, ref, _ = runs
    got = port["spatial"][0] if side == "port" else ref["spatial_example"]
    for key in ("losses", "grad_norms"):
        first, again = got[key][5:8], got[key][8:11]
        np.testing.assert_array_equal(again, first, err_msg=key)


def test_spatial_losses_within_the_compression_bound(runs):
    port, ref = runs[0]["spatial"][0], runs[1]["spatial_example"]
    np.testing.assert_allclose(port["losses"][0], ref["losses"][0],
                               rtol=RTOL)
    np.testing.assert_allclose(port["losses"], ref["losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(port["grad_norms"], ref["grad_norms"],
                               rtol=NORM_RTOL)


def test_spatial_final_params_within_the_compression_bound(runs):
    port, ref = runs[0]["spatial"][0], runs[1]["spatial_example"]
    want = tree_leaves(cases.meshnet_params(ref, "final/"))
    assert len(want) == sum(k.startswith("final/") for k in port)
    for i, w in enumerate(want):
        np.testing.assert_allclose(port[f"final/{i}"], w, rtol=0,
                                   atol=FINAL_ATOL, err_msg=f"leaf {i}")
