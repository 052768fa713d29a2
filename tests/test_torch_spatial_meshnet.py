"""The slice as a whole: a small meshnet (input 64, widths (8, 16), two
convs a block, 4 channels, local BN) under the reference's uniform plan,
N over data and H over model, on data=1 x model=2 and data=2 x model=2
gloo CPU ranks, against the JAX reference's `meshnet.loss_fn` under the
same plan on as many host devices (`jax_mesh_oracles.py`), with the same
params (carried across by `MeshNet.params_from_jax`) and batches.

Tolerances: loss rtol 2e-5 (dist_checks'), grads rtol 3e-4 / atol 3e-5
(dist_checks' for meshnet grads); the 3-step SGD trajectory: losses rtol
1e-4 and params rtol 3e-4 / atol 3e-5, the grads' tolerance carried
through three steps.
"""
import jax
import numpy as np
import pytest

import jax_mesh_oracles
import torch_dist_cases as cases
from repro.models.cnn import meshnet as jmesh

MESHES = [(1, 2), (2, 2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mn")
    cfg = jmesh.MeshNetConfig("t", **cases.MESHNET)
    params = jmesh.init(jax.random.PRNGKey(0), cfg)
    np.savez(d / "inputs.npz", **{
        f"{i}.{k}.{pk}": np.asarray(v) for i, layer in enumerate(params)
        for k, sub in layer.items() for pk, v in sub.items()})
    jax_mesh_oracles.run("meshnet", str(d))
    want = dict(np.load(d / "meshnet.npz"))
    got = {}
    for dims in MESHES:
        sub = tmp_path_factory.mktemp("r")
        (sub / "inputs.npz").write_bytes((d / "inputs.npz").read_bytes())
        got[dims] = cases.run("meshnet", dims, str(sub))
    sub = tmp_path_factory.mktemp("t")
    (sub / "inputs.npz").write_bytes((d / "inputs.npz").read_bytes())
    got["trajectory"] = cases.run("trajectory", (1, 2), str(sub))
    return want, got


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
def test_meshnet_loss_and_grads_match_jax_mesh(runs, dims):
    want, got = runs
    key = f"{dims[0]}x{dims[1]}"
    outs = got[dims]
    n_leaves = sum(k[len(key) + 5:].isdigit() for k in want
                   if k.startswith(f"{key}/grad"))
    assert n_leaves == 4 * 3 + 1          # w, gamma, beta a body layer
    for o in outs:                           # one loss and grad everywhere
        np.testing.assert_array_equal(o["loss"], outs[0]["loss"])
        for i in range(n_leaves):
            np.testing.assert_array_equal(o[f"grad{i}"], outs[0][f"grad{i}"])
    np.testing.assert_allclose(float(outs[0]["loss"]),
                               float(want[f"{key}/loss"]), rtol=2e-5)
    for i in range(n_leaves):
        np.testing.assert_allclose(outs[0][f"grad{i}"],
                                   want[f"{key}/grad{i}"], rtol=3e-4,
                                   atol=3e-5, err_msg=f"leaf {i}")


def test_meshnet_three_step_sgd_trajectory_matches_jax_mesh(runs):
    want, got = runs
    outs = got["trajectory"]
    for o in outs:                           # params stay equal on the ranks
        for k in o:
            np.testing.assert_array_equal(o[k], outs[0][k])
    np.testing.assert_allclose(outs[0]["losses"], want["1x2/losses"],
                               rtol=1e-4)
    np.testing.assert_allclose(outs[0]["grad_norms"], want["1x2/grad_norms"],
                               rtol=1e-4)
    i = 0
    while f"param{i}" in outs[0]:
        np.testing.assert_allclose(outs[0][f"param{i}"],
                                   want[f"1x2/param{i}"], rtol=3e-4,
                                   atol=3e-5, err_msg=f"leaf {i}")
        i += 1
    assert i == 4 * 3 + 1
