"""The port's BN under a spatial split (`core/spatial_norm.py`) on gloo CPU
ranks, N over data and H over model, forward and the gradients of
sum(y * gy) (dgamma, dbeta summed over the ranks).

- 'global' against the reference's one-device BN of the whole tensor;
- 'spatial' against the one-device BN of each data shard's samples (the
  spatial shards of a sample pool their statistics);
- 'local' (per-shard statistics, not one-device BN) against the
  reference's own local BN under shard_map on as many host devices.
Tolerance 1e-4, dist_checks' for BN.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import jax_mesh_oracles
import torch_dist_cases as cases
from repro.core import spatial_conv as jsc
from repro.core import spatial_norm as jsn

MESHES = [(1, 2), (2, 2), (2, 4)]
SH = {"batch_axes": ("data",), "h_axis": "model"}
TOL = 1e-4


@pytest.fixture(scope="module")
def bn_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("bn")
    jax_mesh_oracles.run("bn_local", str(d))
    local = dict(np.load(d / "bn_local.npz"))
    runs = {dims: cases.run("bn", dims, str(tmp_path_factory.mktemp("b")))
            for dims in MESHES}
    return runs, local


def one_device(x, g, b, gy):
    """(y, dx, dgamma, dbeta) of the reference's one-device BN."""
    y, vjp = jax.vjp(lambda x, g, b: jsn.batch_norm(
        x, g, b, sharding=jsc.ConvSharding(), scope="local"),
        *(jnp.asarray(a) for a in (x, g, b)))
    return (np.asarray(y),) + tuple(np.asarray(a)
                                    for a in vjp(jnp.asarray(gy)))


def check(outs, dims, scope, want):
    y, dx, dg, db = want
    got_y = cases.stitch([o[f"{scope}/y"] for o in outs], dims, **SH)
    got_dx = cases.stitch([o[f"{scope}/dx"] for o in outs], dims, **SH)
    np.testing.assert_allclose(got_y, y, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_dx, dx, rtol=TOL, atol=TOL)
    for o in outs:
        np.testing.assert_array_equal(o[f"{scope}/dgamma"],
                                      outs[0][f"{scope}/dgamma"])
    np.testing.assert_allclose(outs[0][f"{scope}/dgamma"], dg, rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(outs[0][f"{scope}/dbeta"], db, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
def test_global_bn_matches_one_device(bn_runs, dims):
    x, g, b, gy = cases.bn_inputs()
    check(bn_runs[0][dims], dims, "global", one_device(x, g, b, gy))


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
def test_spatial_bn_matches_one_device_per_data_shard(bn_runs, dims):
    x, g, b, gy = cases.bn_inputs()
    parts = [one_device(xs, g, b, gs) for xs, gs in
             zip(np.split(x, dims[0]), np.split(gy, dims[0]))]
    want = (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
            sum(p[2] for p in parts), sum(p[3] for p in parts))
    check(bn_runs[0][dims], dims, "spatial", want)


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
def test_local_bn_matches_jax_shard_map(bn_runs, dims):
    runs, local = bn_runs
    key = f"{dims[0]}x{dims[1]}"
    want = tuple(local[f"{key}/{n}"] for n in ("y", "dx", "dgamma",
                                               "dbeta"))
    check(runs[dims], dims, "local", want)
    # per-shard statistics are not one-device BN
    x, g, b, gy = cases.bn_inputs()
    assert np.abs(want[0] - one_device(x, g, b, gy)[0]).max() > 1e-2
