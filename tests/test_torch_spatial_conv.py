"""The port's distributed spatial conv and pooling (`core/spatial_conv.py`)
on 2, 4 and 8 gloo CPU ranks against the JAX single-device oracle, and
the layers built on them (`models/cnn/layers.py`).

The cases are tests/dist_checks.py `check_conv`'s: four geometries, N over
data and H over model, with and without the §IV-A interior/boundary
split, forward and gradients of sum(y^2) (dw summed over the ranks by
`reduce_replicated_grads`), plus H over the product axis (data, model)
and max/avg pooling (4 and 8 ranks).  The oracle is `oracle_conv` (XLA's SAME conv) and
the reference's one-device `spatial_pool`, run here.  Tolerances are
dist_checks': 2e-5 forward, 3e-4 gradients, 1e-6 pooling.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

import torch_dist_cases as cases
from repro.core import spatial_conv as jsc
from repro.models.cnn import layers as jlayers
from repro.utils import same_pads
from repro_torch.core import spatial_conv as tsc

MESHES = [(1, 2), (2, 2), (2, 4)]
H_SH = {"batch_axes": ("data",), "h_axis": "model"}
PROD_SH = {"batch_axes": (), "h_axis": ("data", "model")}


def oracle_conv(x, w, s):
    kh, kw = w.shape[0], w.shape[1]
    return lax.conv_general_dilated(
        x, w, (s, s), (same_pads(kh, s), same_pads(kw, s)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


def oracle(geom, n=4):
    """(y, dx, dw) of sum(oracle_conv(x, w)^2) on the case's inputs."""
    x, w = cases.conv_inputs(geom, n)
    s = geom[1]
    y = oracle_conv(jnp.asarray(x), jnp.asarray(w), s)
    dx, dw = jax.grad(lambda a, b: jnp.sum(oracle_conv(a, b, s) ** 2),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    return np.asarray(y), np.asarray(dx), np.asarray(dw)


@pytest.fixture(scope="module", params=MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
def conv_run(request, tmp_path_factory):
    dims = request.param
    return dims, cases.run("conv", dims, str(tmp_path_factory.mktemp("c")))


def check_conv_case(outs, dims, key, geom, sh, n=4):
    y, dx, dw = oracle(geom, n)
    got_y = cases.stitch([o[f"{key}/y"] for o in outs], dims, **sh)
    got_dx = cases.stitch([o[f"{key}/dx"] for o in outs], dims, **sh)
    np.testing.assert_allclose(got_y, y, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_dx, dx, rtol=3e-4, atol=3e-4)
    for o in outs:        # the reduced dw is the same on every rank
        np.testing.assert_array_equal(o[f"{key}/dw"], outs[0][f"{key}/dw"])
    np.testing.assert_allclose(outs[0][f"{key}/dw"], dw, rtol=3e-4,
                               atol=3e-4)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("gi", range(len(cases.CONV_GEOMS)))
def test_conv_h_split_matches_oracle(conv_run, gi, overlap):
    dims, outs = conv_run
    check_conv_case(outs, dims, f"h{gi}_{overlap}", cases.CONV_GEOMS[gi],
                    H_SH)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("gi", range(len(cases.PRODUCT_GEOMS)))
def test_conv_product_axis_matches_oracle(conv_run, gi, overlap):
    dims, outs = conv_run
    check_conv_case(outs, dims, f"prod{gi}_{overlap}",
                    cases.PRODUCT_GEOMS[gi], PROD_SH)


@pytest.fixture(scope="module", params=[(2, 2), (2, 4)],
                ids=lambda d: f"{d[0]}x{d[1]}")
def pool_run(request, tmp_path_factory):
    dims = request.param
    return dims, cases.run("pool", dims, str(tmp_path_factory.mktemp("p")))


def check_pool_case(outs, dims, key, sh, kind, x, g):
    want, vjp = jax.vjp(lambda a: jsc.spatial_pool(
        a, window=(3, 3), strides=(2, 2), sharding=jsc.ConvSharding(),
        kind=kind), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    got = cases.stitch([o[f"{key}/y"] for o in outs], dims, **sh)
    got_dx = cases.stitch([o[f"{key}/dx"] for o in outs], dims, **sh)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_dx, np.asarray(want_dx), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("name,sh", [("h", H_SH), ("prod", PROD_SH)])
def test_pool_matches_oracle(pool_run, name, sh, kind):
    """Max pooling's global-edge halo is -inf, so edge windows match the
    one-device SAME pool."""
    dims, outs = pool_run
    x, g = cases.pool_input()
    check_pool_case(outs, dims, f"{name}_{kind}", sh, kind, x, g)


@pytest.mark.parametrize("name,sh", [("h", H_SH), ("prod", PROD_SH)])
def test_layers_pooling_matches_reference_layers(pool_run, name, sh):
    """`layers.global_avg_pool` (a local mean, then a sum over the spatial
    axes over their size) and `layers.max_pool` (fitted to the global
    extents) against the reference's one-device layers."""
    dims, outs = pool_run
    x, _ = cases.pool_input()
    want_gap = jlayers.global_avg_pool(jnp.asarray(x),
                                       sharding=jsc.ConvSharding())
    got = cases.stitch([o[f"{name}_gap/y"] for o in outs], dims,
                       batch_axes=sh["batch_axes"])
    np.testing.assert_allclose(got[:, 0, 0], np.asarray(want_gap),
                               rtol=1e-6, atol=1e-6)
    want_max = jlayers.max_pool(jnp.asarray(x), sharding=jsc.ConvSharding())
    got = cases.stitch([o[f"{name}_layer_max/y"] for o in outs], dims, **sh)
    np.testing.assert_allclose(got, np.asarray(want_max), rtol=1e-6,
                               atol=1e-6)


def test_dense_head_matches_reference():
    import torch
    from repro_torch.models.cnn import layers as tlayers
    rng = np.random.default_rng(9)
    p = {"w": rng.standard_normal((12, 5)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32)}
    x = rng.standard_normal((3, 12)).astype(np.float32)
    want = jlayers.dense_apply({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x))
    got = tlayers.dense_apply({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    init = tlayers.dense_init(torch.Generator().manual_seed(0), 256, 10)
    assert init["w"].shape == (256, 10) and not init["b"].any()
    assert abs(float(init["w"].std()) - (1 / 256) ** 0.5) < 0.01


def test_conv_calls_count_the_split():
    """12 stride-1 3x3 layers x 3, 6 stride-2 x 2 (lo 0, hi 1), 1 pred:
    mesh1k's 49 kernel calls a forward at model = 2."""
    assert tsc.conv_calls(512, 3, 1) == 3
    assert tsc.conv_calls(512, 3, 2) == 2
    assert tsc.conv_calls(8, 1, 1) == 1
    assert tsc.conv_calls(8, 3, 1, overlap=False) == 1
    assert tsc.conv_calls(3, 3, 1) == 3          # a 1-row interior
    assert tsc.conv_calls(8, 7, 4) == 1          # too small to split
    assert tsc.conv_calls(16, 7, 2) == 3


def test_spatial_conv_needs_the_mesh_and_one_stride():
    import torch
    x = torch.zeros(1, 8, 8, 4)
    w = torch.zeros(3, 3, 4, 4)
    with pytest.raises(ValueError, match="needs the mesh"):
        tsc.spatial_conv2d(x, w, sharding=tsc.ConvSharding(h_axis="model"))
    with pytest.raises(ValueError, match="one stride"):
        tsc.spatial_conv2d(x, w, strides=(1, 2), sharding=tsc.ConvSharding())


@pytest.mark.parametrize("sh", [
    {"batch_axes": ("data",), "h_axis": "model"},
    {"batch_axes": (), "h_axis": ("pod", "model"), "w_axis": "model"}],
    ids=["h", "hw_product"])
@pytest.mark.parametrize("geom", [(3, 1), (3, 2), (1, 1)],
                         ids=["3x3s1", "3x3s2", "1x1"])
def test_a_spatial_axis_of_one_rank_runs_one_dense_conv(monkeypatch, sh,
                                                        geom):
    """An H (or W) split over an axis of one rank has no neighbour: the
    conv is one dense SAME conv, with no halo and no §IV-A split, equal
    bit for bit to the unsharded conv, forward and gradients.  The
    sharding stays (so BN keeps its scope); only the conv drops the
    axis (`ConvSharding.without_unit_axes`)."""
    import torch
    from repro_torch.core import halo
    from repro_torch.launch.mesh import Mesh
    k, s = geom
    mesh = Mesh({"pod": 1, "data": 2, "model": 1}, rank=0)
    calls, conv = [], tsc._conv_nhwc

    def counted(*a, **kw):
        calls.append(1)
        return conv(*a, **kw)
    monkeypatch.setattr(tsc, "_conv_nhwc", counted)
    monkeypatch.setattr(halo, "HaloSchedule", None)      # never reached
    gen = torch.Generator().manual_seed(3)
    x0 = torch.randn((2, 8, 8, 4), generator=gen)
    w0 = torch.randn((k, k, 4, 5), generator=gen)
    out = {}
    for name, sharding in (("cut", tsc.ConvSharding(**sh)),
                           ("dense", tsc.ConvSharding())):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        calls.clear()
        y = tsc.spatial_conv2d(x, w, strides=(s, s), sharding=sharding,
                               mesh=mesh)
        n = len(calls)
        dx, dw = torch.autograd.grad(y.square().sum(), (x, w))
        out[name] = (y.detach(), dx, dw, n)
    assert out["cut"][3] == out["dense"][3] == 1
    for a, b in zip(out["cut"][:3], out["dense"][:3]):
        assert torch.equal(a, b)
    assert tsc.ConvSharding(**sh).without_unit_axes(mesh.shape) == \
        tsc.ConvSharding(batch_axes=sh["batch_axes"])
