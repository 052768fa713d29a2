"""The port's channel/filter-parallel conv (`core/channel_conv.py`) on 2
and 4 gloo CPU ranks against the JAX reference's `cf_conv2d` on as many
host devices (`jax_mesh_oracles.py cf`, the local convs on XLA) and the
single-device oracle (the SAME conv in float64).

Cases (`torch_dist_cases.CF_CONFIGS`, two geometries each, stride 1 and
2): 'channel' mode at chunks 1 and 2 and 'filter' mode, CF over model on
1 x 2 and 1 x 4; CF over model with N over data on 2 x 2 (channel at
chunks 2, filter); CF over model composed with H over data on 2 x 2
(both modes; the local conv goes through the halo exchange and the §IV-A
split).  Forward y, dx and the mesh-summed dw of sum(y * gy), each within
1e-5 of the oracle's largest magnitude (f32 sums in other orders).
`cf_batch_norm` at the three scopes and `cf_bias_add`
(`CF_BN_CONFIGS`): y, dx, dgamma and dbeta within 1e-5 of the
reference's largest magnitude.

The weight stays globally addressed and is sliced per rank, so each
rank's dw is zero outside its block: the sum over the mesh
(`reduce_replicated_grads`) is what puts dL/dw together, checked here
by holding that sum to the oracle's full dw.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax_mesh_oracles
import torch_dist_cases as cases
from repro_torch.utils import same_pads

TOL = 1e-5
MESHES = [(1, 2), (1, 4), (2, 2)]


@pytest.fixture(scope="module")
def cf_runs(tmp_path_factory):
    """The JAX oracle and the gloo ranks of every mesh, all at once."""
    d = tmp_path_factory.mktemp("cf")
    procs = {}
    for dims in MESHES:
        sub = d / f"r{dims[0]}x{dims[1]}"
        sub.mkdir()
        procs[dims] = (sub, cases.start("cf", dims, str(sub)))
    jax_mesh_oracles.run("cf", str(d))
    got = {dims: cases.collect(p, dims, str(sub))
           for dims, (sub, p) in procs.items()}
    return dict(np.load(d / "cf.npz")), got


def oracle(geom) -> dict:
    """y, dx and dw of sum(y * gy) of the SAME conv in float64 (NCHW
    `F.conv2d` on explicitly padded views)."""
    k, s = geom[0], geom[1]
    x, w, gy = (torch.from_numpy(a).double() for a in cases.cf_inputs(geom))
    x.requires_grad_()
    w.requires_grad_()
    p = same_pads(k, s)
    y = F.conv2d(F.pad(x, (0, 0) + p + p).permute(0, 3, 1, 2),
                 w.permute(3, 2, 0, 1), stride=s).permute(0, 2, 3, 1)
    (y * gy).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dw": w.grad.numpy()}


CONV = [(c, gi) for c in cases.CF_CONFIGS for gi in range(len(cases.CF_GEOMS))]


@pytest.mark.parametrize("config,gi", CONV,
                         ids=[f"{c[0]}-{gi}" for c, gi in CONV])
def test_cf_conv_matches_reference_and_oracle(cf_runs, config, gi):
    want, got = cf_runs
    key, dims, kw, mode, chunks = config
    outs = got[dims]
    spec = cases.cf_spec(kw)
    exact = oracle(cases.CF_GEOMS[gi])
    mine = {n: cases.stitch([o[f"{key}/{gi}/{n}"] for o in outs], dims,
                            **spec) for n in ("y", "dx")}
    for o in outs:            # the summed dw is the same on every rank
        np.testing.assert_array_equal(o[f"{key}/{gi}/dw"],
                                      outs[0][f"{key}/{gi}/dw"])
    mine["dw"] = outs[0][f"{key}/{gi}/dw"]
    for n in ("y", "dx", "dw"):
        scale = np.abs(exact[n]).max()
        assert np.abs(mine[n] - exact[n]).max() <= TOL * scale, n
        assert np.abs(mine[n] - want[f"{key}/{gi}/{n}"]).max() \
            <= TOL * scale, n


BN = [(c, scope) for c in cases.CF_BN_CONFIGS
      for scope in cases.BN_SCOPES + ("bias",)]


@pytest.mark.parametrize("config,scope", BN,
                         ids=[f"{c[0]}-{s}" for c, s in BN])
def test_cf_batch_norm_and_bias_match_reference(cf_runs, config, scope):
    want, got = cf_runs
    key, dims, kw = config
    outs = got[dims]
    spec = cases.cf_spec(kw)
    for n in ("y", "dx", "dgamma", "dbeta"):
        k = f"bn_{key}_{scope}/{n}"
        mine = cases.stitch([o[k] for o in outs], dims, **spec) \
            if n in ("y", "dx") else outs[0][k]
        ref = want[k]
        scale = max(np.abs(ref).max(), 1.0 if n == "dgamma" else 0.0)
        assert np.abs(mine - ref).max() <= TOL * scale, (k, scale)


def test_cf_sharding_surface():
    """CFSharding's placement, fit and channel check, and the refusals of
    a CF axis that also shards a spatial dim and of channels that do not
    divide."""
    from repro_torch.core import channel_conv as cc
    from repro_torch.launch.mesh import Mesh
    sh = cc.CFSharding(batch_axes=("data",), cf_axis="model", h_axis="pod")
    assert sh.x_spec() == (("data",), "pod", None, "model")
    shape = {"pod": 2, "data": 2, "model": 4}
    assert sh.fit(8, 8, 3, 1, shape) == sh
    assert sh.fit(4, 8, 3, 1, shape).h_axis is None
    assert sh.fits_channels(8, 12, shape)
    assert not sh.fits_channels(8, 6, shape)
    with pytest.raises(ValueError, match="different mesh axes"):
        cc.CFSharding(cf_axis="model", h_axis="model")
    with pytest.raises(ValueError, match="mode"):
        cc.CFSharding(cf_axis="model", mode="rows")
    mesh = Mesh({"data": 1, "model": 4}, rank=0)
    with pytest.raises(ValueError, match="not divisible"):
        cc.cf_conv2d(torch.zeros(1, 4, 4, 2), torch.zeros(3, 3, 6, 4),
                     sharding=cc.CFSharding(cf_axis="model"), mesh=mesh)
    assert cc.chunks_decision() == (1, "eta unmeasured")
    assert cc.default_channel_chunks() == 1
