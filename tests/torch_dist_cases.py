"""Rank-side cases of the port's multi-rank tests, on gloo CPU ranks.

    PYTHONPATH=src python tests/torch_dist_cases.py <case> <data>,<model> DIR

spawns one process per rank of a ("data", "model") mesh with
torch.multiprocessing (spawn).  Each joins a gloo group through a
FileStore in DIR, builds the port's `Mesh`, runs `CASES[case]` on its
block of the case's global inputs (made from numpy seeds here, or read
from DIR/inputs.npz where the test wrote them) and writes what the case
returns to DIR/rank<r>.npz.  A rank that raises makes the run exit
non-zero.  The tests (`tests/test_torch_*.py`) call `run` and compare the
blocks, stitched with `stitch`, against the JAX reference in their own
process.  This module imports torch and numpy only, never jax.

The block layout is written here independently of `launch/mesh.py`:
ranks major-to-minor over (data, model), a product axis linearized
major-to-minor in tuple order.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("data", "model")

# (K, s, H, W, C, F): tests/dist_checks.py check_conv's geometries
CONV_GEOMS = [(3, 1, 16, 12, 5, 7), (7, 2, 32, 16, 3, 8),
              (1, 1, 16, 8, 4, 4), (3, 2, 16, 16, 6, 6)]
# H over the product axis (data, model): heights that 8 shards still fit
PRODUCT_GEOMS = [(3, 1, 32, 8, 4, 5), (3, 2, 32, 8, 3, 6)]
# check_spatial2d's: W only, and H x W, (K, s) in {(3,1), (3,2), (7,2)}
SPATIAL2D = {"w": {"batch_axes": ("model",), "h_axis": None,
                   "w_axis": "data"},
             "hw": {"batch_axes": (), "h_axis": "model", "w_axis": "data"}}
SPATIAL2D_KS = [(3, 1), (3, 2), (7, 2)]
# halo cases: (name, axis, dim, lo, hi, edge) on a (2, 8, 8, 3) tensor
HALO_CASES = [("h_1_1", "model", 1, 1, 1, 0.0),
              ("h_2_1_neginf", "model", 1, 2, 1, float("-inf")),
              ("w_0_1", "model", 2, 0, 1, 0.0),
              ("data_h_1_1", "data", 1, 1, 1, 0.0),
              ("prod_h_1_2", ("data", "model"), 1, 1, 2, 0.0),
              ("prod_w_2_0_neginf", ("data", "model"), 2, 2, 0,
               float("-inf"))]
BN_SCOPES = ("local", "spatial", "global")
MESHNET = {"input_hw": 64, "in_channels": 4, "convs_per_block": 2,
           "widths": (8, 16)}
# §III-D CF conv: (K, s, H, W, C, F), C and F divisible by 4
CF_GEOMS = [(3, 1, 8, 8, 8, 12), (3, 2, 8, 8, 8, 4)]
# (key, mesh dims, CFSharding kwargs but mode, mode, channel chunks)
CF_CONFIGS = [
    ("m2_channel_c1", (1, 2), {"cf_axis": "model"}, "channel", 1),
    ("m2_channel_c2", (1, 2), {"cf_axis": "model"}, "channel", 2),
    ("m2_filter", (1, 2), {"cf_axis": "model"}, "filter", 1),
    ("m4_channel_c1", (1, 4), {"cf_axis": "model"}, "channel", 1),
    ("m4_channel_c2", (1, 4), {"cf_axis": "model"}, "channel", 2),
    ("m4_filter", (1, 4), {"cf_axis": "model"}, "filter", 1),
    ("nd_channel_c2", (2, 2), {"batch_axes": ("data",), "cf_axis": "model"},
     "channel", 2),
    ("nd_filter", (2, 2), {"batch_axes": ("data",), "cf_axis": "model"},
     "filter", 1),
    ("hd_channel", (2, 2), {"cf_axis": "model", "h_axis": "data"},
     "channel", 1),
    ("hd_filter", (2, 2), {"cf_axis": "model", "h_axis": "data"},
     "filter", 1),
]
# cf_batch_norm / cf_bias_add: (key, mesh dims, CFSharding kwargs)
CF_BN_CONFIGS = [
    ("m4", (1, 4), {"cf_axis": "model"}),
    ("nd", (2, 2), {"batch_axes": ("data",), "cf_axis": "model"}),
    ("hd", (2, 2), {"batch_axes": (), "cf_axis": "model", "h_axis": "data"}),
]
# the reshard's layouts, one per kind of sharding: the mesh axes of N, H,
# W and C; on 2 x 2 with product axes (W's against the mesh order)
RESHARD_KINDS = {
    (1, 2): {"N": (("model",), (), (), ()), "H": ((), ("model",), (), ()),
             "W": ((), (), ("model",), ()), "CF": ((), (), (), ("model",)),
             "R": ((), (), (), ())},
    (2, 2): {"N": (("data", "model"), (), (), ()),
             "H": (("data",), ("model",), (), ()),
             "W": ((), (), ("model", "data"), ()),
             "CF": ((), ("data",), (), ("model",)),
             "R": ((), (), (), ())},
}


# ------------------------------------------------------------- layout --

def axes_of(axis) -> tuple:
    if axis is None:
        return ()
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def coords(rank: int, dims: tuple) -> dict:
    return {"data": rank // dims[1], "model": rank % dims[1]}


def shard(rank: int, dims: tuple, axis) -> tuple[int, int]:
    """(index, count) of rank's shard along a (product) axis."""
    c, size = coords(rank, dims), dict(zip(AXES, dims))
    i, n = 0, 1
    for a in axes_of(axis):
        i, n = i * size[a] + c[a], n * size[a]
    return i, n


def block(a: np.ndarray, rank: int, dims: tuple, batch_axes=(),
          h_axis=None, w_axis=None, c_axis=None) -> np.ndarray:
    """rank's block of global NHWC `a`."""
    for dim, axis in enumerate((batch_axes, h_axis, w_axis, c_axis)):
        i, n = shard(rank, dims, axis)
        m = a.shape[dim] // n
        a = a[(slice(None),) * dim + (slice(i * m, (i + 1) * m),)]
    return np.ascontiguousarray(a)


def stitch(blocks: list, dims: tuple, batch_axes=(), h_axis=None,
           w_axis=None, c_axis=None) -> np.ndarray:
    """The global array from every rank's block (ranks replicating a block
    must agree)."""
    axes = (batch_axes, h_axis, w_axis, c_axis)
    b0 = blocks[0]
    ns = [shard(0, dims, a)[1] for a in axes]
    out = np.full(tuple(e * n for e, n in zip(b0.shape, ns)) + b0.shape[4:],
                  np.nan, b0.dtype)
    for r, b in enumerate(blocks):
        s = tuple(slice(i * e, (i + 1) * e) for (i, _), e in
                  zip((shard(r, dims, a) for a in axes), b.shape))
        prev = out[s]
        if not np.isnan(prev).all():
            np.testing.assert_array_equal(prev, b)
        out[s] = b
    return out


def conv_inputs(geom, n=4, seed=0):
    k, s, h, w, c, f = geom
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((k, k, c, f)) * 0.1).astype(np.float32)
    return x, wt


def halo_input():
    return np.random.default_rng(3).standard_normal((2, 8, 8, 3)) \
        .astype(np.float32)


def halo_cotangent(name: str, rank: int, shape) -> np.ndarray:
    seed = 100 + 10 * rank + [c[0] for c in HALO_CASES].index(name)
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def bn_inputs(seed=4):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 16, 8, 6)) * 3 + 1).astype(np.float32)
    g = rng.standard_normal(6).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    return x, g, b, gy


def pool_input(n=4, h=32, w=16, c=5, seed=5):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, h, w, c)).astype(np.float32), \
        rng.standard_normal((n, h // 2, w // 2, c)).astype(np.float32)


def cf_inputs(geom, n=2, seed=7):
    k, s, h, w, c, f = geom
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((k, k, c, f)) * 0.3).astype(np.float32)
    gy = rng.standard_normal((n, h // s, w // s, f)).astype(np.float32)
    return x, wt, gy


def cf_bn_inputs(seed=8):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 8, 8, 8)) * 2 + 0.5).astype(np.float32)
    g = rng.standard_normal(8).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    return x, g, b, gy


def cf_spec(kw: dict) -> dict:
    """CFSharding kwargs as `block`'s axis arguments."""
    return {"batch_axes": tuple(kw.get("batch_axes", ())),
            "h_axis": kw.get("h_axis"), "w_axis": kw.get("w_axis"),
            "c_axis": kw["cf_axis"]}


def reshard_input(seed=9):
    return np.random.default_rng(seed).standard_normal((4, 8, 8, 4))


# -------------------------------------------------------------- cases --

def _t(a, grad=False):
    import torch
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def case_halo(mesh, d):
    import torch
    from repro_torch.core import halo
    r, dims = mesh.rank, tuple(mesh.shape.values())
    out = {"index_model": mesh.index("model"),
           "index_prod": mesh.index(("data", "model"))}
    x_g = halo_input()
    for name, axis, dim, lo, hi, edge in HALO_CASES:
        kw = {"h_axis": axis} if dim == 1 else {"w_axis": axis}
        x = _t(block(x_g, r, dims, **kw), grad=True)
        ext = halo.halo_exchange(x, dim, lo, hi, axis, mesh, edge)
        g = _t(halo_cotangent(name, r, tuple(ext.shape)))
        (ext * g).sum().backward()
        out[f"{name}/ext"] = ext.detach().numpy()
        out[f"{name}/dx"] = x.grad.numpy()
    for axis in ("model", ("data", "model")):
        key = "prod" if isinstance(axis, tuple) else "model"
        for reverse in (False, True):
            x = _t(np.full((2, 3), float(r), np.float32), grad=True)
            y = halo.ring_shift(x, axis, mesh, reverse=reverse)
            (y * (1.0 + r)).sum().backward()
            out[f"ring_{key}_{reverse}/y"] = y.detach().numpy()
            out[f"ring_{key}_{reverse}/dx"] = x.grad.numpy()
    torch.distributed.barrier()
    return out


def _conv_case(mesh, out, key, geom, sh, overlap, n=4):
    from repro_torch.core import spatial_conv as sc
    from repro_torch.train.train_loop import reduce_replicated_grads
    r, dims = mesh.rank, tuple(mesh.shape.values())
    k, s = geom[0], geom[1]
    x_g, w_g = conv_inputs(geom, n)
    x = _t(block(x_g, r, dims, sh.batch_axes, sh.h_axis, sh.w_axis),
           grad=True)
    w = _t(w_g, grad=True)
    y = sc.spatial_conv2d(x, w, strides=(s, s), sharding=sh, mesh=mesh,
                          overlap=overlap)
    (y ** 2).sum().backward()
    out[f"{key}/y"] = y.detach().numpy()
    out[f"{key}/dx"] = x.grad.numpy()
    out[f"{key}/dw"] = reduce_replicated_grads([w.grad], mesh)[0].numpy()


def case_conv(mesh, d):
    from repro_torch.core.spatial_conv import ConvSharding
    out = {}
    sh = ConvSharding(batch_axes=("data",), h_axis="model")
    for gi, geom in enumerate(CONV_GEOMS):
        for overlap in (False, True):
            _conv_case(mesh, out, f"h{gi}_{overlap}", geom, sh, overlap)
    shp = ConvSharding(batch_axes=(), h_axis=("data", "model"))
    for gi, geom in enumerate(PRODUCT_GEOMS):
        for overlap in (False, True):
            _conv_case(mesh, out, f"prod{gi}_{overlap}", geom, shp, overlap)
    return out


def _pool_case(mesh, out, key, sh, kind, x_g, g_g):
    from repro_torch.core import spatial_conv as sc
    r, dims = mesh.rank, tuple(mesh.shape.values())
    kw = dict(batch_axes=sh.batch_axes, h_axis=sh.h_axis, w_axis=sh.w_axis)
    x = _t(block(x_g, r, dims, **kw), grad=True)
    y = sc.spatial_pool(x, window=(3, 3), strides=(2, 2), sharding=sh,
                        mesh=mesh, kind=kind)
    (y * _t(block(g_g, r, dims, **kw))).sum().backward()
    out[f"{key}/y"] = y.detach().numpy()
    out[f"{key}/dx"] = x.grad.numpy()


def case_pool(mesh, d):
    from repro_torch.core.spatial_conv import ConvSharding
    from repro_torch.models.cnn import layers
    r, dims = mesh.rank, tuple(mesh.shape.values())
    out = {}
    x_g, g_g = pool_input()
    for name, sh in (("h", ConvSharding(batch_axes=("data",),
                                        h_axis="model")),
                     ("prod", ConvSharding(h_axis=("data", "model")))):
        for kind in ("max", "avg"):
            _pool_case(mesh, out, f"{name}_{kind}", sh, kind, x_g, g_g)
        x = _t(block(x_g, r, dims, sh.batch_axes, sh.h_axis))
        gap = layers.global_avg_pool(x, sharding=sh, mesh=mesh)
        out[f"{name}_gap/y"] = gap[:, None, None, :].numpy()
        out[f"{name}_layer_max/y"] = layers.max_pool(
            x, sharding=sh, mesh=mesh).numpy()
    return out


def case_spatial2d(mesh, d):
    from repro_torch.core.spatial_conv import ConvSharding
    out = {}
    for name, kw in SPATIAL2D.items():
        sh = ConvSharding(**kw)
        for k, s in SPATIAL2D_KS:
            geom = (k, s, 16, 16, 3, 5)
            for overlap in (False, True):
                _conv_case(mesh, out, f"{name}_{k}{s}_{overlap}", geom, sh,
                           overlap, n=2)
        x_g, g_g = pool_input(n=2, h=16, w=16, c=3)
        for kind in ("max", "avg"):
            _pool_case(mesh, out, f"{name}_pool_{kind}", sh, kind, x_g, g_g)
    return out


def case_bn(mesh, d):
    from repro_torch.core.spatial_conv import ConvSharding
    from repro_torch.core.spatial_norm import batch_norm
    from repro_torch.train.train_loop import reduce_replicated_grads
    r, dims = mesh.rank, tuple(mesh.shape.values())
    sh = ConvSharding(batch_axes=("data",), h_axis="model")
    x_g, g_g, b_g, gy_g = bn_inputs()
    out = {}
    for scope in BN_SCOPES:
        x = _t(block(x_g, r, dims, ("data",), "model"), grad=True)
        g, b = _t(g_g, grad=True), _t(b_g, grad=True)
        y = batch_norm(x, g, b, sharding=sh, mesh=mesh, scope=scope)
        (y * _t(block(gy_g, r, dims, ("data",), "model"))).sum().backward()
        dg, db = reduce_replicated_grads([g.grad, b.grad], mesh)
        out.update({f"{scope}/y": y.detach().numpy(),
                    f"{scope}/dx": x.grad.numpy(),
                    f"{scope}/dgamma": dg.numpy(),
                    f"{scope}/dbeta": db.numpy()})
    return out


def meshnet_setup(mesh, d):
    """The small meshnet with the test's (the reference's) params, and this
    rank's block of `batch` global samples of step `step`."""
    import torch
    from repro_torch.core.spatial_conv import ConvSharding
    from repro_torch.data import pipeline
    from repro_torch.models.cnn import meshnet
    cfg = meshnet.MeshNetConfig("t", **MESHNET)
    model = meshnet.MeshNet(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    flat = np.load(os.path.join(d, "inputs.npz"))
    n_layers = len(model.params())
    tree = [{k: {pk: flat[f"{i}.{k}.{pk}"] for pk in sub}
             for k, sub in layer.items()}
            for i, layer in zip(range(n_layers), model.params())]
    model.params_from_jax(tree)
    plan = ConvSharding(batch_axes=("data",), h_axis="model")

    def batch(step, n):
        b = pipeline.synthetic_mesh_batch(step, n, cfg.input_hw,
                                          cfg.in_channels,
                                          out_hw=cfg.out_hw)
        return pipeline.to_device(pipeline.shard_batch(b, mesh, plan),
                                  torch.device("cpu"))
    return cfg, model, plan, batch


def case_meshnet(mesh, d):
    import torch
    from repro_torch.models.cnn import meshnet
    from repro_torch.train.train_loop import reduce_replicated_grads
    from repro_torch.utils import tree_leaves
    cfg, model, plan, batch = meshnet_setup(mesh, d)
    n = 2 * mesh.shape["data"]
    params = model.params()
    loss = meshnet.loss_fn(params, batch(0, n), cfg, plan, mesh)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    grads = reduce_replicated_grads(list(grads), mesh)
    out = {"loss": mesh.all_reduce(loss.detach(), mesh.axis_names).numpy()}
    out.update({f"grad{i}": g.numpy() for i, g in enumerate(grads)})
    return out


def case_trajectory(mesh, d):
    import functools
    from repro_torch.models.cnn import meshnet
    from repro_torch.optim import optimizer as opt_lib
    from repro_torch.train import train_loop
    from repro_torch.utils import FP32, tree_leaves
    cfg, model, plan, batch = meshnet_setup(mesh, d)
    n, lr, steps = 2 * mesh.shape["data"], 0.1, 3
    opt = opt_lib.sgd(opt_lib.warmup_cosine(lr, 1, steps), momentum=0.9)
    step = train_loop.make_train_step(
        functools.partial(meshnet.loss_fn, cfg=cfg, plan=plan, mesh=mesh),
        opt, train_loop.TrainStepConfig(precision=FP32), mesh=mesh)
    params = model.params()
    state = opt.init(params)
    losses, norms = [], []
    for s in range(steps):
        params, state, m = step(params, state, batch(s, n))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out = {"losses": np.array(losses), "grad_norms": np.array(norms)}
    out.update({f"param{i}": p.detach().numpy()
                for i, p in enumerate(tree_leaves(params))})
    return out


def case_cf(mesh, d):
    """Every CF_CONFIGS row on this mesh: each rank's blocks of y and dx
    and the mesh-summed dw of sum(y * gy), for each CF_GEOMS geometry;
    then cf_batch_norm at each scope and cf_bias_add."""
    import torch
    from repro_torch.core import channel_conv as cc
    from repro_torch.train.train_loop import reduce_replicated_grads
    r, dims = mesh.rank, tuple(mesh.shape.values())
    out = {}
    for key, cdims, kw, mode, chunks in CF_CONFIGS:
        if cdims != dims:
            continue
        sh = cc.CFSharding(mode=mode, **kw)
        spec = cf_spec(kw)
        for gi, geom in enumerate(CF_GEOMS):
            s = geom[1]
            x_g, w_g, gy_g = cf_inputs(geom)
            x = _t(block(x_g, r, dims, **spec), grad=True)
            w = _t(w_g, grad=True)
            y = cc.cf_conv2d(x, w, strides=(s, s), sharding=sh, mesh=mesh,
                             channel_chunks=chunks)
            (y * _t(block(gy_g, r, dims, **spec))).sum().backward()
            out[f"{key}/{gi}/y"] = y.detach().numpy()
            out[f"{key}/{gi}/dx"] = x.grad.numpy()
            out[f"{key}/{gi}/dw"] = reduce_replicated_grads(
                [w.grad], mesh)[0].numpy()
    x_g, g_g, b_g, gy_g = cf_bn_inputs()
    for key, cdims, kw in CF_BN_CONFIGS:
        if cdims != dims:
            continue
        sh = cc.CFSharding(**kw)
        spec = cf_spec(kw)
        for scope in BN_SCOPES + ("bias",):
            x = _t(block(x_g, r, dims, **spec), grad=True)
            g, b = _t(g_g, grad=True), _t(b_g, grad=True)
            if scope == "bias":
                y = cc.cf_bias_add(x, b, sharding=sh, mesh=mesh)
                g.grad = torch.zeros_like(g)
            else:
                y = cc.cf_batch_norm(x, g, b, sharding=sh, mesh=mesh,
                                     scope=scope)
            (y * _t(block(gy_g, r, dims, **spec))).sum().backward()
            dg, db = reduce_replicated_grads([g.grad, b.grad], mesh)
            out.update({f"bn_{key}_{scope}/y": y.detach().numpy(),
                        f"bn_{key}_{scope}/dx": x.grad.numpy(),
                        f"bn_{key}_{scope}/dgamma": dg.numpy(),
                        f"bn_{key}_{scope}/dbeta": db.numpy()})
    return out


def case_reshard(mesh, d):
    """Every ordered pair of RESHARD_KINDS: this rank's block after the
    reshard of its block of `reshard_input` (float64), the bytes it sent
    and the bytes `reshard_bytes` predicts, and the two sides of the
    adjoint identity <R v, u> = <v, R^T u> summed over the ranks, v and u
    independent random blocks on every rank (replicas too)."""
    import torch
    from repro_torch.core import collectives as co
    r, dims = mesh.rank, tuple(mesh.shape.values())
    kinds = RESHARD_KINDS[dims]
    x_g = reshard_input()
    out = {}
    for a, src in kinds.items():
        for b, dst in kinds.items():
            x = _t(block(x_g, r, dims, *src))
            co.reset_sent()
            y = co.reshard(x, src, dst, mesh)
            out[f"{a}_{b}/y"] = y.numpy()
            out[f"{a}_{b}/sent"] = np.array(sum(co.sent.values()))
            out[f"{a}_{b}/want_sent"] = np.array(co.reshard_bytes(
                x_g.shape, src, dst, dict(mesh.shape), 8))
            rng = np.random.default_rng(1000 + r)
            v = _t(rng.standard_normal(x.shape), grad=True)
            u = torch.from_numpy(rng.standard_normal(tuple(y.shape)))
            ry = co.reshard(v, src, dst, mesh)
            (g,) = torch.autograd.grad(ry, v, u)
            sides = torch.stack([(ry * u).sum(), (v * g).sum()]).detach()
            out[f"{a}_{b}/adjoint"] = mesh.all_reduce(
                sides, mesh.axis_names).numpy()
    return out


def plan_cases(d) -> list[dict]:
    with open(os.path.join(d, "plans.json")) as f:
        return json.load(f)


def case_plan(mesh, d):
    """Each case of DIR/plans.json on this mesh: the meshnet of its
    config with its params (DIR/inputs.npz, `<case>/<i>.<k>.<pk>`) under
    its plan (a repro/plan@1 record lowered by plan_from_spec, or the
    uniform sharding where it has none), on global batch 0 of its batch
    size: the loss summed over the ranks and every param's gradient
    summed over the mesh."""
    import torch
    from repro_torch.core import plan as plan_lib
    from repro_torch.core.spatial_conv import ConvSharding
    from repro_torch.data import pipeline
    from repro_torch.models.cnn import meshnet
    from repro_torch.train.train_loop import reduce_replicated_grads
    from repro_torch.utils import tree_leaves
    dims = tuple(mesh.shape.values())
    flat = np.load(os.path.join(d, "inputs.npz"))
    out = {}
    for c in plan_cases(d):
        if tuple(c["dims"]) != dims:
            continue
        cfg = meshnet.MeshNetConfig(**{**c["cfg"],
                                       "widths": tuple(c["cfg"]["widths"])})
        model = meshnet.MeshNet(cfg, generator=torch.Generator(),
                                device="cpu")
        model.params_from_jax([
            {k: {pk: flat[f"{c['name']}/{i}.{k}.{pk}"] for pk in sub}
             for k, sub in layer.items()}
            for i, layer in enumerate(model.params())])
        specs = meshnet.layer_specs(cfg, c["batch"])
        if c["spec"] is None:
            plan = ConvSharding(batch_axes=("data",), h_axis="model")
            net = meshnet.network_plan(cfg, plan, mesh)
        else:
            plan = net = plan_lib.plan_from_spec(c["spec"], specs, mesh)
        b = pipeline.synthetic_mesh_batch(0, c["batch"], cfg.input_hw,
                                          cfg.in_channels, out_hw=cfg.out_hw)
        b = pipeline.to_device(pipeline.shard_batch(
            b, mesh, net.sharding(specs[0].name), net.sharding("pred")),
            torch.device("cpu"))
        params = model.params()
        loss = meshnet.loss_fn(params, b, cfg, plan, mesh)
        grads = reduce_replicated_grads(
            list(torch.autograd.grad(loss, tree_leaves(params))), mesh)
        key = c["name"]
        out[f"{key}/loss"] = mesh.all_reduce(loss.detach(),
                                             mesh.axis_names).numpy()
        out[f"{key}/n_reshards"] = np.array(net.n_reshards)
        out.update({f"{key}/grad{i}": g.numpy()
                    for i, g in enumerate(grads)})
    return out


def resnet_cases(d) -> list[dict]:
    with open(os.path.join(d, "resnet.json")) as f:
        return json.load(f)


def unflatten(tree, leaves):
    """`leaves` (an iterator, in `tree_leaves` order: dict keys sorted) in
    the structure of `tree`."""
    if isinstance(tree, dict):
        return {k: unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [unflatten(t, leaves) for t in tree]
    return next(leaves)


def resnet_setup(c: dict, mesh, d):
    """The ResNet of case `c` (DIR/resnet.json) with its params
    (DIR/inputs.npz, `<case>/<leaf index>`, loaded by params_from_jax),
    its plan on `mesh` (the solved Dists of `c["spec"]` compiled against
    the graph, or the uniform N x H sharding where it has none) and this
    rank's block of its batch of `step`."""
    import torch
    from repro_torch.core import plan as plan_lib
    from repro_torch.core.spatial_conv import ConvSharding
    from repro_torch.data import pipeline
    from repro_torch.models.cnn import resnet
    cfg = resnet.ResNetConfig(**{**c["cfg"], "stages": tuple(c["cfg"][
        "stages"]), "widths": tuple(c["cfg"]["widths"])})
    model = resnet.ResNet(cfg, generator=torch.Generator(), device="cpu")
    flat = np.load(os.path.join(d, "inputs.npz"))
    n_leaves = sum(k.startswith(f"{c['name']}/") for k in flat)
    model.params_from_jax(unflatten(model.params(), iter(
        flat[f"{c['name']}/{i}"] for i in range(n_leaves))))
    if c["spec"] is None:
        plan = resnet.network_plan(cfg, ConvSharding(
            batch_axes=("data",), h_axis="model"), mesh)
    else:
        plan = plan_lib.compile_plan(
            plan_lib.dists_from_spec(c["spec"]),
            resnet.all_specs(c["batch"], cfg), mesh,
            graph=resnet.resnet_graph(c["batch"], cfg))

    def batch(step):
        b = pipeline.synthetic_imagenet_batch(step, c["batch"], cfg.input_hw,
                                              cfg.n_classes)
        return pipeline.to_device(pipeline.shard_batch(
            b, mesh, plan.sharding("conv1"),
            plan.out_sharding(resnet.last_layer(cfg))), torch.device("cpu"))
    return cfg, model, plan, batch


def case_resnet(mesh, d):
    """Each case of DIR/resnet.json on this mesh: the ResNet loss of
    global batch 0 under the case's plan summed over the ranks, every
    param's gradient summed over the mesh, the plan's reshard points, and
    the bytes this rank's forward reshards sent beside what
    `reshard_report` predicts."""
    import torch
    from repro_torch.core import collectives as co
    from repro_torch.models.cnn import resnet
    from repro_torch.train.train_loop import reduce_replicated_grads
    from repro_torch.utils import tree_leaves
    dims = tuple(mesh.shape.values())
    out = {}
    for c in resnet_cases(d):
        if tuple(c["dims"]) != dims or c.get("steps"):
            continue
        cfg, model, plan, batch = resnet_setup(c, mesh, d)
        params = model.params()
        b = batch(0)
        co.reset_sent()
        loss = resnet.loss_fn(params, b, cfg, plan, mesh)
        sent = co.sent.get("reshard", 0)
        grads = reduce_replicated_grads(
            list(torch.autograd.grad(loss, tree_leaves(params))), mesh)
        report = plan.reshard_report(resnet.all_specs(c["batch"], cfg),
                                     mesh, flow=resnet.flow(cfg))
        key = c["name"]
        out[f"{key}/loss"] = mesh.all_reduce(loss.detach(),
                                             mesh.axis_names).numpy()
        out[f"{key}/n_reshards"] = np.array(plan.n_reshards)
        out[f"{key}/sent"] = np.array(sent)
        out[f"{key}/want_sent"] = np.array(sum(r["bytes"] for r in report))
        out[f"{key}/n_moves"] = np.array(len(report))
        out.update({f"{key}/grad{i}": g.numpy()
                    for i, g in enumerate(grads)})
    return out


def case_resnet_trajectory(mesh, d):
    """The cases of DIR/resnet.json with `steps`: that many SGD-momentum
    steps (lr 0.1 on warmup(1) + cosine) of the train step under the
    case's plan, batches 0, 1, ...: the losses and the params after."""
    import functools
    from repro_torch.models.cnn import resnet
    from repro_torch.optim import optimizer as opt_lib
    from repro_torch.train import train_loop
    from repro_torch.utils import FP32, tree_leaves
    dims = tuple(mesh.shape.values())
    out = {}
    for c in resnet_cases(d):
        if tuple(c["dims"]) != dims or not c.get("steps"):
            continue
        cfg, model, plan, batch = resnet_setup(c, mesh, d)
        steps = c["steps"]
        opt = opt_lib.sgd(opt_lib.warmup_cosine(0.1, 1, steps), momentum=0.9)
        step = train_loop.make_train_step(
            functools.partial(resnet.loss_fn, cfg=cfg, plan=plan, mesh=mesh),
            opt, train_loop.TrainStepConfig(precision=FP32), mesh=mesh)
        params = model.params()
        state = opt.init(params)
        losses = []
        for s in range(steps):
            params, state, m = step(params, state, batch(s))
            losses.append(float(m["loss"]))
        key = c["name"]
        out[f"{key}/losses"] = np.array(losses)
        out.update({f"{key}/param{i}": p.detach().numpy()
                    for i, p in enumerate(tree_leaves(params))})
    return out


# the reference tests' calibration net (tests/test_calibrate.py's CFG at
# batch 4) and the 2-rank profile's plans of the mesh1k SMOKE net
CALIB_NET = {"input_hw": 32, "in_channels": 4, "convs_per_block": 1,
             "widths": (8, 16)}
CALIB_BATCH = 4
TRACE_PLANS = {"uniform": ("uniform", 2), "auto": ("auto", 1)}


def rank_fake_timer(rank: int):
    """The reference tests' fake timer (seconds from the argument sizes
    only, `fn` never called), scaled by 1 + rank: every rank measures a
    different time."""
    def timer(fn, *args):
        return (1 + rank) * (2e-6 + 1e-9 * sum(int(np.prod(a.shape))
                                                for a in args))
    return timer


def case_calibrate(mesh, d):
    """`calibrate.load_or_run` into DIR/cal.json with a fake timer that
    differs on every rank, then again (it must load: a timer that raises
    proves it), and the plan `plan_line` solves on the calibration."""
    from repro_torch.core import calibrate, plan as plan_lib
    from repro_torch.models.cnn import meshnet
    specs = meshnet.layer_specs(meshnet.MeshNetConfig("t", **CALIB_NET),
                                CALIB_BATCH)
    path = os.path.join(d, "cal.json")
    cal = calibrate.load_or_run(path, specs, mesh, device="cpu",
                                timer=rank_fake_timer(mesh.rank))

    def boom(fn, *a):
        raise AssertionError("re-measured instead of loading")
    again = calibrate.load_or_run(path, specs, mesh, device="cpu",
                                  timer=boom)
    plan = plan_lib.plan_line(cal.machine, specs, dict(mesh.shape),
                              table=cal.table)
    return {"cal": np.array(json.dumps(cal.to_json(), sort_keys=True)),
            "again": np.array(json.dumps(again.to_json(), sort_keys=True)),
            "fingerprint": np.array(cal.fingerprint),
            "plan": np.array(json.dumps(plan.to_spec(), sort_keys=True))}


def case_trace(mesh, d):
    """`trace.trace_plan` of the mesh1k SMOKE net under each TRACE_PLANS
    plan (the uniform sample x spatial plan at batch 2; the auto plan on
    LASSEN at batch 1, with CF layers and a reshard) and its attribution
    where the plan has a prediction: per layer fwd_s, bwd_s, fwd_bwd_s."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.data import pipeline
    from repro_torch.launch import train
    from repro_torch.models.cnn import meshnet
    from repro_torch.core import trace
    cfg = registry.get("mesh1k", smoke=True)
    out = {}
    for key, (strategy, batch) in TRACE_PLANS.items():
        args = train.parse_args(["--arch", "mesh1k", "--smoke", "--batch",
                                 str(batch), "--model", str(mesh.size),
                                 "--device", "cpu", "--strategy", strategy])
        specs = meshnet.layer_specs(cfg, batch)
        plan = train.build_cnn_plan(args, specs, torch.device("cpu"), mesh,
                                    echo=False)
        model = meshnet.MeshNet(cfg, generator=torch.Generator()
                                .manual_seed(0), device="cpu")
        b = pipeline.to_device(pipeline.shard_batch(
            pipeline.synthetic_mesh_batch(0, batch, cfg.input_hw,
                                          cfg.in_channels,
                                          out_hw=cfg.out_hw),
            mesh, plan.sharding(specs[0].name), plan.sharding("pred")),
            torch.device("cpu"))
        tr = trace.trace_plan(plan, model.params(), b, cfg=cfg, mesh=mesh,
                              reps=1, rounds=2)
        for name, r in tr.layers.items():
            for k, v in r.items():
                out[f"{key}/{name}/{k}"] = np.array(v)
        out[f"{key}/step"] = np.array([tr.step["fwd_s"], tr.step["bwd_s"],
                                       tr.step["fwd_bwd_s"]])
        out[f"{key}/n_reshards"] = np.array(plan.n_reshards)
        out[f"{key}/kinds"] = np.array(plan.describe())
        if plan.predicted:
            rep = plan.attribution_report(tr)
            out[f"{key}/report"] = np.array(json.dumps(rep))
    return out


# tests/dist_checks.py check_elastic's run: the tiny net, batch 4, 10
# steps, a checkpoint every 3, the fault at step 7
ELASTIC = {"input_hw": 24, "in_channels": 6, "convs_per_block": 1,
           "widths": (12, 24), "bn_scope": "global"}
ELASTIC_NUM, ELASTIC_EVERY, ELASTIC_FAULT, ELASTIC_BATCH = 10, 3, 7, 4


def case_elastic(mesh, d):
    """check_elastic on this 4-rank mesh in the mode of DIR/elastic.json
    (step-fault, kill-device, corrupt-tmp), from the params of
    DIR/inputs.npz: the port's ResilientLoop, CheckpointManager (rank 0
    writes into DIR/ckpt), chaos hooks and, for kill-device, the remesh
    onto the 3 survivors (plan_from_spec of the checkpoint's record,
    PlanError -> a fresh solve under the same limit).  Each rank returns
    the loss of every step it ran (the last run of a step), its last step
    and `left_at` (-1: none); rank 0 the directory's listing too."""
    import functools
    import torch
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.core import plan as plan_lib
    from repro_torch.core.perfmodel import LASSEN
    from repro_torch.data import pipeline
    from repro_torch.launch.mesh import elastic_factorization, make_mesh
    from repro_torch.models.cnn import meshnet
    from repro_torch.optim.optimizer import (load_state_tree, sgd,
                                             state_tree)
    from repro_torch.runtime import chaos
    from repro_torch.runtime.fault_tolerance import (ResilientLoop,
                                                     StragglerMonitor)
    from repro_torch.train.metrics import MetricsLogger
    from repro_torch.train.train_loop import TrainStepConfig, make_train_step
    from repro_torch.utils import FP32
    with open(os.path.join(d, "elastic.json")) as f:
        mode = json.load(f)["mode"]
    cfg = meshnet.MeshNetConfig("t", **ELASTIC)
    specs = meshnet.layer_specs(cfg, ELASTIC_BATCH)
    opt = sgd(0.05, momentum=0.9)
    shape4, shape3 = dict(mesh.shape), {"data": 1, "model": 3}
    peak = max(plan_lib.plan_line(LASSEN, specs, sh).predicted["memory"]
               ["peak_bytes"] for sh in (shape4, shape3))
    limit = 1.25 * peak
    plan4 = plan_lib.plan_line(LASSEN, specs, shape4, mem_limit=limit)
    flat = np.load(os.path.join(d, "inputs.npz"))

    def init_state():
        model = meshnet.MeshNet(cfg, generator=torch.Generator(),
                                device="cpu")
        model.params_from_jax([{k: {pk: flat[f"{i}.{k}.{pk}"] for pk in sub}
                                for k, sub in layer.items()}
                               for i, layer in enumerate(model.params())])
        params = model.params()
        return params, opt.init(params)

    def make_rig(m, plan):
        tstep = make_train_step(
            functools.partial(meshnet.loss_fn, cfg=cfg, plan=plan, mesh=m),
            opt, TrainStepConfig(precision=FP32), mesh=m)
        first, last = plan.sharding(specs[0].name), plan.sharding("pred")

        def put(step):
            b = pipeline.synthetic_mesh_batch(step, ELASTIC_BATCH,
                                              cfg.input_hw, cfg.in_channels,
                                              out_hw=cfg.out_hw)
            return pipeline.to_device(pipeline.shard_batch(b, m, first, last),
                                      torch.device("cpu"))
        return tstep, put

    lead = mesh.rank == 0
    ckdir = os.path.join(d, "ckpt")
    ck = CheckpointManager(ckdir, keep=3, async_save=True, writer=lead)
    mlog = MetricsLogger(os.path.join(d, "metrics.jsonl") if lead else None,
                         echo=False)
    ctx = {"mesh": mesh, "rig": make_rig(mesh, plan4), "how": "",
           "spec": plan4.to_spec(shape4, mem_limit=limit, config_hash="t")}
    got = {}

    def make_step():
        def run(state, step):
            p, o = state
            tstep, put = ctx["rig"]
            p, o, m = tstep(p, o, put(step))
            got[step] = float(m["loss"])
            return (p, o), m
        return run

    def remesh(survivors):
        assert len(survivors) == 3, survivors
        data, model = elastic_factorization(len(survivors),
                                            batch=ELASTIC_BATCH)
        mesh3 = make_mesh(data=data, model=model, members=survivors)
        if not mesh3.member:
            return None
        rec = mesh3.broadcast_object(
            ck.read_manifest()["plan"] if mesh3.rank == 0 else None)
        assert rec["schema"] == plan_lib.PLAN_SCHEMA, rec
        assert rec["mesh"] == {"data": 2, "model": 2}, rec
        try:
            plan3 = plan_lib.plan_from_spec(rec, specs, shape3,
                                            machine=LASSEN,
                                            mem_limit=rec["mem_limit"])
            ctx["how"] = "plan_from_spec"
        except plan_lib.PlanError:
            plan3 = plan_lib.plan_line(LASSEN, specs, shape3,
                                       mem_limit=rec["mem_limit"])
            ctx["how"] = "re-solved"
        assert plan3.predicted["memory"]["peak_bytes"] <= rec["mem_limit"]
        ctx.update(mesh=mesh3, rig=make_rig(mesh3, plan3),
                   spec=plan3.to_spec(shape3, mem_limit=rec["mem_limit"],
                                      config_hash="t"))
        return make_step, init_state()

    if mode == "step-fault":
        inject = chaos.raise_at_step(ELASTIC_FAULT)
    elif mode == "kill-device":
        inject = chaos.drop_device_at_step(ELASTIC_FAULT,
                                           devices=mesh.members)
    else:
        inject = chaos.parse(f"corrupt@{ELASTIC_FAULT - 3},"
                             f"raise@{ELASTIC_FAULT}", ckpt_dir=ckdir,
                             plant=lead)
    loop = ResilientLoop(
        ckpt=ck, make_step=make_step, ckpt_every=ELASTIC_EVERY,
        max_failures=2, remesh=remesh if mode == "kill-device" else None,
        metrics=mlog, plan_spec=lambda: ctx["spec"],
        leaves=lambda st: state_tree(st[0], st[1]),
        load=lambda like, t: (like[0], load_state_tree(t, like[0], like[1])),
        agree=lambda step: ctx["mesh"].broadcast_object(step))
    _, step, _ = loop.run(init_state(), 0, ELASTIC_NUM,
                          monitor=StragglerMonitor(), inject_failure=inject)
    mlog.close()
    out = {"steps": np.array(sorted(got)),
           "losses": np.array([got[s] for s in sorted(got)]),
           "final_step": np.array(step), "how": np.array(ctx["how"]),
           "left_at": np.array(-1 if loop.left_at is None
                               else loop.left_at)}
    if lead:
        out["listing"] = np.array(json.dumps(sorted(os.listdir(ckdir))))
        out["latest"] = np.array(ck.latest_step())
    return out


def case_subset(mesh, d):
    """A halo exchange (and its backward), a ring shift, an all-reduce, a
    broadcast and an all-max on `Mesh(members=[1, 3])` of a 4-rank world,
    or on the whole of a 2-rank world: each member's results, by mesh
    rank, must be the same."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import halo
    from repro_torch.launch.mesh import Mesh
    members = [1, 3] if dist.get_world_size() == 4 else None
    sub = Mesh({"data": 1, "model": 2}, members=members)
    out = {"member": np.array(sub.member)}
    if not sub.member:
        return out
    r = sub.rank
    x = _t(block(halo_input(), r, (1, 2), h_axis="model"), grad=True)
    ext = halo.halo_exchange(x, 1, 1, 1, "model", sub, 0.0)
    (ext * _t(halo_cotangent("h_1_1", r, tuple(ext.shape)))).sum() \
        .backward()
    out.update(mesh_rank=np.array(r), ext=ext.detach().numpy(),
               dx=x.grad.numpy(),
               ring=halo.ring_shift(torch.full((2, 3), float(r)), "model",
                                    sub).detach().numpy(),
               sum=sub.all_reduce(torch.arange(3.0) * (r + 1),
                                  "model").numpy(),
               bcast=np.array(sub.broadcast_object(10 + r)),
               max=np.array(sub.all_max([r, -r])))
    sub.barrier()
    return out


# the reference's audit probes (tests/dist_checks.py check_audit): (n, c,
# h, w, f, k, s), on the meshes the port's audit covers with 4 ranks
AUDIT_PROBES = [(4, 8, 16, 16, 8, 3, 1), (1, 16, 16, 16, 16, 3, 2),
                (2, 12, 8, 8, 6, 1, 1), (2, 4, 32, 8, 8, 3, 1),
                (8, 8, 8, 8, 32, 3, 1), (1, 32, 4, 4, 32, 3, 1)]
AUDIT_MESHES = [(2, 2), (1, 4), (4, 1)]
# (key, probe, dist dims) whose recorded ops are held against the
# reference's collect_ops on 2 x 2
AUDIT_CASES = [
    ("h", 0, {"N": ["data"], "H": ["model"]}),
    ("hw", 0, {"H": ["model"], "W": ["data"]}),
    ("cf_channel", 0, {"N": ["data"], "C": ["model"], "F": ["model"]}),
    ("cf_filter", 4, {"N": ["data"], "C": ["model"], "F": ["model"]}),
    ("cf_h", 0, {"H": ["data"], "C": ["model"], "F": ["model"]}),
]
COLLECTIVES = ("ppermute", "psum", "all_gather", "reduce_scatter",
               "all_to_all")


def audit_spec(pm, i):
    n, c, h, w, f, k, s = AUDIT_PROBES[i]
    return pm.ConvLayer("probe", n=n, c=c, h=h, w=w, f=f, k=k, s=s)


def group_ops(ops) -> dict:
    """Collectives by "layer|direction|kind": [count, total bytes], the
    weight-gradient psums (the reference's, the port's bucket) left out."""
    out: dict = {}
    for o in ops:
        if o.kind in COLLECTIVES and o.kind != "psum":
            key = f"{o.layer}|{o.direction}|{o.kind}"
            c, b = out.get(key, (0, 0.0))
            out[key] = (c + 1, b + o.bytes)
    return {k: list(v) for k, v in sorted(out.items())}


def audit_probe(mesh, spec, dist, overlap=True, declared=True, extra=False):
    """Audit one conv layer's step on this rank's blocks: the loss sum(y^2)
    (+ 1e-9 x an all-reduce of x over data inside the layer, a collective
    no inventory entry prices, with `extra`),
    its gradients in w and x (as the reference's probe takes them), the
    gradient bucket; run with `overlap`, audited as `declared`."""
    import torch
    from repro_torch import analysis
    from repro_torch.core import collectives, plan as plan_lib, trace
    from repro_torch.models.cnn import layers as L
    from repro_torch.train.train_loop import reduce_replicated_grads
    plan = plan_lib.compile_plan({spec.name: dist}, [spec], mesh)
    sh = plan.sharding(spec.name)
    g = np.random.default_rng(11)
    w = _t(g.standard_normal((spec.k, spec.k, spec.c, spec.f))
           .astype(np.float32), grad=True)
    x = torch.from_numpy(g.standard_normal((spec.n, spec.h, spec.w, spec.c))
                         .astype(np.float32))
    for dim, axes in enumerate(collectives.layout(sh)):
        if axes:
            x = collectives.take_block(x, mesh, axes, dim)
    x = x.contiguous().requires_grad_()

    def step(w, x):
        with trace.layer_context(spec.name):
            y = L.conv_apply({"w": w}, x, stride=spec.s, sharding=sh,
                             mesh=mesh, overlap=overlap)
            loss = (y * y).sum()
            if extra:
                loss = loss + mesh.all_reduce(x.detach(), ("data",)).sum() \
                    * 1e-9
        gw, gx = torch.autograd.grad(loss, [w, x])
        return reduce_replicated_grads([gw], mesh), gx

    return analysis.audit_step(step, (w, x), plan, [spec], mesh,
                               overlap=declared, hlo=False,
                               grad_wrt_inputs=True, device="cpu")


def case_audit(mesh, d):
    """On a 4-rank world: every executable candidate of every probe on the
    2 x 2, 1 x 4 and 4 x 1 meshes audited (each finding), the AUDIT_CASES'
    recorded collectives, and the reference's two negative cases (an
    injected all-reduce, a serialized step declared overlapped)."""
    from repro_torch.core import perfmodel as pm, plan as plan_lib
    from repro_torch.core.distribution import Dist
    from repro_torch.launch.mesh import make_mesh
    report = {"probes": [], "cases": {}, "negative": {}}
    meshes = {dims: mesh if dims == tuple(mesh.shape.values())
              else make_mesh(*dims) for dims in AUDIT_MESHES}
    for dims, m in meshes.items():
        for i in range(len(AUDIT_PROBES)):
            spec = audit_spec(pm, i)
            for dist in plan_lib.executable_candidates(spec, dict(m.shape)):
                a = audit_probe(m, spec, dist)
                report["probes"].append({
                    "mesh": list(dims), "probe": i, "dist": dist.name,
                    "dims": {k: list(v) for k, v in dist.dims.items()},
                    "findings": [f.to_json() for f in a.findings]})
    m = meshes[(2, 2)]
    for key, i, dims in AUDIT_CASES:
        a = audit_probe(m, audit_spec(pm, i), Dist(key, {
            k: tuple(v) for k, v in dims.items()}))
        report["cases"][key] = {"ops": group_ops(a.ops),
                                "findings": [f.to_json() for f in a.findings]}
    spec = audit_spec(pm, 0)
    dist = Dist("h+n", {"N": ("data",), "H": ("model",)})
    for key, kw in (("injected", {"extra": True}),
                    ("serialized", {"overlap": False})):
        report["negative"][key] = [
            f.to_json() for f in audit_probe(m, spec, dist, **kw).findings]
    return {"report": np.array(json.dumps(report))}


def case_halo_order(mesh, d):
    """One spatial conv layer with the §IV-A split on 2 ranks, recorded:
    the ops' order, and the gradients against the serialized conv's."""
    import torch
    from repro_torch import analysis
    from repro_torch.core import trace
    from repro_torch.core.spatial_conv import ConvSharding, spatial_conv2d
    x_g, w_g = conv_inputs(CONV_GEOMS[0])
    r, dims = mesh.rank, tuple(mesh.shape.values())
    sh = ConvSharding(h_axis="model")
    out = {}
    for overlap in (True, False):
        x = _t(block(x_g, r, dims, h_axis="model"), grad=True)
        w = _t(w_g, grad=True)

        def step():
            with trace.layer_context("probe"):
                y = spatial_conv2d(x, w, strides=(1, 1), sharding=sh,
                                   mesh=mesh, overlap=overlap)
            (y * y).sum().backward()

        with analysis.record() as rec:
            step()
        key = "overlap" if overlap else "serialized"
        out[f"{key}/ops"] = np.array(json.dumps(
            [[o.kind, o.direction, o.region] for o in rec.ops]))
        out[f"{key}/dx"] = x.grad.numpy()
        out[f"{key}/dw"] = w.grad.numpy()
    return out


CASES = {"halo": case_halo, "conv": case_conv, "pool": case_pool,
         "spatial2d": case_spatial2d, "bn": case_bn,
         "meshnet": case_meshnet, "trajectory": case_trajectory,
         "cf": case_cf, "reshard": case_reshard, "plan": case_plan,
         "resnet": case_resnet, "resnet_trajectory": case_resnet_trajectory,
         "calibrate": case_calibrate, "trace": case_trace,
         "elastic": case_elastic, "subset": case_subset,
         "audit": case_audit, "halo_order": case_halo_order}


# ------------------------------------------------------------ launcher --

def _rank_main(rank: int, case: str, dims: tuple, d: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    world = dims[0] * dims[1]
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(data=dims[0], model=dims[1])
        out = CASES[case](mesh, d)
        np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def start(case: str, dims: tuple, d: str) -> subprocess.Popen:
    """Start `case` on a (data, model) = `dims` mesh of gloo ranks in a
    subprocess."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case,
         ",".join(map(str, dims)), str(d)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)


def collect(p: subprocess.Popen, dims: tuple, d: str,
            timeout: int = 300) -> list[dict]:
    """Wait for a `start`ed run; each rank's arrays."""
    out, err = p.communicate(timeout=timeout)
    if p.returncode != 0:
        raise AssertionError(f"ranks {p.args[2:4]} failed (rc "
                             f"{p.returncode}):\n{out[-2000:]}\n"
                             f"{err[-6000:]}")
    return [dict(np.load(os.path.join(d, f"rank{i}.npz")))
            for i in range(dims[0] * dims[1])]


def run(case: str, dims: tuple, d: str, timeout: int = 300) -> list[dict]:
    """Run `case` on a (data, model) = `dims` mesh of gloo ranks in a
    subprocess; returns each rank's arrays."""
    return collect(start(case, dims, d), dims, d, timeout)


def main(argv) -> int:
    import torch.multiprocessing as mp
    case, dims, d = argv[0], tuple(int(v) for v in argv[1].split(",")), \
        argv[2]
    mp.spawn(_rank_main, args=(case, dims, d), nprocs=dims[0] * dims[1],
             join=True)
    print(json.dumps({"case": case, "dims": dims, "ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
