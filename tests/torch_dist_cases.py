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
          h_axis=None, w_axis=None) -> np.ndarray:
    """rank's block of global NHWC `a`."""
    for dim, axis in ((0, batch_axes), (1, h_axis), (2, w_axis)):
        i, n = shard(rank, dims, axis)
        m = a.shape[dim] // n
        a = a[(slice(None),) * dim + (slice(i * m, (i + 1) * m),)]
    return np.ascontiguousarray(a)


def stitch(blocks: list, dims: tuple, batch_axes=(), h_axis=None,
           w_axis=None) -> np.ndarray:
    """The global array from every rank's block (ranks replicating a block
    must agree)."""
    nb, nh, nw = (shard(0, dims, a)[1] for a in (batch_axes, h_axis, w_axis))
    b0 = blocks[0]
    out = np.full((b0.shape[0] * nb, b0.shape[1] * nh, b0.shape[2] * nw)
                  + b0.shape[3:], np.nan, b0.dtype)
    for r, b in enumerate(blocks):
        (i, _), (j, _), (k, _) = (shard(r, dims, a)
                                  for a in (batch_axes, h_axis, w_axis))
        s = (slice(i * b.shape[0], (i + 1) * b.shape[0]),
             slice(j * b.shape[1], (j + 1) * b.shape[1]),
             slice(k * b.shape[2], (k + 1) * b.shape[2]))
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


CASES = {"halo": case_halo, "conv": case_conv, "pool": case_pool,
         "spatial2d": case_spatial2d, "bn": case_bn,
         "meshnet": case_meshnet, "trajectory": case_trajectory}


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


def run(case: str, dims: tuple, d: str, timeout: int = 300) -> list[dict]:
    """Run `case` on a (data, model) = `dims` mesh of gloo ranks in a
    subprocess; returns each rank's arrays."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run(
        [sys.executable, os.path.abspath(__file__), case,
         ",".join(map(str, dims)), str(d)],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)
    if r.returncode != 0:
        raise AssertionError(f"ranks of {case} on {dims} failed "
                             f"(rc {r.returncode}):\n{r.stdout[-2000:]}\n"
                             f"{r.stderr[-6000:]}")
    world = dims[0] * dims[1]
    return [dict(np.load(os.path.join(d, f"rank{i}.npz")))
            for i in range(world)]


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
