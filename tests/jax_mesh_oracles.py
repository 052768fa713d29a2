"""The JAX reference on a mesh of host devices, for the port's multi-rank
tests: what needs several devices runs here, in a subprocess with
--xla_force_host_platform_device_count, and writes numpy arrays.

    PYTHONPATH=src python tests/jax_mesh_oracles.py <what> DIR

what: `bn_local` (local-scope BN under N over data, H over model, forward
and the gradients of sum(y * gy), on the (1, 2), (2, 2) and (2, 4)
meshes),
`meshnet` (the small meshnet's loss and gradients under the uniform plan
on both meshes, and a 3-step SGD trajectory on (1, 2), with the params in
DIR/inputs.npz),
`cf` (`cf_conv2d` of every `CF_CONFIGS` row and geometry, and
`cf_batch_norm` / `cf_bias_add` of every `CF_BN_CONFIGS` row: global y and
the gradients of sum(y * gy)), or
`plan [K/P]` (part K of P of the cases of DIR/plans.json, into
DIR/planK.npz: the meshnet loss and gradients under each case's plan, as
`torch_dist_cases.case_plan`, and on one device where the case asks), or
`resnet [K/P]` (the same for the ResNet cases of DIR/resnet.json, into
DIR/resnetK.npz, and the one-device SGD trajectory of a case with
`steps`), or `audit` (the reference's `collect_ops` of the audit probes'
steps, into DIR/audit_ref.json).  Inputs are
`torch_dist_cases`' (numpy seeds).  The local convs run on XLA, the
reference's default backend.
"""
import contextlib
import os
import subprocess
import sys

MESHES = [(1, 2), (2, 2)]
BN_MESHES = MESHES + [(2, 4)]


def _bn_local(d):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch_dist_cases as cases
    from repro.core.spatial_conv import ConvSharding
    from repro.core.spatial_norm import batch_norm
    from repro.launch.mesh import make_mesh
    x, g, b, gy = (jnp.asarray(a) for a in cases.bn_inputs())
    out = {}
    for dims in BN_MESHES:
        mesh = make_mesh(data=dims[0], model=dims[1],
                         devices=jax.devices()[:dims[0] * dims[1]])
        sh = ConvSharding(batch_axes=("data",), h_axis="model")

        def f(x, g, b):
            return batch_norm(x, g, b, sharding=sh, mesh=mesh, scope="local")
        with mesh:
            y, vjp = jax.vjp(jax.jit(f), x, g, b)
            dx, dg, db = vjp(gy)
        key = f"{dims[0]}x{dims[1]}"
        out.update({f"{key}/y": y, f"{key}/dx": dx, f"{key}/dgamma": dg,
                    f"{key}/dbeta": db})
    np.savez(os.path.join(d, "bn_local.npz"),
             **{k: np.asarray(v) for k, v in out.items()})


def _meshnet(d):
    import functools
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    import torch_dist_cases as cases
    from repro.core.spatial_conv import ConvSharding
    from repro.data.pipeline import synthetic_mesh_batch
    from repro.launch.mesh import make_mesh
    from repro.models.cnn import meshnet
    from repro.optim import optimizer as jopt
    from repro.train import train_loop as jtl
    from repro.utils import FP32
    cfg = meshnet.MeshNetConfig("t", **cases.MESHNET)
    flat = np.load(os.path.join(d, "inputs.npz"))
    # numpy leaves: the train step donates what device_put makes of them
    params0 = [{k: {pk: flat[f"{i}.{k}.{pk}"] for pk in sub}
                for k, sub in layer.items()}
               for i, layer in enumerate(meshnet.init(
                   jax.random.PRNGKey(0), cfg))]
    sh = ConvSharding(batch_axes=("data",), h_axis="model")
    out = {}
    for dims in MESHES:
        mesh = make_mesh(data=dims[0], model=dims[1],
                         devices=jax.devices()[:dims[0] * dims[1]])
        n = 2 * dims[0]
        key = f"{dims[0]}x{dims[1]}"

        def put(b):
            return {"image": jax.device_put(b["image"], NamedSharding(
                        mesh, P(("data",), "model"))),
                    "label": jax.device_put(b["label"], NamedSharding(
                        mesh, P(("data",))))}
        params = jax.tree.map(
            lambda a: jax.device_put(a, NamedSharding(mesh, P())), params0)
        loss = functools.partial(meshnet.loss_fn, cfg=cfg, plan=sh,
                                 mesh=mesh)
        b = put(synthetic_mesh_batch(0, n, cfg.input_hw, cfg.in_channels,
                                     out_hw=cfg.out_hw))
        with mesh:
            l, g = jax.jit(jax.value_and_grad(loss))(params, b)
        out[f"{key}/loss"] = np.asarray(l)
        for i, leaf in enumerate(jax.tree.leaves(g)):
            out[f"{key}/grad{i}"] = np.asarray(leaf)
        if dims != (1, 2):
            continue
        lr, steps = 0.1, 3
        opt = jopt.sgd(jopt.warmup_cosine(lr, 1, steps), momentum=0.9)
        step = jtl.make_train_step(loss, opt, mesh,
                                   jtl.TrainStepConfig(precision=FP32))
        state = opt.init(params)
        losses, norms = [], []
        with mesh:
            for s in range(steps):
                b = put(synthetic_mesh_batch(s, n, cfg.input_hw,
                                             cfg.in_channels,
                                             out_hw=cfg.out_hw))
                params, state, _, m = step(params, state, None, b)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        out[f"{key}/losses"] = np.array(losses)
        out[f"{key}/grad_norms"] = np.array(norms)
        for i, leaf in enumerate(jax.tree.leaves(params)):
            out[f"{key}/param{i}"] = np.asarray(leaf)
    np.savez(os.path.join(d, "meshnet.npz"), **out)


def _mesh(dims):
    import jax
    from repro.launch.mesh import make_mesh
    return make_mesh(data=dims[0], model=dims[1],
                     devices=jax.devices()[:dims[0] * dims[1]])


def _cf(d):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch_dist_cases as cases
    from repro.core import channel_conv as cc
    out = {}
    for key, dims, kw, mode, chunks in cases.CF_CONFIGS:
        mesh = _mesh(dims)
        sh = cc.CFSharding(mode=mode, **kw)
        for gi, geom in enumerate(cases.CF_GEOMS):
            s = geom[1]
            x, w, gy = (jnp.asarray(a) for a in cases.cf_inputs(geom))

            def f(x, w):
                return cc.cf_conv2d(x, w, strides=(s, s), sharding=sh,
                                    mesh=mesh, channel_chunks=chunks)
            with mesh:
                y, vjp = jax.vjp(jax.jit(f), x, w)
                dx, dw = vjp(gy)
            out.update({f"{key}/{gi}/y": y, f"{key}/{gi}/dx": dx,
                        f"{key}/{gi}/dw": dw})
    x, g, b, gy = (jnp.asarray(a) for a in cases.cf_bn_inputs())
    for key, dims, kw in cases.CF_BN_CONFIGS:
        mesh = _mesh(dims)
        sh = cc.CFSharding(**kw)
        for scope in cases.BN_SCOPES + ("bias",):
            def f(x, g, b):
                if scope == "bias":
                    return cc.cf_bias_add(x, b, sharding=sh, mesh=mesh)
                return cc.cf_batch_norm(x, g, b, sharding=sh, mesh=mesh,
                                        scope=scope)
            with mesh:
                y, vjp = jax.vjp(jax.jit(f), x, g, b)
                dx, dg, db = vjp(gy)
            out.update({f"bn_{key}_{scope}/y": y,
                        f"bn_{key}_{scope}/dx": dx,
                        f"bn_{key}_{scope}/dgamma": dg,
                        f"bn_{key}_{scope}/dbeta": db})
    np.savez(os.path.join(d, "cf.npz"),
             **{k: np.asarray(v) for k, v in out.items()})


def _plan(d, part="0/1"):
    import functools
    import jax
    import numpy as np
    import torch_dist_cases as cases
    from repro.core import plan as plan_lib
    from repro.core.spatial_conv import ConvSharding
    from repro.data.pipeline import synthetic_mesh_batch
    from repro.models.cnn import meshnet
    flat = np.load(os.path.join(d, "inputs.npz"))
    k, parts = (int(v) for v in part.split("/"))
    out = {}
    for c in cases.plan_cases(d)[k::parts]:
        cfg = meshnet.MeshNetConfig(**{**c["cfg"],
                                       "widths": tuple(c["cfg"]["widths"])})
        mesh = _mesh(tuple(c["dims"]))
        params = [{k: {pk: flat[f"{c['name']}/{i}.{k}.{pk}"] for pk in sub}
                   for k, sub in layer.items()}
                  for i, layer in enumerate(meshnet.init(
                      jax.random.PRNGKey(0), cfg))]
        specs = meshnet.layer_specs(cfg, c["batch"])
        plan = ConvSharding(batch_axes=("data",), h_axis="model") \
            if c["spec"] is None else \
            plan_lib.plan_from_spec(c["spec"], specs, mesh)
        loss = functools.partial(meshnet.loss_fn, cfg=cfg, plan=plan,
                                 mesh=mesh)
        b = synthetic_mesh_batch(0, c["batch"], cfg.input_hw,
                                 cfg.in_channels, out_hw=cfg.out_hw)
        with mesh:
            l, g = jax.jit(jax.value_and_grad(loss))(params, b)
        out[f"{c['name']}/loss"] = np.asarray(l)
        for i, leaf in enumerate(jax.tree.leaves(g)):
            out[f"{c['name']}/grad{i}"] = np.asarray(leaf)
        if not c["one_device"]:
            continue
        l, g = jax.jit(jax.value_and_grad(functools.partial(
            meshnet.loss_fn, cfg=cfg)))(params, b)
        out[f"{c['name']}/one/loss"] = np.asarray(l)
        for i, leaf in enumerate(jax.tree.leaves(g)):
            out[f"{c['name']}/one/grad{i}"] = np.asarray(leaf)
    np.savez(os.path.join(d, f"plan{k}.npz"), **out)


def _resnet(d, part="0/1"):
    """Part K of P of the cases of DIR/resnet.json, into DIR/resnetK.npz:
    the ResNet loss and gradients of global batch 0 under each case's plan
    on its mesh (the solved Dists compiled against the graph, or the
    uniform N x H ConvSharding), or on one device where the case asks;
    for a case with `steps`, that many SGD-momentum steps on one device
    (as `torch_dist_cases.case_resnet_trajectory`): the losses and the
    params after."""
    import functools
    import jax
    import numpy as np
    import torch_dist_cases as cases
    from repro.core import plan as plan_lib
    from repro.core.spatial_conv import ConvSharding
    from repro.data.pipeline import synthetic_imagenet_batch
    from repro.models.cnn import resnet
    from repro.optim import optimizer as jopt
    from repro.train import train_loop as jtl
    from repro.utils import FP32
    flat = np.load(os.path.join(d, "inputs.npz"))
    k, parts = (int(v) for v in part.split("/"))
    out = {}
    for c in cases.resnet_cases(d)[k::parts]:
        cfg = resnet.ResNetConfig(**{**c["cfg"], "stages": tuple(
            c["cfg"]["stages"]), "widths": tuple(c["cfg"]["widths"])})
        treedef = jax.tree.structure(resnet.init(jax.random.PRNGKey(0), cfg))
        params = jax.tree.unflatten(treedef, [
            flat[f"{c['name']}/{i}"] for i in range(treedef.num_leaves)])
        key = c["name"]
        if c.get("steps"):
            mesh = _mesh((1, 1))
            opt = jopt.sgd(jopt.warmup_cosine(0.1, 1, c["steps"]),
                           momentum=0.9)
            step = jtl.make_train_step(
                functools.partial(resnet.loss_fn, cfg=cfg), opt, mesh,
                jtl.TrainStepConfig(precision=FP32))
            state, losses = opt.init(params), []
            with mesh:
                for s in range(c["steps"]):
                    b = synthetic_imagenet_batch(s, c["batch"],
                                                 cfg.input_hw, cfg.n_classes)
                    params, state, _, m = step(params, state, None, b)
                    losses.append(float(m["loss"]))
            out[f"{key}/losses"] = np.array(losses)
            for i, leaf in enumerate(jax.tree.leaves(params)):
                out[f"{key}/param{i}"] = np.asarray(leaf)
            continue
        b = synthetic_imagenet_batch(0, c["batch"], cfg.input_hw,
                                     cfg.n_classes)
        if c["one_device"]:
            l, g = jax.jit(jax.value_and_grad(functools.partial(
                resnet.loss_fn, cfg=cfg)))(params, b)
            out[f"{key}/one/loss"] = np.asarray(l)
            for i, leaf in enumerate(jax.tree.leaves(g)):
                out[f"{key}/one/grad{i}"] = np.asarray(leaf)
            continue
        mesh = _mesh(tuple(c["dims"]))
        if c["spec"] is None:
            plan = ConvSharding(batch_axes=("data",), h_axis="model")
        else:
            graph = resnet.resnet_graph(c["batch"], cfg)
            main = resnet.layer_specs(c["batch"], cfg)
            names = {l.name for l in main}
            specs = main + [graph.nodes[n]["layer"] for n in graph.nodes
                            if n not in names]
            plan = plan_lib.compile_plan(
                plan_lib.dists_from_spec(c["spec"]), specs, mesh,
                graph=graph)
        with mesh:
            l, g = jax.jit(jax.value_and_grad(functools.partial(
                resnet.loss_fn, cfg=cfg, plan=plan, mesh=mesh)))(params, b)
        out[f"{key}/loss"] = np.asarray(l)
        for i, leaf in enumerate(jax.tree.leaves(g)):
            out[f"{key}/grad{i}"] = np.asarray(leaf)
    np.savez(os.path.join(d, f"resnet{k}.npz"), **out)


def _audit(d):
    """The reference's `collect_ops` of each `AUDIT_CASES` probe step on 2 x
    2 host devices (value_and_grad in w and x, as its check_audit),
    grouped as `torch_dist_cases.group_ops` groups the port's, into
    DIR/audit_ref.json."""
    import json
    import jax
    import jax.numpy as jnp
    import torch_dist_cases as cases
    from repro.analysis import collect_ops
    from repro.core import perfmodel as pm
    from repro.core import plan as plan_lib
    from repro.core import trace
    from repro.core.distribution import Dist
    from repro.models.cnn import layers as L
    mesh = _mesh((2, 2))
    out = {}
    for key, i, dims in cases.AUDIT_CASES:
        spec = cases.audit_spec(pm, i)
        plan = plan_lib.compile_plan(
            {spec.name: Dist(key, {k: tuple(v) for k, v in dims.items()})},
            [spec], mesh)
        sh = plan.sharding(spec.name)
        params = {"w": jax.ShapeDtypeStruct(
            (spec.k, spec.k, spec.c, spec.f), jnp.float32)}
        x = jax.ShapeDtypeStruct((spec.n, spec.h, spec.w, spec.c),
                                 jnp.float32)

        def loss(p, xx, sh=sh, spec=spec):
            with trace.layer_context(spec.name):
                y = L.conv_apply(p, xx, stride=spec.s, sharding=sh,
                                 mesh=mesh, overlap=True)
            return jnp.sum(y * y)
        with mesh:
            closed = jax.make_jaxpr(jax.value_and_grad(
                loss, argnums=(0, 1)))(params, x)
        out[key] = cases.group_ops(collect_ops(closed, [spec.name]))
    with open(os.path.join(d, "audit_ref.json"), "w") as f:
        json.dump(out, f)


def popen(what: str, d: str, *args: str) -> subprocess.Popen:
    """Start `what` (with `args`) in a subprocess with 8 host devices."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(os.path.dirname(here),
                                                      "src"), here])
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             what, d, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def wait(p: subprocess.Popen, timeout: int = 300) -> None:
    """Wait for a `popen`ed oracle; raise with its errors if it failed."""
    _, err = p.communicate(timeout=timeout)
    if p.returncode != 0:
        raise AssertionError(f"JAX oracle {p.args[2:]} failed:\n"
                             f"{err[-6000:]}")


def run(what: str, d: str, timeout: int = 300) -> None:
    """Run `what` in a subprocess with 8 host devices; its arrays land in
    DIR/<what>.npz."""
    wait(popen(what, d), timeout)


@contextlib.contextmanager
def reference_eta_unmeasured():
    """The reference's in-process state as the port models it: no measured
    η, so its chunked-CF default is 1 ("eta unmeasured"), as the port's
    `chunks_decision` is while no calibration has installed one.  A
    reference test that calibrates (e.g. test_shuffle.py, with a fake
    timer) installs an η and leaves it in its process, which changes the
    plans `repro.core.plan` compiles there."""
    from repro.core import channel_conv
    before = channel_conv.measured_eta()
    channel_conv.set_measured_eta(None)
    try:
        yield
    finally:
        channel_conv.set_measured_eta(before)


if __name__ == "__main__":
    {"bn_local": _bn_local, "meshnet": _meshnet, "cf": _cf,
     "plan": _plan, "resnet": _resnet,
     "audit": _audit}[sys.argv[1]](*sys.argv[2:])
