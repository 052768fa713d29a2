"""The JAX reference on a mesh of host devices, for the port's multi-rank
tests: what needs several devices runs here, in a subprocess with
--xla_force_host_platform_device_count, and writes numpy arrays.

    PYTHONPATH=src python tests/jax_mesh_oracles.py <what> DIR

what: `bn_local` (local-scope BN under N over data, H over model, forward
and the gradients of sum(y * gy), on the (1, 2), (2, 2) and (2, 4)
meshes), or
`meshnet` (the small meshnet's loss and gradients under the uniform plan
on both meshes, and a 3-step SGD trajectory on (1, 2), with the params in
DIR/inputs.npz).  Inputs are `torch_dist_cases`' (numpy seeds).
"""
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


def run(what: str, d: str, timeout: int = 300) -> None:
    """Run `what` in a subprocess with 8 host devices; its arrays land in
    DIR/<what>.npz."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(os.path.dirname(here),
                                                      "src"), here])
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, os.path.abspath(__file__), what, d],
                       capture_output=True, text=True, timeout=timeout,
                       env=env)
    if r.returncode != 0:
        raise AssertionError(f"JAX oracle {what} failed:\n"
                             f"{r.stderr[-6000:]}")


if __name__ == "__main__":
    {"bn_local": _bn_local, "meshnet": _meshnet}[sys.argv[1]](sys.argv[2])
