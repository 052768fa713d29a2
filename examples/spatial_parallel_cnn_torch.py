"""The paper, end to end on 8 ranks of the port (PyTorch; the H100 by
default): hybrid sample x spatial training of a mesh-tangling model with
halo-exchange convolution, fault injection + checkpoint restart, and
int8 error-feedback gradient compression across the pod axis; the
counterpart of examples/spatial_parallel_cnn.py.

  PYTHONPATH=src python examples/spatial_parallel_cnn_torch.py \\
      [--device cuda|cpu]
  PYTHONPATH=src torchrun --nproc-per-node 8 \\
      examples/spatial_parallel_cnn_torch.py --device cpu

A pod 2 x data 2 x model 2 mesh of 8 ranks.  Run alone, the script starts
them itself (`launch.mesh.spawn_local`: one gloo group over a FileStore);
under torchrun it joins the group it is given.  On the card the 8 ranks
share it over gloo (NCCL refuses two ranks on one card), every forward
conv on the conv kernel: a parity run, not a scaling result.  Rank 0
alone prints.  The params are whole on every rank, where the reference
places them replicated (`shard_tree(..., P())`); the port's params are
whole unless held at rest, so it has no `shard_tree`.  Each rank
checkpoints the (global) train state, the int8 residuals with it, to a
directory of its own, and every rank rolls back to the same step.
"""
from __future__ import annotations

import argparse
import functools
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.core.spatial_conv import ConvSharding
from repro_torch.data import pipeline
from repro_torch.launch import shardings
from repro_torch.launch.mesh import (
    init_distributed, make_mesh, spawn_local)
from repro_torch.launch.train import set_fp32_numerics
from repro_torch.models.cnn import meshnet
from repro_torch.optim.grad_compress import init_error_feedback
from repro_torch.optim.optimizer import sgd
from repro_torch.runtime.fault_tolerance import (
    ResilientLoop, StragglerMonitor)
from repro_torch.train.train_loop import (
    TrainStepConfig, make_train_step)
from repro_torch.utils import FP32, resolve_device

POD, DATA, MODEL = 2, 2, 2
CONFIG = meshnet.MeshNetConfig("spatial-demo", input_hw=64, in_channels=4,
                               convs_per_block=1, widths=(8, 16, 16))
BATCH, STEPS, FAIL_AT = 8, 20, 8


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def run(args: argparse.Namespace, params=None) -> dict:
    """This rank's part of the run (joining torchrun's group, or the one
    that exists); `params`: the reference's param list to start from
    (`MeshNet.params_from_jax`), else `init` from seed 0.  Returns every
    step run (a rolled-back step runs again) with its loss and gradient
    norm and seconds (its batch's making and copy included), the final
    step and metrics, and the trained state."""
    device = resolve_device(args.device)
    rank, world, local = init_distributed(device)
    if device.type == "cuda":
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    say = print if rank == 0 else (lambda *a, **k: None)
    set_fp32_numerics(device, echo=False)
    mesh = make_mesh(data=DATA, model=MODEL, pod=POD)
    say(f"mesh: {dict(mesh.shape)} "
        "(pod = cross-pod DP, data = sample parallelism, "
        "model = the paper's spatial axis)")

    cfg = CONFIG
    sharding = ConvSharding(batch_axes=("pod", "data"), h_axis="model")
    model = meshnet.MeshNet(cfg, generator=torch.Generator().manual_seed(0),
                            device=device)
    if params is not None:
        model.params_from_jax(params)
    params = model.params()           # whole on every rank: P()
    plan = meshnet.network_plan(cfg, sharding, mesh)
    loss = functools.partial(meshnet.loss_fn, cfg=cfg, plan=plan, mesh=mesh)
    opt = sgd(0.05, momentum=0.9)
    step_fn = make_train_step(
        loss, opt, TrainStepConfig(grad_accum=2, precision=FP32,
                                   pod_compression="int8_ef"), mesh=mesh)
    first, last = plan.sharding(meshnet.layer_names(cfg)[0]), \
        plan.sharding("pred")

    def put(b):
        return pipeline.to_device(pipeline.shard_batch(b, mesh, first, last),
                                  device)

    def tree(state):
        return shardings.sharded_state_tree(*state, mesh)

    def load(like, restored):
        p, o, e = like
        return p, shardings.load_sharded_state_tree(restored, p, o, e,
                                                    mesh), e

    held = shardings.local_shards(params, mesh)
    work = tempfile.TemporaryDirectory()         # this rank's checkpoints
    ck = CheckpointManager(work.name, keep=2)
    state = (params, opt.init(held), init_error_feedback(held, mesh,
                                                         "int8_ef"))
    ran = []

    def make_step():
        def step(state, i):
            t0 = time.perf_counter()
            p, o, ef = state
            p, o, ef, m = step_fn(p, o, ef, put(pipeline.synthetic_mesh_batch(
                i, BATCH, cfg.input_hw, cfg.in_channels, out_hw=cfg.out_hw)))
            ran.append((i, float(m["loss"]), float(m["grad_norm"]),
                        time.perf_counter() - t0))      # the batch included
            if i % 5 == 0:
                say(f"  step {i}: loss {ran[-1][1]:.4f}")
            return (p, o, ef), m
        return step

    armed = {"on": True}

    def inject(i):
        if i == FAIL_AT and armed["on"]:
            armed["on"] = False
            say(f"  !! injecting node failure at step {FAIL_AT}")
            raise RuntimeError("synthetic failure")

    loop = ResilientLoop(ckpt=ck, make_step=make_step, ckpt_every=5,
                         leaves=tree, load=load)
    try:
        state, end, metrics = loop.run(state, 0, STEPS,
                                       monitor=StragglerMonitor(),
                                       inject_failure=inject)
    finally:
        ck.wait()
        work.cleanup()
    say(f"survived the failure; finished at step {end}, "
        f"loss {float(metrics['loss']):.4f}")
    secs = sorted(r[3] for r in ran)
    say(f"{len(ran)} steps run in {sum(secs):.2f} s, median "
        f"{secs[len(secs) // 2]:.4f} s/step on rank 0 ({device}, "
        f"{world} ranks)")
    return {"ran": ran, "end": end, "loss": float(metrics["loss"]),
            "state": state, "mesh": mesh}


def main(argv=None, params=None) -> dict | None:
    """Train on the process group that exists (torchrun's, or a caller's)
    and return `run`'s dict; with none, start the POD x DATA x MODEL ranks
    (`spawn_local`) and return None."""
    args = parse_args(argv)
    resolve_device(args.device)
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        return run(args, params)
    spawn_local(run, POD * DATA * MODEL, args, params)
    return None


if __name__ == "__main__":
    main()
