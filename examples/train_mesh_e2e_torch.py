"""End-to-end training on the port (PyTorch; the H100 by default): a
scaled mesh-tangling model (the paper's workload family, ~21M params like
the paper's own 1K model) trained for a few hundred steps through the
production path — prefetching pipeline, FP32 train step, async
checkpointing, resilient loop; the counterpart of
examples/train_mesh_e2e.py.

The default is the same network at 128^2 inputs (identical depth/widths
=> identical parameter count, 1/64 the pixels); --full is the paper's 1K
config at 1024^2 x 18, where on the card every forward conv (19 a step)
runs on the conv kernel.  --steps changes the length.  Run as a script it
asserts that the loss fell, as the reference does over its run of
hundreds of steps (`main` returns the losses and asserts nothing: a few
steps in the warmup move less than one batch differs from the next).

  PYTHONPATH=src python examples/train_mesh_e2e_torch.py [--steps 300] \\
      [--batch 2] [--full] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import functools
import tempfile
import time

import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.core.spatial_conv import ConvSharding
from repro_torch.data.pipeline import (
    Prefetcher, synthetic_mesh_batch, to_device)
from repro_torch.launch import shardings
from repro_torch.launch.train import set_fp32_numerics
from repro_torch.models.cnn import meshnet
from repro_torch.optim.optimizer import sgd, warmup_cosine
from repro_torch.runtime.fault_tolerance import (
    ResilientLoop, StragglerMonitor)
from repro_torch.train.train_loop import (
    TrainStepConfig, make_train_step)
from repro_torch.utils import (
    FP32, human_count, resolve_device, tree_num_params)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--full", action="store_true",
                    help="paper's true 1024^2 input size")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None, cfg=None, params=None) -> dict:
    """Train as `argv` says; `cfg`: a MeshNetConfig in place of the
    script's (a smaller one for a test), `params`: the reference's param
    list to start from (`MeshNet.params_from_jax`), else `init` from
    seed 0.  Returns the losses, each step's seconds and the trained
    params."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_fp32_numerics(device, echo=False)
    hw = 1024 if args.full else 128
    cfg = cfg or meshnet.MeshNetConfig("mesh-e2e", input_hw=hw,
                                       in_channels=18, convs_per_block=3)
    model = meshnet.MeshNet(cfg, generator=torch.Generator().manual_seed(0),
                            device=device)
    if params is not None:
        model.params_from_jax(params)
    params = model.params()
    print(f"{cfg.name}: {human_count(tree_num_params(params))} params "
          f"(paper's 1K-model family), input {cfg.input_hw}^2 x "
          f"{cfg.in_channels}")

    loss = functools.partial(meshnet.loss_fn, cfg=cfg, plan=ConvSharding())
    opt = sgd(warmup_cosine(0.02, 20, args.steps), momentum=0.9)
    tstep = make_train_step(loss, opt, TrainStepConfig(precision=FP32))
    work = tempfile.TemporaryDirectory()         # the checkpoints
    ck = CheckpointManager(work.name, keep=2, async_save=True)
    pf = Prefetcher(lambda s: synthetic_mesh_batch(
        s, args.batch, cfg.input_hw, cfg.in_channels, out_hw=cfg.out_hw))
    state = (params, opt.init(params), None)
    t0 = time.time()
    hist, step_s = [], []

    def make_step():
        def run(state, step):
            t1 = time.perf_counter()
            p, o, ef = state
            b = to_device(pf.get(step), device)
            p, o, ef, m = tstep(p, o, ef, b)
            hist.append(float(m["loss"]))            # waits for the step
            step_s.append(time.perf_counter() - t1)
            if step % 20 == 0:
                print(f"step {step:4d} loss {hist[-1]:.4f} "
                      f"({(time.time()-t0)/(len(hist)):.2f}s/step)")
            return (p, o, ef), m
        return run

    def load(like, restored):
        p, o, ef = like
        return p, shardings.load_sharded_state_tree(restored, p, o, ef,
                                                    None), ef

    loop = ResilientLoop(ckpt=ck, make_step=make_step, ckpt_every=100,
                         leaves=lambda st: shardings.sharded_state_tree(
                             *st, None), load=load)
    try:
        state, step, _ = loop.run(state, 0, args.steps,
                                  monitor=StragglerMonitor())
    finally:
        pf.close()
        ck.wait()
        work.cleanup()
    print(f"trained {step} steps in {time.time()-t0:.0f}s; "
          f"loss {hist[0]:.4f} -> {hist[-1]:.4f}")
    return {"cfg": cfg, "losses": hist, "step_s": step_s,
            "params": state[0], "steps": step}


if __name__ == "__main__":
    hist = main()["losses"]
    assert hist[-1] < hist[0]
