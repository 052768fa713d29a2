"""The trainer on one device, port of the single-device paths of
`repro.launch.train`: the mesh-tangling CNNs and the ported LM archs.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mesh1k \
      --steps 3 --batch 2 [--device cuda|cpu] [--smoke]
  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
      --steps 3 --batch 1 --seq 2048 [--bf16] [--device cuda|cpu] [--smoke]

Runs on CUDA unless `--device cpu` is given; asking for CUDA where there
is none is an error.  On the card every forward conv runs through the
hand-written conv kernel (`kernels/csrc/conv2d.cu`), every attention
through the flash-attention kernel (`kernels/csrc/flash_attention.cu`) and
every SSD intra-chunk pass through the SSD-chunk kernel
(`kernels/csrc/ssd.cu`).  As in the reference, the CNNs train under FP32
with SGD + momentum on a warmup(10) + cosine schedule; the LMs train with
AdamW on a warmup(20) + cosine schedule, under FP32 unless `--bf16`
(bf16 compute, fp32 master weights), on `synthetic_lm_batch` token
batches of `--seq` tokens.  The reference's `--strategy`, `--calibrate`,
`--mem-limit`, `--remat`, the mesh flags, checkpoints, `--elastic` and
`--chaos` come with their slices and are refused until then.
"""
from __future__ import annotations

import argparse
import functools
import time

import torch

from repro_torch.configs import registry
from repro_torch.core.spatial_conv import ConvSharding
from repro_torch.data import pipeline
from repro_torch.models.cnn import meshnet
from repro_torch.models.lm import transformer
from repro_torch.optim.optimizer import adamw, sgd, warmup_cosine
from repro_torch.train.metrics import MetricsLogger
from repro_torch.train.train_loop import TrainStepConfig, make_train_step
from repro_torch.utils import (BF16, FP32, human_count, resolve_device,
                               tree_leaves)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 allow_abbrev=False)
    ap.add_argument("--arch", default="mesh1k",
                    help="architecture id; ported: "
                         + ", ".join(registry.CNN_ARCHS + registry.LM_ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's reduced config (CPU runs)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64,
                    help="tokens per sample (LM archs)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--bf16", action="store_true",
                    help="BF16 precision: bf16 compute, fp32 master weights "
                         "(LM archs; the CNNs train in FP32)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics", nargs="?", const="METRICS.jsonl",
                    default=None, metavar="PATH",
                    help="write JSONL step records to PATH")
    args = ap.parse_args(argv)
    if args.bf16 and registry.canon(args.arch) in registry.CNN_ARCHS:
        ap.error("--bf16 covers the LM archs; the CNN archs train in FP32, "
                 "as in the reference")
    return args


def set_fp32_numerics(device: torch.device) -> None:
    """FP32 means full fp32 on the card: cuDNN would otherwise run the
    backward convs (and cuBLAS any matmul) in TF32."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        print("fp32 precision: TF32 off for cuDNN and cuBLAS")


def build(args: argparse.Namespace, device: torch.device):
    """(cfg, params, optimizer, loss_fn, batch factory, precision) of the
    arch.  Params are drawn from a CPU generator seeded with `--seed`, so
    the card and the CPU start from the same weights."""
    cfg = registry.get(args.arch, smoke=args.smoke)
    gen = torch.Generator().manual_seed(args.seed)
    if registry.canon(args.arch) in registry.CNN_ARCHS:
        # the uniform one-device plan.  A JAX mesh of size 1 with the
        # reference's uniform ConvSharding(h_axis="model") computes the
        # same SAME conv: the halos of an axis of size 1 are zeros.
        params = meshnet.MeshNet(cfg, generator=gen, device=device).params()
        opt = sgd(warmup_cosine(args.lr, 10, args.steps), momentum=0.9)
        loss = functools.partial(meshnet.loss_fn, cfg=cfg,
                                 plan=ConvSharding())
        mk = functools.partial(pipeline.synthetic_mesh_batch,
                               batch=args.batch, hw=cfg.input_hw,
                               channels=cfg.in_channels, out_hw=cfg.out_hw)
        return cfg, params, opt, loss, mk, FP32
    params = transformer.init(gen, cfg, device=device)
    opt = adamw(warmup_cosine(args.lr, 20, args.steps))
    loss = functools.partial(transformer.loss_fn, cfg=cfg)
    mk = functools.partial(pipeline.synthetic_lm_batch, batch=args.batch,
                           seq=args.seq, vocab=cfg.vocab)
    return cfg, params, opt, loss, mk, BF16 if args.bf16 else FP32


def run(args: argparse.Namespace) -> dict:
    """Train `args.steps` steps; returns the config it trained, the losses,
    the seconds of each step (batch included) and of its batch's wait and
    copy."""
    device = resolve_device(args.device)
    set_fp32_numerics(device)
    cfg, params, opt, loss, mk, prec = build(args, device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    tstep = make_train_step(loss, opt, TrainStepConfig(
        grad_accum=args.grad_accum, precision=prec))
    opt_state = opt.init(params)
    print(f"arch={cfg.name} params={human_count(n_params)} device={device}")

    losses, step_s, data_s = [], [], []
    pf = pipeline.Prefetcher(mk)
    mlog = MetricsLogger(args.metrics)
    try:
        mlog.log_run(arch=cfg.name, n_params=n_params, device=str(device),
                     batch=args.batch, steps=args.steps, strategy="uniform")
        for step in range(args.steps):
            t0 = time.perf_counter()
            batch = pipeline.to_device(pf.get(step), device)
            data_s.append(time.perf_counter() - t0)    # host wait + copy
            params, opt_state, m = tstep(params, opt_state, batch)
            losses.append(float(m["loss"]))      # waits for the step
            step_s.append(time.perf_counter() - t0)
            mlog.log_step(step, losses[-1], step_time_s=step_s[-1],
                          samples_per_s=args.batch / step_s[-1],
                          grad_norm=float(m["grad_norm"]),
                          echo=step % args.log_every == 0)
        mlog.log_done(args.steps, loss=losses[-1] if losses else None)
    finally:
        pf.close()
        mlog.close()
    if losses:
        print(f"done at step {args.steps}; final loss {losses[-1]:.4f}")
    return {"cfg": cfg, "losses": losses, "step_s": step_s,
            "data_s": data_s, "n_params": n_params}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
