"""The trainer, port of `repro.launch.train`: the CNNs (ResNet-50 and the
mesh-tangling nets) on one device or on a (pod, data, model) mesh of
processes, and the ported LM archs on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mesh1k \
      --steps 3 --batch 2 [--device cuda|cpu] [--smoke]
  PYTHONPATH=src python -m repro_torch.launch.train --arch resnet50 \
      --steps 3 --batch 32 [--device cuda|cpu] [--smoke]
  PYTHONPATH=src torchrun --nproc-per-node M -m repro_torch.launch.train \
      --arch mesh1k|resnet50 --model M [--data D] [--pod P] --batch B \
      [--strategy auto [--search greedy|beam[:N]|hillclimb] [--no-cf] \
      [--mem-limit BYTES|auto]]
  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
      --steps 3 --batch 1 --seq 2048 [--bf16] [--device cuda|cpu] [--smoke]

Runs on CUDA unless `--device cpu` is given; asking for CUDA where there
is none is an error.  On the card every forward conv runs through the
hand-written conv kernel (`kernels/csrc/conv2d.cu`), every attention
through the flash-attention kernel (`kernels/csrc/flash_attention.cu`) and
every SSD intra-chunk pass through the SSD-chunk kernel
(`kernels/csrc/ssd.cu`).  As in the reference, the CNNs train under FP32
with SGD + momentum on a warmup(10) + cosine schedule (ResNet-50 on
`synthetic_imagenet_batch`, the mesh nets on `synthetic_mesh_batch`);
the LMs train with
AdamW on a warmup(20) + cosine schedule, under FP32 unless `--bf16`
(bf16 compute, fp32 master weights), on `synthetic_lm_batch` token
batches of `--seq` tokens.

With more than one process (torchrun's environment, or a process group
that already exists), the CNNs train on a (pod, data, model) mesh under a
per-layer plan (`core.plan.NetworkPlan`, printed at startup):

  --strategy uniform  the reference's uniform plan,
      `ConvSharding(batch_axes=("pod", "data"), h_axis="model")` (N over
      the data axes, H over the model axis, a halo exchange and the §IV-A
      interior/boundary conv split at every layer), fitted to each layer:
      a layer whose geometry drops the spatial axis (§III-A) takes a
      reshard;
  --strategy auto  the §V-C solve of sample / spatial / channel-filter
      distributions, compiled with its demotions and reshard points, on
      the `H100` preset's constants on CUDA and on `LASSEN`'s (the
      paper's machine) on the CPU: a line's (`core.plan.plan_line` over
      `meshnet.layer_specs`) or, for ResNet-50, the longest-path-first
      solve of the branchy DAG (`core.plan.plan_graph` over
      `resnet.resnet_graph`, costed on the main path); `--search`,
      `--no-cf` and `--mem-limit` as in the reference.

`--batch` is the global batch; rank r runs on
`cuda:(local_rank % device_count)` (NCCL) or the CPU (gloo); only rank 0
prints and writes metrics.  `--calibrate`, `--remat`, checkpoints,
`--elastic` and `--chaos` come with their slices and are refused until
then.
"""
from __future__ import annotations

import argparse
import functools
import os
import time

import torch

from repro_torch.configs import registry
from repro_torch.core import plan as plan_lib
from repro_torch.core.perfmodel import H100, LASSEN
from repro_torch.core.spatial_conv import ConvSharding
from repro_torch.core.strategy import parse_search
from repro_torch.data import pipeline
from repro_torch.launch.mesh import batch_axes, init_distributed, make_mesh
from repro_torch.models.cnn import meshnet, resnet
from repro_torch.models.lm import transformer
from repro_torch.optim.optimizer import adamw, sgd, warmup_cosine
from repro_torch.train.metrics import MetricsLogger
from repro_torch.train.train_loop import TrainStepConfig, make_train_step
from repro_torch.utils import (BF16, FP32, human_bytes, human_count,
                               resolve_device, tree_leaves)


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
    ap.add_argument("--data", type=int, default=1,
                    help="mesh data axis (sample parallelism)")
    ap.add_argument("--model", type=int, default=1,
                    help="mesh model axis (spatial H for the CNNs)")
    ap.add_argument("--pod", type=int, default=1,
                    help="mesh pod axis (sample parallelism across pods)")
    ap.add_argument("--strategy", default="uniform",
                    choices=["uniform", "auto"],
                    help="per-layer plan: the uniform sample x spatial plan "
                         "or the §V-C solve (CNN archs)")
    ap.add_argument("--search", default="greedy",
                    help="--strategy auto search mode: greedy | beam[:N] | "
                         "hillclimb")
    ap.add_argument("--no-cf", action="store_true",
                    help="--strategy auto: no channel/filter candidates")
    ap.add_argument("--mem-limit", default=None, metavar="BYTES|auto",
                    help="--strategy auto: per-device memory limit (auto: "
                         "the card's memory, or the host's free memory "
                         "shared among the ranks on the CPU)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics", nargs="?", const="METRICS.jsonl",
                    default=None, metavar="PATH",
                    help="write JSONL step records to PATH")
    args = ap.parse_args(argv)
    try:
        parse_search(args.search)
    except ValueError as e:
        ap.error(str(e))
    if args.mem_limit is not None and args.mem_limit.lower() != "auto":
        try:
            float(args.mem_limit)
        except ValueError:
            ap.error(f"--mem-limit takes bytes or 'auto', got "
                     f"{args.mem_limit!r}")
    if min(args.data, args.model, args.pod) < 1:
        ap.error("--data, --model and --pod must be >= 1")
    if args.batch % (args.data * args.pod):
        ap.error(f"--batch {args.batch} (the global batch) must divide over "
                 f"the data axes (pod {args.pod} x data {args.data})")
    if args.bf16 and registry.canon(args.arch) in registry.CNN_ARCHS:
        ap.error("--bf16 covers the LM archs; the CNN archs train in FP32, "
                 "as in the reference")
    return args


def set_fp32_numerics(device: torch.device, echo: bool = True) -> None:
    """FP32 means full fp32 on the card: cuDNN would otherwise run the
    backward convs (and cuBLAS any matmul) in TF32."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        if echo:
            print("fp32 precision: TF32 off for cuDNN and cuBLAS")


def parse_mem_limit(value, device: torch.device, ranks: int = 1
                    ) -> float | None:
    """--mem-limit BYTES|auto -> bytes a device (None: no limit).  'auto'
    is the card's memory (`torch.cuda.mem_get_info`); on the CPU the
    host's available memory shared among the `ranks` processes (the
    reference's host fallback)."""
    if value is None:
        return None
    if str(value).lower() != "auto":
        return float(value)
    if device.type == "cuda":
        return float(torch.cuda.mem_get_info(device)[1])
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") \
        / max(ranks, 1)


def build_cnn_plan(args: argparse.Namespace, specs, device: torch.device,
                   mesh=None, echo: bool = True, graph=None,
                   flow=None) -> plan_lib.NetworkPlan:
    """--strategy uniform: the uniform plan fitted to every layer.
    --strategy auto: the §V-C solve over `specs` on the mesh, compiled
    (core.plan.plan_line), or over the branchy `graph` whose main path
    `specs` is (core.plan.plan_graph).  `flow`: the tensors that move
    between layers, for the reshard report (None: a line)."""
    every = list(specs) if graph is None else \
        plan_lib.compile_order(graph, specs)
    shape = {"pod": args.pod, "data": args.data, "model": args.model}
    if args.pod == 1:
        del shape["pod"]
    machine = H100 if device.type == "cuda" else LASSEN
    where = "the H100 preset" if device.type == "cuda" else \
        "LASSEN (the paper's machine; the CPU has no preset)"
    mem_limit = parse_mem_limit(args.mem_limit, device,
                                1 if mesh is None else mesh.size)
    if args.strategy == "auto":
        t0 = time.time()
        if mem_limit and echo:
            print(f"memory limit: {human_bytes(mem_limit)}/device")
        kw = dict(allow_channel_filter=not args.no_cf, mem_limit=mem_limit,
                  search=args.search)
        plan = plan_lib.plan_line(machine, specs, shape, **kw) \
            if graph is None else \
            plan_lib.plan_graph(machine, graph, specs, shape, **kw)
        head = f"strategy optimizer ({time.time() - t0:.2f}s, search " \
            f"{args.search}) on {where}:"
    else:
        if mem_limit and echo:
            print("--mem-limit constrains the --strategy auto solve only; "
                  "the uniform plan is not validated")
        if mesh is None:
            # one device: a JAX mesh of size 1 under the reference's
            # uniform ConvSharding(h_axis="model") computes the same SAME
            # conv (the halos of an axis of size 1 are zeros)
            return plan_lib.NetworkPlan.uniform(
                ConvSharding(), [s.name for s in every])
        plan = plan_lib.NetworkPlan.uniform(
            ConvSharding(batch_axes=batch_axes(mesh), h_axis="model"),
            specs=every, mesh=mesh, graph=graph)
        head = "uniform plan:"
    if echo:
        print(head)
        print(plan.describe())
        print(plan_lib.reshard_lines(plan.reshard_report(every, shape,
                                                         flow=flow)))
    return plan


def build(args: argparse.Namespace, device: torch.device, mesh=None,
          echo: bool = True):
    """(cfg, params, optimizer, loss_fn, batch factory, precision, plan) of
    the arch.  Params are drawn from a CPU generator seeded with `--seed`,
    so every rank, the card and the CPU start from the same weights.  On a
    mesh the batch factory returns this rank's block of the global batch."""
    cfg = registry.get(args.arch, smoke=args.smoke)
    gen = torch.Generator().manual_seed(args.seed)
    arch = registry.canon(args.arch)
    if arch in registry.CNN_ARCHS:
        if arch == "resnet50":
            specs = resnet.layer_specs(args.batch, cfg)
            plan = build_cnn_plan(args, specs, device, mesh, echo,
                                  graph=resnet.resnet_graph(args.batch, cfg),
                                  flow=resnet.flow(cfg))
            model, loss_fn = resnet.ResNet(cfg, generator=gen,
                                           device=device), resnet.loss_fn
            mk_global = functools.partial(
                pipeline.synthetic_imagenet_batch, batch=args.batch,
                hw=cfg.input_hw, n_classes=cfg.n_classes)
            # the labels are cut as the head's input is
            last = plan.out_sharding(resnet.last_layer(cfg))
        else:
            specs = meshnet.layer_specs(cfg, args.batch)
            plan = build_cnn_plan(args, specs, device, mesh, echo)
            model, loss_fn = meshnet.MeshNet(cfg, generator=gen,
                                             device=device), meshnet.loss_fn
            mk_global = functools.partial(
                pipeline.synthetic_mesh_batch, batch=args.batch,
                hw=cfg.input_hw, channels=cfg.in_channels,
                out_hw=cfg.out_hw)
            last = plan.sharding("pred")
        first = plan.sharding(specs[0].name)
        opt = sgd(warmup_cosine(args.lr, 10, args.steps), momentum=0.9)
        loss = functools.partial(loss_fn, cfg=cfg, plan=plan, mesh=mesh)

        def mk(step):
            return pipeline.shard_batch(mk_global(step), mesh, first, last)
        return cfg, model.params(), opt, loss, mk, FP32, plan
    if args.strategy == "auto":
        raise SystemExit(
            f"--strategy auto covers the solvable CNN archs "
            f"{registry.CNN_ARCHS}; {cfg.name!r} is an LM arch the §V-C "
            f"optimizer has no candidate space for (drop --strategy auto "
            f"to train it with the uniform sharding)")
    if mesh is not None:
        raise SystemExit(f"{cfg.name} trains on one device in this port "
                         f"(the ring over torch.distributed is not ported "
                         f"yet); run it without a mesh")
    params = transformer.init(gen, cfg, device=device)
    opt = adamw(warmup_cosine(args.lr, 20, args.steps))
    loss = functools.partial(transformer.loss_fn, cfg=cfg)
    mk = functools.partial(pipeline.synthetic_lm_batch, batch=args.batch,
                           seq=args.seq, vocab=cfg.vocab)
    return cfg, params, opt, loss, mk, BF16 if args.bf16 else FP32, None


def setup(args: argparse.Namespace):
    """(device, mesh, rank) of this process: joins the process group where
    there is one (`launch.mesh.init_distributed`), checks that its size is
    pod x data x model, and picks `cuda:(local_rank % device_count)`."""
    device = resolve_device(args.device)
    rank, world, local = init_distributed(device)
    n = args.pod * args.data * args.model
    if world != n:
        raise SystemExit(f"{world} processes for a mesh of pod {args.pod} x "
                         f"data {args.data} x model {args.model} = {n}")
    if device.type == "cuda":
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    mesh = make_mesh(args.data, args.model, args.pod) if world > 1 else None
    return device, mesh, rank


def run(args: argparse.Namespace) -> dict:
    """Train `args.steps` steps; returns the config it trained, the plan,
    the losses, the seconds of each step (batch included) and of its
    batch's wait and copy, and the trained params."""
    device, mesh, rank = setup(args)
    lead = rank == 0
    set_fp32_numerics(device, echo=lead)
    cfg, params, opt, loss, mk, prec, plan = build(args, device, mesh,
                                                   echo=lead)
    n_params = sum(p.numel() for p in tree_leaves(params))
    tstep = make_train_step(loss, opt, TrainStepConfig(
        grad_accum=args.grad_accum, precision=prec), mesh=mesh)
    opt_state = opt.init(params)
    where = f"mesh={dict(mesh.shape)} strategy={args.strategy}" \
        if mesh else f"strategy={args.strategy}"
    if lead:
        print(f"arch={cfg.name} params={human_count(n_params)} "
              f"device={device} {where}".rstrip())

    losses, step_s, data_s = [], [], []
    pf = pipeline.Prefetcher(mk)
    mlog = MetricsLogger(args.metrics if lead else None, echo=lead)
    try:
        mlog.log_run(arch=cfg.name, n_params=n_params, device=str(device),
                     batch=args.batch, steps=args.steps,
                     strategy=args.strategy,
                     mesh=dict(mesh.shape) if mesh else None)
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
                          echo=lead and step % args.log_every == 0)
        mlog.log_done(args.steps, loss=losses[-1] if losses else None)
    finally:
        pf.close()
        mlog.close()
    if losses and lead:
        print(f"done at step {args.steps}; final loss {losses[-1]:.4f}")
    return {"cfg": cfg, "losses": losses, "step_s": step_s,
            "data_s": data_s, "n_params": n_params, "params": params,
            "mesh": mesh, "plan": plan}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
