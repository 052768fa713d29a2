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
      [--mem-limit BYTES|auto] [--calibrate[=PATH]]] [--profile[=PATH]]
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
      `--no-cf` and `--mem-limit` as in the reference.  With
      `--calibrate[=PATH]` the solve runs on measured costs
      (`core.calibrate.load_or_run`: PATH, default
      BENCH_calibration.json, is loaded when it exists, else measured on
      the card, every conv shard shape timed on the conv kernel, and
      written): its fitted `Machine` and `EmpiricalTable` for the line
      and the DAG alike, its fingerprint in the run header.

`--audit` (mesh1k / mesh2k) proves costed == executed before step 0
(`audit_gate`): it lints the built plan and runs one real step of it
(forward, backward and the gradient bucket, no update) on the run's own
params and first batch under the collective recorder
(`NetworkPlan.audit`, `repro_torch.analysis`), prints `plan audit: N
finding(s), E error(s) (T s)` and the findings, and exits non-zero on any
error (the maximum over the ranks); the steps then run as without it.

`--profile[=PATH]` (mesh1k / mesh2k) trains nothing: it times every
plan layer's forward and backward alone (`core.trace.trace_plan`), prints
the predicted-vs-measured attribution under `--strategy auto`
(`NetworkPlan.attribution_report`), writes the StepTrace to PATH (default
BENCH_step_trace.json) and a Chrome trace to `<PATH>.chrome.json`, and
exits.

`--batch` is the global batch; rank r runs on
`cuda:(local_rank % device_count)` (NCCL) or the CPU (gloo); only rank 0
prints and writes metrics.

The steps run through the resilient loop (`runtime.fault_tolerance.
ResilientLoop` with a `StragglerMonitor`), as in the reference:

  --ckpt-dir DIR  checkpoint to DIR in the reference's `repro/ckpt@1`
      format (`checkpoint.CheckpointManager`, async, atomic; every
      manifest records the plan's `repro/plan@1` record) every
      `--ckpt-every` steps and at the end, and resume from its latest
      step, restored in place into the live params and optimizer state
      (a checkpoint of the JAX package's trainer resumes here, and one of
      this trainer there).  Unlike the reference (default
      /tmp/repro_ckpt, always resumed) there is no default: without
      --ckpt-dir nothing is saved or resumed, and a step fault is fatal;
  --chaos SPEC    fault injection (`runtime.chaos`: raise@k, kill@k[xN],
      corrupt@k, comma-composed); a step fault rolls back to the latest
      checkpoint;
  --elastic       on a lost rank (`kill@k`), rebuild the mesh on the
      survivors (`launch.mesh.elastic_factorization`), re-run `build` on
      it (`--strategy auto` re-solves under the same --mem-limit) and
      restore the latest checkpoint into it; a rank that is not a
      survivor returns from `run` with `left_at`;
  --debug-nans    fail at the first non-finite loss or gradient norm,
      naming the first parameter that holds a NaN.

On a mesh, mesh rank 0 alone writes checkpoints (the others read them),
and before a resume or a rollback it broadcasts the step every rank
restores.
"""
from __future__ import annotations

import argparse
import functools
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.core import plan as plan_lib
from repro_torch.core.perfmodel import H100, LASSEN
from repro_torch.core.spatial_conv import ConvSharding
from repro_torch.core.strategy import parse_search
from repro_torch.data import pipeline
from repro_torch.launch.mesh import (batch_axes, elastic_factorization,
                                    init_distributed, make_mesh)
from repro_torch.models.cnn import meshnet, resnet
from repro_torch.models.lm import transformer
from repro_torch.optim.optimizer import (adamw, load_state_tree, sgd,
                                         state_tree, warmup_cosine)
from repro_torch.runtime import chaos
from repro_torch.runtime.fault_tolerance import (ResilientLoop,
                                                 StragglerMonitor)
from repro_torch.train.metrics import MetricsLogger, debug_nan_check
from repro_torch.train.train_loop import TrainStepConfig, make_train_step
from repro_torch.utils import (BF16, FP32, fingerprint, human_bytes,
                               human_count, resolve_device, tree_leaves)


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
    ap.add_argument("--calibrate", nargs="?", const="BENCH_calibration.json",
                    default=None, metavar="PATH",
                    help="--strategy auto on measured costs: load the "
                         "calibration at PATH (default "
                         "BENCH_calibration.json), else measure it on the "
                         "device and write it there (core.calibrate)")
    ap.add_argument("--profile", nargs="?", const="BENCH_step_trace.json",
                    default=None, metavar="PATH",
                    help="profile instead of train: time every plan "
                         "layer alone (core.trace.trace_plan), print the "
                         "predicted-vs-measured attribution, write the "
                         "StepTrace to PATH (default "
                         "BENCH_step_trace.json) and a Chrome trace "
                         "beside it, then exit (mesh1k / mesh2k)")
    ap.add_argument("--audit", action="store_true",
                    help="before step 0, lint the built plan and audit "
                         "the collectives of one real step against the "
                         "priced inventory (repro_torch.analysis); exit "
                         "non-zero on any error-severity finding (mesh1k / "
                         "mesh2k)")
    ap.add_argument("--ckpt-dir", default=None, metavar="DIR",
                    help="checkpoint here (repro/ckpt@1) and resume from "
                         "its latest step; no default: without it nothing "
                         "is saved or resumed")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--elastic", action="store_true",
                    help="survive a lost rank: rebuild the mesh on the "
                         "survivors (launch.mesh.elastic_factorization), "
                         "re-solve the plan on it under the same "
                         "--mem-limit, restore the last checkpoint onto it "
                         "and resume the deterministic batch stream "
                         "(needs --ckpt-dir)")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="fault injection (runtime.chaos): e.g. 'raise@7' "
                         "(step fault), 'kill@5' / 'kill@5x2' (drop ranks "
                         "-> DeviceLoss; pair with --elastic), 'corrupt@3' "
                         "(plant checkpoint-tmp debris); comma-compose "
                         "(needs --ckpt-dir)")
    ap.add_argument("--debug-nans", action="store_true",
                    help="check loss/grad_norm for NaN/inf every step and "
                         "fail fast naming the first offending layer "
                         "(train.metrics.debug_nan_check)")
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
    arch = registry.canon(args.arch)
    if args.bf16 and arch in registry.CNN_ARCHS:
        ap.error("--bf16 covers the LM archs; the CNN archs train in FP32, "
                 "as in the reference")
    if args.calibrate and arch not in registry.CNN_ARCHS:
        ap.error(f"--calibrate covers the CNN archs {registry.CNN_ARCHS}")
    if args.profile and arch not in ("mesh1k", "mesh2k"):
        ap.error("--profile covers the meshnet archs (mesh1k / mesh2k): "
                 "the segmented profiler walks meshnet.layer_fns")
    if args.audit and arch not in ("mesh1k", "mesh2k"):
        ap.error("--audit covers the meshnet archs (mesh1k / mesh2k): the "
                 "collective auditor runs meshnet.loss_fn")
    if args.audit and args.profile:
        ap.error("--audit gates training; --profile trains nothing")
    if (args.chaos or args.elastic) and not args.ckpt_dir:
        ap.error("--chaos and --elastic recover from a checkpoint: give "
                 "--ckpt-dir (it has no default in this port)")
    if args.ckpt_every < 1:
        ap.error("--ckpt-every must be >= 1")
    if args.chaos:
        try:
            chaos.parse(args.chaos, ckpt_dir=args.ckpt_dir, plant=False)
        except ValueError as e:
            ap.error(str(e))
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
    is `core.calibrate.detect_mem_capacity`: the card's memory
    (`torch.cuda.mem_get_info`); on the CPU the host's available memory
    shared among the `ranks` processes (the reference's host
    fallback)."""
    if value is None:
        return None
    if str(value).lower() != "auto":
        return float(value)
    from repro_torch.core.calibrate import detect_mem_capacity
    return detect_mem_capacity(device, ranks)


def plan_shape(args: argparse.Namespace) -> dict[str, int]:
    """The mesh shape the plan is solved for ({"data": 1, "model": 1} on
    one device), as the reference's mesh names it."""
    shape = {"pod": args.pod, "data": args.data, "model": args.model}
    if args.pod == 1:
        del shape["pod"]
    return shape


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
    shape = plan_shape(args)
    machine = H100 if device.type == "cuda" else LASSEN
    where = "the H100 preset" if device.type == "cuda" else \
        "LASSEN (the paper's machine; the CPU has no preset)"
    table, cal = None, None
    if args.calibrate and args.strategy != "auto":
        if echo:
            print(f"--calibrate only feeds the --strategy auto solve; "
                  f"skipping calibration for --strategy {args.strategy}")
    elif args.calibrate:
        from repro_torch.core import calibrate as calib
        t0 = time.time()
        # --no-cf: no time spent on shapes the solve may not pick
        cal = calib.load_or_run(args.calibrate, specs,
                                mesh if mesh is not None else shape,
                                allow_channel_filter=not args.no_cf,
                                device=device)
        machine, table = cal.machine, cal.table
        where = f"the calibration {args.calibrate} ({cal.machine.name})"
        if echo:
            print(f"calibration ready ({time.time() - t0:.2f}s, "
                  f"{len(cal.table)} table entries, fingerprint "
                  f"{cal.fingerprint})")
    mem_limit = parse_mem_limit(args.mem_limit, device,
                                1 if mesh is None else mesh.size)
    if args.strategy == "auto":
        t0 = time.time()
        if mem_limit and echo:
            print(f"memory limit: {human_bytes(mem_limit)}/device")
        kw = dict(table=table, allow_channel_filter=not args.no_cf,
                  mem_limit=mem_limit, search=args.search)
        plan = plan_lib.plan_line(machine, specs, shape, **kw) \
            if graph is None else \
            plan_lib.plan_graph(machine, graph, specs, shape, **kw)
        if cal is not None:
            plan.predicted["calibration"] = {"path": args.calibrate,
                                             "fingerprint": cal.fingerprint}
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


def plan_record(args: argparse.Namespace, cfg, plan, device: torch.device,
                mesh=None) -> dict | None:
    """The ``repro/plan@1`` record every checkpoint manifest carries: the
    solved per-layer dists and the solve's inputs (mesh shape, mem_limit,
    config hash, calibration fingerprint), what an elastic restart lowers
    or re-solves on a new mesh (core.plan.plan_from_spec).  None for an
    arch without a plan (the LMs)."""
    if plan is None:
        return None
    calib = (plan.predicted or {}).get("calibration")
    return plan.to_spec(
        plan_shape(args), mem_limit=parse_mem_limit(
            args.mem_limit, device, 1 if mesh is None else mesh.size),
        config_hash=fingerprint(cfg),
        calibration_fingerprint=calib["fingerprint"] if calib else None)


def checkpoint_layout(cfg):
    """(to_ref, from_ref) between the port's param tree and the
    reference's, for `optim.optimizer.state_tree`: the LMs stack their
    layers into the reference's segments; the CNNs' trees are the
    reference's (None, None)."""
    if isinstance(cfg, (meshnet.MeshNetConfig, resnet.ResNetConfig)):
        return None, None
    return (functools.partial(transformer.tree_to_jax, cfg=cfg),
            functools.partial(transformer.tree_from_jax, cfg=cfg))


def run(args: argparse.Namespace) -> dict:
    """Train to step `args.steps` (from the latest checkpoint of
    --ckpt-dir where it has one); returns the config it trained, the
    plan, and for every step run (a rolled-back step runs again) its
    index (`steps`), loss, seconds (batch included) and seconds of its
    batch's wait and copy, the trained params, and `left_at` (the step at
    which this rank left the mesh under --elastic, else None)."""
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
    calib = (plan.predicted or {}).get("calibration") if plan else None
    if calib:
        where += f" calibration={calib['fingerprint']}"
    if lead:
        print(f"arch={cfg.name} params={human_count(n_params)} "
              f"device={device} {where}".rstrip())
    if args.profile:
        return profile(args, cfg, params, mk, device, mesh, plan, lead)

    # what an elastic remesh swaps: the loop's closures read it
    ctx = {"mesh": mesh, "tstep": tstep, "mk": mk, "pf": None, "plan": plan,
           "plan_spec": plan_record(args, cfg, plan, device, mesh),
           "layer_names": meshnet.layer_names(cfg)
           if isinstance(cfg, meshnet.MeshNetConfig) else None}
    to_ref, from_ref = checkpoint_layout(cfg)

    def leaves(state):
        return state_tree(state[0], state[1], to_ref)

    def load(state_like, tree):
        p, o = state_like
        return p, load_state_tree(tree, p, o, from_ref)

    def agree(step):
        """Mesh rank 0's latest step, on every rank (rank 0 broadcasts
        it after its writer's wait)."""
        m = ctx["mesh"]
        return step if m is None else m.broadcast_object(step)

    ck, start = None, 0
    if args.ckpt_dir:
        ck = CheckpointManager(args.ckpt_dir, keep=3, async_save=True,
                               writer=lead)
        latest = agree(ck.latest_step())
        if latest is not None:
            restored, manifest = ck.restore(leaves((params, opt_state)),
                                            latest)
            params, opt_state = load((params, opt_state), restored)
            start = manifest["extra"]["step"]
            rec = manifest.get("plan")
            if lead:
                print(f"resumed from step {start}")
                if rec and rec.get("mesh") and rec["mesh"] != plan_shape(
                        args):
                    print(f"reshard-on-restore: checkpoint recorded mesh "
                          f"{rec['mesh']}, restoring onto "
                          f"{plan_shape(args)} (global arrays re-placed "
                          f"under the current plan)")

    if args.audit:
        audit_gate(args, cfg, mesh, plan, params,
                   pipeline.to_device(mk(start), device), device, lead)

    losses, step_s, data_s, steps = [], [], [], []
    mlog = MetricsLogger(args.metrics if lead else None, echo=lead)

    def make_step():
        def run_step(state, step):
            p, o = state
            t0 = time.perf_counter()
            if ctx["pf"] is None:       # a remesh's new batch factory
                ctx["pf"] = pipeline.Prefetcher(ctx["mk"], start_step=step)
            batch = pipeline.to_device(ctx["pf"].get(step), device)
            data_s.append(time.perf_counter() - t0)    # host wait + copy
            p, o, m = ctx["tstep"](p, o, batch)
            losses.append(float(m["loss"]))      # waits for the step
            step_s.append(time.perf_counter() - t0)
            steps.append(step)
            grad_norm = float(m["grad_norm"])
            if args.debug_nans:
                debug_nan_check(step, {"loss": losses[-1],
                                       "grad_norm": grad_norm}, p,
                                ctx["layer_names"])
            mlog.log_step(step, losses[-1], step_time_s=step_s[-1],
                          samples_per_s=args.batch / step_s[-1],
                          grad_norm=grad_norm,
                          echo=lead and step % args.log_every == 0)
            return (p, o), m
        return run_step

    def remesh(survivors):
        """Elastic restart: rebuild mesh, plan and step on the survivors
        (None on a rank that is not one).  Every rank of the process
        group builds the new mesh (its groups); the survivors re-run
        `build` on it, so --strategy auto re-solves under the same
        --mem-limit, and the batch factory cuts the new mesh's blocks."""
        old = ctx["mesh"]
        if old is None or len(old.members) != dist.get_world_size():
            raise RuntimeError("an elastic remesh needs every rank of the "
                               "process group (a second shrink would need "
                               "the ranks that left)")
        data, model = elastic_factorization(len(survivors),
                                            batch=args.batch)
        if lead:
            print(f"elastic restart: {len(survivors)} survivors -> mesh "
                  f"data={data} model={model}; re-solving plan")
        new_mesh = make_mesh(data=data, model=model, members=survivors) \
            if len(survivors) > 1 else None
        if rank not in survivors:
            return None
        args2 = argparse.Namespace(**{**vars(args), "data": data,
                                      "model": model, "pod": 1})
        cfg2, params2, opt2, loss2, mk2, prec2, plan2 = build(
            args2, device, new_mesh, echo=lead)
        if ctx["pf"] is not None:
            ctx["pf"].close()
        ctx.update(mesh=new_mesh, mk=mk2, pf=None, plan=plan2,
                   tstep=make_train_step(loss2, opt2, TrainStepConfig(
                       grad_accum=args.grad_accum, precision=prec2),
                       mesh=new_mesh),
                   plan_spec=plan_record(args2, cfg2, plan2, device,
                                         new_mesh))
        return make_step, (params2, opt2.init(params2))

    loop = ResilientLoop(ckpt=ck, make_step=make_step,
                         ckpt_every=args.ckpt_every,
                         remesh=remesh if args.elastic else None,
                         metrics=mlog, plan_spec=lambda: ctx["plan_spec"],
                         leaves=leaves, load=load, agree=agree)
    inject = None
    if args.chaos:
        inject = chaos.parse(args.chaos, ckpt_dir=args.ckpt_dir,
                             devices=mesh.members if mesh else [rank],
                             plant=lead)
    mon = StragglerMonitor()
    try:
        ctx["pf"] = pipeline.Prefetcher(mk, start_step=start)
        mlog.log_run(arch=cfg.name, n_params=n_params, device=str(device),
                     batch=args.batch, steps=args.steps,
                     strategy=args.strategy,
                     mesh=dict(mesh.shape) if mesh else None,
                     start_step=start,
                     **({"calibration": calib} if calib else {}))
        (params, opt_state), step, _ = loop.run(
            (params, opt_state), start, args.steps, monitor=mon,
            inject_failure=inject)
        if loop.left_at is None and ck is not None:
            ck.save(step, leaves((params, opt_state)), extra={"step": step},
                    plan=ctx["plan_spec"])
            ck.wait()
        mlog.log_done(step, loss=losses[-1] if losses else None,
                      straggler=mon.stats)
    finally:
        if ctx["pf"] is not None:
            ctx["pf"].close()
        mlog.close()
    if loop.left_at is not None:
        print(f"rank {rank} left the mesh at step {loop.left_at}")
    elif losses and lead:
        print(f"done at step {step}; final loss {losses[-1]:.4f}")
    return {"cfg": cfg, "losses": losses, "step_s": step_s,
            "data_s": data_s, "steps": steps, "n_params": n_params,
            "params": params, "mesh": ctx["mesh"], "plan": ctx["plan"],
            "left_at": loop.left_at, "straggler": mon.stats,
            "checkpoint": None if ck is None else
            {**ck.last_save, "write_s": ck.last_write_s}}


def audit_gate(args: argparse.Namespace, cfg, mesh, plan, params, batch,
               device: torch.device, lead: bool) -> list:
    """--audit: prove costed == executed before spending a single step.

    Lints the built plan and joins its priced collective inventory against
    what one real step of it executes on `params` and this rank's `batch`
    on the run's `device` (`NetworkPlan.audit`); the params are not
    updated.  Every rank joins
    its own record and the error count is the maximum over the ranks, so
    every rank exits alike.  Any error-severity finding aborts the run;
    warnings and infos print and training proceeds."""
    from repro_torch import analysis
    t0 = time.time()
    findings = plan.audit(meshnet.layer_specs(cfg, args.batch), mesh,
                          cfg=cfg, overlap=True, hlo=False, params=params,
                          batch=batch, device=device)
    errs = analysis.error_count(findings)
    if mesh is not None:
        errs = int(mesh.all_max([errs])[0])
    if lead:
        print(f"plan audit: {len(findings)} finding(s), {errs} error(s) "
              f"({time.time() - t0:.1f} s)")
        print(analysis.format_findings(findings))
    if errs:
        raise SystemExit(
            f"--audit: {errs} error-severity finding(s) — the plan's "
            f"costed collectives do not match the executed step; refusing "
            f"to train on it")
    return findings


def profile(args: argparse.Namespace, cfg, params, mk, device, mesh, plan,
            lead: bool) -> dict:
    """--profile: the segmented per-layer measurement instead of training
    (`core.trace.trace_plan` on this rank's block of batch 0), the
    predicted-vs-measured attribution where the plan carries a perf-model
    report (--strategy auto), the StepTrace JSON (attribution in its meta)
    and a Chrome trace beside it, written by rank 0."""
    from repro_torch.core.trace import format_attribution, trace_plan
    batch = pipeline.to_device(mk(0), device)
    t0 = time.time()
    trace = trace_plan(plan, params, batch, cfg=cfg, mesh=mesh, reps=2,
                       rounds=2)
    report = None
    if plan.predicted and "layer_costs" in plan.predicted:
        report = plan.attribution_report(trace)
        trace.meta["attribution"] = report
    if lead:
        print(f"profiled {len(trace.layers)} layers in "
              f"{time.time() - t0:.1f}s (step fwd+bwd "
              f"{trace.step['fwd_bwd_s']*1e3:.3f} ms, layer sum "
              f"{trace.layer_sum_s*1e3:.3f} ms)")
        print(format_attribution(report) if report else
              "no perf-model prediction on this plan (use --strategy auto "
              "for the predicted-vs-measured attribution)")
        trace.save(args.profile)
        chrome = args.profile[:-5] if args.profile.endswith(".json") \
            else args.profile
        trace.save_chrome(chrome + ".chrome.json")
        print(f"wrote {args.profile} and {chrome}.chrome.json")
    return {"cfg": cfg, "trace": trace, "report": report, "plan": plan,
            "mesh": mesh, "params": params}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
