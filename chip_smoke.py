#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card and `nvcc` (CUDA_HOME or /usr/local/cuda).  Phases:

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build every kernel under src/repro_torch/kernels/csrc with nvcc, one
   process per source, all at once; count the HGMMA instructions (wgmma)
   in the conv and attention libraries' SASS and the HMMA instructions
   (mma.sync) in the SSD library's, each of which must be > 0;
3. kernel vs plain: for each distinct conv shape of mesh1k at batch 2, in
   float32 and bfloat16, print the conv's launch plan (path, tile, K
   splits), hold the conv kernel against `conv2d_ref` and the
   autograd Function's dx/dw against autograd through `conv2d_ref`; time
   the kernel, the plain version and one `F.conv2d` call (channels_last,
   TF32 off: the yardstick, never called by the port); compute the bound;
   then the same for the flash-attention kernel at hymba-1.5b's shapes
   (window 1024 and none, each row with its plan, the bf16 ones on
   `wgmma` and held element by element to one bf16 ulp of A + |o32|, and
   the CPU emulation of its tiling, `flash_attention_emulated`, run on
   the same inputs, held against it; yardstick
   `F.scaled_dot_product_attention`) and
   the SSD-chunk kernel at hymba's and mamba2-780m's shapes (each row
   with its plan, the bf16 ones on `mma.sync` and held element by element
   to 2^-7 |y32| + 2^-12 |M|.|xdt|; no yardstick: no one PyTorch call
   computes it), forward and gradients of their autograd Functions;
4. mesh1k: run the trainer's own entry (`launch.train.main`) on
   full-width mesh1k, batch 2, 3 steps; check finite losses and 19 x 3
   conv launches; hold the full-width forward loss of one batch-1 sample
   on the card (kernel) against the same params and sample on the CPU
   (plain versions); profile one more step by kind of device kernel;
   time the §IV-A split's interior-slice copy at a 2-way H shard;
4b. spatial mesh1k: spawn 2 ranks on the one card, joined over gloo
   (the kernels are built before; a rank that fails fails the run): the
   19 convs' parity (each rank's block of y, dx and the summed dw against
   the float64 conv, with the split's kernel calls), the 2-rank
   global-BN loss against one rank's, and 3 training steps through the
   trainer's own entry (`--model 2`): equal losses and params on both
   ranks, 49 conv launches and 59 staged halo messages a step a rank,
   one more step profiled and the gradient all-reduce timed; then 4
   ranks (2 x 2, H x W) for block 1's two conv shapes.  Two processes
   sharing one card over gloo: not a scaling result;
4c. the auto plan, the paper's own loop: solve full-width mesh1k at batch
   2 on data 1 x model 2 with the H100 preset (it must have a CF layer
   and a reshard) and print it with each reshard's bytes; spawn 2 ranks
   on the card over gloo: CF conv parity at conv4_2, conv5_1 and conv6_3 (channel mode at
   chunks 1 and 2, filter mode: each rank's blocks of y, dx and the
   summed dw against the float64 conv, the kernel's plan at each shard
   shape), 3 training steps through the trainer's own entry
   (`--strategy auto`): equal losses and params, the conv launches a step
   the plan derives, the bytes the reshards send; the forward loss of one
   global batch under the plan against 2 gloo CPU ranks' (plain
   versions); one more step profiled, with the host time of the
   `cf_reduce_scatter`, `cf_all_gather` and `reshard` ranges.  Not a
   scaling result either;
4d. ResNet-50, the branchy network: the conv kernel against its plain
   version at the 23 distinct forward conv shapes of full-width ResNet-50
   at batch 32 (53 calls a forward), f32 and bf16, also element by
   element (tests/test_torch_cuda.py's TOL), each row with its plan (path,
   tile, K step, K splits, C/F after padding), kernel, plain and
   `F.conv2d` times and the bound, and their sums over one forward; the
   trainer's own entry on full-width ResNet-50, batch 32, 3 steps (finite
   losses, 53 x 3 conv launches); the forward loss at batch 2 on the
   card against the CPU; one profiled step by kind of kernel, and the
   max-pool alone (time and memory); then `--strategy auto`: the
   §V-C longest-path-first solve on the H100 preset on data 1 x model 2
   (it must have a CF layer and a residual-add reshard), printed with the
   reshards the port executes, 2 ranks spawned on the card over gloo: 3
   trainer steps with equal losses and params, the conv launches and
   staged collectives the plan derives, the reshard bytes its report
   predicts, the forward loss of one global batch under the plan against
   the one-device card loss, one profiled step with its host ranges.  Not
   a scaling result;
4e. the paper's §V calibration loop: 2 ranks spawned on the card over
   gloo run `python -m repro_torch.core.calibrate`'s path for full-width
   mesh1k at batch 2 on data 1 x model 2 (every conv table entry timed on
   the conv kernel: its launches must cover each conv key's 6 calls;
   coverage 1.0; one fingerprint on both ranks), print the fitted
   constants beside the H100 preset's and each table row beside the
   preset's analytic time; the plan solved on the calibration beside the
   preset's, the layers whose kind changed marked; 3 trainer steps under
   `--strategy auto --calibrate` (equal losses and params, the forward
   loss against 2 gloo CPU ranks'); `--profile` of that plan, its
   predicted-vs-measured attribution over all 19 layers; then
   full-width ResNet-50 at batch 32 solved on a table of 64 keys measured
   in this process (no live communication) beside the preset's plan.
   Not a scaling result: 2 processes share one card, and their α/β are
   gloo's through the host, not NVLink's;
4f. resilient training (`--ckpt-dir`, `--chaos`, `--elastic`), every
   forward conv on the kernel: full-width ResNet-50 at batch 32 trained 4
   steps, then 2 with a checkpoint, resumed to 4 (losses within 1e-5 of
   the uninterrupted run's, 53 x 2 conv launches), and trained with
   `--chaos raise@3` (rolled back to step 2, step 3 within 1e-5), with
   the bytes of a checkpoint, the host ms of `save()` and the ms of the
   thread's write; the reference's checkpoint-overhead bench on
   full-width mesh1k at batch 2 (the bare step and the step with one
   async save, interleaved: both medians and their ratio, gating
   nothing); full-width mesh1k on 4 ranks spawned on the card over gloo,
   `--data 2 --model 2 --strategy auto --elastic --chaos kill@5x2`: the
   fault, remesh (2 ranks) and rollback (step 4) records, ranks 2-3
   leaving at 5, the survivors' equal losses, the conv launches each
   plan derives before and after the remesh, and steps 4-5 within 1e-5
   of a 2-rank `--data 1 --model 2` run resumed from a copy of the same
   step-4 checkpoint.  Not a scaling result;
4g. the static-analysis lane: 2 ranks spawned on the card over gloo
   audit full-width mesh1k at batch 2 on data 1 x model 2 under the
   uniform H plan (every layer split over model: halos, the §IV-A split
   pinned both ways) and the H100 auto plan (CF layers, reshards): each
   plan linted and one real step of it (forward, backward, the gradient
   bucket) recorded and joined against the priced inventory
   (`repro_torch.analysis`), with the findings table, the recorded ops by
   kind and direction, the gradient bucket's bytes against the priced
   weight gradients', the audited step's host seconds and its conv
   launches (the plan's forward calls); one layer's backward timed with
   and without the split; then `python -m repro_torch.launch.dryrun
   --audit` on 4 ranks over the six bench workloads (its tables in
   build/audit/dryrun.log).  Any error finding fails the phase;
5. hymba-1.5b: the same entry at full width and depth, batch 1 x seq
   2048, 3 steps, FP32 and then `--bf16`: each with finite losses and
   32 x 3 launches of each LM kernel;
   the forward loss of a 4-layer full-width hymba (layer types g, s, g, g)
   at seq 1280 on the card against the CPU; one profiled step and the
   SSD's inter-chunk recurrence timed alone, with its launches per layer;
6. print every kernel's registers, static shared memory and spills (the
   ptxas report), the HGMMA counts, the `kernels` JSON line and, last, the
   `ok` JSON line.

Each launch count is read from a run that starts with every count at 0.
Any failed phase raises and the script exits non-zero.  Per-shape rows go
to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.checkpoint.checkpoint import CheckpointManager  # noqa
from repro_torch.configs import hymba_1_5b  # noqa: E402
from repro_torch.core import calibrate, channel_conv  # noqa: E402
from repro_torch.core import collectives, halo, perfmodel  # noqa: E402
from repro_torch.core import plan as plan_lib  # noqa: E402
from repro_torch.core import trace as trace_lib  # noqa: E402
from repro_torch.core.perfmodel import H100  # noqa: E402
from repro_torch.core.spatial_conv import (  # noqa: E402
    ConvSharding, conv_calls, spatial_conv2d, split_rows)
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import conv2d as kconv  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import ssd as kssd  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    conv2d_ref, flash_attention_ref, ssd_chunked_ref)
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_mesh  # noqa: E402
from repro_torch.models.cnn import layers as cnn_layers  # noqa: E402
from repro_torch.models.cnn import meshnet, resnet  # noqa: E402
from repro_torch.models.lm import modules as lm_modules  # noqa: E402
from repro_torch.models.lm import transformer  # noqa: E402
from repro_torch.optim.optimizer import (  # noqa: E402
    adamw, sgd, state_tree)
from repro_torch.train.train_loop import (  # noqa: E402
    TrainStepConfig, make_train_step, reduce_replicated_grads)
from repro_torch.utils import (  # noqa: E402
    FP32, interleaved_samples, same_pads, time_fn, tree_leaves, tree_map)

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_FLOPS = {torch.float32: 67e12,     # fp32 on the CUDA cores
              torch.bfloat16: 989e12}   # bf16 on the tensor cores
PEAK_BYTES_S = 3.35e12                  # HBM3
BATCH, STEPS = 2, 3
# kernel vs plain, both fp32-accumulated, the max |difference| over the
# output relative to the output's largest magnitude: sums of up to
# K*K*C = 4608 products in another order (f32), or one bf16 rounding of
# the result that may land on the neighbouring value (bf16: 2^-7)
FWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# dx/dw: cuDNN's gradients against autograd through the plain version,
# reductions over up to N*H*W = 524288 terms (bf16: rounded results)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# full-width forward loss, card vs CPU: fp32 through 19 conv-BN-ReLU
# layers whose sums run in another order on each
LOSS_RTOL = 1e-4
# the spatial path: each rank's block of the conv output, dx and dw (summed
# over the ranks) against the same conv in float64 on the card, over the
# largest magnitude (tests/test_torch_cuda.py's tolerances: f32 sums in
# the kernel's order, cuDNN's gradients over other extents; the
# one-process f32 conv's errors are printed beside); the 2-rank global-BN
# loss against one rank's at LOSS_RTOL
SPATIAL_FWD_TOL, SPATIAL_BWD_TOL = 2e-5, 1e-4
SPATIAL_MODEL = 2
# attention / SSD kernel vs plain, max |difference| over the largest
# output magnitude: f32 sums of up to 2048 keys x 64 dims (attention) or
# cl x n products (SSD) in another order; bf16 one rounding of the output
# that may land on the neighbouring value.  S is fp32 for both dtypes.
LM_FWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# their autograd Functions' gradients: the backward recomputes through
# the plain version, so only the order of the reductions may differ
LM_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# bf16 attention, element by element as well: the kernel rounds each P to
# bf16 (relative error <= 2^-8) and its output once (<= 2^-8 |o|), so
# |o - o32| <= 2^-8 (A + |o32|), where o32 is the plain version in fp32 on
# the same bf16 inputs and A = softmax(S).|v| (both by `attention_limit`).
# The limit is twice that, one bf16 ulp of A + |o32|: unlike LM_FWD_TOL,
# which scales with the largest output, it sees a key tile gone astray in
# a row that averages over a thousand keys.
ATTN_ELEM_ULP = 2.0 ** -7
HYMBA = hymba_1_5b.CONFIG
LM_BATCH, LM_SEQ = 1, 2048
# the 4-layer full-width forward loss, card vs CPU: fp32 through four
# hybrid blocks whose sums (up to 6400 products) run in another order
LM_LOSS_RTOL = 1e-4
# the 4-layer full-width forward check: types g, s, g, g and a sequence
# longer than the 1024 window, a multiple of the SSD chunk
CHECK_LAYERS, CHECK_SEQ = 4, 1280


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def sass_count(lib, opcode: str) -> int:
    """How many `opcode` instructions cuobjdump finds in the SASS of the
    built library `lib`."""
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return sum(opcode in line for line in sass.splitlines())


def ptxas_resources(name: str, log: str) -> list[str]:
    """One line per kernel of an `nvcc -Xptxas -v` log: its registers,
    static shared memory (the dynamic ring is not in the log) and
    spills."""
    kernels, out, spill = [], [], ""
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            kernels.append(m.group(1))
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spill = f"spills {m.group(1)} / {m.group(2)} bytes"
        elif (m := re.search(r"Used (\d+) registers(?:.*?(\d+) bytes "
                             r"smem)?", line)) and kernels:
            out.append([kernels[-1], f"{m.group(1)} registers, "
                        f"{m.group(2) or 0} bytes static shared memory, "
                        f"{spill}"])
    filt = shutil.which("c++filt")
    if filt and out:
        names = subprocess.run([filt], input="\n".join(k for k, _ in out),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        for row, nm in zip(out, names):
            row[0] = nm.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("(")[0]
    return [f"  {name}: {k}: {v}" for k, v in out]


def mesh_conv_shapes(cfg) -> list[dict]:
    """The distinct conv calls of one forward, in order, with how many of
    the cfg's layers make each: padded input (N, H, W, C), K, F, stride."""
    shapes: dict[tuple, dict] = {}
    c, hw = cfg.in_channels, cfg.input_hw
    layers = []
    for width in cfg.widths:
        for i in range(cfg.convs_per_block):
            s = 2 if i == 0 else 1
            layers.append((c, hw, width, 3, s))
            hw //= s
            c = width
    layers.append((c, hw, cfg.n_classes, 1, 1))
    names = meshnet.layer_names(cfg)
    for name, (c, hw, f, k, s) in zip(names, layers):
        lo, hi = same_pads(k, s)
        key = (BATCH, hw + lo + hi, hw + lo + hi, c, k, f, s)
        if key not in shapes:
            shapes[key] = {"layer": name, "x": key[:4], "k": k, "f": f,
                           "stride": s, "count": 0}
        shapes[key]["count"] += 1
    return list(shapes.values())


def _check_close(what: str, got: torch.Tensor, want: torch.Tensor,
                 tol: float) -> float:
    """max |got - want|, which must be within tol x max(1, max |want|)."""
    want = want.float()
    err = float((got.float() - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    if not err <= tol * scale:
        raise AssertionError(f"{what}: max |err| {err} > {tol} * {scale}")
    return err


def _timings(fn_kernel, fn_plain, fn_library, flops: float, nbytes: float,
             dtype: torch.dtype) -> dict:
    """Kernel, plain and library times (CUDA events, trimmed mean of 10
    after 2 warmups) and the bound: max(FLOPs / peak, bytes / 3.35 TB/s)."""
    kernel_s = time_fn(fn_kernel, reps=10, warmup=2)
    plain_s = time_fn(fn_plain, reps=10, warmup=2)
    library_s = None if fn_library is None else \
        time_fn(fn_library, reps=10, warmup=2)
    ops_s, bytes_s = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_S
    return {"ms": kernel_s * 1e3, "plain_ms": plain_s * 1e3,
            "library_ms": None if library_s is None else library_s * 1e3,
            "bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "ops_ms": ops_s * 1e3, "bytes_ms": bytes_s * 1e3,
            "gflops": flops / 1e9, "tflops_s": flops / kernel_s / 1e12}


def check_shape(sh: dict, dtype: torch.dtype, gen: torch.Generator,
                elem_tol: dict | None = None) -> dict:
    dev = torch.device("cuda")
    n, hp, wp, c = sh["x"]
    k, f, s = sh["k"], sh["f"], sh["stride"]
    lo, hi = same_pads(k, s)
    x = torch.randn((n, hp - lo - hi, wp - lo - hi, c), generator=gen,
                    device=dev).to(dtype)
    xp = F.pad(x, (0, 0, lo, hi, lo, hi))
    w = (torch.randn((k, k, c, f), generator=gen, device=dev)
         * math.sqrt(2.0 / (k * k * c))).to(dtype)

    y = kconv.conv2d(xp, w, stride=s)
    yr = conv2d_ref(xp, w, stride=s)
    torch.cuda.synchronize()
    err = float((y.float() - yr.float()).abs().max())
    scale = max(1.0, float(yr.float().abs().max()))
    if not err <= FWD_TOL[dtype] * scale:
        # say which side is off: both against the library's conv
        lib = F.conv2d(xp.permute(0, 3, 1, 2).float(),
                       w.permute(3, 2, 0, 1).float(), stride=s) \
            .permute(0, 2, 3, 1)
        raise AssertionError(
            f"{sh['layer']} {dtype}: kernel vs plain max |err| {err} > "
            f"{FWD_TOL[dtype]} * {scale}; max |x| {xp.abs().max()}, "
            f"|w| {w.abs().max()}, |kernel - library| "
            f"{(y.float() - lib).abs().max()}, |plain - library| "
            f"{(yr.float() - lib).abs().max()}")
    if elem_tol is not None:
        # element by element as well: |kernel - plain| <= tol (1 + |plain|)
        tol = elem_tol[dtype]
        worst = float(((y.float() - yr.float()).abs()
                       / (1.0 + yr.float().abs())).max())
        if not worst <= tol:
            raise AssertionError(f"{sh['layer']} {dtype}: kernel vs plain "
                                 f"element error {worst} > {tol} (1 + "
                                 f"|plain|)")

    # the autograd Function (kernel forward, cuDNN backward) vs autograd
    # through the plain version, through one random cotangent
    g = torch.randn(y.shape, generator=gen, device=dev).to(dtype)
    grads = []
    for fwd in (lambda a, b: kconv.Conv2d.apply(a, b, s),
                lambda a, b: conv2d_ref(a, b, stride=s)):
        a = xp.detach().requires_grad_()
        b = w.detach().requires_grad_()
        (fwd(a, b).float() * g.float()).sum().backward()
        grads.append((a.grad, b.grad))
    for nm, got, want in zip(("dx", "dw"), *grads):
        _check_close(f"{sh['layer']} {dtype}: {nm}", got, want,
                     BWD_TOL[dtype])
    del grads

    x_nchw = xp.permute(0, 3, 1, 2)            # channels_last view
    w_oihw = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    p = kconv.plan(tuple(xp.shape), tuple(w.shape), s, dtype)
    row = {"layer": sh["layer"], "dtype": str(dtype).split(".")[-1],
           "x": list(sh["x"]), "k": k, "f": f, "stride": s,
           "count": sh["count"], "max_abs_err": err,
           "plan": dataclasses.asdict(p)}
    row.update(_timings(
        lambda: kconv.conv2d(xp, w, stride=s),
        lambda: conv2d_ref(xp, w, stride=s),
        lambda: F.conv2d(x_nchw, w_oihw, stride=s),
        2.0 * n * y.shape[1] * y.shape[2] * f * k * k * c,
        (xp.numel() + w.numel() + y.numel()) * xp.element_size(), dtype))
    return row


def kernel_phase(card: str, shapes=None, elem_tol=None) -> list[dict]:
    """Kernel-vs-plain rows (`check_shape`) of every conv shape in
    `shapes` (default: mesh1k's at batch 2), float32 then bfloat16."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = shapes or mesh_conv_shapes(meshnet.MESH1K)
    rows = []
    print(f"{'layer':15s} {'dtype':8s} {'x (N,H,W,C)':22s} {'k':>2s} "
          f"{'F':>4s} {'s':>2s} {'n':>2s} {'path tile k splits C/F':29s} "
          f"{'kernel_ms':>10s} "
          f"{'plain_ms':>9s} {'library_ms':>10s} {'bound_ms':>9s} "
          f"{'TFLOP/s':>8s} {'max_err':>9s}   ({card})")
    for dtype in (torch.float32, torch.bfloat16):
        for sh in shapes:
            r = check_shape(sh, dtype, gen, elem_tol)
            rows.append(r)
            p = r["plan"]
            plan = f"{p['path']} {p['tile_m']}x{p['tile_n']} " \
                f"k{p['tile_k']} {p['splits']} {p['c_pad']}/{p['f_pad']}"
            print(f"{r['layer']:15s} {r['dtype']:8s} "
                  f"{str(tuple(r['x'])):22s} "
                  f"{r['k']:2d} {r['f']:4d} {r['stride']:2d} "
                  f"{r['count']:2d} {plan:29s} {r['ms']:10.4f} "
                  f"{r['plain_ms']:9.4f} "
                  f"{r['library_ms']:10.4f} {r['bound_ms']:9.4f} "
                  f"{r['tflops_s']:8.2f} {r['max_abs_err']:9.2e}",
                  flush=True)
            torch.cuda.empty_cache()
    return rows


def train_phase() -> dict:
    ops.reset_launch_counts()
    res = train_cli.main(["--arch", "mesh1k", "--batch", str(BATCH),
                          "--steps", str(STEPS), "--device", "cuda",
                          "--log-every", "1"])
    launches = ops.launch_counts()["conv2d"]
    n_convs = len(meshnet.layer_names(meshnet.MESH1K))
    if not all(math.isfinite(l) for l in res["losses"]):
        raise AssertionError(f"non-finite loss: {res['losses']}")
    if launches != n_convs * STEPS:
        raise AssertionError(f"conv kernel launched {launches} times in "
                             f"{STEPS} steps, want {n_convs} x {STEPS}")
    steady = res["step_s"][1:]
    step_s = sum(steady) / len(steady)
    compute = [t - d for t, d in zip(res["step_s"], res["data_s"])][1:]
    compute_s = sum(compute) / len(compute)
    print(f"train: {STEPS} steps of full-width mesh1k at batch {BATCH}; "
          f"losses {res['losses']}; step seconds {res['step_s']} "
          f"(batch wait + copy {res['data_s']}); steps 2..{STEPS}: "
          f"{step_s:.4f} s/step, {BATCH / step_s:.3f} samples/s; without "
          f"the batch wait {compute_s:.4f} s/step, "
          f"{BATCH / compute_s:.3f} samples/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"conv launches {launches}")
    return {"launches": launches, "losses": res["losses"],
            "step_s": res["step_s"], "data_s": res["data_s"],
            "steady_step_s": step_s, "steady_compute_s": compute_s}


def _annotation(e) -> bool:
    """Whether a profiler event is a `record_function` range's span on
    the device timeline (a layer or a named region, `core.trace`), not a
    kernel: its time is its kernels', counted already."""
    return bool(getattr(e, "is_user_annotation", False))


def _device_breakdown(run_step, classify) -> tuple[float, dict, int]:
    """One call of `run_step` (which must end in a device sync) under
    torch.profiler: (host ms, {group: device ms}, device kernels), each
    kernel's time added to the group `classify(name.lower())` gives."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict[str, float] = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or _annotation(e):
            continue
        n_kernels += 1
        g = classify(e.name.lower())
        groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us() / 1e3
    return wall_ms, groups, n_kernels


def cnn_kind(name: str) -> str:
    """The kind of a CNN step's device kernel, by its lower-case name."""
    if "repro_conv2d" in name:
        return "conv2d kernel (forward, split-K sums included)"
    if any(t in name for t in ("cudnn", "xmma", "dgrad", "wgrad", "conv",
                               "gemm", "cutlass")):
        return "library conv (dgrad/wgrad)"
    return "other"


def profile_phase() -> dict:
    """Device time of one full-width training step (batch 2, batch already
    on the card) by kind of kernel, from torch.profiler's CUDA events."""
    cfg, dev = meshnet.MESH1K, torch.device("cuda")
    model = meshnet.MeshNet(cfg, generator=torch.Generator().manual_seed(0),
                            device=dev)
    params = model.params()
    opt = sgd(0.0, momentum=0.9)
    step = make_train_step(functools.partial(meshnet.loss_fn, cfg=cfg), opt,
                           TrainStepConfig(precision=FP32))
    state = opt.init(params)
    batch = pipeline.to_device(pipeline.synthetic_mesh_batch(
        0, BATCH, cfg.input_hw, cfg.in_channels, out_hw=cfg.out_hw), dev)
    params, state, m = step(params, state, batch)     # warm

    def run_step():
        float(step(params, state, batch)[2]["loss"])

    wall_ms, groups, n_kernels = _device_breakdown(run_step, cnn_kind)
    busy = sum(groups.values())
    if n_kernels == 0:
        print("step breakdown: the profiler saw no device kernels "
              "(not measured)")
        return {"wall_ms": wall_ms, "device_ms": None}
    print(f"step breakdown (one step, batch 2 on the card, host clock "
          f"{wall_ms:.2f} ms): device kernels {busy:.2f} ms, idle share "
          f"{1 - busy / wall_ms:.3f}; " + "; ".join(
              f"{k} {v:.2f} ms" for k, v in groups.items()))
    return {"wall_ms": wall_ms, "device_ms": busy, "groups": groups,
            "n_kernels": n_kernels}


def forward_check() -> dict:
    """Full-width forward loss of one batch-1 sample: card vs CPU."""
    cfg = meshnet.MESH1K
    nb = pipeline.synthetic_mesh_batch(0, 1, cfg.input_hw, cfg.in_channels,
                                       out_hw=cfg.out_hw)
    out = {}
    with torch.no_grad():
        for dev in ("cuda", "cpu"):
            d = torch.device(dev)
            model = meshnet.MeshNet(cfg, generator=torch.Generator()
                                    .manual_seed(0), device=d)
            b = pipeline.to_device(nb, d)
            t0 = time.perf_counter()
            logits = model(b["image"])
            out[dev] = (float(meshnet.bce_loss(logits, b["label"])),
                        logits.float().cpu())
            out[dev + "_s"] = time.perf_counter() - t0
            del model, b
    (lg, yg), (lc, yc) = out["cuda"], out["cpu"]
    rel = abs(lg - lc) / abs(lc)
    dlogit = float((yg - yc).abs().max())
    print(f"forward check, batch 1: loss card {lg!r} cpu {lc!r} rel diff "
          f"{rel:.3e} (tol {LOSS_RTOL}); max |logit diff| {dlogit:.3e}")
    if not (math.isfinite(lg) and rel <= LOSS_RTOL):
        raise AssertionError(f"card loss {lg} vs cpu loss {lc}: rel {rel}")
    return {"loss_cuda": lg, "loss_cpu": lc, "rel_diff": rel,
            "max_logit_diff": dlogit}


# ------------------------------------------------------- spatial path --

def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank_entry(rank: int, world: int, port: int, fn, out_dir: str,
                args: tuple) -> None:
    """One spawned rank on cuda:0: join the gloo group, run fn(rank, world,
    *args), write its dict to out_dir/rank<r>.json."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, *args) -> list[dict]:
    """fn(rank, world, *args) in `world` processes spawned on the one card,
    one gloo group on a free port; each rank's returned dict.  The kernels
    are built before (the ranks load the cached libraries); a rank that
    raises fails the run."""
    import torch.multiprocessing as mp
    out_dir = os.path.join(HERE, "build", "spatial")
    os.makedirs(out_dir, exist_ok=True)
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.json")
        if os.path.exists(path):
            os.remove(path)
    torch.cuda.empty_cache()
    mp.spawn(_rank_entry, args=(world, _free_port(), fn, out_dir, args),
             nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _block(t: torch.Tensor, mesh, sh: ConvSharding) -> torch.Tensor:
    """This rank's H (and W) block of a global NHWC tensor."""
    for dim, axis in ((1, sh.h_axis), (2, sh.w_axis)):
        if axis is not None:
            t = pipeline.shard_dim(t, dim, mesh, axis)
    return t


def _conv_f64(x: torch.Tensor, w: torch.Tensor, s: int) -> torch.Tensor:
    """The SAME conv in float64 (`F.conv2d` on NCHW / OIHW views of the
    padded input; `conv2d_ref` sums in fp32): the exact reference the f32
    paths are held against."""
    pads = same_pads(w.shape[0], s)
    xp = F.pad(x, (0, 0) + pads + pads).permute(0, 3, 1, 2)
    return F.conv2d(xp, w.permute(3, 2, 0, 1), stride=s).permute(0, 2, 3, 1)


def conv_parity(mesh, sh: ConvSharding, layers) -> list[dict]:
    """At each of `layers` (meshnet.layer_geometry rows), batch 2, f32:
    this rank's spatial_conv2d (overlap=True) of its block, dx and dw
    (summed over the ranks), each against the same conv in float64 on the
    card; the one-process spatial_conv2d's errors against it beside (two
    f32 orders of a reduction over up to 524288 terms differ by about
    1e-4 of the largest dw, so each is held to the exact value); with
    the kernel launches of the spatial call."""
    dev, rows = torch.device("cuda"), []
    split = sh.h_axis if sh.w_axis is None else sh.w_axis   # the conv's
    for li, (name, c, hw, f, k, s) in layers:
        gen = torch.Generator(device=dev).manual_seed(100 + li)
        x = torch.randn((BATCH, hw, hw, c), generator=gen, device=dev)
        w = torch.randn((k, k, c, f), generator=gen, device=dev) \
            * math.sqrt(2.0 / (k * k * c))
        g = torch.randn((BATCH, hw // s, hw // s, f), generator=gen,
                        device=dev)
        grads = []
        for dt, fn in ((torch.float32, lambda a, b: spatial_conv2d(
                a, b, strides=(s, s), sharding=ConvSharding())),
                       (torch.float64, lambda a, b: _conv_f64(a, b, s))):
            a = x.to(dt, copy=True).requires_grad_()
            b = w.to(dt, copy=True).requires_grad_()
            y_ = fn(a, b)
            (y_ * g.to(dt)).sum().backward()
            grads.append((y_.detach(), a.grad, b.grad))
            del a, b, y_
        (y32, dx32, dw32), (y64, dx64, dw64) = grads
        xl = _block(x, mesh, sh).contiguous().requires_grad_()
        wl = w.clone().requires_grad_()
        before = kconv.conv2d.launches
        y = spatial_conv2d(xl, wl, strides=(s, s), sharding=sh, mesh=mesh,
                           overlap=True)
        calls = kconv.conv2d.launches - before
        (y * _block(g, mesh, sh)).sum().backward()
        dw = reduce_replicated_grads([wl.grad], mesh)[0]
        torch.cuda.synchronize()
        what = f"spatial conv {name} rank {mesh.rank}"
        row = {"layer": name, "x": [BATCH, hw, hw, c], "k": k, "f": f,
               "stride": s, "calls": calls,
               "want_calls": conv_calls(hw // mesh.axis_size(split), k, s)}
        for nm, got, one, exact, tol in (
                ("y", y.detach(), _block(y32, mesh, sh),
                 _block(y64, mesh, sh), SPATIAL_FWD_TOL),
                ("dx", xl.grad, _block(dx32, mesh, sh),
                 _block(dx64, mesh, sh), SPATIAL_BWD_TOL),
                ("dw", dw, dw32, dw64, SPATIAL_BWD_TOL)):
            row[f"err_{nm}"] = _check_close(f"{what} {nm}", got, exact, tol)
            row[f"one_err_{nm}"] = float((one.double() - exact).abs().max())
            row[f"vs_one_{nm}"] = float((got - one).abs().max())
        rows.append(row)
        del x, w, g, grads, y32, dx32, dw32, y64, dx64, dw64, xl, wl, y, dw
    torch.cuda.empty_cache()
    return rows


def spatial_rank(rank: int, world: int) -> dict:
    """One of 2 ranks (data 1 x model 2, H over model) on the card: (a) the
    19 conv-parity rows; (b) the full-width global-BN forward loss against
    one rank's; (c) 3 training steps through the trainer's own entry."""
    mesh = make_mesh(data=1, model=SPATIAL_MODEL)
    sh = ConvSharding(batch_axes=("data",), h_axis="model")
    layers = list(enumerate(meshnet.layer_geometry(meshnet.MESH1K)))
    rows = conv_parity(mesh, sh, layers)

    cfg = dataclasses.replace(meshnet.MESH1K, bn_scope="global")
    dev = torch.device("cuda")
    model = meshnet.MeshNet(cfg, generator=torch.Generator().manual_seed(0),
                            device=dev)
    nb = pipeline.synthetic_mesh_batch(0, BATCH, cfg.input_hw,
                                       cfg.in_channels, out_hw=cfg.out_hw)
    with torch.no_grad():
        part = meshnet.loss_fn(model.params(), pipeline.to_device(
            pipeline.shard_batch(nb, mesh, sh), dev), cfg, sh, mesh)
        loss_ranks = float(mesh.all_reduce(part, mesh.axis_names))
        loss_one = float(meshnet.loss_fn(model.params(), pipeline.to_device(
            nb, dev), cfg)) if rank == 0 else None
    del model
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    halo.reset_staged()
    res = train_cli.main(["--arch", "mesh1k", "--batch", str(BATCH),
                          "--steps", str(STEPS), "--model",
                          str(SPATIAL_MODEL), "--device", "cuda",
                          "--log-every", "1"])
    launches, staged = ops.launch_counts()["conv2d"], halo.staged
    collectives_staged = res["mesh"].staged
    breakdown = spatial_step_breakdown(res["params"], res["mesh"], sh)
    return {"conv_rows": rows, "loss_ranks": loss_ranks,
            "breakdown": breakdown,
            "loss_one": loss_one, "losses": res["losses"],
            "step_s": res["step_s"], "data_s": res["data_s"],
            "launches": launches, "staged": staged,
            "collectives_staged": collectives_staged,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "digest": [float(p.detach().double().sum())
                       for p in tree_leaves(res["params"])]}


def spatial_step_breakdown(params, mesh, sh: ConvSharding) -> dict:
    """One more training step of this rank (batch already on the card, lr
    0) under torch.profiler, by kind of device kernel; and the gradient
    all-reduce alone (the flat fp32 buffer of every param through gloo),
    host clock around synchronised calls, the mean of 3."""
    cfg, dev = meshnet.MESH1K, torch.device("cuda")
    opt = sgd(0.0, momentum=0.9)
    step = make_train_step(functools.partial(
        meshnet.loss_fn, cfg=cfg, plan=sh, mesh=mesh), opt,
        TrainStepConfig(precision=FP32), mesh=mesh)
    state = opt.init(params)
    batch = pipeline.to_device(pipeline.shard_batch(
        pipeline.synthetic_mesh_batch(0, BATCH, cfg.input_hw,
                                      cfg.in_channels, out_hw=cfg.out_hw),
        mesh, sh), dev)
    float(step(params, state, batch)[2]["loss"])        # warm

    def run_step():
        float(step(params, state, batch)[2]["loss"])
    wall_ms, groups, n_kernels = _device_breakdown(run_step, cnn_kind)
    grads = [torch.ones_like(p) for p in tree_leaves(params)]
    reduce_replicated_grads(grads, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        reduce_replicated_grads(grads, mesh)
    torch.cuda.synchronize()
    return {"wall_ms": wall_ms, "groups": groups, "n_kernels": n_kernels,
            "device_ms": sum(groups.values()),
            "grad_all_reduce_ms": (time.perf_counter() - t0) / 3 * 1e3,
            "grad_mb": sum(g.numel() for g in grads) * 4 / 1e6}


def spatial_hw_rank(rank: int, world: int) -> dict:
    """One of 4 ranks (data 2 x model 2; H over model, W over data): the
    conv-parity rows of block 1's stride-2 and stride-1 layers."""
    mesh = make_mesh(data=2, model=2)
    sh = ConvSharding(batch_axes=(), h_axis="model", w_axis="data")
    layers = list(enumerate(meshnet.layer_geometry(meshnet.MESH1K)))[:2]
    return {"conv_rows": conv_parity(mesh, sh, layers)}


def interior_copy_phase(card: str) -> dict:
    """What the §IV-A split's interior slice costs at a 2-way H shard of
    every mesh1k layer, batch 2, f32: the slice of a contiguous NHWC block
    is not contiguous (N > 1), and its W padding copies it into the
    contiguous tensor the kernel takes.  Times that pad (what the port
    does), the same pad of a contiguous tensor of the slice's shape, and
    the interior conv kernel (CUDA events, one process)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    tot = {"pad_slice_ms": 0.0, "pad_contig_ms": 0.0, "kernel_ms": 0.0}
    for name, c, hw, f, k, s in meshnet.layer_geometry(meshnet.MESH1K):
        lo, hi = same_pads(k, s)
        if lo == hi == 0:
            continue
        hl = hw // SPATIAL_MODEL
        x = torch.randn((BATCH, hl, hw, c), generator=gen, device=dev)
        w = torch.randn((k, k, c, f), generator=gen, device=dev)
        t_lo, i_hi, _ = split_rows(hl, k, s, lo)
        start = t_lo * s - lo
        inner = x.narrow(1, start, (i_hi - 1) * s - lo + k - start)
        dense = inner.contiguous()
        pad = (0, 0) + same_pads(k, s)
        xp = F.pad(inner, pad)
        tot["pad_slice_ms"] += time_fn(lambda: F.pad(inner, pad), reps=10,
                                       warmup=2) * 1e3
        tot["pad_contig_ms"] += time_fn(lambda: F.pad(dense, pad), reps=10,
                                        warmup=2) * 1e3
        tot["kernel_ms"] += time_fn(lambda: kconv.conv2d(xp, w, stride=s),
                                    reps=10, warmup=2) * 1e3
        del x, w, inner, dense, xp
    torch.cuda.empty_cache()
    print(f"interior slice copy, mesh1k at a {SPATIAL_MODEL}-way H shard, "
          f"batch {BATCH}, f32, 18 halo layers summed: pad of the "
          f"non-contiguous slice {tot['pad_slice_ms']:.4f} ms, pad of a "
          f"contiguous tensor of its shape {tot['pad_contig_ms']:.4f} ms, "
          f"interior conv kernels {tot['kernel_ms']:.4f} ms ({card})")
    return tot


def spatial_phase(card: str) -> dict:
    """The sample x spatial path as 2 and 4 processes sharing the one card
    over gloo (halos staged through the host): not a scaling result."""
    ranks = spawn_ranks(spatial_rank, SPATIAL_MODEL)
    hw4 = spawn_ranks(spatial_hw_rank, 4)
    geo = meshnet.layer_geometry(meshnet.MESH1K)
    print(f"spatial conv parity, f32, batch {BATCH}, overlap (interior / "
          f"boundary split): max |error| of each rank's block of y, dx and "
          f"dw (summed over the ranks) against the conv in float64 on the "
          f"card, and in brackets the one-process f32 conv's ({card}):")
    print(f"{'ranks':6s} {'layer':8s} {'x (N,H,W,C)':22s} {'k':>2s} {'s':>2s} "
          f"{'calls':>5s} {'err y':>20s} {'err dx':>20s} {'err dw':>20s}")
    for tag, runs in (("2 H", ranks), ("2x2 HW", hw4)):
        for i, row in enumerate(runs[0]["conv_rows"]):
            rs = [r["conv_rows"][i] for r in runs]
            for r in rs:
                if r["calls"] != r["want_calls"]:
                    raise AssertionError(f"{tag} {r['layer']}: {r['calls']} "
                                         f"conv launches, want "
                                         f"{r['want_calls']}")
            errs = " ".join(
                f"{max(r[f'err_{n}'] for r in rs):9.2e} "
                f"({max(r[f'one_err_{n}'] for r in rs):8.2e})"
                for n in ("y", "dx", "dw"))
            print(f"{tag:6s} {row['layer']:8s} {str(tuple(row['x'])):22s} "
                  f"{row['k']:2d} {row['stride']:2d} {row['calls']:5d} "
                  f"{errs}", flush=True)
    if len(ranks[0]["conv_rows"]) != len(geo) or len(hw4[0]["conv_rows"]) \
            != 2:
        raise AssertionError("spatial conv parity rows missing")

    lo_, l1 = ranks[0]["loss_ranks"], ranks[0]["loss_one"]
    rel = abs(lo_ - l1) / abs(l1)
    print(f"spatial forward check, full-width mesh1k, global BN, batch "
          f"{BATCH}: loss on {SPATIAL_MODEL} ranks {lo_!r} "
          f"({ranks[1]['loss_ranks']!r} on rank 1), one rank {l1!r}, rel "
          f"diff {rel:.3e} (tol {LOSS_RTOL}) ({card})")
    if not (math.isfinite(lo_) and rel <= LOSS_RTOL
            and ranks[1]["loss_ranks"] == lo_):
        raise AssertionError(f"spatial loss {lo_} vs one rank {l1}")

    # conv launches a step: the interior plus a top block where lo > 0 and
    # a bottom block where hi > 0 (spatial_conv.conv_calls); halo messages
    # through the host a step: on 2 ranks each sends or receives one per
    # halo width that is not 0, forward, and again backward except at the
    # first layer, whose input needs no gradient
    per_step = sum(conv_calls(hw // SPATIAL_MODEL, k, s)
                   for _, _, hw, _, k, s in geo)
    halo_step = sum(((same_pads(k, s)[0] > 0) + (same_pads(k, s)[1] > 0))
                    * (1 if i == 0 else 2)
                    for i, (_, _, _, _, k, s) in enumerate(geo))
    for r, out in enumerate(ranks):
        if out["losses"] != ranks[0]["losses"] or \
                out["digest"] != ranks[0]["digest"]:
            raise AssertionError(f"rank {r} diverged: losses "
                                 f"{out['losses']} vs {ranks[0]['losses']}")
        if not all(math.isfinite(x) for x in out["losses"]):
            raise AssertionError(f"non-finite loss: {out['losses']}")
        if out["launches"] != per_step * STEPS:
            raise AssertionError(f"rank {r}: {out['launches']} conv launches "
                                 f"in {STEPS} steps, want {per_step} x "
                                 f"{STEPS}")
        if out["staged"] != halo_step * STEPS:
            raise AssertionError(f"rank {r}: {out['staged']} staged halo "
                                 f"messages, want {halo_step} x {STEPS}")
        steady = out["step_s"][1:]
        print(f"spatial train rank {r}/{SPATIAL_MODEL} (2 processes sharing "
              f"one card over gloo: not a scaling result): full-width "
              f"mesh1k, global batch {BATCH}, uniform plan, losses "
              f"{out['losses']}; step seconds {out['step_s']} (batch wait "
              f"+ copy {out['data_s']}); steps 2..{STEPS}: "
              f"{sum(steady) / len(steady):.4f} s/step; peak memory "
              f"{out['peak_gib']:.2f} GiB; conv launches {out['launches']} "
              f"({per_step} a step); halo messages staged through the host "
              f"{out['staged']} ({halo_step} a step); all-reduces staged "
              f"{out['collectives_staged']} ({card})")
        b = out["breakdown"]
        print(f"spatial step breakdown rank {r} (one step, its block on "
              f"the card, the other rank stepping beside it, host clock "
              f"{b['wall_ms']:.2f} ms): device kernels {b['device_ms']:.2f} "
              f"ms in {b['n_kernels']} kernels, idle share "
              f"{1 - b['device_ms'] / b['wall_ms']:.3f}; " + "; ".join(
                  f"{k} {v:.2f} ms" for k, v in sorted(b["groups"].items()))
              + f"; the gradient all-reduce alone ({b['grad_mb']:.1f} MB "
              f"through gloo) {b['grad_all_reduce_ms']:.2f} ms ({card})")
    return {"ranks": ranks, "hw_ranks": hw4, "launches_per_step": per_step,
            "staged_per_step": halo_step, "loss_rel_diff": rel}


# ------------------------------------------------------ the auto plan --

AUTO_MESH = {"data": 1, "model": SPATIAL_MODEL}
# the CF conv-parity layers of full-width mesh1k: (layer, mode, chunks)
CF_PARITY = [(layer, mode, chunks) for layer in ("conv4_2", "conv5_1",
                                                 "conv6_3")
             for mode, chunks in (("channel", 1), ("channel", 2),
                                  ("filter", 1))]
# the record_function ranges of the plan's collectives (host time)
AUTO_RANGES = ("cf_reduce_scatter", "cf_all_gather", "reshard")


def auto_plan():
    """The plan `--strategy auto` solves on the card for full-width mesh1k
    at batch BATCH on AUTO_MESH (the H100 preset)."""
    return plan_lib.plan_line(H100, meshnet.layer_specs(
        meshnet.MESH1K, BATCH), AUTO_MESH)


def plan_kinds(plan) -> list[str]:
    """Each layer's kind: CF, or the spatial split, or sample, or R."""
    out = []
    for lp in plan.layers.values():
        sh = lp.sharding
        out.append("CF" if getattr(sh, "cf_axis", None) else
                   "HW"[0 if sh.h_axis else 1] if sh.is_spatial else
                   "N" if sh.batch_axes else "R")
    return out


def plan_conv_calls(plan, specs, shape=AUTO_MESH) -> int:
    """Conv kernel launches of one forward under `plan` on one rank of a
    mesh of `shape`: one a sample, replicated or channel/filter layer
    (`chunks` in chunked channel mode), `conv_calls` of its local extent
    a spatially split one (CF x spatial too)."""
    layout = Mesh(shape, rank=0)
    n = 0
    for spec in specs:
        sh = plan.sharding(spec.name)
        cf = getattr(sh, "cf_axis", None) is not None
        if sh.is_spatial:
            axis = sh.w_axis if sh.w_axis is not None else sh.h_axis
            ext = spec.w if sh.w_axis is not None else spec.h
            n += conv_calls(ext // layout.axis_size(axis), spec.k, spec.s)
        elif cf and sh.mode == "channel":
            n += min(channel_conv.default_channel_chunks(),
                     spec.c // layout.axis_size(sh.cf_axis))
        else:
            n += 1
    return n


def _reshard_staged(src, dst) -> int:
    """Collectives a reshard from sharding `src` to `dst` stages, forward
    and backward: each all-gather or all-to-all (a slice sends nothing)."""
    return 2 * sum(op != "slice" for op, *_ in collectives.reshard_steps(
        collectives.layout(src), collectives.layout(dst)))


def _layer_staged(lp, spec, scope: str, bn: bool) -> int:
    """Collectives a layer's conv and BN stage, forward and backward: each
    CF collective, and a BN whose statistics are summed over more than
    one rank."""
    shape = Mesh(AUTO_MESH, rank=0)
    n, sh = 0, lp.sharding
    if getattr(sh, "cf_axis", None) is not None:
        n += 2 * (1 if sh.is_spatial or sh.mode == "filter" else
                  min(channel_conv.default_channel_chunks(),
                      spec.c // SPATIAL_MODEL))
    if not bn:
        return n
    out = lp.out_sharding
    if getattr(out, "cf_axis", None) is not None or out.is_spatial:
        axes = () if scope == "local" else out.spatial_axes + (
            tuple(out.batch_axes) if scope == "global" else ())
    else:
        axes = tuple(out.batch_axes)
    return n + 2 * (shape.axis_size(axes) > 1)


def plan_staged(plan, specs, scope: str) -> int:
    """Collectives one training step under `plan` stages through the host
    on one rank (gloo, CUDA tensors; halos apart): a BN whose statistics
    are summed over more than one rank, and each CF collective and each
    reshard's all-gather or all-to-all, forward and backward alike; then
    the gradient and the loss all-reduces."""
    n = 2
    for i, spec in enumerate(specs):
        lp = plan.layers[spec.name]
        if lp.reshard_in:
            n += _reshard_staged(plan.out_sharding(specs[i - 1].name),
                                 lp.sharding)
        n += _layer_staged(lp, spec, scope, bn=spec.name != "pred")
    return n


def cf_parity(mesh) -> list[dict]:
    """At each CF_PARITY row of full-width mesh1k, batch BATCH, f32: this
    rank's block of y (F-sharded), of dx (C-sharded) and the mesh-summed
    dw of `cf_conv2d`, each against the conv in float64 on the card, with
    the conv kernel's plan at the shard shape and its launches."""
    dev, rows = torch.device("cuda"), []
    geo = {g[0]: g for g in meshnet.layer_geometry(meshnet.MESH1K)}
    p = mesh.axis_size("model")
    for li, (name, mode, chunks) in enumerate(CF_PARITY):
        _, c, hw, f, k, s = geo[name]
        gen = torch.Generator(device=dev).manual_seed(200 + li)
        x = torch.randn((BATCH, hw, hw, c), generator=gen, device=dev)
        w = torch.randn((k, k, c, f), generator=gen, device=dev) \
            * math.sqrt(2.0 / (k * k * c))
        g = torch.randn((BATCH, hw // s, hw // s, f), generator=gen,
                        device=dev)
        a = x.double().requires_grad_()
        b = w.double().requires_grad_()
        y64 = _conv_f64(a, b, s)
        (y64 * g.double()).sum().backward()
        dx64, dw64 = a.grad, b.grad
        del a, b
        xl = pipeline.shard_dim(x, 3, mesh, "model").contiguous() \
            .requires_grad_()
        wl = w.clone().requires_grad_()
        sh = channel_conv.CFSharding(cf_axis="model", mode=mode)
        before = kconv.conv2d.launches
        y = channel_conv.cf_conv2d(xl, wl, strides=(s, s), sharding=sh,
                                   mesh=mesh, channel_chunks=chunks)
        calls = kconv.conv2d.launches - before
        (y * pipeline.shard_dim(g, 3, mesh, "model")).sum().backward()
        dw = reduce_replicated_grads([wl.grad], mesh)[0]
        torch.cuda.synchronize()
        lo, hi = same_pads(k, s)
        c_loc = c // p // chunks if mode == "channel" else c
        f_loc = f if mode == "channel" else f // p
        kp = kconv.plan((BATCH, hw + lo + hi, hw + lo + hi, c_loc),
                        (k, k, c_loc, f_loc), s, torch.float32)
        what = f"CF conv {name} {mode} chunks {chunks} rank {mesh.rank}"
        row = {"layer": name, "mode": mode, "chunks": chunks,
               "x": [BATCH, hw, hw, c], "f": f, "stride": s,
               "shard": [BATCH, hw + lo + hi, hw + lo + hi, c_loc, f_loc],
               "plan": dataclasses.asdict(kp), "calls": calls,
               "want_calls": chunks if mode == "channel" else 1}
        for nm, got, exact, tol in (
                ("y", y.detach(), pipeline.shard_dim(y64, 3, mesh, "model"),
                 SPATIAL_FWD_TOL),
                ("dx", xl.grad, pipeline.shard_dim(dx64, 3, mesh, "model"),
                 SPATIAL_BWD_TOL),
                ("dw", dw, dw64, SPATIAL_BWD_TOL)):
            row[f"err_{nm}"] = _check_close(f"{what} {nm}", got, exact, tol)
        rows.append(row)
        del x, w, g, y64, dx64, dw64, xl, wl, y, dw
    torch.cuda.empty_cache()
    return rows


def _plan_loss(plan_spec: dict, mesh, dev: torch.device) -> float:
    """The full-width mesh1k forward loss of global batch 0 (seed-0
    params) under the plan `plan_spec` lowers to, summed over the ranks."""
    cfg = meshnet.MESH1K
    specs = meshnet.layer_specs(cfg, BATCH)
    plan = plan_lib.plan_from_spec(plan_spec, specs, AUTO_MESH)
    model = meshnet.MeshNet(cfg, generator=torch.Generator().manual_seed(0),
                            device=dev)
    nb = pipeline.synthetic_mesh_batch(0, BATCH, cfg.input_hw,
                                       cfg.in_channels, out_hw=cfg.out_hw)
    b = pipeline.to_device(pipeline.shard_batch(
        nb, mesh, plan.sharding(specs[0].name), plan.sharding("pred")), dev)
    with torch.no_grad():
        part = meshnet.loss_fn(model.params(), b, cfg, plan, mesh)
        return float(mesh.all_reduce(part, mesh.axis_names))


def auto_cpu_rank(rank: int, world: int, plan_spec: dict) -> dict:
    """One of 2 gloo ranks on the CPU (plain versions): `_plan_loss`."""
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))
    mesh = make_mesh(**AUTO_MESH)
    t0 = time.perf_counter()
    loss = _plan_loss(plan_spec, mesh, torch.device("cpu"))
    return {"loss": loss, "seconds": time.perf_counter() - t0}


def auto_rank(rank: int, world: int) -> dict:
    """One of 2 ranks on the card: (a) the CF conv-parity rows; (b) 3
    training steps through the trainer's own entry under `--strategy auto`,
    with its conv launches, staged
    messages and bytes sent by each collective; (c) the forward loss of
    one global batch under that plan; (d) one more step profiled."""
    mesh = make_mesh(**AUTO_MESH)
    rows = cf_parity(mesh)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    halo.reset_staged()
    collectives.reset_sent()
    res = train_cli.main(["--arch", "mesh1k", "--batch", str(BATCH),
                          "--steps", str(STEPS), "--model",
                          str(SPATIAL_MODEL), "--device", "cuda",
                          "--strategy", "auto", "--log-every", "1"])
    launches, staged = ops.launch_counts()["conv2d"], halo.staged
    collectives_staged, sent = res["mesh"].staged, dict(collectives.sent)
    peak = torch.cuda.max_memory_allocated() / 2**30
    plan = res["plan"]
    spec = plan.to_spec(AUTO_MESH)
    loss = _plan_loss(spec, mesh, torch.device("cuda"))
    breakdown = auto_step_breakdown(res["params"], mesh, plan)
    return {"cf_rows": rows, "losses": res["losses"],
            "step_s": res["step_s"], "data_s": res["data_s"],
            "launches": launches, "staged": staged,
            "collectives_staged": collectives_staged, "sent": sent,
            "peak_gib": peak, "plan_spec": spec,
            "describe": plan.describe(), "loss_card": loss,
            "breakdown": breakdown,
            "digest": [float(p.detach().double().sum())
                       for p in tree_leaves(res["params"])]}


def auto_step_breakdown(params, mesh, plan) -> dict:
    """One more training step of this rank under `plan` (batch on the card,
    lr 0) under torch.profiler (`plan_step_breakdown`)."""
    cfg = meshnet.MESH1K
    specs = meshnet.layer_specs(cfg, BATCH)
    batch = pipeline.shard_batch(
        pipeline.synthetic_mesh_batch(0, BATCH, cfg.input_hw,
                                      cfg.in_channels, out_hw=cfg.out_hw),
        mesh, plan.sharding(specs[0].name), plan.sharding("pred"))
    return plan_step_breakdown(functools.partial(
        meshnet.loss_fn, cfg=cfg, plan=plan, mesh=mesh), params, mesh,
        batch, cnn_kind)


def plan_step_breakdown(loss, params, mesh, batch, classify) -> dict:
    """One training step of this rank of `loss` (lr 0) on its block
    `batch` on the card, after a warm one, under torch.profiler: device
    kernels by kind (`classify`; the copies that stage gloo's collectives
    apart), and the host time of the plan's collective ranges
    (AUTO_RANGES)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    opt = sgd(0.0, momentum=0.9)
    step = make_train_step(loss, opt, TrainStepConfig(precision=FP32),
                           mesh=mesh)
    state = opt.init(params)
    batch = pipeline.to_device(batch, torch.device("cuda"))
    float(step(params, state, batch)[2]["loss"])        # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(params, state, batch)[2]["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict[str, float] = {}
    ranges = {k: 0.0 for k in AUTO_RANGES}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and _annotation(e):
            continue
        if e.device_type == DeviceType.CUDA:
            n_kernels += 1
            name = e.name.lower()
            g = "memcpy (gloo's host staging)" if "memcpy" in name \
                else classify(name)
            groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us() / 1e3
        elif e.name.rsplit("/", 1)[-1] in ranges:
            # `<layer>/<region>` (core.trace.annotate), summed by region
            ranges[e.name.rsplit("/", 1)[-1]] += \
                e.time_range.elapsed_us() / 1e3
    return {"wall_ms": wall_ms, "groups": groups, "n_kernels": n_kernels,
            "device_ms": sum(groups.values()), "host_ranges_ms": ranges}


def auto_phase(card: str) -> dict:
    """The paper's own loop, `--strategy auto`, as 2 processes sharing the
    one card over gloo (not a scaling result): the solve on the H100
    preset, 3 trainer steps, the CF conv parity at the CF
    shard shapes, the card's forward loss under the plan against 2 gloo
    CPU ranks' and one profiled step."""
    specs = meshnet.layer_specs(meshnet.MESH1K, BATCH)
    solved = auto_plan()
    kinds = plan_kinds(solved)
    if "CF" not in kinds or solved.n_reshards == 0:
        raise AssertionError(f"auto plan without a CF layer or a reshard: "
                             f"{kinds}")
    ranks = spawn_ranks(auto_rank, SPATIAL_MODEL)
    if ranks[0]["plan_spec"]["layers"] != solved.to_spec()["layers"]:
        raise AssertionError("the trainer ran another plan than the one "
                             "solved here:\n" + ranks[0]["describe"])
    report = solved.reshard_report(specs, AUTO_MESH)
    print(f"auto plan, full-width mesh1k, batch {BATCH}, mesh {AUTO_MESH}, "
          f"layer kinds {' '.join(kinds)}:")
    print(solved.describe())
    print(plan_lib.reshard_lines(report))

    print(f"CF conv parity, f32, batch {BATCH}, 2 ranks: max |error| of each "
          f"rank's block of y, dx and of dw (summed over the ranks) against "
          f"the conv in float64 on the card, with the conv kernel's plan at "
          f"the shard shape ({card}):")
    for i, row in enumerate(ranks[0]["cf_rows"]):
        rs = [r["cf_rows"][i] for r in ranks]
        for r in rs:
            if r["calls"] != r["want_calls"]:
                raise AssertionError(f"CF {r['layer']} {r['mode']}: "
                                     f"{r['calls']} conv launches, want "
                                     f"{r['want_calls']}")
        kp = row["plan"]
        print(f"  {row['layer']:8s} {row['mode']:7s} chunks {row['chunks']} "
              f"x {tuple(row['x'])} stride {row['stride']} shard (N,H,W,C)"
              f"xF {tuple(row['shard'][:4])}x{row['shard'][4]}: plan "
              f"{kp['path']} {kp['tile_m']}x{kp['tile_n']} k{kp['tile_k']} "
              f"splits {kp['splits']}; calls {row['calls']}; err y "
              f"{max(r['err_y'] for r in rs):.2e} dx "
              f"{max(r['err_dx'] for r in rs):.2e} dw "
              f"{max(r['err_dw'] for r in rs):.2e}", flush=True)

    cpu = spawn_ranks(auto_cpu_rank, SPATIAL_MODEL, ranks[0]["plan_spec"])
    lg, lc = ranks[0]["loss_card"], cpu[0]["loss"]
    rel = abs(lg - lc) / abs(lc)
    print(f"auto forward check, full-width mesh1k, batch {BATCH}, 2 ranks "
          f"under the plan: loss card {lg!r} ({ranks[1]['loss_card']!r} on "
          f"rank 1), 2 gloo CPU ranks {lc!r} ({cpu[0]['seconds']:.1f} s), "
          f"rel diff {rel:.3e} (tol {LOSS_RTOL}) ({card})")
    if not (math.isfinite(lg) and rel <= LOSS_RTOL
            and ranks[1]["loss_card"] == lg and cpu[1]["loss"] == lc):
        raise AssertionError(f"auto plan loss {lg} vs CPU {lc}")

    per_step = plan_conv_calls(solved, specs)
    staged_step = plan_staged(solved, specs, meshnet.MESH1K.bn_scope)
    reshard_bytes = 2 * sum(r["bytes"] for r in report)    # fwd + bwd
    for r, out in enumerate(ranks):
        if out["losses"] != ranks[0]["losses"] or \
                out["digest"] != ranks[0]["digest"]:
            raise AssertionError(f"rank {r} diverged: losses "
                                 f"{out['losses']} vs {ranks[0]['losses']}")
        if not all(math.isfinite(x) for x in out["losses"]):
            raise AssertionError(f"non-finite loss: {out['losses']}")
        if out["launches"] != per_step * STEPS:
            raise AssertionError(f"rank {r}: {out['launches']} conv launches "
                                 f"in {STEPS} steps, want {per_step} x "
                                 f"{STEPS}")
        if out["collectives_staged"] != staged_step * STEPS:
            raise AssertionError(f"rank {r}: {out['collectives_staged']} "
                                 f"collectives staged, want {staged_step} "
                                 f"x {STEPS}")
        if out["sent"].get("reshard", 0) != reshard_bytes * STEPS:
            raise AssertionError(f"rank {r}: reshards sent "
                                 f"{out['sent'].get('reshard', 0)} bytes, "
                                 f"want {reshard_bytes} x {STEPS}")
        steady = out["step_s"][1:]
        print(f"auto train rank {r}/{SPATIAL_MODEL} (2 processes sharing one "
              f"card over gloo: not a scaling result): full-width mesh1k, "
              f"global batch {BATCH}, losses {out['losses']}; step seconds "
              f"{out['step_s']} (batch wait + copy {out['data_s']}); steps "
              f"2..{STEPS}: {sum(steady) / len(steady):.4f} s/step; peak "
              f"memory {out['peak_gib']:.2f} GiB; conv launches "
              f"{out['launches']} ({per_step} a step); halo messages staged "
              f"{out['staged']}; collectives staged through the host "
              f"{out['collectives_staged']} ({staged_step} a step); bytes "
              f"sent {out['sent']} (reshards "
              f"{reshard_bytes} a step) ({card})")
        b = out["breakdown"]
        print(f"auto step breakdown rank {r} (one step, host clock "
              f"{b['wall_ms']:.2f} ms): device kernels {b['device_ms']:.2f} "
              f"ms in {b['n_kernels']} kernels, idle share "
              f"{1 - b['device_ms'] / b['wall_ms']:.3f}; " + "; ".join(
                  f"{k} {v:.2f} ms" for k, v in sorted(b["groups"].items()))
              + "; host ranges: " + "; ".join(
                  f"{k} {v:.2f} ms"
                  for k, v in b["host_ranges_ms"].items()) + f" ({card})")
    return {"ranks": ranks, "cpu": cpu, "kinds": kinds,
            "n_reshards": solved.n_reshards, "reshard_report": report,
            "launches_per_step": per_step, "staged_per_step": staged_step,
            "loss_rel_diff": rel}


# ------------------------------------------------------------ ResNet-50 --

RESNET = resnet.RESNET50
RESNET_BATCH = 32
# the 23 conv shapes, kernel vs plain element by element as well
# (tests/test_torch_cuda.py's TOL): |kernel - plain| <= tol (1 + |plain|)
RESNET_ELEM_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# full-width forward loss at batch 2, card vs CPU (as mesh1k's)
RESNET_CHECK_BATCH = 2
# the auto plan's forward loss of one global batch against the one-device
# card loss on the same params and batch: the same function (every BN of
# the plan normalises as one device does), sums split over 2 ranks
RESNET_PLAN_RTOL = 1e-5
RESNET_MESH = AUTO_MESH


def resnet_conv_shapes(cfg, batch: int) -> list[dict]:
    """The distinct conv calls of one ResNet forward, in graph order, with
    how many convs make each: padded input (N, H, W, C), K, F, stride."""
    g = resnet.resnet_graph(batch, cfg)
    shapes: dict[tuple, dict] = {}
    for name in g.nodes:
        spec = g.nodes[name]["layer"]
        if spec.kind == "pool":
            continue
        lo, hi = same_pads(spec.k, spec.s)
        key = (batch, spec.h + lo + hi, spec.w + lo + hi, spec.c, spec.k,
               spec.f, spec.s)
        if key not in shapes:
            shapes[key] = {"layer": name, "x": key[:4], "k": spec.k,
                           "f": spec.f, "stride": spec.s, "count": 0}
        shapes[key]["count"] += 1
    return list(shapes.values())


def resnet_n_convs(cfg) -> int:
    return sum(s.kind != "pool" for s in resnet.all_specs(1, cfg))


def resnet_kind(name: str) -> str:
    """`cnn_kind`, with the max-pool's amax reduction (a max-reducing
    `reduce_kernel`, the only one a ResNet step runs) apart."""
    if "reduce_kernel" in name and "max" in name:
        return "max-pool amax (forward)"
    return cnn_kind(name)


def resnet_train_phase(card: str) -> dict:
    """The trainer's own entry on full-width ResNet-50, batch 32, 3 steps:
    finite losses and 53 x 3 conv launches."""
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = train_cli.main(["--arch", "resnet50", "--batch",
                          str(RESNET_BATCH), "--steps", str(STEPS),
                          "--device", "cuda", "--log-every", "1"])
    launches = ops.launch_counts()["conv2d"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_convs = resnet_n_convs(RESNET)
    if not all(math.isfinite(l) for l in res["losses"]):
        raise AssertionError(f"non-finite loss: {res['losses']}")
    if launches != n_convs * STEPS:
        raise AssertionError(f"conv kernel launched {launches} times in "
                             f"{STEPS} steps, want {n_convs} x {STEPS}")
    steady = res["step_s"][1:]
    step_s = sum(steady) / len(steady)
    compute = [t - d for t, d in zip(res["step_s"], res["data_s"])][1:]
    compute_s = sum(compute) / len(compute)
    print(f"resnet50 train: {STEPS} steps of full-width ResNet-50 "
          f"({res['n_params']} params) at batch {RESNET_BATCH}; losses "
          f"{res['losses']}; step seconds {res['step_s']} (batch wait + "
          f"copy {res['data_s']}); steps 2..{STEPS}: {step_s:.4f} s/step, "
          f"{RESNET_BATCH / step_s:.2f} samples/s; without the batch wait "
          f"{compute_s:.4f} s/step, {RESNET_BATCH / compute_s:.2f} "
          f"samples/s; peak memory {peak:.2f} GiB; conv launches "
          f"{launches} ({n_convs} a forward) ({card})")
    return {"launches": launches, "losses": res["losses"],
            "step_s": res["step_s"], "data_s": res["data_s"],
            "steady_step_s": step_s, "steady_compute_s": compute_s,
            "peak_gib": peak, "n_params": res["n_params"]}


def resnet_profile_phase(card: str) -> dict:
    """Device time of one full-width ResNet-50 training step (batch 32 on
    the card) by kind of kernel, and the max-pool alone: its forward and
    forward + backward times (CUDA events) and the memory it adds, at
    conv1's output (32, 112, 112, 64)."""
    dev = torch.device("cuda")
    model = resnet.ResNet(RESNET, generator=torch.Generator().manual_seed(0),
                          device=dev)
    params = model.params()
    opt = sgd(0.0, momentum=0.9)
    step = make_train_step(functools.partial(resnet.loss_fn, cfg=RESNET),
                           opt, TrainStepConfig(precision=FP32))
    state = opt.init(params)
    batch = pipeline.to_device(pipeline.synthetic_imagenet_batch(
        0, RESNET_BATCH, RESNET.input_hw, RESNET.n_classes), dev)
    params, state, _ = step(params, state, batch)     # warm

    def run_step():
        float(step(params, state, batch)[2]["loss"])

    wall_ms, groups, n_kernels = _device_breakdown(run_step, resnet_kind)
    busy = sum(groups.values())
    del model, params, state, batch
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.relu(torch.randn((RESNET_BATCH, RESNET.input_hw // 2,
                                RESNET.input_hw // 2, 64), generator=gen,
                               device=dev)).requires_grad_()
    sh = ConvSharding()

    def pool():
        return cnn_layers.max_pool(x, window=3, stride=2, sharding=sh)

    def pool_fwd_bwd():
        return torch.autograd.grad(pool().sum(), x)[0]

    fwd_ms = time_fn(pool, reps=10, warmup=2) * 1e3
    fwd_bwd_ms = time_fn(pool_fwd_bwd, reps=10, warmup=2) * 1e3
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = pool()
    held = torch.cuda.memory_allocated() - base      # output + saved taps
    torch.autograd.grad(y.sum(), x)
    pool_peak = torch.cuda.max_memory_allocated() - base
    del x, y
    torch.cuda.empty_cache()
    if n_kernels == 0:
        print("resnet50 step breakdown: the profiler saw no device kernels "
              "(not measured)")
    else:
        print(f"resnet50 step breakdown (one step, batch {RESNET_BATCH} on "
              f"the card, host clock {wall_ms:.2f} ms): device kernels "
              f"{busy:.2f} ms in {n_kernels} kernels, idle share "
              f"{1 - busy / wall_ms:.3f}; " + "; ".join(
                  f"{k} {v:.2f} ms" for k, v in sorted(groups.items()))
              + f" ({card})")
    print(f"resnet50 max-pool (plain PyTorch: 9 stacked taps, amax) at "
          f"(32, 112, 112, 64): forward {fwd_ms:.3f} ms, forward + "
          f"backward {fwd_bwd_ms:.3f} ms; held after the forward "
          f"{held / 2**20:.1f} MiB, peak over the input through the "
          f"backward {pool_peak / 2**20:.1f} MiB ({card})")
    return {"wall_ms": wall_ms, "device_ms": busy if n_kernels else None,
            "groups": groups, "n_kernels": n_kernels,
            "pool_fwd_ms": fwd_ms, "pool_fwd_bwd_ms": fwd_bwd_ms,
            "pool_held_mib": held / 2**20, "pool_peak_mib": pool_peak / 2**20}


def resnet_forward_check(card: str) -> dict:
    """Full-width ResNet-50 forward loss at batch 2 (seed-0 params): card
    vs CPU."""
    nb = pipeline.synthetic_imagenet_batch(0, RESNET_CHECK_BATCH,
                                           RESNET.input_hw, RESNET.n_classes)
    out = {}
    with torch.no_grad():
        for dev in ("cuda", "cpu"):
            d = torch.device(dev)
            model = resnet.ResNet(RESNET, generator=torch.Generator()
                                  .manual_seed(0), device=d)
            b = pipeline.to_device(nb, d)
            t0 = time.perf_counter()
            out[dev] = float(resnet.loss_fn(model.params(), b, RESNET))
            out[dev + "_s"] = time.perf_counter() - t0
            del model, b
    lg, lc = out["cuda"], out["cpu"]
    rel = abs(lg - lc) / abs(lc)
    print(f"resnet50 forward check, batch {RESNET_CHECK_BATCH}: loss card "
          f"{lg!r} cpu {lc!r} ({out['cpu_s']:.1f} s) rel diff {rel:.3e} "
          f"(tol {LOSS_RTOL}) ({card})")
    if not (math.isfinite(lg) and rel <= LOSS_RTOL):
        raise AssertionError(f"card loss {lg} vs cpu loss {lc}: rel {rel}")
    return {"loss_cuda": lg, "loss_cpu": lc, "rel_diff": rel}


def resnet_auto_plan():
    """The plan `--strategy auto` solves on the card for full-width
    ResNet-50 at batch 32 on RESNET_MESH (the H100 preset)."""
    return plan_lib.plan_graph(H100, resnet.resnet_graph(RESNET_BATCH),
                               resnet.layer_specs(RESNET_BATCH), RESNET_MESH)


def resnet_staged(plan, cfg) -> int:
    """Collectives one ResNet training step under `plan` stages through
    the host on one rank (gloo, CUDA tensors; halos apart): each layer's
    (`_layer_staged`; the pool has no BN), each reshard of `resnet.flow`
    (the residual adds' included), the head's gather of a CF-sharded or
    sum of a spatially sharded last output, forward and backward alike;
    then the gradient and the loss all-reduces."""
    shape = Mesh(RESNET_MESH, rank=0)
    n = 2
    for spec in resnet.all_specs(1, cfg):
        n += _layer_staged(plan.layers[spec.name], spec, cfg.bn_scope,
                           bn=spec.kind != "pool")
    for src, name, kind in resnet.flow(cfg):
        dst = plan.sharding(name) if kind == "in" else \
            plan.out_sharding(name)
        n += _reshard_staged(plan.out_sharding(src), dst)
    last = plan.out_sharding(resnet.last_layer(cfg))
    n += 2 * (shape.axis_size(last.spatial_axes) > 1)
    n += 2 * (getattr(last, "cf_axis", None) is not None)
    return n


def _resnet_plan_loss(plan, mesh, dev: torch.device) -> float:
    """The full-width ResNet-50 forward loss of global batch 0 (seed-0
    params) under `plan`, summed over the ranks (one device: mesh None)."""
    model = resnet.ResNet(RESNET, generator=torch.Generator().manual_seed(0),
                          device=dev)
    nb = pipeline.synthetic_imagenet_batch(0, RESNET_BATCH, RESNET.input_hw,
                                           RESNET.n_classes)
    if mesh is not None:
        nb = pipeline.shard_batch(nb, mesh, plan.sharding("conv1"),
                                  plan.out_sharding(resnet.last_layer(
                                      RESNET)))
    with torch.no_grad():
        part = resnet.loss_fn(model.params(), pipeline.to_device(nb, dev),
                              RESNET, plan, mesh)
        if mesh is None:
            return float(part)
        return float(mesh.all_reduce(part, mesh.axis_names))


def resnet_auto_rank(rank: int, world: int) -> dict:
    """One of 2 ranks on the card: (a) 3 training steps of full-width
    ResNet-50 through the trainer's own entry under `--strategy auto`,
    with its conv launches, staged collectives and bytes sent by each;
    (b) the forward loss of one global batch under that plan; (c) one
    more step profiled."""
    mesh = make_mesh(**RESNET_MESH)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    halo.reset_staged()
    collectives.reset_sent()
    res = train_cli.main(["--arch", "resnet50", "--batch",
                          str(RESNET_BATCH), "--steps", str(STEPS),
                          "--model", str(SPATIAL_MODEL), "--device", "cuda",
                          "--strategy", "auto", "--log-every", "1"])
    launches, staged = ops.launch_counts()["conv2d"], halo.staged
    collectives_staged, sent = res["mesh"].staged, dict(collectives.sent)
    peak = torch.cuda.max_memory_allocated() / 2**30
    plan = res["plan"]
    loss = _resnet_plan_loss(plan, mesh, torch.device("cuda"))
    batch = pipeline.shard_batch(
        pipeline.synthetic_imagenet_batch(0, RESNET_BATCH, RESNET.input_hw,
                                          RESNET.n_classes),
        mesh, plan.sharding("conv1"),
        plan.out_sharding(resnet.last_layer(RESNET)))
    breakdown = plan_step_breakdown(functools.partial(
        resnet.loss_fn, cfg=RESNET, plan=plan, mesh=mesh), res["params"],
        mesh, batch, resnet_kind)
    return {"losses": res["losses"], "step_s": res["step_s"],
            "data_s": res["data_s"], "launches": launches,
            "staged": staged, "collectives_staged": collectives_staged,
            "sent": sent, "peak_gib": peak,
            "plan_spec": plan.to_spec(RESNET_MESH),
            "describe": plan.describe(), "loss_card": loss,
            "breakdown": breakdown,
            "digest": [float(p.detach().double().sum())
                       for p in tree_leaves(res["params"])]}


def resnet_auto_phase(card: str) -> dict:
    """§V-C longest-path-first on ResNet-50, `--strategy auto`, as 2
    processes sharing the one card over gloo (not a scaling result): the
    solve on the H100 preset (it must have a CF layer and a residual-add
    reshard), 3 trainer steps, the forward loss under the plan against
    the one-device card loss, one profiled step."""
    specs = resnet.all_specs(RESNET_BATCH)
    solved = resnet_auto_plan()
    kinds = plan_kinds(solved)
    report = solved.reshard_report(specs, RESNET_MESH,
                                   flow=resnet.flow(RESNET))
    if "CF" not in kinds or not any(r["layer"].endswith("(add)")
                                    for r in report):
        raise AssertionError(f"auto ResNet-50 plan without a CF layer or a "
                             f"residual-add reshard: {kinds}")
    print(f"auto plan, full-width ResNet-50, batch {RESNET_BATCH}, mesh "
          f"{RESNET_MESH}, layer kinds {' '.join(kinds)}:")
    print(solved.describe())
    print(plan_lib.reshard_lines(report))
    one = _resnet_plan_loss(None, None, torch.device("cuda"))
    torch.cuda.empty_cache()
    ranks = spawn_ranks(resnet_auto_rank, SPATIAL_MODEL)
    if ranks[0]["plan_spec"]["layers"] != solved.to_spec()["layers"]:
        raise AssertionError("the trainer ran another plan than the one "
                             "solved here:\n" + ranks[0]["describe"])
    lg = ranks[0]["loss_card"]
    rel = abs(lg - one) / abs(one)
    print(f"auto resnet50 forward check, batch {RESNET_BATCH}, 2 ranks under "
          f"the plan: loss {lg!r} ({ranks[1]['loss_card']!r} on rank 1), "
          f"one device {one!r}, rel diff {rel:.3e} (tol {RESNET_PLAN_RTOL}) "
          f"({card})")
    if not (math.isfinite(lg) and rel <= RESNET_PLAN_RTOL
            and ranks[1]["loss_card"] == lg):
        raise AssertionError(f"auto plan loss {lg} vs one device {one}")
    per_step = plan_conv_calls(solved, [s for s in specs
                                        if s.kind != "pool"])
    staged_step = resnet_staged(solved, RESNET)
    reshard_bytes = 2 * sum(r["bytes"] for r in report)    # fwd + bwd
    for r, out in enumerate(ranks):
        if out["losses"] != ranks[0]["losses"] or \
                out["digest"] != ranks[0]["digest"]:
            raise AssertionError(f"rank {r} diverged: losses "
                                 f"{out['losses']} vs {ranks[0]['losses']}")
        if not all(math.isfinite(x) for x in out["losses"]):
            raise AssertionError(f"non-finite loss: {out['losses']}")
        if out["launches"] != per_step * STEPS:
            raise AssertionError(f"rank {r}: {out['launches']} conv launches "
                                 f"in {STEPS} steps, want {per_step} x "
                                 f"{STEPS}")
        if out["collectives_staged"] != staged_step * STEPS:
            raise AssertionError(f"rank {r}: {out['collectives_staged']} "
                                 f"collectives staged, want {staged_step} "
                                 f"x {STEPS}")
        if out["sent"].get("reshard", 0) != reshard_bytes * STEPS:
            raise AssertionError(f"rank {r}: reshards sent "
                                 f"{out['sent'].get('reshard', 0)} bytes, "
                                 f"want {reshard_bytes} x {STEPS}")
        steady = out["step_s"][1:]
        step_s = sum(steady) / len(steady)
        print(f"auto resnet50 train rank {r}/{SPATIAL_MODEL} (2 processes "
              f"sharing one card over gloo: not a scaling result): "
              f"full-width ResNet-50, global batch {RESNET_BATCH}, losses "
              f"{out['losses']}; step seconds {out['step_s']} (batch wait + "
              f"copy {out['data_s']}); steps 2..{STEPS}: {step_s:.4f} "
              f"s/step, {RESNET_BATCH / step_s:.2f} samples/s (both ranks); "
              f"peak memory {out['peak_gib']:.2f} GiB; conv launches "
              f"{out['launches']} ({per_step} a step); halo messages "
              f"staged {out['staged']}; collectives staged through the "
              f"host {out['collectives_staged']} ({staged_step} a step); "
              f"bytes sent {out['sent']} (reshards {reshard_bytes} a step) "
              f"({card})")
        b = out["breakdown"]
        print(f"auto resnet50 step breakdown rank {r} (one step, host clock "
              f"{b['wall_ms']:.2f} ms): device kernels {b['device_ms']:.2f} "
              f"ms in {b['n_kernels']} kernels, idle share "
              f"{1 - b['device_ms'] / b['wall_ms']:.3f}; " + "; ".join(
                  f"{k} {v:.2f} ms" for k, v in sorted(b["groups"].items()))
              + "; host ranges: " + "; ".join(
                  f"{k} {v:.2f} ms"
                  for k, v in b["host_ranges_ms"].items()) + f" ({card})")
    return {"ranks": ranks, "kinds": kinds, "n_reshards": solved.n_reshards,
            "reshard_report": report, "launches_per_step": per_step,
            "staged_per_step": staged_step, "loss_one_device": one,
            "loss_rel_diff": rel}


# ------------------------------- calibrate -> solve -> profile (4e) --

CALIB_DIR = os.path.join(HERE, "build", "calibrate")
# calibrate.main's timing: one warmup call and CALIB_REPS timed calls a
# table key, so each conv key launches the conv kernel at least 6 times
CALIB_REPS = 5


def calib_rank(rank: int, world: int, path: str, trace_path: str) -> dict:
    """One of 2 ranks on the card: (a) `python -m repro_torch.core.
    calibrate`'s path for full-width mesh1k at batch BATCH on AUTO_MESH
    into `path`, with the conv launches it makes; (b) 3 training steps
    through the trainer's own entry under `--strategy auto --calibrate
    path`; (c) the forward loss of one global batch under that plan; (d)
    `--profile` on that plan, with its attribution report."""
    mesh = make_mesh(**AUTO_MESH)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cal = calibrate.main(["--arch", "mesh1k", "--batch", str(BATCH),
                          "--data", "1", "--model", str(SPATIAL_MODEL),
                          "--device", "cuda", "--reps", str(CALIB_REPS),
                          "--out", path])
    cal_s = time.perf_counter() - t0
    cal_launches = ops.launch_counts()["conv2d"]
    args = ["--arch", "mesh1k", "--batch", str(BATCH), "--model",
            str(SPATIAL_MODEL), "--device", "cuda", "--strategy", "auto",
            "--calibrate", path]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = train_cli.main(args + ["--steps", str(STEPS), "--log-every", "1"])
    launches = ops.launch_counts()["conv2d"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    plan = res["plan"]
    spec = plan.to_spec(AUTO_MESH)
    loss = _plan_loss(spec, mesh, torch.device("cuda"))
    t0 = time.perf_counter()
    prof = train_cli.main(args + ["--profile", trace_path])
    return {"fingerprint": cal.fingerprint, "cal_s": cal_s,
            "cal_launches": cal_launches,
            "train_fingerprint": plan.predicted["calibration"]["fingerprint"],
            "losses": res["losses"], "step_s": res["step_s"],
            "launches": launches, "peak_gib": peak, "plan_spec": spec,
            "describe": plan.describe(),
            "predicted_step_s": plan.predicted["total"], "loss_card": loss,
            "eta": channel_conv.measured_eta(),
            "chunks": list(channel_conv.chunks_decision()),
            "report": prof["report"], "trace_step": prof["trace"].step,
            "trace_meta": {k: v for k, v in prof["trace"].meta.items()
                           if k != "attribution"},
            "profile_s": time.perf_counter() - t0,
            "digest": [float(p.detach().double().sum())
                       for p in tree_leaves(res["params"])]}


def calib_cpu_rank(rank: int, world: int, plan_spec: dict,
                   eta: float | None) -> dict:
    """One of 2 gloo ranks on the CPU (plain versions) with the card
    ranks' measured η installed (so the same chunked-CF default):
    `_plan_loss`."""
    channel_conv.set_measured_eta(eta)
    return auto_cpu_rank(rank, world, plan_spec)


def _kind_changes(specs, before, after) -> list[str]:
    """The layers whose kind (plan_kinds) differs between two plans."""
    return [f"{s.name} {a} -> {b}" for s, a, b in
            zip(specs, plan_kinds(before), plan_kinds(after)) if a != b]


def calibrate_phase(card: str) -> dict:
    """The paper's §V loop on the card: calibrate (2 ranks over gloo,
    every conv table entry timed on the conv kernel), solve on the
    calibration, train 3 steps under it, profile it against its
    prediction; then ResNet-50's solve on a table measured in this one
    process.  Not a scaling result: 2 processes share one card."""
    os.makedirs(CALIB_DIR, exist_ok=True)
    path = os.path.join(CALIB_DIR, "mesh1k_calibration.json")
    trace_path = os.path.join(CALIB_DIR, "mesh1k_step_trace.json")
    for p in (path, trace_path):
        if os.path.exists(p):
            os.remove(p)
    cfg = meshnet.MESH1K
    specs = meshnet.layer_specs(cfg, BATCH)
    ranks = spawn_ranks(calib_rank, SPATIAL_MODEL, path, trace_path)
    cal = calibrate.Calibration.load(path)
    fps = {r[k] for r in ranks for k in ("fingerprint", "train_fingerprint")}
    if fps != {cal.fingerprint}:
        raise AssertionError(f"the ranks hold other calibrations: {fps} vs "
                             f"the file's {cal.fingerprint}")
    conv_keys = sorted(k for k in cal.table.entries if k[0] == "conv")
    want = len(conv_keys) * (1 + CALIB_REPS)
    if ranks[0]["cal_launches"] < want:
        raise AssertionError(f"calibration launched the conv kernel "
                             f"{ranks[0]['cal_launches']} times, want >= "
                             f"{len(conv_keys)} conv keys x "
                             f"{1 + CALIB_REPS}")
    cov = calibrate.coverage(cal, specs, AUTO_MESH)
    if cov != 1.0:
        raise AssertionError(f"calibration coverage {cov} != 1.0")
    m, meta = cal.machine, cal.meta
    print(f"calibration, full-width mesh1k, batch {BATCH}, mesh {AUTO_MESH}, "
          f"2 ranks over gloo on one card ({ranks[0]['cal_s']:.1f} s; "
          f"{meta.get('card', card)}): {cal.summary()}")
    print(f"  fingerprint {cal.fingerprint} on both ranks; coverage {cov}; "
          f"{len(cal.table)} table entries ({len(conv_keys)} conv, "
          f"{sum(k[0] == 'pool' for k in cal.table.entries)} pool, "
          f"{sum(k[0].startswith('shuffle') for k in cal.table.entries)} "
          f"shuffle); conv launches on rank 0 {ranks[0]['cal_launches']} "
          f"(>= {want})")
    print(f"  fitted: achieved peak {m.peak_flops / 1e12:.3f} TFLOP/s, "
          f"efficiency {m.compute_efficiency:.3f}, halfwork "
          f"{m.eff_halfwork:.3e} FLOP, mem_bw {m.mem_bw / 1e9:.1f} GB/s, "
          f"p2p alpha {m.alpha * 1e6:.2f} us beta 1/{1 / m.beta / 1e9:.3f} "
          f"GB/s, coll alpha {m.alpha_coll * 1e6:.2f} us beta "
          f"1/{1 / m.beta_coll / 1e9:.3f} GB/s (gloo through the host on "
          f"one card, not NVLink), eta {m.overlap_eta!r} (samples "
          f"{meta['eta_fit']['samples']}), shuffle x{m.shuffle_factor:.3f} "
          f"(samples {meta['shuffle_fit']['samples']}), composed cf "
          f"x{m.composed_cf_factor:.3f} halo x{m.composed_halo_factor:.3f}; "
          f"H100 preset: peak {H100.peak_flops / 1e12:.1f} TFLOP/s x eff "
          f"{H100.compute_efficiency}, mem_bw {H100.mem_bw / 1e9:.0f} GB/s, "
          f"alpha {H100.alpha * 1e6:.1f} us beta 1/"
          f"{1 / H100.beta / 1e9:.0f} GB/s, coll alpha "
          f"{H100.alpha_coll * 1e6:.1f} us")
    print("  p2p samples (axis, bytes, s): " + str(meta["p2p_samples"]))
    print("  collective samples (op, axis, p, bytes, s): "
          + str(meta["collective_samples"]))
    print(f"  table (kind, n, c, h, w, f, k, s): measured on the conv kernel "
          f"/ the H100 preset's analytic time, ms ({card}):")
    for key in sorted((k for k in cal.table.entries
                       if k[0] in ("conv", "pool")),
                      key=lambda k: calibrate._conv_flops_bytes(k)[0]):
        kind, n, c, h, w, f, k, st = key
        layer = perfmodel.ConvLayer("key", n=n, c=c, h=h, w=w, f=f, k=k,
                                    s=st, kind=kind)
        pre = perfmodel.conv_compute_time(H100, layer, n, c, h, w, f)
        t = cal.table.entries[key]
        print(f"    {str(key):42s} {t * 1e3:9.4f} / {pre * 1e3:9.4f}  "
              f"(x{t / pre:.2f})")

    preset = auto_plan()
    solved = plan_lib.plan_line(cal.machine, specs, AUTO_MESH,
                                table=cal.table)
    if ranks[0]["plan_spec"]["layers"] != solved.to_spec()["layers"]:
        raise AssertionError("the trainer ran another plan than the "
                             "calibration solves:\n" + ranks[0]["describe"])
    changed = _kind_changes(specs, preset, solved)
    print(f"calibrated plan, full-width mesh1k, batch {BATCH}, layer kinds "
          f"{' '.join(plan_kinds(solved))} (H100 preset: "
          f"{' '.join(plan_kinds(preset))}); changed: "
          f"{', '.join(changed) or 'none'}; chunked CF "
          f"{ranks[0]['chunks']}:")
    print(ranks[0]["describe"])
    print("H100 preset plan:")
    print(preset.describe())

    for r, out in enumerate(ranks):
        if out["losses"] != ranks[0]["losses"] or \
                out["digest"] != ranks[0]["digest"]:
            raise AssertionError(f"rank {r} diverged: losses "
                                 f"{out['losses']} vs {ranks[0]['losses']}")
        if not all(math.isfinite(x) for x in out["losses"]):
            raise AssertionError(f"non-finite loss: {out['losses']}")
    cpu = spawn_ranks(calib_cpu_rank, SPATIAL_MODEL, ranks[0]["plan_spec"],
                      ranks[0]["eta"])
    lg, lc = ranks[0]["loss_card"], cpu[0]["loss"]
    rel = abs(lg - lc) / abs(lc)
    steady = ranks[0]["step_s"][1:]
    print(f"calibrated train (2 processes sharing one card over gloo: not a "
          f"scaling result): losses {ranks[0]['losses']} on both ranks; "
          f"steps 2..{STEPS}: {sum(steady) / len(steady):.4f} s/step "
          f"(predicted {ranks[0]['predicted_step_s'] * 1e3:.3f} ms); peak "
          f"{ranks[0]['peak_gib']:.2f} GiB; conv launches "
          f"{ranks[0]['launches']}; forward loss card {lg!r}, 2 gloo CPU "
          f"ranks {lc!r}, rel diff {rel:.3e} (tol {LOSS_RTOL}) ({card})")
    if not (math.isfinite(lg) and rel <= LOSS_RTOL
            and ranks[1]["loss_card"] == lg and cpu[1]["loss"] == lc):
        raise AssertionError(f"calibrated plan loss {lg} vs CPU {lc}")

    report = ranks[0]["report"]
    if list(report["per_layer"]) != [s.name for s in specs]:
        raise AssertionError(f"the attribution covers "
                             f"{list(report['per_layer'])}, not the "
                             f"{len(specs)} layers")
    ts = ranks[0]["trace_step"]
    print(f"attribution of the calibrated plan, {len(report['per_layer'])} "
          f"layers, each timed alone on rank 0 of 2 (the max over the "
          f"ranks; profile {ranks[0]['profile_s']:.1f} s; step fwd "
          f"{ts['fwd_s'] * 1e3:.3f} ms, fwd+bwd {ts['fwd_bwd_s'] * 1e3:.3f} "
          f"ms; peak {ranks[0]['trace_meta']['measured_peak_bytes']} B; "
          f"{card}):")
    print(trace_lib.format_attribution(report))
    print(f"  flagged (x{report['tolerance']} either way): "
          f"{report['flagged']}; worst term {report['worst_term']}; terms "
          + "; ".join(f"{k} predicted {v['predicted_s'] * 1e3:.3f} ms "
                      f"drift x{v['drift']:.2f}"
                      for k, v in report["terms"].items()))

    t0 = time.perf_counter()
    rspecs = resnet.layer_specs(RESNET_BATCH)
    rcal = calibrate.calibrate(rspecs, RESNET_MESH, device="cuda")
    rcov = calibrate.coverage(rcal, rspecs, RESNET_MESH)
    if rcov != 1.0 or len(rcal.table) != min(
            64, rcal.meta["shapes"]["requested"]):
        raise AssertionError(f"resnet50 calibration: coverage {rcov}, "
                             f"{len(rcal.table)} entries of "
                             f"{rcal.meta['shapes']}")
    rgraph = resnet.resnet_graph(RESNET_BATCH)
    rsolved = plan_lib.plan_graph(rcal.machine, rgraph, rspecs, RESNET_MESH,
                                  table=rcal.table)
    rpreset = resnet_auto_plan()
    every = plan_lib.compile_order(rgraph, rspecs)
    rchanged = _kind_changes(every, rpreset, rsolved)
    resnet_s = time.perf_counter() - t0
    print(f"resnet50 calibration, batch {RESNET_BATCH}, shapes of mesh "
          f"{RESNET_MESH}, one process, no live communication "
          f"({resnet_s:.1f} s with the solve; "
          f"{rcal.meta.get('card', card)}): "
          f"{rcal.summary()}; {rcal.meta['shapes']}, coverage {rcov}")
    print(f"calibrated resnet50 plan, layer kinds "
          f"{' '.join(plan_kinds(rsolved))}; changed from the H100 preset's: "
          f"{', '.join(rchanged) or 'none'}:")
    print(rsolved.describe())
    print("H100 preset resnet50 plan:")
    print(rpreset.describe())
    return {"calibration": cal.to_json(), "ranks": ranks, "cpu": cpu,
            "coverage": cov, "loss_rel_diff": rel, "changed": changed,
            "kinds": plan_kinds(solved), "preset_kinds": plan_kinds(preset),
            "resnet50": {"calibration": rcal.to_json(),
                         "kinds": plan_kinds(rsolved),
                         "preset_kinds": plan_kinds(rpreset),
                         "changed": rchanged,
                         "predicted_s": rsolved.predicted["total"],
                         "preset_predicted_s": rpreset.predicted["total"],
                         "seconds": resnet_s}}


# ------------------------------------------------ resilient training --

RESILIENT_DIR = os.path.join(HERE, "build", "resilient")
# a resumed or rolled-back step against the uninterrupted run's: the same
# ops on the same values.  cuDNN's default backward algorithms are not
# deterministic, and ResNet-50 at init amplifies their rounding by about
# 10x a step (5.7e-4 at step 3 in one run, PERF.md §6), so these
# runs pick cuDNN's deterministic algorithms: the compare is of the
# checkpoint, not of cuDNN's order of summation
RESUME_RTOL = 1e-5
RESUME_STEPS = 4
# the elastic run: mesh1k on 4 gloo ranks, the chaos kill at step 5 drops
# 2 (elastic_factorization(2, batch=4): data 1 x model 2), the rollback
# lands on step 4
ELASTIC_ARGS = ["--arch", "mesh1k", "--batch", "4", "--strategy", "auto",
                "--ckpt-every", "2", "--device", "cuda", "--log-every", "1"]
ELASTIC_STEPS, ELASTIC_KILL = 6, 5


def _fresh_dir(*parts) -> str:
    path = os.path.join(RESILIENT_DIR, *parts)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def _loss_at(res: dict) -> dict:
    """{step: loss} of a trainer run (a rolled-back step's last run)."""
    return dict(zip(res["steps"], res["losses"]))


def _events(path: str) -> list[dict]:
    """The records of a metrics JSONL other than the steps."""
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if r["kind"] != "step"]


def _check_steps(what: str, got: dict, want: dict, steps) -> float:
    """The largest relative difference of `got`'s losses from `want`'s at
    `steps`; raises above RESUME_RTOL."""
    rel = max(abs(got[s] - want[s]) / abs(want[s]) for s in steps)
    if not rel <= RESUME_RTOL:
        raise AssertionError(f"{what}: losses {[got[s] for s in steps]} vs "
                             f"{[want[s] for s in steps]} (rel {rel:.2e} > "
                             f"{RESUME_RTOL})")
    return rel


def ckpt_resume_phase(card: str) -> dict:
    """Full-width ResNet-50 at batch 32 in this process, every forward conv
    on the kernel, on cuDNN's deterministic algorithms (RESUME_RTOL): run
    A trains RESUME_STEPS steps; run B 2 steps with a checkpoint at 2; run
    C resumes B's and trains to RESUME_STEPS (its losses within
    RESUME_RTOL of A's); run D trains with `--chaos raise@3` and rolls
    back to step 2 (its step 3 within RESUME_RTOL of A's).  The bytes a
    checkpoint holds, the host ms of `save()` (the copy the caller waits
    for) and the ms of the thread's write; and, before them, A on the
    default algorithms, to show how far those move the losses."""
    base = ["--arch", "resnet50", "--batch", str(RESNET_BATCH), "--device",
            "cuda", "--log-every", "1", "--ckpt-every", "2"]
    default = train_cli.main(base + ["--steps", str(RESUME_STEPS)])
    prev, torch.backends.cudnn.deterministic = \
        torch.backends.cudnn.deterministic, True
    try:
        out = _resume_runs(card, base)
    finally:
        torch.backends.cudnn.deterministic = prev
    spread = max(abs(x - y) / abs(y) for x, y in
                 zip(default["losses"], out["losses"]))
    print(f"ckpt resume: the uninterrupted run on cuDNN's default "
          f"algorithms {default['losses']}, rel {spread:.2e} from the "
          f"deterministic one ({card})")
    out["default_algorithms"] = {"losses": default["losses"],
                                 "rel": spread}
    return out


def _resume_runs(card: str, base: list) -> dict:
    """ckpt_resume_phase's runs A-D."""
    a = train_cli.main(base + ["--steps", str(RESUME_STEPS)])
    want = _loss_at(a)
    b_dir = _fresh_dir("resume")
    b = train_cli.main(base + ["--steps", "2", "--ckpt-dir", b_dir])
    ops.reset_launch_counts()
    c = train_cli.main(base + ["--steps", str(RESUME_STEPS), "--ckpt-dir",
                               b_dir])
    resume_launches = ops.launch_counts()["conv2d"]
    n_convs = resnet_n_convs(RESNET)
    if c["steps"] != list(range(2, RESUME_STEPS)):
        raise AssertionError(f"resumed run took steps {c['steps']}")
    if resume_launches != n_convs * (RESUME_STEPS - 2):
        raise AssertionError(f"resumed run launched the conv kernel "
                             f"{resume_launches} times, want {n_convs} x "
                             f"{RESUME_STEPS - 2}")
    rel_c = _check_steps("resume", _loss_at(c), want,
                         range(2, RESUME_STEPS))
    d_metrics = os.path.join(RESILIENT_DIR, "raise.jsonl")
    d = train_cli.main(base + ["--steps", str(RESUME_STEPS), "--ckpt-dir",
                               _fresh_dir("raise"), "--chaos", "raise@3",
                               "--metrics", d_metrics])
    rollbacks = [e["step"] for e in _events(d_metrics)
                 if e["kind"] == "rollback"]
    if rollbacks != [2] or d["steps"] != [0, 1, 2, 2, 3]:
        raise AssertionError(f"raise@3: rollbacks {rollbacks}, steps "
                             f"{d['steps']}")
    rel_d = _check_steps("raise@3 rollback", _loss_at(d), want, [3])
    ck = b["checkpoint"]
    print(f"ckpt resume, full-width ResNet-50 at batch {RESNET_BATCH}: "
          f"losses {a['losses']}; resumed at 2: {c['losses']} (rel "
          f"{rel_c:.2e}); raise@3 rolled back to 2, steps {d['steps']}, "
          f"step 3 rel {rel_d:.2e}; conv launches of the resumed run "
          f"{resume_launches} ({n_convs} a forward); checkpoint "
          f"{ck['bytes']} bytes, save() host copy {ck['copy_s'] * 1e3:.2f} "
          f"ms, thread write {ck['write_s'] * 1e3:.2f} ms ({card})")
    return {"losses": a["losses"], "resumed": c["losses"],
            "raise_steps": d["steps"], "raise_losses": d["losses"],
            "rel_resume": rel_c, "rel_rollback": rel_d,
            "resume_launches": resume_launches, "checkpoint": ck,
            "resumed_step_s": c["step_s"], "checkpoint_run": {
                k: d["checkpoint"][k] for k in ("copy_s", "write_s",
                                                "bytes")}}


def ckpt_overhead_phase(card: str, cfg=meshnet.MESH1K,
                        device: str = "cuda") -> dict:
    """The reference's `benchmarks/strategy_exec.py` checkpoint-overhead
    bench on the card: full-width mesh1k at batch BATCH in this process,
    the bare train step (lr 0, a batch on the card) and the step plus one
    async `save` of `(params, OptState, None)` in interleaved rounds.
    Both arms' median round (seconds a call), their ratio, the saves'
    host copy and the last write.  A measurement: it gates nothing."""
    dev = torch.device(device)
    model = meshnet.MeshNet(cfg, generator=torch.Generator().manual_seed(0),
                            device=dev)
    params = model.params()
    opt = sgd(0.0, momentum=0.9)
    step = make_train_step(functools.partial(meshnet.loss_fn, cfg=cfg), opt,
                           TrainStepConfig(precision=FP32))
    state = opt.init(params)
    batch = pipeline.to_device(pipeline.synthetic_mesh_batch(
        0, BATCH, cfg.input_hw, cfg.in_channels, out_hw=cfg.out_hw), dev)
    ck = CheckpointManager(_fresh_dir("overhead"), keep=2, async_save=True)
    counter, copies = itertools.count(), []

    def with_save():
        out = step(params, state, batch)
        ck.save(next(counter), state_tree(params, state), extra={"step": 0})
        copies.append(ck.last_save["copy_s"])
        return out
    bare = functools.partial(step, params, state, batch)
    bare()
    with_save()
    ck.wait()
    copies.clear()
    samples = interleaved_samples({"no_ckpt": bare, "async_ckpt": with_save},
                                  reps=3, rounds=5)
    t0 = time.perf_counter()
    ck.wait()
    drain_s = time.perf_counter() - t0
    med = {k: float(np.median(v)) for k, v in samples.items()}
    ratio = med["async_ckpt"] / med["no_ckpt"]
    copy_ms = float(np.median(copies)) * 1e3
    print(f"ckpt overhead, full-width mesh1k at batch {BATCH}: step "
          f"{med['no_ckpt'] * 1e3:.2f} ms bare, {med['async_ckpt'] * 1e3:.2f}"
          f" ms with one async save a step (median of {len(samples['no_ckpt'])}"
          f" rounds of 3), ratio {ratio:.3f}; save() host copy median "
          f"{copy_ms:.2f} ms of {ck.last_save['bytes']} bytes; last write "
          f"{ck.last_write_s * 1e3:.2f} ms; queue drained {drain_s:.2f} s "
          f"after the last round ({card})")
    return {"samples_s": samples, "median_s": med, "ratio": ratio,
            "copy_ms": [c * 1e3 for c in copies], "bytes":
            ck.last_save["bytes"], "write_s": ck.last_write_s,
            "drain_s": drain_s}


def elastic_rank(rank: int, world: int, args: list) -> dict:
    """One of the spawned ranks of an elastic run (or of its resume), on
    cuDNN's deterministic algorithms: the trainer's own entry with `args`,
    the conv launches it made before and after its remesh (build is
    called once at the start and once by the remesh) and the describe()
    of each plan it built."""
    torch.backends.cudnn.deterministic = True      # see RESUME_RTOL
    marks, plans, build = [], [], train_cli.build

    def marked(args, *a, **k):
        marks.append(ops.launch_counts()["conv2d"])
        out = build(args, *a, **k)
        plans.append((out[-1], {"data": args.data, "model": args.model}))
        return out
    train_cli.build = marked
    ops.reset_launch_counts()
    try:
        res = train_cli.main(args)
    finally:
        train_cli.build = build
    total = ops.launch_counts()["conv2d"]
    before = marks[1] if len(marks) > 1 else total
    specs = meshnet.layer_specs(meshnet.MESH1K, int(args[args.index(
        "--batch") + 1]))
    return {"steps": res["steps"], "losses": res["losses"],
            "step_s": res["step_s"], "left_at": res["left_at"],
            "plans": [p.describe() for p, _ in plans],
            "calls_per_step": [plan_conv_calls(p, specs, shape)
                               for p, shape in plans],
            "launches_before": before, "launches_after": total - before}


def _split_s(r: dict) -> tuple[float | None, float | None]:
    """Mean seconds a step before the remesh (its first step left out)
    and after it (the step that repeats the rolled-back one left out)."""
    steps, ts = r["steps"], r["step_s"]
    cut = next((i for i in range(1, len(steps)) if steps[i] <= steps[i - 1]),
               len(steps))
    pre, post = ts[1:cut], ts[cut + 1:]
    return (sum(pre) / len(pre) if pre else None,
            sum(post) / len(post) if post else None)


def elastic_phase(card: str) -> dict:
    """Full-width mesh1k on 4 ranks spawned on the card over gloo (NCCL
    refuses two ranks on one card: not a scaling result), `--data 2
    --model 2 --strategy auto --steps 6 --ckpt-every 2 --elastic --chaos
    kill@5x2`: the kill drops ranks 2-3, the survivors remesh onto data 1
    x model 2, re-solve, roll back to step 4 and finish.  Held: the
    metrics' fault, remesh (2 ranks) and rollback (step 4) records, ranks
    2-3 leaving at 5, equal losses on the survivors, and their steps 4-5
    within RESUME_RTOL of a 2-rank `--data 1 --model 2` run resumed from
    a copy of the same step-4 checkpoint."""
    ckdir = _fresh_dir("elastic")
    metrics = os.path.join(RESILIENT_DIR, "elastic.jsonl")
    ranks = spawn_ranks(elastic_rank, 4, ELASTIC_ARGS + [
        "--data", "2", "--model", "2", "--steps", str(ELASTIC_STEPS),
        "--ckpt-dir", ckdir, "--elastic", "--chaos",
        f"kill@{ELASTIC_KILL}x2", "--metrics", metrics])
    events = _events(metrics)
    remesh = [e for e in events if e["kind"] == "remesh"]
    rollbacks = [e["step"] for e in events if e["kind"] == "rollback"]
    if not any(e["kind"] == "fault" for e in events) or \
            [e["n_devices"] for e in remesh] != [2] or \
            rollbacks != [ELASTIC_KILL - 1]:
        raise AssertionError(f"elastic events: {events}")
    left = [r["left_at"] for r in ranks]
    if left != [None, None, ELASTIC_KILL, ELASTIC_KILL]:
        raise AssertionError(f"left_at per rank: {left}")
    if ranks[0]["losses"] != ranks[1]["losses"]:
        raise AssertionError(f"survivors' losses differ: "
                             f"{[r['losses'] for r in ranks[:2]]}")
    for r in ranks:      # every forward conv on the kernel, on both meshes
        calls = r["calls_per_step"] + [0]
        want = [calls[0] * ELASTIC_KILL,
                calls[1] * (ELASTIC_STEPS - ELASTIC_KILL + 1)]
        if [r["launches_before"], r["launches_after"]] != want:
            raise AssertionError(f"conv launches before / after the remesh "
                                 f"{r['launches_before']} / "
                                 f"{r['launches_after']}, the plans derive "
                                 f"{want}")
    resume_dir = _fresh_dir("elastic_resume")
    shutil.copytree(os.path.join(ckdir, f"step-{ELASTIC_KILL - 1}"),
                    os.path.join(resume_dir, f"step-{ELASTIC_KILL - 1}"))
    resumed = spawn_ranks(elastic_rank, 2, ELASTIC_ARGS + [
        "--data", "1", "--model", "2", "--steps", str(ELASTIC_STEPS),
        "--ckpt-dir", resume_dir])
    after = range(ELASTIC_KILL - 1, ELASTIC_STEPS)
    rel = _check_steps("elastic vs its 2-rank resume",
                       _loss_at(ranks[0]), _loss_at(resumed[0]), after)
    split = [_split_s(r) for r in ranks]
    for r, (pre, post) in enumerate(split):
        print(f"rank {r}: elastic steps {ranks[r]['steps']}, losses "
              f"{ranks[r]['losses']}, left at {ranks[r]['left_at']}, conv "
              f"launches {ranks[r]['launches_before']} before the remesh, "
              f"{ranks[r]['launches_after']} after; s/step "
              f"{pre if pre is None else round(pre, 4)} before, "
              f"{post if post is None else round(post, 4)} after")
    for when, plan in zip(("before", "after"), ranks[0]["plans"]):
        print(f"elastic plan {when} the remesh:\n{plan}")
    print(f"elastic mesh1k 4 -> 2 gloo ranks on one card: steps "
          f"{list(after)} within {rel:.2e} of the 2-rank resume from "
          f"step-{ELASTIC_KILL - 1} ({resumed[0]['losses']}) ({card})")
    return {"ranks": ranks, "resumed": resumed, "events": events,
            "rel_resume": rel, "s_per_step": split}


# ------------------------------------------------ static analysis (4g) --

AUDIT_DIR = os.path.join(HERE, "build", "audit")
# the layer whose backward is timed with and without the §IV-A split
HALO_BWD_LAYER = "conv2_2"
HALO_BWD_ROUNDS = 4


def audit_plans() -> tuple[dict, list]:
    """The two plans phase 4g audits on AUTO_MESH, full-width mesh1k at
    batch BATCH: the uniform H plan (every layer split over model, halos
    and the interior/boundary split; the workload registry's `uniform_h`
    recipe) and the H100 auto plan (CF layers and reshards)."""
    specs = meshnet.layer_specs(meshnet.MESH1K, BATCH)
    dist = plan_lib._sharding_to_dist(
        ConvSharding(batch_axes=("data",), h_axis="model"))
    uniform = plan_lib.compile_plan({s.name: dist for s in specs}, specs,
                                    AUTO_MESH, machine=H100)
    return {"uniform_h": uniform, "auto": auto_plan()}, specs


def halo_backward_ms(mesh, spec) -> dict:
    """Host ms of one spatially split layer's backward (dL/dx and dL/dw of
    its convs and the halo gradients' exchange) under the §IV-A split,
    whose backward posts the halo gradients before the interior's dL/dx,
    and serialized, in alternating rounds; the median of each."""
    gen = torch.Generator().manual_seed(mesh.rank)
    hl = spec.h // mesh.axis_size("model")
    x0 = torch.randn((spec.n, hl, spec.w, spec.c), generator=gen).cuda()
    w = (torch.randn((spec.k, spec.k, spec.c, spec.f), generator=gen)
         * 0.05).cuda().requires_grad_()
    sh = ConvSharding(h_axis="model")
    out = {"overlapped": [], "serialized": []}

    def once(overlap: bool) -> float:
        x = x0.detach().requires_grad_()
        y = spatial_conv2d(x, w, strides=(spec.s, spec.s), sharding=sh,
                           mesh=mesh, overlap=overlap)
        gy = torch.ones_like(y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y.backward(gy)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for overlap in (True, False):                  # warm both
        once(overlap)
    for _ in range(HALO_BWD_ROUNDS):
        for overlap in (True, False):
            out["overlapped" if overlap else "serialized"].append(
                once(overlap))
    return {k: sorted(v)[len(v) // 2] for k, v in out.items()}


def audit_rank(rank: int, world: int) -> dict:
    """One of 2 ranks on the card: each of `audit_plans` linted and its
    collectives audited on one real step (forward, backward, the gradient
    bucket; seeded params, the synthetic batch), with the conv launches
    of the audited step; then HALO_BWD_LAYER's backward timed."""
    from repro_torch import analysis
    mesh = make_mesh(**AUTO_MESH)
    plans, specs = audit_plans()
    out = {}
    for key, plan in plans.items():
        ops.reset_launch_counts()
        a = analysis.meshnet_audit(plan, specs, meshnet.MESH1K, mesh,
                                   machine=H100, device="cuda")
        launches = ops.launch_counts()["conv2d"]
        findings = analysis.lint_plan(plan, specs, AUTO_MESH) + a.findings
        moved, once, priced = a.bucket()
        out[key] = {
            "describe": plan.describe(), "n_reshards": plan.n_reshards,
            "kinds": plan_kinds(plan),
            "table": analysis.format_findings(findings),
            "findings": [f.to_json() for f in findings],
            "errors": int(mesh.all_max([analysis.error_count(findings)])[0]),
            "counts": a.counts(), "bucket_bytes": moved,
            "priced_once": once, "priced_total": priced,
            "seconds": a.seconds, "launches": launches,
            "calls": plan_conv_calls(plan, specs)}
    spec = next(s for s in specs if s.name == HALO_BWD_LAYER)
    out["halo_bwd"] = halo_backward_ms(mesh, spec)
    return out


def audit_dryrun_rank(rank: int, world: int, out_path: str,
                      log_path: str) -> dict:
    """One of 4 ranks on the card: `python -m repro_torch.launch.dryrun
    --audit` on this gloo group (data 2 x model 2, the H100 preset), its
    findings tables into `log_path` (rank 0)."""
    import contextlib
    import io
    from repro_torch.launch import dryrun
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = dryrun.main(["--audit", "--device", "cuda", "--audit-out",
                          out_path])
    if rank == 0:
        with open(log_path, "w") as f:
            f.write(buf.getvalue())
    return {"rc": rc, "seconds": time.perf_counter() - t0}


def audit_phase(card: str) -> dict:
    """Phase 4g, the static-analysis lane on the card: `audit_rank` on 2
    spawned ranks (gloo), then the `dryrun --audit` lane on 4.  Fails on
    any error finding, on a conv launch count other than the plan's, and
    where the uniform plan's audited step shows no pin in either
    direction or the auto plan has no CF layer or no reshard."""
    t0 = time.perf_counter()
    ranks = spawn_ranks(audit_rank, 2)
    for key in ("uniform_h", "auto"):
        r0 = ranks[0][key]
        print(f"audit {key}, full-width mesh1k, batch {BATCH}, mesh "
              f"{AUTO_MESH}, layer kinds {' '.join(r0['kinds'])}:")
        print(r0["describe"])
        print(r0["table"])
        for rank, r in enumerate(ranks):
            a = r[key]
            print(f"audit {key} rank {rank}: {a['errors']} error(s); ops "
                  f"{a['counts']}; grad bucket {a['bucket_bytes']:.0f} B "
                  f"against the priced weight gradients {a['priced_once']:.0f}"
                  f" B once ({a['priced_total']:.0f} B over the inventory's "
                  f"psums); audit step {a['seconds']:.4f} s host; conv "
                  f"launches {a['launches']} (the plan derives "
                  f"{a['calls']}) ({card})")
            if a["errors"]:
                raise AssertionError(f"audit {key}: {a['errors']} error "
                                     f"finding(s) on rank {rank}")
            if a["launches"] != a["calls"]:
                raise AssertionError(f"audit {key} rank {rank}: "
                                     f"{a['launches']} conv launches, the "
                                     f"plan derives {a['calls']}")
    for rank, r in enumerate(ranks):
        c = r["uniform_h"]["counts"]
        if not (c.get("pin/fwd") and c.get("pin/bwd")):
            raise AssertionError(f"audit uniform_h rank {rank}: no pin in "
                                 f"both directions: {c}")
        if "CF" not in r["auto"]["kinds"] or not r["auto"]["n_reshards"]:
            raise AssertionError("audit auto: the H100 plan has no CF layer "
                                 "or no reshard")
        hb = r["halo_bwd"]
        print(f"halo backward, {HALO_BWD_LAYER} (H over model 2), rank "
              f"{rank}: overlapped {hb['overlapped']:.3f} ms, serialized "
              f"{hb['serialized']:.3f} ms (median of {HALO_BWD_ROUNDS}, "
              f"gloo through the host; {card})")
    t_dry = time.perf_counter()
    os.makedirs(AUDIT_DIR, exist_ok=True)
    out_path = os.path.join(AUDIT_DIR, "PLAN_audit.json")
    log_path = os.path.join(AUDIT_DIR, "dryrun.log")
    dry = spawn_ranks(audit_dryrun_rank, 4, out_path, log_path)
    with open(out_path) as f:
        report = json.load(f)
    for name, w in report["workloads"].items():
        print(f"dryrun --audit {name} on {report['mesh']} (the H100 "
              f"preset, {report['collective_backend']}): "
              + ("skipped" if w["skipped"] else
                 f"{w['n_findings']} finding(s), {w['n_errors']} error(s), "
                 f"{w['n_reshards']} reshard point(s)"))
    if any(r["rc"] for r in dry) or report["n_errors"] or \
            len(report["workloads"]) != 6 or \
            any(w["skipped"] for w in report["workloads"].values()):
        raise AssertionError(f"dryrun --audit failed: rc "
                             f"{[r['rc'] for r in dry]}, {report['n_errors']}"
                             f" error(s); see {log_path}")
    phase_s = time.perf_counter() - t0
    print(f"dryrun --audit, 4 card ranks: {time.perf_counter() - t_dry:.1f}"
          f" s; audit phase took {phase_s:.1f} s of this run ({card})")
    return {"ranks": ranks, "dryrun": {"ranks": dry, "report": report},
            "phase_s": phase_s}


# ---------------------------------------------------------------- LM path --

def admitted_pairs(s: int, window: int | None) -> int:
    """(query, key) pairs that causality and the window admit at length s:
    the work the masks leave, which is what the bound counts."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def attention_cases(cfg) -> list[dict]:
    """The attention calls of one forward: full causal on the global
    layers, causal + window on the others."""
    n_glob = sum(t == "hybrid_g" for t in cfg.layer_types())
    return [{"mask": "causal", "window": None, "count": n_glob},
            {"mask": f"window {cfg.window}", "window": cfg.window,
             "count": cfg.n_layers - n_glob}]


def attention_limit(q, k, v, **opts) -> tuple[torch.Tensor, torch.Tensor]:
    """(o32, limit) for bf16 attention: the plain version in fp32 on the
    same inputs, and ATTN_ELEM_ULP x (softmax(S).|v| + |o32|) per
    element."""
    q, k, v = (t.float() for t in (q, k, v))
    want = flash_attention_ref(q, k, v, **opts)
    spread = flash_attention_ref(q, k, v.abs(), **opts)
    return want, ATTN_ELEM_ULP * (spread + want.abs())


def check_attention(case: dict, dtype: torch.dtype,
                    gen: torch.Generator) -> dict:
    dev, cfg = torch.device("cuda"), HYMBA
    b, s, hq, hkv, d = LM_BATCH, LM_SEQ, cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim
    window, what = case["window"], f"flash_attention {case['mask']} {dtype}"
    q = torch.randn((b, s, hq, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
    o = kfa.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    err = _check_close(what, o, flash_attention_ref(q, k, v, window=window),
                       LM_FWD_TOL[dtype])
    # the CPU emulation of the kernel's tiling, run here on the same
    # inputs, against the kernel itself
    emu_err = _check_close(f"{what} emulation vs kernel",
                           kfa.flash_attention_emulated(q, k, v,
                                                        window=window),
                           o, LM_FWD_TOL[dtype])
    elem = None
    if dtype == torch.bfloat16:
        want, limit = attention_limit(q, k, v, window=window)
        elem = float(((o.float() - want).abs() / limit).max())
        if not elem <= 1.0:
            raise AssertionError(f"{what}: an element is {elem} x its "
                                 f"limit (one bf16 ulp of A + |o32|)")
        del want, limit

    # the autograd Function (kernel forward, backward recomputed through
    # the plain version) vs autograd through the plain version
    g = torch.randn(o.shape, generator=gen, device=dev).to(dtype)
    grads = []
    for fwd in (lambda *a: kfa.FlashAttention.apply(*a, True, window, None,
                                                    None),
                lambda *a: flash_attention_ref(*a, window=window)):
        ts = [t.detach().requires_grad_() for t in (q, k, v)]
        (fwd(*ts).float() * g.float()).sum().backward()
        grads.append([t.grad for t in ts])
    for nm, got, want in zip(("dq", "dk", "dv"), *grads):
        _check_close(f"{what} {nm}", got, want, LM_BWD_TOL[dtype])
    del grads

    # the yardstick: one SDPA call on (B, H, S, D) views, GQA, the same mask
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window is None:
        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
    else:
        pos = torch.arange(s, device=dev)
        keep = (pos[:, None] >= pos[None, :]) & \
            (pos[:, None] - pos[None, :] < window)

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep,
                                                  enable_gqa=True)
    lib_err = float((library().transpose(1, 2).float() - o.float())
                    .abs().max())
    p = kfa.plan(tuple(q.shape), tuple(k.shape), dtype, True, window)
    row = {"kernel": "flash_attention", "mask": case["mask"],
           "dtype": str(dtype).split(".")[-1], "count": case["count"],
           "q": [b, s, hq, d], "kv": [b, s, hkv, d], "max_abs_err": err,
           "max_err_over_elem_limit": elem,
           "emulation_vs_kernel_err": emu_err,
           "library_vs_kernel_err": lib_err, "plan": dataclasses.asdict(p),
           "plan_str": f"{p.path} {p.tile_q}x{p.tile_k}"}
    row.update(_timings(
        lambda: kfa.flash_attention(q, k, v, window=window),
        lambda: flash_attention_ref(q, k, v, window=window), library,
        4.0 * d * admitted_pairs(s, window) * b * hq,
        (2 * q.numel() + k.numel() + v.numel()) * q.element_size(), dtype))
    return row


# the SSD shapes: hymba's (its path) and mamba2-780m's (repro/configs/
# mamba2_780m.py: d 1536 x expand 2 / head dim 64 = 48 heads, state 128,
# chunk 128), which the kernel takes too but no ported path runs yet
SSD_SHAPES = [
    {"model": "hymba-1.5b", "h": HYMBA.ssm_heads, "p": HYMBA.ssm_head_dim,
     "n": HYMBA.ssm_state, "chunk": HYMBA.ssm_chunk,
     "count": HYMBA.n_layers},
    {"model": "mamba2-780m", "h": 48, "p": 64, "n": 128, "chunk": 128,
     "count": 0},
]


def ssd_inputs(shape: dict, dtype: torch.dtype, gen: torch.Generator):
    """xdt, la, B, C at batch LM_BATCH x LM_SEQ: the model's inputs at
    init, la = softplus(dt) * -A with A_log = log(linspace(1, 16)); la
    stays fp32 under bf16, as in the model."""
    dev = torch.device("cuda")
    b, l, h, p, n = LM_BATCH, LM_SEQ, shape["h"], shape["p"], shape["n"]
    xdt = (torch.randn((b, l, h, p), generator=gen, device=dev) * 0.5) \
        .to(dtype)
    dt = F.softplus(torch.randn((b, l, h), generator=gen, device=dev))
    la = (-dt * torch.linspace(1.0, 16.0, h, device=dev)).contiguous()
    B = (torch.randn((b, l, n), generator=gen, device=dev) * 0.5).to(dtype)
    C = (torch.randn((b, l, n), generator=gen, device=dev) * 0.5).to(dtype)
    return xdt, la, B, C


def ssd_work(xdt, la, B, S, chunk: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one call: G = C.B^T once per chunk, then per head
    y over the causal pairs and S; each input read once (C as B), each
    output written once."""
    b, l, h, p = xdt.shape
    n, nc = B.shape[-1], l // chunk
    flops = b * nc * (2.0 * chunk * chunk * n
                      + h * (p * chunk * (chunk + 1) + 2.0 * chunk * p * n))
    nbytes = (2 * xdt.numel() + 2 * B.numel()) * xdt.element_size() \
        + (la.numel() + S.numel()) * 4
    return flops, nbytes


def ssd_plan_str(pl, ctas: int | None = None) -> str:
    """path, the chunk the CTA is built for, its heads and (if given) the
    CTAs an SM holds: "mma 64 h2 3/SM"."""
    return f"{pl.path} {pl.chunk_tile} h{pl.heads}" + (
        "" if ctas is None else f" {ctas}/SM")


def check_ssd(shape: dict, dtype: torch.dtype, gen: torch.Generator) -> dict:
    dev = torch.device("cuda")
    chunk = shape["chunk"]
    what = f"ssd_chunk {shape['model']} {dtype}"
    xdt, la, B, C = ssd_inputs(shape, dtype, gen)
    pl = kssd.plan(chunk, shape["n"], dtype)
    if pl.path != ("mma" if dtype == torch.bfloat16 else "fma"):
        raise AssertionError(f"{what} planned {pl}")
    y, S = kssd.ssd_chunk(xdt, la, B, C, chunk=chunk)
    torch.cuda.synchronize()
    yr, Sr = ssd_chunked_ref(xdt, la, B, C, chunk)
    err = max(_check_close(f"{what} y", y, yr, LM_FWD_TOL[dtype]),
              _check_close(f"{what} S", S, Sr, LM_FWD_TOL[torch.float32]))
    del yr, Sr
    elem = None
    if dtype == torch.bfloat16:
        want, limit = kssd.elem_limit(xdt, la, B, C, chunk)
        elem = float(((y.float() - want).abs() / limit).max())
        if not elem <= 1.0:
            raise AssertionError(f"{what}: an element is {elem} x its "
                                 f"limit (2^-7 |y32| + 2^-12 |M|.|xdt|)")
        del want, limit

    gy = torch.randn(y.shape, generator=gen, device=dev).to(dtype)
    gS = torch.randn(S.shape, generator=gen, device=dev)
    grads = []
    for fwd in (lambda *a: kssd.SsdChunk.apply(*a, chunk),
                lambda *a: ssd_chunked_ref(*a, chunk)):
        ts = [t.detach().requires_grad_() for t in (xdt, la, B, C)]
        yy, SS = fwd(*ts)
        ((yy.float() * gy.float()).sum() + (SS * gS).sum()).backward()
        grads.append([t.grad for t in ts])
    for nm, got, want in zip(("dxdt", "dla", "dB", "dC"), *grads):
        _check_close(f"{what} {nm}", got, want, LM_BWD_TOL[dtype])
    del grads

    flops, nbytes = ssd_work(xdt, la, B, S, chunk)
    row = {"kernel": "ssd_chunk", "model": shape["model"],
           "dtype": str(dtype).split(".")[-1], "count": shape["count"],
           "xdt": list(xdt.shape), "n": shape["n"], "chunk": chunk,
           "max_abs_err": err, "max_err_over_elem_limit": elem,
           "plan": dataclasses.asdict(pl),
           "ctas_per_sm": kssd.occupancy(chunk, shape["n"], dtype)}
    row["plan_str"] = ssd_plan_str(pl, row["ctas_per_sm"])
    row.update(_timings(
        lambda: kssd.ssd_chunk(xdt, la, B, C, chunk=chunk),
        lambda: ssd_chunked_ref(xdt, la, B, C, chunk), None, flops, nbytes,
        dtype))
    return row


def lm_kernel_phase(card: str) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    print(f"{'kernel':16s} {'case':12s} {'dtype':8s} {'n':>2s} "
          f"{'plan':15s} {'kernel_ms':>10s} {'plain_ms':>9s} "
          f"{'library_ms':>10s} "
          f"{'bound_ms':>9s} {'TFLOP/s':>8s} {'max_err':>9s}   ({card})")
    for dtype in (torch.float32, torch.bfloat16):
        cases = [(check_attention, c) for c in attention_cases(HYMBA)] + \
            [(check_ssd, s) for s in SSD_SHAPES]
        for check, case in cases:
            r = check(case, dtype, gen)
            rows.append(r)
            if r["kernel"] == "flash_attention" and dtype == torch.bfloat16 \
                    and r["plan"]["path"] != "wgmma":
                raise AssertionError(f"bf16 attention at D = {r['q'][3]} "
                                     f"planned {r['plan']}, not wgmma")
            lib = "none" if r["library_ms"] is None else \
                f"{r['library_ms']:.4f}"
            print(f"{r['kernel']:16s} {r.get('mask', r.get('model')):12s} "
                  f"{r['dtype']:8s} {r['count']:2d} "
                  f"{r.get('plan_str', '-'):15s} {r['ms']:10.4f} "
                  f"{r['plain_ms']:9.4f} {lib:>10s} {r['bound_ms']:9.4f} "
                  f"{r['tflops_s']:8.2f} {r['max_abs_err']:9.2e}"
                  + ("" if r.get("max_err_over_elem_limit") is None else
                     f"  err/elem limit "
                     f"{r['max_err_over_elem_limit']:.3f}")
                  + ("" if r.get("emulation_vs_kernel_err") is None else
                     f"  emulation vs kernel "
                     f"{r['emulation_vs_kernel_err']:.2e}"),
                  flush=True)
            torch.cuda.empty_cache()
    return rows


def lm_train_phase(bf16: bool = False) -> dict:
    """3 full-width hymba-1.5b steps through the trainer's own entry, FP32
    or (`--bf16`) bf16 compute with fp32 master weights."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = train_cli.main(["--arch", "hymba-1.5b", "--batch", str(LM_BATCH),
                          "--seq", str(LM_SEQ), "--steps", str(STEPS),
                          "--device", "cuda", "--log-every", "1"]
                         + (["--bf16"] if bf16 else []))
    counts = ops.launch_counts()
    want = {"conv2d": 0, "flash_attention": HYMBA.n_layers * STEPS,
            "ssd_chunk": HYMBA.n_layers * STEPS}
    if not all(math.isfinite(l) for l in res["losses"]):
        raise AssertionError(f"non-finite loss: {res['losses']}")
    if counts != want:
        raise AssertionError(f"launches {counts} in {STEPS} steps, want "
                             f"{want} (one forward launch per layer; the "
                             f"backward recomputes through the plain "
                             f"versions)")
    steady = res["step_s"][1:]
    step_s = sum(steady) / len(steady)
    tokens = LM_BATCH * LM_SEQ
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"train: {STEPS} steps of full-width hymba-1.5b "
          f"({res['n_params'] / 1e9:.3f} B params, "
          f"{'BF16' if bf16 else 'FP32'}) at batch {LM_BATCH} x "
          f"seq {LM_SEQ}; losses {res['losses']}; step seconds "
          f"{res['step_s']}; steps 2..{STEPS}: {step_s:.4f} s/step, "
          f"{tokens / step_s:.1f} tokens/s; peak memory {peak:.2f} GiB; "
          f"launches {counts}")
    return {"launches": counts, "losses": res["losses"],
            "step_s": res["step_s"], "data_s": res["data_s"],
            "steady_step_s": step_s, "tokens_per_s": tokens / step_s,
            "peak_gib": peak, "n_params": res["n_params"],
            "precision": "bf16" if bf16 else "fp32"}


def lm_forward_check() -> dict:
    """Forward loss of a 4-layer full-width hymba at seq 1280, the same
    params and batch through the card's kernels and the CPU's plain
    versions."""
    cfg = dataclasses.replace(HYMBA, n_layers=CHECK_LAYERS)
    types = cfg.layer_types()
    if types != ["hybrid_g", "hybrid_s", "hybrid_g", "hybrid_g"]:
        raise AssertionError(f"check layers {types}")
    params = transformer.init(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    nb = pipeline.synthetic_lm_batch(0, 1, CHECK_SEQ, cfg.vocab)
    out = {}
    with torch.no_grad():
        for dev in ("cuda", "cpu"):
            d = torch.device(dev)
            p = tree_map(lambda t: t.detach().to(d), params)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            out[dev] = float(transformer.loss_fn(
                p, pipeline.to_device(nb, d), cfg))
            out[dev + "_s"] = time.perf_counter() - t0
            out[dev + "_launches"] = ops.launch_counts()
            del p
    lg, lc = out["cuda"], out["cpu"]
    rel = abs(lg - lc) / abs(lc)
    print(f"forward check, hymba-1.5b {CHECK_LAYERS} layers {types} at seq "
          f"{CHECK_SEQ}: loss card {lg!r} cpu {lc!r} rel diff {rel:.3e} "
          f"(tol {LM_LOSS_RTOL}); card launches {out['cuda_launches']}")
    if not (math.isfinite(lg) and rel <= LM_LOSS_RTOL):
        raise AssertionError(f"card loss {lg} vs cpu loss {lc}: rel {rel}")
    want = {"conv2d": 0, "flash_attention": CHECK_LAYERS,
            "ssd_chunk": CHECK_LAYERS}
    if out["cuda_launches"] != want:
        raise AssertionError(f"card forward launches {out['cuda_launches']}")
    return {"loss_cuda": lg, "loss_cpu": lc, "rel_diff": rel,
            "types": types, "seq": CHECK_SEQ}


def lm_profile_phase() -> dict:
    """Device time of one full-width hymba-1.5b step (batch 1 x seq 2048,
    batch on the card) by kind of kernel, and the SSD's inter-chunk
    recurrence timed alone at hymba's shape."""
    dev = torch.device("cuda")
    args = train_cli.parse_args(["--arch", "hymba-1.5b", "--batch",
                                 str(LM_BATCH), "--seq", str(LM_SEQ),
                                 "--steps", str(STEPS)])
    cfg, params, _, loss, mk, prec, _ = train_cli.build(args, dev)
    opt = adamw(0.0)
    step = make_train_step(loss, opt, TrainStepConfig(precision=prec))
    state = opt.init(params)
    batch = pipeline.to_device(mk(0), dev)
    float(step(params, state, batch)[2]["loss"])        # warm

    def run_step():
        float(step(params, state, batch)[2]["loss"])

    def classify(name):
        if "flash_fwd" in name:
            return "flash_attention kernel"
        if "ssd_chunk_kernel" in name:
            return "ssd_chunk kernel"
        if any(t in name for t in ("gemm", "cutlass", "xmma", "sm90",
                                   "cublas")):
            return "cuBLAS matmuls"
        if "softmax" in name:
            return "softmax (plain attention recompute)"
        if "reduce" in name:
            return "reductions"
        if any(t in name for t in ("elementwise", "vectorized", "unrolled")):
            return "elementwise"
        return "other"

    wall_ms, groups, n_kernels = _device_breakdown(run_step, classify)
    del params, state, step, opt
    torch.cuda.empty_cache()

    # the inter-chunk recurrence of one layer: forward, and forward +
    # backward, at hymba's (b, nc, h, p, n), from per-chunk log decays of
    # hymba's range (-0.16 to -700: some underflow)
    nc = LM_SEQ // cfg.ssm_chunk
    gen = torch.Generator(device="cuda").manual_seed(2)
    log_a = -torch.exp(torch.empty((LM_BATCH, nc, cfg.ssm_heads),
                                   device=dev).uniform_(
        math.log(0.16), math.log(700.0), generator=gen))
    S = torch.randn((LM_BATCH, nc, cfg.ssm_heads, cfg.ssm_head_dim,
                     cfg.ssm_state), generator=gen, device=dev)
    fwd_s = time_fn(lambda: lm_modules.inter_chunk_states(log_a, S)[1],
                    reps=10, warmup=2)
    a_g, S_g = log_a.clone().requires_grad_(), S.clone().requires_grad_()

    def fwd_bwd():
        h_in, h_fin = lm_modules.inter_chunk_states(a_g, S_g)
        (h_in.sum() + h_fin.sum()).backward()
        return S_g.grad
    fwd_bwd_s = time_fn(fwd_bwd, reps=10, warmup=2)
    # the same calls' kernels alone: CUDA events above include the gaps
    # in which the card waits for the host to launch the next small op
    _, _, ic_fwd_kernels = _device_breakdown(
        lambda: lm_modules.inter_chunk_states(log_a, S)[1].sum().item(),
        lambda name: "all")
    ic_wall_ms, ic_groups, ic_kernels = _device_breakdown(
        lambda: fwd_bwd().sum().item(), lambda name: "all")
    ic_device_ms = ic_groups.get("all")
    if not torch.isfinite(a_g.grad).all():
        raise AssertionError("the recurrence's gradient is not finite")
    busy = sum(groups.values()) if n_kernels else None
    print(f"step breakdown (one hymba-1.5b step, batch {LM_BATCH} x seq "
          f"{LM_SEQ} on the card, host clock {wall_ms:.2f} ms): " + (
              f"device kernels {busy:.2f} ms in {n_kernels} kernels, idle "
              f"share {1 - busy / wall_ms:.3f}; " + "; ".join(
                  f"{k} {v:.2f} ms" for k, v in sorted(groups.items()))
              if n_kernels else "the profiler saw no device kernels (not "
              "measured)"))
    ic_device = "not measured (the profiler saw no kernels)" \
        if ic_device_ms is None else \
        f"{ic_device_ms:.4f} ms in {ic_kernels} kernels"
    print(f"ssd inter-chunk recurrence ({nc} chunks, one layer, closed "
          f"form): launches per layer {ic_fwd_kernels} forward, "
          f"{ic_kernels} forward + backward (the profiler's device "
          f"kernels); forward {fwd_s * 1e3:.4f} ms, forward + backward "
          f"{fwd_bwd_s * 1e3:.4f} ms (CUDA events, launch gaps included); "
          f"x {cfg.n_layers} layers: {fwd_bwd_s * 1e3 * cfg.n_layers:.2f} "
          f"ms per step; forward + backward device kernels {ic_device} "
          f"(host clock {ic_wall_ms:.2f} ms under the profiler)")
    return {"wall_ms": wall_ms, "device_ms": busy, "groups": groups,
            "n_kernels": n_kernels, "inter_chunk_fwd_ms": fwd_s * 1e3,
            "inter_chunk_fwd_bwd_ms": fwd_bwd_s * 1e3,
            "inter_chunk_fwd_bwd_device_ms": ic_device_ms,
            "inter_chunk_fwd_kernels": ic_fwd_kernels,
            "inter_chunk_fwd_bwd_kernels": ic_kernels}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f}s")
    resources = [line for name, path in sorted(libs.items())
                 for line in ptxas_resources(
                     name, path.with_suffix(".log").read_text())]
    # the bf16 conv and attention paths must run on the tensor cores'
    # wgmma, the bf16 SSD path on their mma.sync
    hgmma = {name: sass_count(libs[name], "HGMMA")
             for name in ("conv2d", "flash_attention")}
    hgmma["ssd"] = sass_count(libs["ssd"], "HMMA")
    for name, n in hgmma.items():
        op = "HMMA" if name == "ssd" else "HGMMA"
        print(f"{name} library: {n} {op} instructions in its SASS")
        if n == 0:
            raise AssertionError(f"no {op} in the {name} library: its "
                                 f"bf16 path does not use the tensor "
                                 f"cores")

    rows = kernel_phase(card)
    lm_rows = lm_kernel_phase(card)
    train = train_phase()
    fwd = forward_check()
    breakdown = profile_phase()
    t_spatial = time.perf_counter()
    interior = interior_copy_phase(card)
    spatial = spatial_phase(card)
    spatial["phase_s"] = time.perf_counter() - t_spatial
    print(f"spatial phases (interior copy, 2 and 4 spawned ranks) took "
          f"{spatial['phase_s']:.1f} s of this run ({card})")
    t_auto = time.perf_counter()
    auto = auto_phase(card)
    auto["phase_s"] = time.perf_counter() - t_auto
    print(f"auto-plan phase (2 card ranks, 2 CPU ranks) took "
          f"{auto['phase_s']:.1f} s of this run ({card})")
    t_resnet = time.perf_counter()
    print(f"resnet50 conv shapes, batch {RESNET_BATCH}: kernel vs plain "
          f"(and element by element within {RESNET_ELEM_TOL[torch.float32]} "
          f"/ {RESNET_ELEM_TOL[torch.bfloat16]} (1 + |plain|)), plan "
          f"(path, tile, k step, K splits, C/F after padding), times:")
    resnet_rows = kernel_phase(card, resnet_conv_shapes(RESNET, RESNET_BATCH),
                               RESNET_ELEM_TOL)
    for dt in ("float32", "bfloat16"):
        sel = [r for r in resnet_rows if r["dtype"] == dt]
        tot = {k: sum(r[k] * r["count"] for r in sel)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                         "gflops")}
        print(f"resnet50 conv, one forward ({sum(r['count'] for r in sel)} "
              f"calls, {tot['gflops']:.2f} GFLOP) {dt}: kernel "
              f"{tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, "
              f"F.conv2d {tot['library_ms']:.3f} ms, bound "
              f"{tot['bound_ms']:.3f} ms ({card})")
    resnet_train = resnet_train_phase(card)
    resnet_fwd = resnet_forward_check(card)
    resnet_breakdown = resnet_profile_phase(card)
    resnet_auto = resnet_auto_phase(card)
    resnet_s = time.perf_counter() - t_resnet
    print(f"resnet50 phases (conv rows, train, forward check, breakdown, "
          f"2-rank auto plan) took {resnet_s:.1f} s of this run ({card})")
    t_calib = time.perf_counter()
    calib = calibrate_phase(card)
    calib["phase_s"] = time.perf_counter() - t_calib
    print(f"calibrate-solve-profile phase (2 card ranks, 2 CPU ranks, the "
          f"resnet50 table) took {calib['phase_s']:.1f} s of this run "
          f"({card})")
    t_res = time.perf_counter()
    resume = ckpt_resume_phase(card)
    overhead = ckpt_overhead_phase(card)
    elastic = elastic_phase(card)
    resilient_s = time.perf_counter() - t_res
    print(f"resilient-training phases (ResNet-50 resume and rollback, "
          f"checkpoint overhead, 4 -> 2 elastic ranks) took "
          f"{resilient_s:.1f} s of this run ({card})")
    audit = audit_phase(card)
    lm_train = lm_train_phase()
    lm_train_bf16 = lm_train_phase(bf16=True)
    lm_fwd = lm_forward_check()
    lm_breakdown = lm_profile_phase()

    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump({"card": card, "shapes": rows, "lm_shapes": lm_rows,
                   "train": train, "forward_check": fwd,
                   "step_breakdown": breakdown,
                   "interior_copy": interior, "spatial": spatial,
                   "auto": auto,
                   "resnet50": {"shapes": resnet_rows,
                                "train": resnet_train,
                                "forward_check": resnet_fwd,
                                "step_breakdown": resnet_breakdown,
                                "auto": resnet_auto, "phase_s": resnet_s},
                   "calibrate": calib,
                   "ckpt_resume": resume, "ckpt_overhead": overhead,
                   "elastic": elastic, "resilient_phase_s": resilient_s,
                   "audit": audit,
                   "lm_train": lm_train,
                   "lm_train_bf16": lm_train_bf16,
                   "lm_forward_check": lm_fwd,
                   "lm_step_breakdown": lm_breakdown,
                   "hgmma": hgmma, "resources": resources}, f,
                  indent=1)

    # the kernels line: each kernel's numbers over one forward of its model
    # in float32 (bf16 beside), each shape's times the calls that make it
    def entry(name, source, replaces, launches, rs, scope):
        rs = [r for r in rs if r["count"]]
        f32 = [r for r in rs if r["dtype"] == "float32"]
        bf16 = [r for r in rs if r["dtype"] == "bfloat16"]

        def total(sel, key):
            if any(r[key] is None for r in sel):
                return None
            return sum(r[key] * r["count"] for r in sel)

        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in f32),
            "ms": total(f32, "ms"), "plain_ms": total(f32, "plain_ms"),
            "bound_ms": total(f32, "bound_ms"),
            "bound_by": "operations" if total(f32, "ops_ms")
            >= total(f32, "bytes_ms") else "bytes",
            "library_ms": total(f32, "library_ms"), "scope": scope,
            "bf16": {"max_abs_err": max(r["max_abs_err"] for r in bf16),
                     "ms": total(bf16, "ms"),
                     "plain_ms": total(bf16, "plain_ms"),
                     "bound_ms": total(bf16, "bound_ms"),
                     "library_ms": total(bf16, "library_ms")},
        }

    n_glob = sum(t == "hybrid_g" for t in HYMBA.layer_types())
    lm_scope = f"one hymba-1.5b forward, batch {LM_BATCH} x seq {LM_SEQ}, " \
        f"float32: "
    kernels = [
        dict(entry("conv2d", "src/repro_torch/kernels/csrc/conv2d.cu",
                   "src/repro/kernels/conv2d.py:43", train["launches"], rows,
                   "one mesh1k forward, batch 2, float32: 19 conv calls"),
             spatial_launches_per_rank=[r["launches"]
                                        for r in spatial["ranks"]],
             auto_launches_per_rank=[r["launches"]
                                     for r in auto["ranks"]],
             calibrate_launches_per_rank=[r["cal_launches"]
                                          for r in calib["ranks"]],
             resume_launches=resume["resume_launches"],
             elastic_launches_per_rank=[[r["launches_before"],
                                         r["launches_after"]]
                                        for r in elastic["ranks"]],
             audit_launches_per_rank=[[r["uniform_h"]["launches"],
                                       r["auto"]["launches"]]
                                      for r in audit["ranks"]],
             resnet50=dict(entry(
                 "conv2d", "src/repro_torch/kernels/csrc/conv2d.cu",
                 "src/repro/kernels/conv2d.py:43", resnet_train["launches"],
                 resnet_rows, f"one ResNet-50 forward, batch {RESNET_BATCH}, "
                 f"float32: {resnet_n_convs(RESNET)} conv calls at "
                 f"{len(resnet_rows) // 2} shapes"),
                 auto_launches_per_rank=[r["launches"] for r in
                                         resnet_auto["ranks"]])),
        entry("flash_attention",
              "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:77",
              lm_train["launches"]["flash_attention"],
              [r for r in lm_rows if r["kernel"] == "flash_attention"],
              lm_scope + f"{n_glob} causal + {HYMBA.n_layers - n_glob} "
              f"window-{HYMBA.window} calls"),
        entry("ssd_chunk", "src/repro_torch/kernels/csrc/ssd.cu",
              "src/repro/kernels/ssd.py:55",
              lm_train["launches"]["ssd_chunk"],
              [r for r in lm_rows if r["kernel"] == "ssd_chunk"],
              lm_scope + f"{HYMBA.n_layers} calls"),
    ]
    print("kernel resources (ptxas):")
    print("\n".join(resources))
    print("; ".join(f"{name} library: {n} "
                    f"{'HMMA' if name == 'ssd' else 'HGMMA'} instructions "
                    f"in its SASS" for name, n in hgmma.items()))
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
