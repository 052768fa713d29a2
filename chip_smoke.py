#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card and `nvcc` (CUDA_HOME or /usr/local/cuda).  Phases:

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build every kernel under src/repro_torch/kernels/csrc with nvcc;
3. kernel vs plain: for each distinct conv shape of mesh1k at batch 2, in
   float32 and bfloat16, hold the conv kernel against `conv2d_ref` and the
   autograd Function's dx/dw against autograd through `conv2d_ref`; time
   the kernel, the plain version and one `F.conv2d` call (channels_last,
   TF32 off: the yardstick, never called by the port); compute the bound;
4. train: run the trainer's own entry (`launch.train.main`) on full-width
   mesh1k, batch 2, 3 steps; check finite losses and 19 x 3 kernel
   launches; then hold the full-width forward loss of one batch-1 sample
   on the card (kernel) against the same params and sample on the CPU
   (plain versions); profile one more step by kind of device kernel;
5. print the `kernels` JSON line and, last, the `ok` JSON line.

Any failed phase raises and the script exits non-zero.  Per-shape rows go
to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import conv2d as kconv  # noqa: E402
from repro_torch.kernels.ref import conv2d_ref  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.cnn import meshnet  # noqa: E402
from repro_torch.optim.optimizer import sgd  # noqa: E402
from repro_torch.train.train_loop import (  # noqa: E402
    TrainStepConfig, make_train_step)
from repro_torch.utils import FP32, same_pads, time_fn  # noqa: E402

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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


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


def check_shape(sh: dict, dtype: torch.dtype, gen: torch.Generator) -> dict:
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

    # the autograd Function (kernel forward, cuDNN backward) vs autograd
    # through the plain version, through one random cotangent
    g = torch.randn(y.shape, generator=gen, device=dev).to(dtype)
    grads = []
    for fwd in (lambda a, b: kconv.Conv2d.apply(a, b, s),
                lambda a, b: conv2d_ref(a, b, stride=s)):
        a = xp.detach().requires_grad_()
        b = w.detach().requires_grad_()
        (fwd(a, b).float() * g.float()).sum().backward()
        grads.append((a.grad.float(), b.grad.float()))
    (dx, dw), (rdx, rdw) = grads
    for nm, got, want in (("dx", dx, rdx), ("dw", dw, rdw)):
        e = float((got - want).abs().max())
        sc = max(1.0, float(want.abs().max()))
        if not e <= BWD_TOL[dtype] * sc:
            raise AssertionError(f"{sh['layer']} {dtype}: {nm} max |err| "
                                 f"{e} > {BWD_TOL[dtype]} * {sc}")
    del grads, dx, dw, rdx, rdw

    x_nchw = xp.permute(0, 3, 1, 2)            # channels_last view
    w_oihw = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    kernel_s = time_fn(lambda: kconv.conv2d(xp, w, stride=s), reps=10,
                       warmup=2)
    plain_s = time_fn(lambda: conv2d_ref(xp, w, stride=s), reps=10,
                      warmup=2)
    library_s = time_fn(lambda: F.conv2d(x_nchw, w_oihw, stride=s),
                        reps=10, warmup=2)
    flops = 2.0 * n * y.shape[1] * y.shape[2] * f * k * k * c
    nbytes = (xp.numel() + w.numel() + y.numel()) * xp.element_size()
    ops_s, bytes_s = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_S
    return {"layer": sh["layer"], "dtype": str(dtype).split(".")[-1],
            "x": list(sh["x"]), "k": k, "f": f, "stride": s,
            "count": sh["count"], "max_abs_err": err,
            "ms": kernel_s * 1e3, "plain_ms": plain_s * 1e3,
            "library_ms": library_s * 1e3,
            "bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "ops_ms": ops_s * 1e3, "bytes_ms": bytes_s * 1e3,
            "gflops": flops / 1e9,
            "tflops_s": flops / kernel_s / 1e12}


def kernel_phase(card: str) -> list[dict]:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    print(f"{'layer':8s} {'dtype':8s} {'x (N,H,W,C)':22s} {'k':>2s} "
          f"{'F':>4s} {'s':>2s} {'n':>2s} {'kernel_ms':>10s} "
          f"{'plain_ms':>9s} {'library_ms':>10s} {'bound_ms':>9s} "
          f"{'TFLOP/s':>8s} {'max_err':>9s}   ({card})")
    for dtype in (torch.float32, torch.bfloat16):
        for sh in mesh_conv_shapes(meshnet.MESH1K):
            r = check_shape(sh, dtype, gen)
            rows.append(r)
            print(f"{r['layer']:8s} {r['dtype']:8s} {str(tuple(r['x'])):22s} "
                  f"{r['k']:2d} {r['f']:4d} {r['stride']:2d} "
                  f"{r['count']:2d} {r['ms']:10.4f} {r['plain_ms']:9.4f} "
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


def profile_phase() -> dict:
    """Device time of one full-width training step (batch 2, batch already
    on the card) by kind of kernel, from torch.profiler's CUDA events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        float(m["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {"conv2d kernel (forward)": 0.0,
              "library conv (dgrad/wgrad)": 0.0, "other": 0.0}
    n_kernels = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        n_kernels += 1
        ms = e.time_range.elapsed_us() / 1e3
        name = e.name.lower()
        if "conv2d_kernel" in name:
            groups["conv2d kernel (forward)"] += ms
        elif any(t in name for t in ("cudnn", "xmma", "dgrad", "wgrad",
                                     "conv", "gemm", "cutlass")):
            groups["library conv (dgrad/wgrad)"] += ms
        else:
            groups["other"] += ms
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
    for name, path in libs.items():
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

    rows = kernel_phase(card)
    train = train_phase()
    fwd = forward_check()
    breakdown = profile_phase()

    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump({"card": card, "shapes": rows, "train": train,
                   "forward_check": fwd, "step_breakdown": breakdown}, f,
                  indent=1)

    # the kernels line: one forward of mesh1k at batch 2 in float32, each
    # shape's numbers times the layers that make it (19 calls)
    f32 = [r for r in rows if r["dtype"] == "float32"]
    bf16 = [r for r in rows if r["dtype"] == "bfloat16"]

    def total(rs, key):
        return sum(r[key] * r["count"] for r in rs)

    entry = {
        "name": "conv2d", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/conv2d.cu",
        "replaces": "src/repro/kernels/conv2d.py:43",
        "launches": train["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in f32),
        "ms": total(f32, "ms"), "plain_ms": total(f32, "plain_ms"),
        "bound_ms": total(f32, "bound_ms"),
        "bound_by": "operations" if total(f32, "ops_ms")
        >= total(f32, "bytes_ms") else "bytes",
        "library_ms": total(f32, "library_ms"),
        "scope": "one mesh1k forward, batch 2, float32: 19 conv calls",
        "bf16": {"max_abs_err": max(r["max_abs_err"] for r in bf16),
                 "ms": total(bf16, "ms"),
                 "plain_ms": total(bf16, "plain_ms"),
                 "bound_ms": total(bf16, "bound_ms"),
                 "library_ms": total(bf16, "library_ms")},
    }
    print(f"card: {card}")
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
