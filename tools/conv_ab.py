#!/usr/bin/env python3
"""A/B of the conv kernel against an earlier version of it, on one card.

    python3 tools/conv_ab.py [--parent-src OLD.cu] [--parent-tree DIR]

Needs one CUDA card and `nvcc`.  For each distinct conv shape of a mesh1k
forward at batch 2, in float32 and bfloat16 (TF32 off), it holds this
tree's kernel (`kernels/conv2d.py::conv2d`) against `conv2d_ref` and times
it, the earlier kernel built from OLD.cu (if given), `F.conv2d`
(channels_last, the yardstick) and the bound, in turns: earlier, this,
this, earlier.  OLD.cu is a source with the first C entry point,
`repro_conv2d(x, w, y, dtype, n, h, wd, c, kh, kw, f, s, stream)`; it is
built beside this tree's kernels and called on the same inputs.

With --parent-tree DIR (a checkout of the earlier tree) it also times the
mesh1k training step without the batch wait (batch 2, batch already on
the card, host clock around 10 synchronised steps after 2 warm-ups), in
four fresh processes: DIR's package, this one, this one, DIR's.

Rows go to chiprun_out/conv_ab.json.  `--step-only --src DIR/src` is the
step timing of one process (used by the above).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_REPS, STEP_WARMUP, BATCH = 10, 2, 2


def step_only(src: str) -> dict:
    """Seconds per full-width mesh1k step of the package under `src`."""
    sys.path.insert(0, src)
    import functools

    import torch
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.train import set_fp32_numerics
    from repro_torch.models.cnn import meshnet
    from repro_torch.optim.optimizer import sgd
    from repro_torch.train.train_loop import TrainStepConfig, make_train_step
    from repro_torch.utils import FP32

    dev = torch.device("cuda")
    set_fp32_numerics(dev)
    cfg = meshnet.MESH1K
    model = meshnet.MeshNet(cfg, generator=torch.Generator().manual_seed(0),
                            device=dev)
    params = model.params()
    opt = sgd(0.0, momentum=0.9)
    step = make_train_step(functools.partial(meshnet.loss_fn, cfg=cfg), opt,
                           TrainStepConfig(precision=FP32))
    state = opt.init(params)
    batch = pipeline.to_device(pipeline.synthetic_mesh_batch(
        0, BATCH, cfg.input_hw, cfg.in_channels, out_hw=cfg.out_hw), dev)
    for _ in range(STEP_WARMUP):
        loss = float(step(params, state, batch)[2]["loss"])
    ops.reset_launch_counts()
    times = []
    for _ in range(STEP_REPS):
        t0 = time.perf_counter()
        loss = float(step(params, state, batch)[2]["loss"])
        times.append(time.perf_counter() - t0)
    return {"src": src, "step_s": times,
            "mean_s": sum(times) / len(times), "loss": loss,
            "conv_launches": ops.launch_counts()["conv2d"]}


def step_ab(parent_tree: str) -> list[dict]:
    order = [("parent", os.path.join(parent_tree, "src")),
             ("change", os.path.join(HERE, "src"))]
    out = []
    for name, src in order + order[::-1]:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--step-only",
             "--src", src], capture_output=True, text=True, check=True,
            timeout=900)
        row = json.loads(res.stdout.strip().splitlines()[-1])
        row["tree"] = name
        out.append(row)
        print(f"step {name:6s}: mean {row['mean_s'] * 1e3:.3f} ms over "
              f"{STEP_REPS} steps (min {min(row['step_s']) * 1e3:.3f}), "
              f"loss {row['loss']!r}, conv launches {row['conv_launches']}",
              flush=True)
    return out


def parent_fn(src: str):
    """The earlier kernel's entry point, built from `src` with this tree's
    nvcc flags."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR / "conv2d_parent.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run(_build.nvcc_command(_build.find_nvcc(), Path(src), out),
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).repro_conv2d
    i64 = ctypes.c_int64
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [i64] * 8 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_ab(parent_src: str | None) -> list[dict]:
    sys.path.insert(0, HERE)
    import math

    import chip_smoke as cs
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import conv2d as kconv
    from repro_torch.kernels.ref import conv2d_ref
    from repro_torch.models.cnn import meshnet
    from repro_torch.utils import same_pads, time_fn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    old = parent_fn(parent_src) if parent_src else None
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, failed = [], []
    print(f"{'layer':8s} {'dtype':8s} {'plan':24s} {'n':>2s} {'new_ms':>9s} "
          f"{'parent_ms':>9s} {'library_ms':>10s} {'bound_ms':>9s} "
          f"{'TFLOP/s':>8s} {'err':>9s} {'parent_err':>10s}")
    for dtype in (torch.float32, torch.bfloat16):
        for sh in cs.mesh_conv_shapes(meshnet.MESH1K):
            n, hp, wp, c = sh["x"]
            k, f, s = sh["k"], sh["f"], sh["stride"]
            lo, hi = same_pads(k, s)
            x = torch.randn((n, hp - lo - hi, wp - lo - hi, c), generator=gen,
                            device=dev).to(dtype)
            xp = F.pad(x, (0, 0, lo, hi, lo, hi))
            w = (torch.randn((k, k, c, f), generator=gen, device=dev)
                 * math.sqrt(2.0 / (k * k * c))).to(dtype)
            y = kconv.conv2d(xp, w, stride=s)

            def run_old():
                yo = torch.empty_like(y)
                err = old(xp.data_ptr(), w.data_ptr(), yo.data_ptr(),
                          0 if dtype == torch.float32 else 1, n, hp, wp, c,
                          k, k, f, s, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"parent kernel: cudaError_t {err}")
                return yo

            yr = conv2d_ref(xp, w, stride=s).float()
            scale = max(1.0, float(yr.abs().max()))
            err = float((y.float() - yr).abs().max())
            if not err <= cs.FWD_TOL[dtype] * scale:
                failed.append(f"{sh['layer']} {dtype}: max |err| {err} > "
                              f"{cs.FWD_TOL[dtype]} * {scale}")
                print(failed[-1], flush=True)
            p_err = None if old is None else \
                float((run_old().float() - yr).abs().max())
            new_t, old_t = [], []
            for turn in ("old", "new", "new", "old"):
                if turn == "old" and old is None:
                    continue
                t = time_fn(run_old if turn == "old" else
                            (lambda: kconv.conv2d(xp, w, stride=s)),
                            reps=10, warmup=2)
                (old_t if turn == "old" else new_t).append(t * 1e3)
            x_nchw = xp.permute(0, 3, 1, 2)
            w_oihw = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            lib_ms = time_fn(lambda: F.conv2d(x_nchw, w_oihw, stride=s),
                             reps=10, warmup=2) * 1e3
            flops = 2.0 * n * y.shape[1] * y.shape[2] * f * k * k * c
            nbytes = (xp.numel() + w.numel() + y.numel()) * xp.element_size()
            bound_ms = max(flops / cs.PEAK_FLOPS[dtype],
                           nbytes / cs.PEAK_BYTES_S) * 1e3
            p = kconv.plan(tuple(xp.shape), tuple(w.shape), s, dtype)
            ms = sum(new_t) / len(new_t)
            row = {"layer": sh["layer"], "dtype": str(dtype).split(".")[-1],
                   "x": list(sh["x"]), "k": k, "f": f, "stride": s,
                   "count": sh["count"], "plan": p.__dict__, "ms": ms,
                   "ms_turns": new_t, "parent_ms": (sum(old_t) / len(old_t)
                                                    if old_t else None),
                   "parent_ms_turns": old_t, "library_ms": lib_ms,
                   "bound_ms": bound_ms, "tflops_s": flops / ms / 1e9,
                   "max_abs_err": err, "parent_max_abs_err": p_err}
            rows.append(row)
            plan_s = f"{p.path} {p.tile_m}x{p.tile_n} k{p.splits}"
            par = "-" if row["parent_ms"] is None else \
                f"{row['parent_ms']:9.4f}"
            print(f"{sh['layer']:8s} {row['dtype']:8s} {plan_s:24s} "
                  f"{sh['count']:2d} {ms:9.4f} {par:>9s} {lib_ms:10.4f} "
                  f"{bound_ms:9.4f} {row['tflops_s']:8.2f} {err:9.2e} "
                  f"{'-' if p_err is None else f'{p_err:.2e}':>10s}",
                  flush=True)
            del x, xp, w, y, yr
            torch.cuda.empty_cache()
    for dt in ("float32", "bfloat16"):
        sel = [r for r in rows if r["dtype"] == dt]
        tot = {key: (None if any(r[key] is None for r in sel) else
                     sum(r[key] * r["count"] for r in sel))
               for key in ("ms", "parent_ms", "library_ms", "bound_ms")}
        print(f"one mesh1k forward, {dt}: " + ", ".join(
            f"{key} {'-' if v is None else f'{v:.4f}'}"
            for key, v in tot.items()), flush=True)
    if failed:
        raise AssertionError("kernel vs plain: " + "; ".join(failed))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-src")
    ap.add_argument("--parent-tree")
    ap.add_argument("--step-only", action="store_true")
    ap.add_argument("--src")
    args = ap.parse_args()
    if args.step_only:
        print(json.dumps(step_only(args.src)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("conv_ab: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    rows = kernel_ab(args.parent_src)
    steps = step_ab(args.parent_tree) if args.parent_tree else None
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "conv_ab.json"), "w") as f:
        json.dump({"card": card, "shapes": rows, "steps": steps}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
