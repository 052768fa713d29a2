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

import ctypes
import sys
import time

from ab_common import HERE, main, parent_fn, print_totals, timing_row, turns

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
        loss = float(step(params, state, None, batch)[3]["loss"])
    ops.reset_launch_counts()
    times = []
    for _ in range(STEP_REPS):
        t0 = time.perf_counter()
        loss = float(step(params, state, None, batch)[3]["loss"])
        times.append(time.perf_counter() - t0)
    return {"src": src, "step_s": times,
            "mean_s": sum(times) / len(times), "loss": loss,
            "conv_launches": ops.launch_counts()["conv2d"]}


def report(name: str, row: dict) -> None:
    print(f"step {name:6s}: mean {row['mean_s'] * 1e3:.3f} ms over "
          f"{STEP_REPS} steps (min {min(row['step_s']) * 1e3:.3f}), "
          f"loss {row['loss']!r}, conv launches {row['conv_launches']}",
          flush=True)


I64 = ctypes.c_int64
# repro_conv2d(x, w, y, dtype, n, h, wd, c, kh, kw, f, s, stream)
PARENT_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [I64] * 8 + \
    [ctypes.c_void_p]


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
    old = parent_fn(parent_src, "conv2d", PARENT_ARGTYPES) \
        if parent_src else None
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
            new_t, old_t = turns(
                lambda fn: time_fn(fn, reps=10, warmup=2) * 1e3,
                lambda: kconv.conv2d(xp, w, stride=s),
                None if old is None else run_old)
            x_nchw = xp.permute(0, 3, 1, 2)
            w_oihw = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            lib_ms = time_fn(lambda: F.conv2d(x_nchw, w_oihw, stride=s),
                             reps=10, warmup=2) * 1e3
            flops = 2.0 * n * y.shape[1] * y.shape[2] * f * k * k * c
            nbytes = (xp.numel() + w.numel() + y.numel()) * xp.element_size()
            p = kconv.plan(tuple(xp.shape), tuple(w.shape), s, dtype)
            row = {"layer": sh["layer"], "dtype": str(dtype).split(".")[-1],
                   "x": list(sh["x"]), "k": k, "f": f, "stride": s,
                   "count": sh["count"], "plan": p.__dict__,
                   "max_abs_err": err, "parent_max_abs_err": p_err,
                   **timing_row(new_t, old_t, lib_ms, flops, nbytes, dtype)}
            rows.append(row)
            ms, bound_ms = row["ms"], row["bound_ms"]
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
    print_totals(rows, "one mesh1k forward")
    if failed:
        raise AssertionError("kernel vs plain: " + "; ".join(failed))
    return rows


if __name__ == "__main__":
    sys.exit(main(__doc__, "conv_ab", __file__, kernel_ab, step_only,
                  report))
