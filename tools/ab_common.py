"""What the kernel A/B tools (`conv_ab.py`, `attn_ab.py`) share: building
an earlier source of a kernel beside this tree's, timing the two in turns
(earlier, this, this, earlier), the bound and the row of one shape, the
per-forward totals, the training step of two checkouts in four fresh
processes (a step's ranks spawned on the card, the mesh1k step timed on
each), and the command line that writes chiprun_out/<name>.json.

A tool supplies its kernel rows (`kernel_ab(parent_src)`), its step body
(`step_only(src)`, run as `<tool> --step-only --src DIR/src`) and a line
that reports one step row.
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


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def parent_fn(src: str, name: str, argtypes: list):
    """The entry point `repro_<name>` of the earlier source `src`, built
    with this tree's nvcc flags beside this tree's kernels."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR / f"{name}_parent.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run(_build.nvcc_command(_build.find_nvcc(), Path(src), out),
                   check=True, capture_output=True)
    fn = getattr(ctypes.CDLL(str(out)), f"repro_{name}")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def turns(timer, run_new, run_old) -> tuple[list[float], list[float]]:
    """ms of `run_new` and of `run_old` (None: no earlier kernel) by
    `timer`, in turns: earlier, this, this, earlier."""
    new_t, old_t = [], []
    for turn in ("old", "new", "new", "old"):
        if turn == "old" and run_old is None:
            continue
        t = timer(run_old if turn == "old" else run_new)
        (old_t if turn == "old" else new_t).append(t)
    return new_t, old_t


def timing_row(new_t, old_t, lib_ms, flops, nbytes, dtype) -> dict:
    """The times of one shape, its bound (max of FLOPs over the dtype's
    peak and bytes over HBM3's rate, chip_smoke's table) and TFLOP/s."""
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    ms = sum(new_t) / len(new_t)
    return {"ms": ms, "ms_turns": new_t,
            "parent_ms": sum(old_t) / len(old_t) if old_t else None,
            "parent_ms_turns": old_t, "library_ms": lib_ms,
            "bound_ms": max(flops / cs.PEAK_FLOPS[dtype],
                            nbytes / cs.PEAK_BYTES_S) * 1e3,
            "tflops_s": flops / ms / 1e9}


def print_totals(rows: list[dict], what: str) -> None:
    """Each dtype's times over one forward: each shape's times the calls
    that make it."""
    for dt in ("float32", "bfloat16"):
        sel = [r for r in rows if r["dtype"] == dt]
        tot = {key: (None if any(r[key] is None for r in sel) else
                     sum(r[key] * r["count"] for r in sel))
               for key in ("ms", "parent_ms", "library_ms", "bound_ms")}
        print(f"{what}, {dt}: " + ", ".join(
            f"{key} {'-' if v is None else f'{v:.4f}'}"
            for key, v in tot.items()), flush=True)


def spawn_ranks(rank_fn, ranks: int, src: str) -> list[dict]:
    """rank_fn(rank, ranks, port, src, out_dir) in `ranks` spawned
    processes (one gloo group on a free local port); what each wrote to
    out_dir/rank<r>.json."""
    import socket
    import tempfile

    import torch.multiprocessing as mp
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    out_dir = tempfile.mkdtemp(dir=os.path.join(HERE, "build"))
    mp.spawn(rank_fn, args=(ranks, port, src, out_dir), nprocs=ranks,
             join=True)
    out = []
    for r in range(ranks):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def mesh1k_step_s(plan, mesh, batch: int, warmup: int, reps: int,
                  overlap: bool = True) -> dict:
    """On a rank of `mesh` on the card: the full-width mesh1k training
    step under `plan` (seeded params, lr 0, the synthetic batch of step
    0), `warmup` steps, then each of `reps` steps on the host clock from
    a barrier to a synchronise; the step seconds and the last loss."""
    import functools

    import torch
    import torch.distributed as dist
    from repro_torch.data import pipeline
    from repro_torch.models.cnn import meshnet
    from repro_torch.optim.optimizer import sgd
    from repro_torch.train.train_loop import TrainStepConfig, make_train_step
    from repro_torch.utils import FP32
    dev = torch.device("cuda")
    cfg = meshnet.MESH1K
    specs = meshnet.layer_specs(cfg, batch)
    params = meshnet.MeshNet(cfg, generator=torch.Generator().manual_seed(0),
                             device=dev).params()
    opt = sgd(0.0, momentum=0.9)
    step = make_train_step(functools.partial(
        meshnet.loss_fn, cfg=cfg, plan=plan, mesh=mesh, overlap=overlap),
        opt, TrainStepConfig(precision=FP32), mesh=mesh)
    state = opt.init(params)
    data = pipeline.to_device(pipeline.shard_batch(
        pipeline.synthetic_mesh_batch(0, batch, cfg.input_hw,
                                      cfg.in_channels, out_hw=cfg.out_hw),
        mesh, plan.sharding(specs[0].name), plan.sharding("pred")), dev)
    for _ in range(warmup):
        loss = float(step(params, state, data)[2]["loss"])
    times = []
    for _ in range(reps):
        dist.barrier()
        t0 = time.perf_counter()
        loss = float(step(params, state, data)[2]["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    del params, state, data
    torch.cuda.empty_cache()
    return {"step_s": times, "loss": loss}


def step_ab(script: str, parent_tree: str, report) -> list[dict]:
    """`script --step-only --src` of DIR's package and this one, in four
    fresh processes (parent, change, change, parent); `report(name, row)`
    prints each row."""
    order = [("parent", os.path.join(parent_tree, "src")),
             ("change", os.path.join(HERE, "src"))]
    out = []
    for name, src in order + order[::-1]:
        res = subprocess.run(
            [sys.executable, os.path.abspath(script), "--step-only",
             "--src", src], capture_output=True, text=True, timeout=900)
        if res.returncode:
            raise RuntimeError(f"step run of {name} failed:\n"
                               f"{res.stderr[-4000:]}")
        row = json.loads(res.stdout.strip().splitlines()[-1])
        row["tree"] = name
        out.append(row)
        report(name, row)
    return out


def main(doc: str, name: str, script: str, kernel_ab, step_only,
         report) -> int:
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
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
        print(f"{name}: needs a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}", flush=True)
    rows = kernel_ab(args.parent_src)
    steps = step_ab(script, args.parent_tree, report) \
        if args.parent_tree else None
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", f"{name}.json"), "w") as f:
        json.dump({"card": card, "shapes": rows, "steps": steps}, f,
                  indent=1)
    return 0
