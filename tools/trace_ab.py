#!/usr/bin/env python3
"""The cost of the named regions (`core/trace.py`) on a training step, on
one card: this tree against an earlier one, in turns.

    python3 tools/trace_ab.py --parent-tree DIR

Needs one CUDA card and `nvcc`.  Times the full-width mesh1k training
step (batch 2 on the card, lr 0, 2 warm-up steps, then 10 steps each
ended by a synchronise, on the host clock) as 2 processes sharing the
card over gloo, under two plans: the H100-solved auto plan (N -> CF -> N,
two reshards; chip_smoke's phase 4c) and the uniform plan (N over data, H
over model: a halo exchange and the §IV-A split at every layer).  A
step's time is the max over the two ranks.  Four fresh runs: DIR's
package, this one, this one, DIR's.  In this tree every layer is a
`layer_context` and every halo exchange, conv piece, BN all-reduce, CF
collective and reshard a `record_function` region; the profiler is off,
so what they cost is their bookkeeping.

Rows go to chiprun_out/trace_ab.json.  `--step-only --src DIR/src` is
the timing of one tree (used by the above).
"""
from __future__ import annotations

import json
import os
import sys

from ab_common import HERE, card_line, mesh1k_step_s, spawn_ranks, step_ab

STEP_REPS, STEP_WARMUP, BATCH, RANKS = 10, 2, 2, 2
PLANS = ("auto", "uniform")


def _rank(rank: int, world: int, port: int, src: str, out_dir: str) -> None:
    """One rank: each plan's step times, to out_dir/rank<r>.json."""
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist
    from repro_torch.core import plan as plan_lib
    from repro_torch.core.perfmodel import H100
    from repro_torch.core.spatial_conv import ConvSharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import set_fp32_numerics
    from repro_torch.models.cnn import meshnet

    torch.cuda.set_device(0)
    set_fp32_numerics(torch.device("cuda"), echo=False)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(1, world)
        cfg = meshnet.MESH1K
        specs = meshnet.layer_specs(cfg, BATCH)
        out = {}
        for name in PLANS:
            plan = plan_lib.plan_line(H100, specs, dict(mesh.shape)) \
                if name == "auto" else meshnet.network_plan(
                    cfg, ConvSharding(batch_axes=("data",),
                                      h_axis="model"), mesh)
            out[name] = mesh1k_step_s(plan, mesh, BATCH, STEP_WARMUP,
                                      STEP_REPS)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def step_only(src: str) -> dict:
    """The 2-rank step times of the package under `src`: per plan, each
    step's max over the ranks."""
    ranks = spawn_ranks(_rank, RANKS, src)
    out = {"src": src}
    for name in PLANS:
        steps = [max(t) for t in zip(*(r[name]["step_s"] for r in ranks))]
        out[name] = {"step_s": steps, "mean_s": sum(steps) / len(steps),
                     "loss": ranks[0][name]["loss"]}
    return out


def report(name: str, row: dict) -> None:
    print(f"step {name:6s}: " + "; ".join(
        f"{plan} mean {row[plan]['mean_s'] * 1e3:.3f} ms over {STEP_REPS} "
        f"steps (min {min(row[plan]['step_s']) * 1e3:.3f}), loss "
        f"{row[plan]['loss']!r}" for plan in PLANS), flush=True)


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-tree")
    ap.add_argument("--step-only", action="store_true")
    ap.add_argument("--src")
    args = ap.parse_args()
    if args.step_only:
        print(json.dumps(step_only(args.src)))
        return 0
    import torch
    if not torch.cuda.is_available() or not args.parent_tree:
        print("trace_ab: needs a CUDA card and --parent-tree",
              file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}", flush=True)
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import _build
    _build.build_all()
    steps = step_ab(__file__, args.parent_tree, report)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "trace_ab.json"), "w") as f:
        json.dump({"card": card, "steps": steps}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
