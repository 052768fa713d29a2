#!/usr/bin/env python3
"""The halo's backward on the card: this tree against an earlier one, in
turns.

    python3 tools/halo_ab.py --parent-tree DIR

Needs one CUDA card and `nvcc`.  2 processes share the card over gloo
(data 1 x model 2).  Each times, with the §IV-A split (overlap on, the
default of every spatial step) and serialized:

- conv2_2 of full-width mesh1k at batch 2, H over model: the host ms of
  one backward (dL/dx and dL/dw of its convs and the halo gradients'
  exchange), in alternating rounds after one warm-up of each;
- the full-width mesh1k training step (batch 2, lr 0, 2 warm-up steps,
  then 10 steps each ended by a synchronise, on the host clock) under
  the uniform plan (N over data, H over model: a halo exchange and the
  split at every layer).

A time is the max over the two ranks.  Four fresh runs: DIR's package,
this one, this one, DIR's.  Only the halo's backward differs between a
tree that posts the halo gradients before the interior's dL/dx and one
whose backward exchange is synchronous.

Rows go to chiprun_out/halo_ab.json.  `--step-only --src DIR/src` is the
timing of one tree (used by the above).
"""
from __future__ import annotations

import json
import os
import sys
import time

from ab_common import HERE, card_line, mesh1k_step_s, spawn_ranks, step_ab

STEP_REPS, STEP_WARMUP, BATCH, RANKS = 10, 2, 2, 2
LAYER, LAYER_ROUNDS = "conv2_2", 8
MODES = {"overlapped": True, "serialized": False}


def _layer_bwd_ms(mesh, spec, overlap: bool, rounds: int) -> list[float]:
    """Host ms of `spec`'s backward under H over model, `rounds` times."""
    import torch
    from repro_torch.core.spatial_conv import ConvSharding, spatial_conv2d
    gen = torch.Generator().manual_seed(mesh.rank)
    hl = spec.h // mesh.axis_size("model")
    x0 = torch.randn((spec.n, hl, spec.w, spec.c), generator=gen).cuda()
    w = (torch.randn((spec.k, spec.k, spec.c, spec.f), generator=gen)
         * 0.05).cuda().requires_grad_()
    out = []
    for _ in range(rounds):
        x = x0.detach().requires_grad_()
        y = spatial_conv2d(x, w, strides=(spec.s, spec.s),
                           sharding=ConvSharding(h_axis="model"),
                           mesh=mesh, overlap=overlap)
        gy = torch.ones_like(y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y.backward(gy)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _rank(rank: int, world: int, port: int, src: str, out_dir: str) -> None:
    """One rank: the layer's backward and the step times of each mode, to
    out_dir/rank<r>.json."""
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist
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
        spec = next(s for s in meshnet.layer_specs(cfg, BATCH)
                    if s.name == LAYER)
        out = {"layer_ms": {m: [] for m in MODES}}
        for overlap in MODES.values():                 # warm both
            _layer_bwd_ms(mesh, spec, overlap, 1)
        for _ in range(LAYER_ROUNDS):
            for mode, overlap in MODES.items():
                out["layer_ms"][mode] += _layer_bwd_ms(mesh, spec, overlap,
                                                       1)
        plan = meshnet.network_plan(
            cfg, ConvSharding(batch_axes=("data",), h_axis="model"), mesh)
        for mode, overlap in MODES.items():
            out[mode] = mesh1k_step_s(plan, mesh, BATCH, STEP_WARMUP,
                                      STEP_REPS, overlap=overlap)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _median(v: list[float]) -> float:
    return sorted(v)[len(v) // 2]


def step_only(src: str) -> dict:
    """The package under `src` on 2 ranks: per mode, the layer's backward
    ms and each step's seconds, each the max over the ranks."""
    ranks = spawn_ranks(_rank, RANKS, src)
    out = {"src": src}
    for mode in MODES:
        layer = [max(t) for t in zip(*(r["layer_ms"][mode] for r in ranks))]
        steps = [max(t) for t in zip(*(r[mode]["step_s"] for r in ranks))]
        out[mode] = {"layer_ms": layer, "layer_median_ms": _median(layer),
                     "step_s": steps, "mean_s": sum(steps) / len(steps),
                     "loss": ranks[0][mode]["loss"]}
    return out


def report(name: str, row: dict) -> None:
    print(f"{name:6s}: " + "; ".join(
        f"{mode}: {LAYER} backward median {row[mode]['layer_median_ms']:.3f}"
        f" ms of {LAYER_ROUNDS}, uniform step mean "
        f"{row[mode]['mean_s'] * 1e3:.3f} ms over {STEP_REPS} (min "
        f"{min(row[mode]['step_s']) * 1e3:.3f}), loss {row[mode]['loss']!r}"
        for mode in MODES), flush=True)


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
        print("halo_ab: needs a CUDA card and --parent-tree",
              file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}", flush=True)
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import _build
    _build.build_all()
    rows = step_ab(__file__, args.parent_tree, report)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "halo_ab.json"), "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
