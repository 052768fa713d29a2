#!/usr/bin/env python3
"""The data-2 training step on the card: this tree's gradient reduction
against an earlier tree's, in turns.

    python3 tools/zero_ab.py --parent-tree DIR

Needs one CUDA card and `nvcc`.  2 processes share the card over gloo
(data 2 x model 1).  Each times, on full-width mesh1k at global batch 2
(one sample a rank) under the sample-parallel plan (N over data, no
spatial split, so that only the gradient reduction, the update and what
follows it differ between two trees):

- the gradient reduction alone, on mesh1k's 55 gradient leaves (seeded,
  fp32): a tree with the sharded training state (`launch/shardings.py`)
  runs `train_loop.reduce_grads` (a reduce-scatter of the sharded leaves
  over data, an all-reduce of the rest) and `shardings.gather_params_`
  (the all-gather of the updated blocks); an earlier one
  `train_loop.reduce_replicated_grads` (one all-reduce of everything);
  host ms from a barrier to a synchronise, in rounds after one warm-up;
- each collective those are made of, alone, on a flat fp32 buffer of
  mesh1k's gradient elements: the all-reduce and the reduce-scatter of
  all of it, the all-gather of one rank's half;
- the training step (lr 0, 2 warm-up steps, then 10 steps each ended by
  a synchronise, on the host clock).

A time is the max over the two ranks.  Four fresh runs: DIR's package,
this one, this one, DIR's.  Gloo stages every collective through host
memory: these are not NCCL times, and 2 processes share one card.

Rows go to chiprun_out/zero_ab.json.  `--step-only --src DIR/src` is the
timing of one tree (used by the above).
"""
from __future__ import annotations

import json
import os
import sys
import time

from ab_common import HERE, card_line, spawn_ranks, step_ab

STEP_REPS, STEP_WARMUP, BATCH, RANKS = 10, 2, 2, 2
REDUCE_ROUNDS = 8


def _reduction_ms(mesh, params, rounds: int) -> tuple[list[float], str]:
    """Host ms of this tree's gradient reduction (and, with the sharded
    state, the gather of the updated blocks), `rounds` times after one
    warm-up; which reduction ran."""
    import torch
    import torch.distributed as dist
    from repro_torch.train import train_loop
    from repro_torch.utils import tree_leaves
    gen = torch.Generator().manual_seed(1 + mesh.rank)
    grads = [torch.randn(p.shape, generator=gen).to(p.device)
             for p in tree_leaves(params)]
    if hasattr(train_loop, "reduce_grads"):
        from repro_torch.launch import shardings
        what = "reduce_grads + gather_params_"

        def run():
            train_loop.reduce_grads(grads, mesh)
            shardings.gather_params_(params, mesh)
    else:
        what = "reduce_replicated_grads"

        def run():
            train_loop.reduce_replicated_grads(grads, mesh)
    out = []
    for i in range(rounds + 1):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        if i:
            out.append((time.perf_counter() - t0) * 1e3)
    return out, what


def _collectives_ms(mesh, params, rounds: int) -> dict:
    """Host ms (median of `rounds`) of each collective the two reductions
    are made of, on a flat fp32 buffer of mesh1k's gradient elements on
    the card, through this tree's `Mesh` over data: the all-reduce of
    all of it, the reduce-scatter of all of it and the all-gather of
    one rank's half."""
    import torch
    import torch.distributed as dist
    from repro_torch.utils import tree_leaves
    n = sum(p.numel() for p in tree_leaves(params))
    n -= n % mesh.shape["data"]
    flat = torch.ones(n, device="cuda")
    half = flat[:n // mesh.shape["data"]].clone()
    ops = {"all_reduce": lambda: mesh.all_reduce(flat, "data"),
           "reduce_scatter": lambda: mesh.reduce_scatter(flat, "data", 0),
           "all_gather": lambda: mesh.all_gather(half, "data", 0)}
    out = {}
    for name, op in ops.items():
        times = []
        for i in range(rounds + 1):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            op()
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
        out[name] = times
    return out


def _step_s(plan, mesh, params) -> dict:
    """The training step's seconds under `plan` (lr 0, the synthetic batch
    of step 0) with either tree's step signature, and the last loss."""
    import functools

    import torch
    import torch.distributed as dist
    from repro_torch.data import pipeline
    from repro_torch.models.cnn import meshnet
    from repro_torch.optim.optimizer import sgd
    from repro_torch.train import train_loop
    from repro_torch.utils import FP32
    cfg = meshnet.MESH1K
    specs = meshnet.layer_specs(cfg, BATCH)
    opt = sgd(0.0, momentum=0.9)
    step = train_loop.make_train_step(
        functools.partial(meshnet.loss_fn, cfg=cfg, plan=plan, mesh=mesh),
        opt, train_loop.TrainStepConfig(precision=FP32), mesh=mesh)
    data = pipeline.to_device(pipeline.shard_batch(
        pipeline.synthetic_mesh_batch(0, BATCH, cfg.input_hw,
                                      cfg.in_channels, out_hw=cfg.out_hw),
        mesh, plan.sharding(specs[0].name), plan.sharding("pred")),
        torch.device("cuda"))
    if hasattr(train_loop, "reduce_grads"):          # the sharded state
        from repro_torch.launch import shardings
        state = opt.init(shardings.local_shards(params, mesh))

        def run():
            return step(params, state, None, data)[3]["loss"]
    else:
        state = opt.init(params)

        def run():
            return step(params, state, data)[2]["loss"]
    for _ in range(STEP_WARMUP):
        loss = float(run())
    times = []
    for _ in range(STEP_REPS):
        dist.barrier()
        t0 = time.perf_counter()
        loss = float(run())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"step_s": times, "loss": loss}


def _rank(rank: int, world: int, port: int, src: str, out_dir: str) -> None:
    """One rank: the reduction's and the step's times, to
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
        mesh = make_mesh(world, 1)
        cfg = meshnet.MESH1K
        params = meshnet.MeshNet(
            cfg, generator=torch.Generator().manual_seed(0),
            device=torch.device("cuda")).params()
        red, what = _reduction_ms(mesh, params, REDUCE_ROUNDS)
        coll = _collectives_ms(mesh, params, REDUCE_ROUNDS)
        plan = meshnet.network_plan(cfg, ConvSharding(batch_axes=("data",)),
                                    mesh)
        out = {"reduction_ms": red, "reduction": what,
               "collectives_ms": coll,
               **_step_s(plan, mesh, params)}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _median(v: list[float]) -> float:
    return sorted(v)[len(v) // 2]


def step_only(src: str) -> dict:
    """The package under `src` on 2 ranks: the reduction's ms and each
    step's seconds, each the max over the ranks."""
    ranks = spawn_ranks(_rank, RANKS, src)
    red = [max(t) for t in zip(*(r["reduction_ms"] for r in ranks))]
    steps = [max(t) for t in zip(*(r["step_s"] for r in ranks))]
    coll = {k: _median([max(t) for t in zip(*(r["collectives_ms"][k]
                                              for r in ranks))])
            for k in ranks[0]["collectives_ms"]}
    return {"src": src, "reduction": ranks[0]["reduction"],
            "collectives_median_ms": coll,
            "reduction_ms": red, "reduction_median_ms": _median(red),
            "step_s": steps, "mean_s": sum(steps) / len(steps),
            "median_s": _median(steps), "loss": ranks[0]["loss"]}


def report(name: str, row: dict) -> None:
    print(f"{name:6s}: {row['reduction']} median "
          f"{row['reduction_median_ms']:.3f} ms of {REDUCE_ROUNDS}; step "
          f"mean {row['mean_s'] * 1e3:.3f} ms, median "
          f"{row['median_s'] * 1e3:.3f} over {STEP_REPS} (min "
          f"{min(row['step_s']) * 1e3:.3f}), loss {row['loss']!r}; "
          f"collectives alone, median ms: " + ", ".join(
              f"{k} {v:.3f}" for k, v in
              row["collectives_median_ms"].items()), flush=True)


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
        print("zero_ab: needs a CUDA card and --parent-tree",
              file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}", flush=True)
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import _build
    _build.build_all()
    rows = step_ab(__file__, args.parent_tree, report)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "zero_ab.json"), "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
