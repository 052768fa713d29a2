"""The dry run's abstract trace against the same rank's real step, on the
CPU, in a process of its own (the fake process group is global to a
process).

    PYTHONPATH=src python tests/torch_dryrun_cases.py DIR

joins torch.distributed's fake group as one rank of data 2 x model 2 and,
for each CELLS cell (SMOKE configs at reduced shapes, passed as the
reference's probes pass `cfg=`), builds the cell with
`launch.dryrun.build_cell` twice: under `FakeTensorMode` (the dry run's
trace) and for real, on the CPU, from the same seeds.  Each step runs
once under `dryrun.measure_step`; the kernels' entry points in
`kernels.ops` are counted as they are called (the plain versions on the
CPU).  Writes DIR/cells.json: per cell the two runs' FLOPs, collectives
by kind and kernel-entry calls, and the facts a test derives the calls
from.  Imports torch and numpy only, never jax.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import sys

# (name, arch, shape or None for a CNN, variant, rank of the 4): the
# sequences are multiples of the SMOKE SSD chunks; mixtral's 512 keeps its
# routing groups of 256 within a shard (expert parallelism on model 2);
# rank 2 holds pixtral's patch prefix
SMOKE_SHAPE = {"seq_len": 64, "global_batch": 4}
CELLS = [
    ("hymba_train", "hymba_1_5b", dict(SMOKE_SHAPE, kind="train"), "base", 3),
    ("hymba_prefill", "hymba_1_5b", dict(SMOKE_SHAPE, kind="prefill"),
     "base", 3),
    ("hymba_decode", "hymba_1_5b", dict(SMOKE_SHAPE, kind="decode"), "base",
     3),
    ("mixtral_opt", "mixtral_8x7b",
     {"seq_len": 512, "global_batch": 4, "kind": "train"}, "opt", 3),
    ("seamless_prefill", "seamless_m4t_large_v2",
     dict(SMOKE_SHAPE, kind="prefill"), "base", 3),
    ("seamless_decode", "seamless_m4t_large_v2",
     dict(SMOKE_SHAPE, kind="decode"), "base", 3),
    ("pixtral_prefill", "pixtral_12b", dict(SMOKE_SHAPE, kind="prefill"),
     "base", 2),
    ("mesh1k_cnn", "mesh1k", None, "base", 3),
]
MESH = {"data": 2, "model": 2}
CNN_BATCH = 4
ENTRIES = ("conv2d", "flash_attention", "flash_attention_block", "ssd_chunk")


def _counting(calls: collections.Counter):
    """Wrap `kernels.ops`' kernel entry points so each call adds one to
    `calls` (the plain versions run on the CPU)."""
    from repro_torch.kernels import ops

    def wrap(name, fn):
        def counted(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return counted
    for name in ENTRIES:
        setattr(ops, name, wrap(name, getattr(ops, name)))


def main(d: str) -> int:
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh, init_fake_group
    torch.set_num_threads(1)
    calls: collections.Counter = collections.Counter()
    _counting(calls)
    out = {}
    world = MESH["data"] * MESH["model"]
    for name, arch, shape, variant, rank in CELLS:
        init_fake_group(rank, world)
        try:
            mesh = Mesh(MESH)
            cfg = registry.get(arch, smoke=True)
            runs = {}
            for how in ("fake", "real"):
                calls.clear()
                torch.manual_seed(0)
                with FakeTensorMode() if how == "fake" else \
                        contextlib.nullcontext():
                    step, args, _ = dryrun.build_cell(
                        arch, shape, mesh, variant, "cpu", cfg, CNN_BATCH)
                    _, res = dryrun.measure_step(step, args, mesh, "cpu",
                                                 memory=how == "fake")
                runs[how] = {"flops": res["flops"],
                             "collectives": res["collectives"],
                             "entries": dict(calls),
                             "kernel_calls": res["kernel_calls"]}
                if how == "fake":
                    runs[how]["peak_bytes"] = res["peak_bytes"]
                    runs[how]["argument_bytes"] = res["argument_bytes"]
            out[name] = dict(runs, arch=arch, rank=rank,
                             coords=mesh.coords, layer_types=getattr(
                                 cfg, "layer_types", lambda: [])(),
                             window=getattr(cfg, "window", None))
        finally:
            dist.destroy_process_group()
    with open(os.path.join(d, "cells.json"), "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
