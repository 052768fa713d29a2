#!/usr/bin/env python3
"""Params held at rest (FSDP blocks over data) against an earlier tree
that holds them whole, on the card: the bytes of params a rank holds and
its peak memory, and the dry run's cells that did not fit.

    python3 tools/fsdp_ab.py --parent-tree DIR

Needs one CUDA card and `nvcc`.  Each tree (DIR's, this one) builds its
kernels, then runs in fresh processes of its own `chip_smoke.py`:

- phase 4h's four ranks (`zero_rank`: full-width mesh1k, global batch 4
  on pod 2 x data 2 x model 1 over gloo, 3 trainer steps under each pod
  compression): each rank's params as it holds them between steps and
  its `torch.cuda.max_memory_allocated`;
- phase 11's real steps (`dryrun_real`: the last rank of the production
  mesh under the fake group, qwen1.5-0.5b train_4k, hymba-1.5b
  prefill_32k and decode_32k, mesh1k pod1, full width and depth): the
  params the step takes and its peak; a step a tree cannot build (an
  earlier tree's whole decode caches, say) is recorded with its error.

Meanwhile both trees trace on the host's spare cores (`python -m
repro_torch.launch.dryrun --device cuda`, no card used, the lowest CPU
priority, four at a time) the serving cells that the sweep put over 80
GiB a card with whole fp32 params (mixtral-8x7b prefill_32k, decode_32k
and long_500k, pod1 and pod2), and this tree the train cells it put
over 80 GiB with whole params (gemma2-9b, qwen2.5-14b, pixtral-12b,
olmoe-1b-7b and mixtral-8x7b train_4k, pod1 and pod2); each one's
traced peak a rank.

A gloo mesh sharing one card is a parity run, not a scaling result.
Rows go to chiprun_out/fsdp_ab.json, with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (arch, shape, multi_pod) over 80 GiB a card in the sweep with whole
# params: the train cells (PR 29), then the serving ones (PR 31)
TRAIN_OVER_80 = [(a, "train_4k", p) for a in (
    "gemma2_9b", "qwen2_5_14b", "pixtral_12b", "olmoe_1b_7b",
    "mixtral_8x7b") for p in (False, True)]
SERVING_OVER_80 = [("mixtral_8x7b", s, p) for s in (
    "prefill_32k", "decode_32k", "long_500k") for p in (False, True)]
REAL_CELLS = [("qwen1_5_0_5b", "train_4k", False),
              ("hymba_1_5b", "prefill_32k", False),
              ("hymba_1_5b", "decode_32k", False),
              ("mesh1k", "cnn", False)]
TRACE_JOBS = 4


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def _env(tree: str) -> dict:
    return dict(os.environ, PYTHONPATH=os.path.join(tree, "src"),
                OMP_NUM_THREADS="1")


def _py(tree: str, code: str, timeout: int = 1200) -> str:
    """`code` run by python in `tree` (its chip_smoke importable); its
    standard output, raising on failure."""
    p = subprocess.run([sys.executable, "-c", code], cwd=tree,
                       env=_env(tree), capture_output=True, text=True,
                       timeout=timeout)
    if p.returncode:
        raise RuntimeError(f"{tree}: rc {p.returncode}\n{p.stdout[-3000:]}"
                           f"\n{p.stderr[-6000:]}")
    return p.stdout


ZERO_CODE = """
import json, chip_smoke as c
ranks = c.spawn_ranks(c.zero_rank, 4)
print("ROWS " + json.dumps([{m: {k: r[m].get(k) for k in (
    "peak_gib", "losses", "n_params", "momentum_bytes",
    "param_bytes_at_rest", "param_bytes_whole")} for m in c.ZERO_METHODS}
    for r in ranks]))
"""


def zero_rows(tree: str) -> list[dict]:
    """Phase 4h's ranks of `tree`: per rank and pod compression, the peak
    and the params' bytes as the rank holds them (an earlier tree holds
    them whole: 4 bytes a param)."""
    out = _py(tree, ZERO_CODE)
    rows = json.loads(out.split("ROWS ", 1)[1].splitlines()[0])
    for r in rows:
        for v in r.values():
            if v["param_bytes_at_rest"] is None:
                v["param_bytes_at_rest"] = 4 * v["n_params"]
    return rows


def real_rows(tree: str) -> dict:
    """Phase 11's real steps of `tree` (REAL_CELLS), one fresh process a
    cell, each timed at once: the params' bytes the step takes and its
    peak, or the error of a step the tree cannot build."""
    out = {}
    for arch, shape, pod2 in REAL_CELLS:
        path = os.path.join(HERE, "build", "fsdp_ab",
                            f"{os.path.basename(tree)}-{arch}-{shape}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path + ".go", "w"):
            pass
        code = ("import chip_smoke as c\n"
                f"c.dryrun_real({arch!r}, {shape!r}, {pod2!r}, {path!r})\n")
        try:
            _py(tree, code)
        except RuntimeError as e:
            out[f"{arch}-{shape}"] = {"error": str(e).strip().splitlines()[-1]}
            continue
        with open(path) as f:
            got = json.load(f)
        out[f"{arch}-{shape}"] = {
            "peak_bytes": got["peak_bytes"], "flops": got["flops"],
            "param_bytes": got.get("param_bytes"),
            "step_ms": got["step_ms"], "launches": got["launches"]}
    return out


def param_bytes_of(tree: str, arch: str, shape: str) -> int:
    """The bytes of the params the dry run's cell takes on the last rank
    (built on fake tensors): for an earlier tree's real rows, which do
    not report them."""
    code = ("import torch\n"
            "from torch._subclasses.fake_tensor import FakeTensorMode\n"
            "from repro_torch.launch import dryrun\n"
            "from repro_torch.launch.mesh import PRODUCTION_MESH\n"
            "from repro_torch.utils import tree_leaves\n"
            "with FakeTensorMode():\n"
            f"    _, args, _ = dryrun.build_cell({arch!r}, {shape!r}, "
            "dict(PRODUCTION_MESH[False]), 'base', 'cuda')\n"
            "    print('BYTES', sum(p.numel() * p.element_size() for p in "
            "tree_leaves(args[0])))\n")
    return int(_py(tree, code).split("BYTES ", 1)[1].split()[0])


def trace_over_80(jobs: list, out_dir: str) -> dict:
    """The dry run of each (tree, arch, shape, multi_pod) of `jobs` in its
    tree, TRACE_JOBS at a time: each one's traced peak a rank, by tree
    and cell tag."""
    def tag_of(arch, shape, pod2):
        return f"{arch}-{shape}-{'pod2' if pod2 else 'pod1'}"
    jobs = list(jobs)
    running, rows = [], {}
    while jobs or running:
        while jobs and len(running) < TRACE_JOBS:
            tree, arch, shape, pod2 = jobs.pop(0)
            tag = f"{os.path.basename(tree)}/{tag_of(arch, shape, pod2)}"
            out = os.path.join(out_dir, os.path.basename(tree))
            os.makedirs(out, exist_ok=True)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--device",
                   "cuda", "--out", out] + ["--multi-pod"] * pod2
            log = open(os.path.join(out_dir, tag + ".log"), "w")
            running.append((tag, log, subprocess.Popen(
                cmd, cwd=tree, env=_env(tree), stdout=log,
                stderr=subprocess.STDOUT, preexec_fn=lambda: os.nice(19))))
        time.sleep(1)
        for item in list(running):
            tag, log, p = item
            if p.poll() is None:
                continue
            log.close()
            running.remove(item)
            path = os.path.join(out_dir, tag + ".json")
            if p.returncode or not os.path.exists(path):
                rows[tag] = {"result": f"failed rc {p.returncode}"}
                continue
            with open(path) as f:
                pd = json.load(f)["per_device"]
            rows[tag] = {"result": "ok", "peak_bytes": pd["peak_bytes"],
                         "argument_bytes": pd["argument_bytes"],
                         "fits_80gib": pd["peak_bytes"] <= 80 * 2 ** 30}
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-tree", required=True)
    args = ap.parse_args()
    parent = os.path.abspath(args.parent_tree)
    card = card_line()
    t0 = time.perf_counter()
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from repro_torch.kernels import _build; "
         "_build.build_all()"], cwd=t, env=_env(t)) for t in (parent, HERE)]
    if any(b.wait() for b in builds):
        raise RuntimeError("a kernel build failed")
    print(f"built both trees in {time.perf_counter() - t0:.1f} s",
          flush=True)
    out = {"card": card, "trees": {}}
    # the traces use no card: on the host's spare cores meanwhile
    jobs = [(t, *c) for c in SERVING_OVER_80 for t in (parent, HERE)] + \
        [(HERE, *c) for c in TRAIN_OVER_80]
    traced = threading.Thread(target=lambda: out.update(
        over_80=trace_over_80(jobs, os.path.join(HERE, "build", "fsdp_ab",
                                                 "dryrun"))))
    traced.start()
    for name, tree in (("parent", parent), ("this", HERE)):
        row = {"zero": zero_rows(tree), "real": real_rows(tree)}
        for cell, r in row["real"].items():
            if "error" not in r and r["param_bytes"] is None:
                r["param_bytes"] = param_bytes_of(tree, *cell.split("-"))
        out["trees"][name] = row
        for i, r in enumerate(row["zero"]):
            print(f"{name}: phase 4h rank {i}: " + "; ".join(
                f"{m} params held {v['param_bytes_at_rest']} B, peak "
                f"{v['peak_gib']:.3f} GiB" for m, v in r.items())
                + f" ({card})", flush=True)
        for cell, r in row["real"].items():
            print(f"{name}: phase 11 {cell} real step: " + (
                f"params held {r['param_bytes']} B, peak "
                f"{r['peak_bytes']} B ({r['peak_bytes'] / 2 ** 30:.3f} "
                f"GiB), step {r['step_ms']:.1f} ms" if "error" not in r
                else f"failed: {r['error']}") + f" ({card})", flush=True)
    traced.join()
    for tag, r in out["over_80"].items():
        print(f"dry run {tag}: " + (
            f"peak {r['peak_bytes'] / 2 ** 30:.2f} GiB a rank "
            f"({'fits' if r['fits_80gib'] else 'OVER'} 80 GiB), arguments "
            f"{r['argument_bytes'] / 2 ** 30:.2f} GiB" if r["result"] == "ok"
            else r["result"]) + f" ({card})", flush=True)
    out["seconds"] = time.perf_counter() - t0
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "fsdp_ab.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"fsdp_ab took {out['seconds']:.1f} s ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
