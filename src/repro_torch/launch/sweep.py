"""Run the dry run's whole matrix, port of `repro.launch.sweep`: 10 LM
archs x 4 shapes x {1 pod, 2 pods} plus the paper's CNN workloads (86
cells).  One subprocess a cell (`python -m repro_torch.launch.dryrun`,
the repo root its working directory, `PYTHONPATH=src`): the fake process
group a cell joins is global to its process.  A cell that fails writes
the reference's failure JSON (its last lines of stderr) in place of its
artifact.

  PYTHONPATH=src python -m repro_torch.launch.sweep [--only-missing] \
      [--pods 1,2] [--out build/dryrun] [--device cuda|cpu] [--jobs N]

`--jobs` runs that many cells at once (default 1, as the reference).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import time

from repro_torch.configs import registry
from repro_torch.launch.dryrun import cell_tag

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def run_one(arch, shape, multi_pod, out_dir, variant="base",
            timeout=1200, device="cuda") -> dict:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", out_dir, "--device", device]
    if multi_pod:
        cmd.append("--multi-pod")
    if variant != "base":
        cmd += ["--variant", variant]
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    t0 = time.time()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, env=env, cwd=REPO)
        ok, err = r.returncode == 0, (r.stderr or "").strip().splitlines()
    except subprocess.TimeoutExpired:
        ok, err = False, [f"timed out after {timeout} s"]
    if not ok:
        fail = {"arch": arch, "shape": shape, "variant": variant,
                "mesh": "2x16x16" if multi_pod else "16x16", "ok": False,
                "error": err[-15:] if err else ["(no stderr)"]}
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir,
                               cell_tag(arch, shape, multi_pod, variant)
                               + ".json"), "w") as f:
            json.dump(fail, f, indent=1)
    print(f"[{time.strftime('%H:%M:%S')}] {arch:24s} {shape:12s} "
          f"{'pod2' if multi_pod else 'pod1'} "
          f"{'OK' if ok else 'FAIL'} ({time.time()-t0:.0f}s)", flush=True)
    return {"ok": ok}


def cells(pods=(False, True), include_cnn: bool = True) -> list[tuple]:
    """(arch, shape, multi_pod) of every base cell, in the reference's
    order."""
    out = [(arch, shape, mp) for arch in registry.ARCHS
           for shape in registry.SHAPES for mp in pods]
    if include_cnn:
        out += [(arch, "cnn", mp) for arch in registry.CNN_ARCHS
                for mp in pods]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only-missing", action="store_true")
    ap.add_argument("--pods", default="1,2")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--include-cnn", action="store_true", default=True)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--jobs", type=int, default=1)
    args = ap.parse_args(argv)
    args.out = os.path.abspath(args.out)     # the cells run from the root
    pods = [p == "2" for p in args.pods.split(",")]

    todo, n_skip = [], 0
    for arch, shape, mp in cells(pods, args.include_cnn):
        path = os.path.join(args.out, cell_tag(arch, shape, mp) + ".json")
        if args.only_missing and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("ok"):
                    n_skip += 1
                    continue
        todo.append((arch, shape, mp))
    with concurrent.futures.ThreadPoolExecutor(max(1, args.jobs)) as pool:
        oks = list(pool.map(lambda c: run_one(
            *c, args.out, device=args.device)["ok"], todo))
    n_ok = sum(oks)
    print(f"sweep done: {n_ok} ok, {len(oks) - n_ok} failed, {n_skip} "
          f"skipped")


if __name__ == "__main__":
    main()
