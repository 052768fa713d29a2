"""The static-analysis lane's driver, port of `repro.launch.dryrun --audit`.

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.dryrun \
      --audit [WORKLOAD ...] [--audit-out FILE] [--no-hlo] \
      [--search greedy|beam[:N]|hillclimb] [--device cuda|cpu]

The bench workloads' plans (`repro_torch.analysis.workloads`, the
reference's registry) are solved on the mesh of the running processes,
data = world // 2 x model 2 on 4 (the reference's 4 host devices), on
the `H100` preset on CUDA and on `LASSEN` (the paper's machine) on the
CPU, as `launch/train.py` solves.  Each is linted and its collectives
audited (`NetworkPlan.audit`: one real step, forward, backward and the
gradient bucket, on seeded params and the synthetic batch, joined against
the priced inventory, and with the profiler cross-check unless
`--no-hlo`).  On a mesh without a model axis of size > 1 the workloads
that need one are skipped, as in the reference.  Every rank audits its
own record; the errors counted are the maximum over the ranks.  Rank 0
prints the findings and writes one `repro/plan_audit@1` JSON (the
reference's keys; `collective_backend`, the torch.distributed backend, in
place of its `replication_policy`).  Any error-severity finding exits
non-zero.  Runs on CUDA unless `--device cpu` is given (gloo ranks on the
CPU, NCCL on the card under torchrun; a process group that already exists
is used as it is).

The reference's other mode, lowering every (arch x shape) cell on a
512-device pod, is not ported.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch import analysis
from repro_torch.analysis import workloads as WL
from repro_torch.core.perfmodel import H100, LASSEN
from repro_torch.core.plan import PlanError
from repro_torch.core.strategy import CapacityError, parse_search
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.utils import resolve_device

SCHEMA = "repro/plan_audit@1"


def run_audit(workload_names, out_path: str, hlo: bool = True,
              search: str = "greedy", device: str = "cuda") -> int:
    """--audit: lint + collective-audit the bench workloads' solved plans
    on this process group's mesh.  Returns the process exit code (non-zero
    iff any error-severity finding on any rank)."""
    dev = resolve_device(device)
    rank, world, local = init_distributed(dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    data = max(1, world // 2)
    model = max(1, world // data)
    mesh = make_mesh(data=data, model=model)
    lead = rank == 0
    machine = H100 if dev.type == "cuda" else LASSEN
    names = list(workload_names) or list(WL.WORKLOADS)
    report = {
        "schema": SCHEMA,
        "backend": dev.type,
        "collective_backend": mesh.backend,
        "mesh": dict(mesh.shape),
        "search": search,
        "workloads": {},
    }
    n_errors = 0
    for name in names:
        w = WL.WORKLOADS[name]
        if w.needs_model_axis and model <= 1:
            if lead:
                print(f"# audit/{name}: SKIPPED (mesh has no model axis)")
            report["workloads"][name] = {"skipped": True}
            continue
        t0 = time.time()
        try:
            plan, specs, cfg = WL.solve_workload(
                name, machine, dict(mesh.shape), search=search)
        except (PlanError, CapacityError) as e:
            # a memory-fit recipe can have no plan on a small mesh
            if lead:
                print(f"# audit/{name}: SKIPPED (no plan on this mesh: "
                      f"{type(e).__name__}: {str(e).splitlines()[0]})")
            report["workloads"][name] = {"skipped": True,
                                         "reason": str(e)}
            continue
        findings = plan.audit(specs, mesh, cfg=cfg, overlap=True, hlo=hlo,
                              device=dev)
        errs = int(mesh.all_max([analysis.error_count(findings)])[0])
        n_errors += errs
        if lead:
            print(f"# audit/{name}: {len(findings)} finding(s), {errs} "
                  f"error(s) ({time.time() - t0:.1f}s, one step)")
            print(analysis.format_findings(findings))
        report["workloads"][name] = {
            "skipped": False,
            "n_findings": len(findings),
            "n_errors": errs,
            "n_reshards": plan.n_reshards,
            "findings": [f.to_json() for f in findings],
        }
    report["n_errors"] = n_errors
    if lead:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        print(f"# wrote {out_path}")
        if n_errors:
            print(f"# AUDIT FAILED: {n_errors} error-severity finding(s) — "
                  f"costed != executed")
    return 1 if n_errors else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 allow_abbrev=False)
    ap.add_argument("--audit", nargs="*", default=None, metavar="WORKLOAD",
                    help="lint + collective-audit the named bench workload "
                         "plans (all when none named); exits non-zero on "
                         "any error-severity finding")
    ap.add_argument("--audit-out", default="build/audit/PLAN_audit.json")
    ap.add_argument("--no-hlo", action="store_true",
                    help="skip the profiler cross-check of the audited step")
    ap.add_argument("--search", default="greedy",
                    metavar="greedy|beam[:N]|hillclimb",
                    help="solver search mode for the audited workload plans")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    try:
        parse_search(args.search)
    except ValueError as e:
        ap.error(str(e))
    if args.audit is None:
        ap.error("only the --audit lane is ported (the arch-cell lowering "
                 "is not)")
    unknown = [n for n in args.audit if n not in WL.WORKLOADS]
    if unknown:
        ap.error(f"unknown workload(s) {unknown}; known: "
                 f"{', '.join(WL.WORKLOADS)}")
    created = not dist.is_initialized()
    try:
        return run_audit(args.audit, args.audit_out, hlo=not args.no_hlo,
                         search=args.search, device=args.device)
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
