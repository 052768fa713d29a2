"""Quickstart on the port (PyTorch; the H100 by default): the paper's
pipeline — solve, compile, execute — in one minute, the counterpart of
examples/quickstart.py, stage for stage.

1. Build the (reduced) mesh-tangling model.
2. Run the strategy optimizer (paper §V-C) on its layer line for this
   mesh, and ALSO show what it would pick on a hypothetical 2x2 mesh —
   including a hand-mixed spatial + channel/filter (§III-D) plan with
   explicit reshard points at the transitions.
3. Compile the solved strategy into an executable NetworkPlan (per-layer
   shardings + §III-C reshard points, core.plan), audit it, and train a
   few steps WITH that plan; checkpoint and resume.
4. Trace the plan: segmented per-layer profiling (core.trace) joined
   against the model's predictions (plan.attribution_report).

  PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]
  PYTHONPATH=src torchrun --nproc-per-node M examples/quickstart_torch.py \\
      --device cpu

The machine preset is the trainer's (`launch.train.build_cnn_plan`):
`H100` on the card, `LASSEN` (the paper's machine) on the CPU.  The
reference's script hardcodes `TPU_V5E`, which the port does not carry, so
the plans solved here may differ from that script's printout; with the
reference's functions called on `LASSEN` they are the same.  "This
process's devices" are one card (or the CPU), or under torchrun the
process group's ranks as a data 1 x model M mesh.  The params are whole
on every rank: the reference places them with `shard_tree(..., P())`,
which the port needs no counterpart of.  Each rank writes its own copy of
the (global) checkpoint.
"""
from __future__ import annotations

import argparse
import functools
import os
import tempfile

import torch

from repro_torch import analysis
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.core import plan as plan_lib
from repro_torch.core.distribution import (
    Dist, channel_filter, hybrid)
from repro_torch.core.perfmodel import H100, LASSEN
from repro_torch.core.trace import format_attribution, trace_plan
from repro_torch.data import pipeline
from repro_torch.launch import shardings
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.launch.train import set_fp32_numerics
from repro_torch.models.cnn import meshnet
from repro_torch.optim.optimizer import sgd
from repro_torch.runtime import chaos
from repro_torch.runtime.fault_tolerance import (
    ResilientLoop, StragglerMonitor)
from repro_torch.train.train_loop import (
    TrainStepConfig, make_train_step)
from repro_torch.utils import (
    FP32, human_count, resolve_device, tree_num_params)

CONFIG = meshnet.MeshNetConfig("quickstart", input_hw=64, in_channels=4,
                               convs_per_block=1, widths=(8, 16, 16))
BATCH = 4


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None, params=None) -> dict:
    """Run every stage; `params`: the reference's param list to start from
    (numpy arrays, `MeshNet.params_from_jax`), else `init` from seed 0.
    Returns the plans, the audit's findings, the losses and the trace."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    rank, world, local = init_distributed(device)
    if device.type == "cuda":
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    lead = rank == 0
    say = print if lead else (lambda *a, **k: None)
    set_fp32_numerics(device, echo=False)

    cfg = CONFIG
    model = meshnet.MeshNet(cfg, generator=torch.Generator().manual_seed(0),
                            device=device)
    if params is not None:
        model.params_from_jax(params)
    params = model.params()
    say(f"model: {cfg.name}, {human_count(tree_num_params(params))} params")

    machine = H100 if device.type == "cuda" else LASSEN
    layers = meshnet.layer_specs(cfg, n=BATCH)

    # --- what would the optimizer do on a (hypothetical) 2x2 mesh? -------
    hypo = plan_lib.plan_line(machine, layers, {"data": 2, "model": 2})
    say(f"\nsolved plan for a hypothetical 2x2 mesh (paper §V-C, "
        f"{machine.name}):")
    say(hypo.describe())

    # --- mixed spatial + channel/filter plan (§III-D) --------------------
    # The early layer keeps the hybrid sample x spatial decomposition; the
    # later layers switch to channel/filter parallelism
    # (core.channel_conv).  Each transition compiles to one §III-C
    # reshard point.
    mixed = plan_lib.compile_plan(
        {"conv1_1": hybrid(),                 # N on data, H on model
         "conv2_1": channel_filter(),         # N on data, C&F on model
         "conv3_1": channel_filter(),         # chains with zero resharding
         "pred": Dist("sample", {"N": ("data", "model")})},
        layers, {"data": 2, "model": 2}, machine=machine)
    say("\nhand-mixed spatial + CF plan on the same 2x2 mesh:")
    say(mixed.describe())

    # --- a 16-device (4x2x2) mesh: H over a tuple of axes (core.halo's
    # product axis) and CF on one axis composed with spatial on others
    ms16 = {"pod": 4, "data": 2, "model": 2}
    auto16 = plan_lib.plan_line(machine, layers, ms16)
    say("\nsolved plan for a hypothetical 16-device (4x2x2) mesh:")
    say(auto16.describe())
    mixed16 = plan_lib.compile_plan(
        {"conv1_1": Dist("s+h2", {"N": ("pod",), "H": ("data", "model")}),
         "conv2_1": Dist("cf*h", {"N": ("pod",), "H": ("data",),
                                  "C": ("model",), "F": ("model",)}),
         "conv3_1": Dist("cf*h", {"N": ("pod",), "H": ("data",),
                                  "C": ("model",), "F": ("model",)}),
         "pred": Dist("s+h2", {"N": ("pod",), "H": ("data", "model")})},
        layers, ms16, machine=machine)
    say("\nhand-mixed sample + two-axis-spatial + CF x spatial plan "
        "(consecutive CF layers chain; each family change is one reshard):")
    say(mixed16.describe())

    # --- memory-aware planning (--mem-limit): at batch 2 < 4 devices the
    # sample-parallel plan is stuck at one sample a device, its peak above
    # a limit of 3/4 of it; the solve under that limit buys memory with
    # spatial parallelism
    layers2 = meshnet.layer_specs(cfg, n=2)
    ms22 = {"data": 2, "model": 2}
    sample2 = plan_lib.compile_plan(
        {l.name: Dist("sample", {"N": ("data",)}) for l in layers2},
        layers2, ms22, machine=machine)
    limit = 0.75 * sample2.predicted["memory"]["peak_bytes"]
    say(f"\nuniform sample-parallel at batch 2 — stuck at one sample per "
        f"device, peak ABOVE the {limit:.0f}-byte limit:")
    say(sample2.describe())
    fit2 = plan_lib.plan_line(machine, layers2, ms22, mem_limit=limit)
    say(f"\nsolved WITH --mem-limit {limit:.0f} "
        f"(min-time subject to the fit — spatial buys the memory down):")
    say(fit2.describe())
    for name, lm in fit2.predicted["memory"]["per_layer"].items():
        say(f"  {name:10s} {lm.total / 2**10:7.1f} KiB  ({lm.breakdown()})")

    # --- solve + compile for THIS process's devices, then execute it -----
    mesh = make_mesh(data=1, model=world)
    plan = plan_lib.plan_line(machine, layers, mesh)
    say(f"\nexecuting on mesh {dict(mesh.shape)}:")
    say(plan.describe())
    first, last = plan.sharding(layers[0].name), plan.sharding("pred")

    def batch_at(step: int) -> dict:
        b = pipeline.synthetic_mesh_batch(step, BATCH, cfg.input_hw,
                                          cfg.in_channels, out_hw=cfg.out_hw)
        return pipeline.to_device(
            pipeline.shard_batch(b, mesh, first, last), device)

    # --- static audit: prove costed == executed BEFORE spending a step ---
    # repro_torch.analysis lints the solved plan and records one real step
    # of it (forward, backward, the gradient reduction), joining every
    # collective against the cost model's priced inventory.
    findings = plan.audit(layers, mesh, cfg=cfg, overlap=True, hlo=False,
                          params=params, batch=batch_at(0), device=device)
    errors = analysis.error_count(findings)
    say(f"\nstatic audit of the executing plan ({len(findings)} "
        f"finding(s), {errors} error(s)):")
    say(analysis.format_findings(findings))
    assert errors == 0

    loss_fn = functools.partial(meshnet.loss_fn, cfg=cfg, plan=plan,
                                mesh=mesh)
    opt = sgd(0.05, momentum=0.9)
    step = make_train_step(loss_fn, opt, TrainStepConfig(precision=FP32),
                           mesh=mesh)
    state = opt.init(params)

    def tree(st):
        return shardings.sharded_state_tree(st[0], st[1], None, mesh)

    def load(like, restored):
        return like[0], shardings.load_sharded_state_tree(
            restored, like[0], like[1], None, mesh)

    work = tempfile.TemporaryDirectory()         # the checkpoints
    ck = CheckpointManager(os.path.join(work.name, "ck"), async_save=False)
    say("\ntraining under the compiled plan:")
    losses = []
    for i in range(10):
        params, state, _, m = step(params, state, None, batch_at(i))
        losses.append(float(m["loss"]))
        if i % 3 == 0:
            say(f"  step {i}: loss {losses[-1]:.4f}")
    ck.save(10, tree((params, state)), extra={"step": 10})
    restored, manifest = ck.restore(tree((params, state)))
    params, state = load((params, state), restored)
    say(f"checkpoint round-trip ok (step {manifest['step']})")

    # --- fault tolerance: kill the run mid-step, watch it recover --------
    # The resilient loop checkpoints every 3 steps, its manifests carrying
    # the solved plan spec (repro/plan@1); on a fault it rolls back to the
    # last checkpoint and replays the same step-indexed batches, so the
    # recovered trajectory is the uninterrupted one.
    ran = []

    def make_step():
        def run(st, i):
            p, s, _, mt = step(st[0], st[1], None, batch_at(i))
            ran.append((i, float(mt["loss"])))
            return (p, s), {"loss": ran[-1][1]}
        return run

    ck2 = CheckpointManager(os.path.join(work.name, "ck2"),
                            async_save=False)
    loop = ResilientLoop(ckpt=ck2, make_step=make_step, ckpt_every=3,
                         plan_spec=lambda: plan.to_spec(dict(mesh.shape)),
                         leaves=tree, load=load)
    (params, state), end, m = loop.run((params, state), 0, 8,
                                       monitor=StragglerMonitor(),
                                       inject_failure=chaos.raise_at_step(5))
    rec = ck2.read_manifest()["plan"]
    work.cleanup()
    say(f"faulted at step 5, rolled back to the step-3 checkpoint, replayed "
        f"to step {end} (loss {m['loss']:.4f}); manifest records the plan "
        f"solved on mesh {rec['mesh']}")

    # --- trace the plan: measured per-layer cost vs the model's prediction
    # core.trace runs each layer alone (forward and forward + backward,
    # interleaved-min timing) and the attribution report joins the
    # measured seconds against the plan's predicted LayerCost terms.
    trace = trace_plan(plan, params, batch_at(0), cfg=cfg, mesh=mesh,
                       reps=2, rounds=2)
    say(f"\ntraced {len(trace.layers)} layers "
        f"(per-layer sum {trace.layer_sum_s * 1e3:.2f} ms, "
        f"fused step {trace.step['fwd_bwd_s'] * 1e3:.2f} ms):")
    report = plan.attribution_report(trace)
    say(format_attribution(report))
    say("done.")
    return {"cfg": cfg, "machine": machine.name, "mesh": dict(mesh.shape),
            "plans": {"hypo": hypo, "mixed": mixed, "auto16": auto16,
                      "mixed16": mixed16, "sample2": sample2, "fit2": fit2,
                      "plan": plan},
            "limit": limit, "findings": findings, "errors": errors,
            "losses": losses, "resilient": ran, "end": end,
            "final_loss": m["loss"], "manifest_plan": rec, "trace": trace,
            "report": report, "params": params}


if __name__ == "__main__":
    main()
