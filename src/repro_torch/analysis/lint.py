"""Plan linter — pure-static invariant checks over a compiled NetworkPlan,
port of `repro.analysis.lint` (rule ids, severities and messages are the
reference's).

No tracing, no execution, no devices: every rule re-derives an invariant
the plan compiler (core.plan) is supposed to have established and reports
where the plan in hand violates it, as structured `Finding` records in the
PlanError diagnostics style (offending layer named, fix hint attached).

Rule catalog (rule ids are stable — tests and the CI static lane key on
them):

  divisibility             the compiled dist must lower to a runtime
                           sharding that is a fixed point of the §III-A
                           geometry fit (no hidden demotion left to do),
                           divide N, and — for CF layers — divide the
                           channel counts.
  demotion-not-load-bearing  every recorded demotion must be load-bearing:
                           the pre-demotion solved dist must genuinely
                           fail the geometry/channel/executability checks.
  reshard-missing /        reshard_in must hold exactly on layers whose
  reshard-spurious         dist differs from the previous layer's (§III-C
                           coverage, recomputed in execution order).
  reshard-unpriced /       every reshard point must carry a positive
  phantom-shuffle          priced shuffle in predicted['shuffle_per_layer']
                           — and only reshard points may.
  memory-fit               per-layer resident sets and the network peak
                           must fit predicted['memory']['limit_bytes'],
                           findings naming LayerMemory.breakdown().
  spec-roundtrip           to_spec -> dists_from_spec -> compile_plan must
                           reproduce the same shardings and reshard flags
                           (the repro/plan@1 checkpoint contract).
  no-cost-report           (info) the plan was compiled without a machine,
                           so the priced-shuffle and memory rules have
                           nothing to check against.

Two readings follow the port's fitted uniform plan (`NetworkPlan.uniform`
with specs, what `launch/train.py --strategy uniform` runs): where a
layer's output reshards after its conv (`LayerPlan.out`), the reshard
coverage compares the next layer with that output sharding, the tensor it
receives; and the spec round trip compares shardings without the mesh's
axes of size 1, which shard nothing and which `compile_plan` drops (the
reference compares them as they are).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from repro_torch.core import plan as plan_lib
from repro_torch.core.channel_conv import CFSharding
from repro_torch.core.perfmodel import ConvLayer
from repro_torch.launch.mesh import axes_tuple
from repro_torch.utils import human_bytes

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One static-analysis result: what rule fired, where, and how to fix.

    severity: 'error' (the costed and executed plans disagree — the audit
    gates fail on these), 'warning' (known model gap or unconfirmed
    convention), 'info' (context, never gating)."""
    severity: str
    rule: str
    message: str
    layer: str | None = None
    fix: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def error_count(findings: Sequence[Finding]) -> int:
    return sum(1 for f in findings if f.severity == "error")


def format_findings(findings: Sequence[Finding]) -> str:
    """Render findings as the fixed-width table --audit modes print."""
    if not findings:
        return "no findings"
    order = {s: i for i, s in enumerate(SEVERITIES)}
    rows = [f"{'severity':8s} {'rule':26s} {'layer':14s} message"]
    for f in sorted(findings, key=lambda f: order.get(f.severity, 9)):
        msg = f.message + (f"  [fix: {f.fix}]" if f.fix else "")
        rows.append(f"{f.severity:8s} {f.rule:26s} {f.layer or '-':14s} "
                    f"{msg}")
    counts = {s: sum(1 for f in findings if f.severity == s)
              for s in SEVERITIES}
    rows.append(" ".join(f"{v} {k}(s)" for k, v in counts.items() if v))
    return "\n".join(rows)


def _load_bearing(solved, spec: ConvLayer,
                  mesh_shape: Mapping[str, int]) -> bool:
    """Would the pre-demotion dist really have failed to execute as-is?"""
    try:
        sh = plan_lib.dist_to_sharding(solved, mesh_shape, layer=spec.name)
    except plan_lib.PlanError:
        return True
    if solved.ways("N", mesh_shape) and spec.n % max(
            solved.ways("N", mesh_shape), 1):
        return True
    if sh.fit(spec.h, spec.w, spec.k, spec.s, dict(mesh_shape)) != sh:
        return True
    if isinstance(sh, CFSharding) and not sh.fits_channels(
            spec.c, spec.f, mesh_shape):
        return True
    return False


def _unit_free(sh, mesh_shape: Mapping[str, int]):
    """`sh` without the mesh axes of size 1, which shard nothing
    (compile_plan drops them, the fitted uniform plan keeps them)."""
    def keep(axes):
        return tuple(a for a in axes_tuple(axes) if mesh_shape.get(a, 1) > 1)
    return dataclasses.replace(
        sh, batch_axes=keep(sh.batch_axes),
        h_axis=plan_lib._spatial_axis(keep(sh.h_axis)),
        w_axis=plan_lib._spatial_axis(keep(sh.w_axis)))


def lint_plan(plan, specs: Sequence[ConvLayer] | None = None,
              mesh_shape: Mapping[str, int] | None = None) -> list[Finding]:
    """Run every applicable lint rule over `plan`.

    `specs` and `mesh_shape` unlock the geometry-dependent rules
    (divisibility, demotion, spec round-trip); without them only the
    plan-internal rules (reshard coverage, shuffle pricing, memory fit)
    run.  Returns Finding records; error-severity means the plan violates
    an invariant the solver's cost report relies on.
    """
    plan = plan_lib.NetworkPlan.of(plan)
    out: list[Finding] = []
    lps = list(plan.layers.values())
    spec_by_name = {s.name: s for s in (specs or [])}

    # ---- geometry: divisibility / fit fixed point / demotion -------------
    if mesh_shape:
        for lp in lps:
            if lp.dist is None:
                continue
            spec = spec_by_name.get(lp.name)
            try:
                sh = plan_lib.dist_to_sharding(lp.dist, mesh_shape,
                                               layer=lp.name)
            except plan_lib.PlanError as e:
                out.append(Finding(
                    "error", "divisibility", layer=lp.name,
                    message=f"compiled dist does not lower: {e}",
                    fix="recompile the plan; the stored dist predates a "
                        "runtime rule change"))
                continue
            if spec is None:
                continue
            if spec.n % max(lp.dist.ways("N", mesh_shape), 1):
                out.append(Finding(
                    "error", "divisibility", layer=lp.name,
                    message=f"N={spec.n} not divisible by "
                            f"{lp.dist.ways('N', mesh_shape)}-way batch "
                            f"split",
                    fix="demote the batch axes or change the batch size"))
            fitted = sh.fit(spec.h, spec.w, spec.k, spec.s,
                            dict(mesh_shape))
            if fitted != sh:
                out.append(Finding(
                    "error", "divisibility", layer=lp.name,
                    message=f"compiled sharding is not a fixed point of "
                            f"the geometry fit ({spec.h}x{spec.w} vs "
                            f"k={spec.k},s={spec.s}) — the runtime would "
                            f"demote it again, diverging from the cost "
                            f"report",
                    fix="compile through core.plan.compile_plan so the "
                        "demotion is recorded and re-costed"))
            if isinstance(sh, CFSharding) and not sh.fits_channels(
                    spec.c, spec.f, mesh_shape):
                out.append(Finding(
                    "error", "divisibility", layer=lp.name,
                    message=f"channels C={spec.c}->F={spec.f} do not "
                            f"divide the {sh.cf_axis!r} CF axis",
                    fix="compile_plan demotes such layers; this plan "
                        "bypassed it"))
            if lp.solved is not None and not _load_bearing(
                    lp.solved, spec, mesh_shape):
                out.append(Finding(
                    "error", "demotion-not-load-bearing", layer=lp.name,
                    message=f"recorded demotion "
                            f"({lp.note or 'unannotated'}) demoted a dist "
                            f"that executes fine as solved — the plan "
                            f"runs a slower distribution than it charged "
                            f"for",
                    fix="drop the demotion or fix the fit rule that "
                        "triggered it"))

    # ---- reshard coverage (§III-C, recomputed in execution order) --------
    prev = None
    for i, lp in enumerate(lps):
        d = lp.dist
        if d is not None and prev is not None:
            expected = not prev.same_as(d)
            if expected and not lp.reshard_in:
                out.append(Finding(
                    "error", "reshard-missing", layer=lp.name,
                    message="distribution changes at this layer but no "
                            "reshard point is compiled — the runtime "
                            "would feed it a mis-sharded tensor",
                    fix="recompile with core.plan.compile_plan (it "
                        "detects transitions by dist comparison)"))
            if not expected and lp.reshard_in:
                out.append(Finding(
                    "error", "reshard-spurious", layer=lp.name,
                    message="reshard point compiled but the adjacent "
                            "dists are identical — an unpaid shuffle "
                            "the cost report never charged",
                    fix="drop reshard_in; identical dists chain for "
                        "free"))
        if i == 0 and lp.reshard_in:
            out.append(Finding(
                "error", "reshard-spurious", layer=lp.name,
                message="first layer marked reshard_in — the input "
                        "batch is placed by input_spec, never shuffled",
                fix="drop reshard_in on the first layer"))
        if lp.out is not None:
            d = plan_lib._sharding_to_dist(lp.out)
        prev = d if d is not None else prev

    # ---- priced shuffles -------------------------------------------------
    if plan.predicted is None:
        out.append(Finding(
            "info", "no-cost-report",
            message="plan compiled without a machine: shuffle pricing and "
                    "memory fit have nothing to check against"))
    else:
        shuf = plan.predicted.get("shuffle_per_layer", {})
        for i, lp in enumerate(lps):
            if lp.name not in shuf:
                continue          # cost report covers a sub-path (graphs)
            priced = shuf[lp.name] > 0.0
            if i == 0 and priced:
                out.append(Finding(
                    "error", "phantom-shuffle", layer=lp.name,
                    message="first layer carries a priced shuffle — "
                            "there is no §III-C transition into it",
                    fix="shuffle_per_layer[first] must be 0.0"))
            elif lp.reshard_in and not priced:
                out.append(Finding(
                    "error", "reshard-unpriced", layer=lp.name,
                    message="compiled reshard point carries no priced "
                            "shuffle — the solver compared plans "
                            "without this transition's cost",
                    fix="compile_plan charges shuffle_time to the "
                        "receiving layer; re-attach the cost report"))
            elif i > 0 and not lp.reshard_in and priced:
                out.append(Finding(
                    "error", "phantom-shuffle", layer=lp.name,
                    message=f"priced shuffle "
                            f"({shuf[lp.name] * 1e6:.1f} us) on a layer "
                            f"with no reshard point — comm charged but "
                            f"never executed",
                    fix="recompute shuffle_per_layer from the compiled "
                        "dists"))

        # ---- memory fit vs the recorded limit ----------------------------
        mem = plan.predicted.get("memory")
        if mem is not None and mem.get("limit_bytes"):
            limit = mem["limit_bytes"]
            for name, lm in mem.get("per_layer", {}).items():
                if lm.total > limit:
                    out.append(Finding(
                        "error", "memory-fit", layer=name,
                        message=f"resident set "
                                f"{human_bytes(lm.total)} exceeds the "
                                f"{human_bytes(limit)}/device limit "
                                f"({lm.breakdown()})",
                        fix="re-solve with mem_limit; this plan skipped "
                            "the capacity validation"))
            if mem["peak_bytes"] > limit:
                peak_lm = mem.get("per_layer", {}).get(mem["peak_layer"])
                out.append(Finding(
                    "error", "memory-fit", layer=mem["peak_layer"],
                    message=f"network peak "
                            f"{human_bytes(mem['peak_bytes'])} exceeds "
                            f"the {human_bytes(limit)}/device limit"
                            + (f" ({peak_lm.breakdown()})"
                               if peak_lm is not None else ""),
                    fix="stash accumulation overflows even though each "
                        "layer fits; tighten the per-layer budget "
                        "(plan_line does this automatically)"))

    # ---- repro/plan@1 round trip -----------------------------------------
    if mesh_shape and specs and all(lp.dist is not None for lp in lps) \
            and set(spec_by_name) == set(plan.layers):
        try:
            rec = plan.to_spec(mesh_shape)
            dists = plan_lib.dists_from_spec(rec)
            plan2 = plan_lib.compile_plan(dists, list(specs), mesh_shape)
        except Exception as e:  # noqa: BLE001 — any failure is the finding
            out.append(Finding(
                "error", "spec-roundtrip",
                message=f"to_spec -> compile_plan round trip failed: {e}",
                fix="the stored spec must always re-lower on the mesh it "
                    "was solved for (the checkpoint restore contract)"))
        else:
            for lp in lps:
                lp2 = plan2.layers[lp.name]
                if _unit_free(lp2.sharding, mesh_shape) != \
                        _unit_free(lp.sharding, mesh_shape):
                    out.append(Finding(
                        "error", "spec-roundtrip", layer=lp.name,
                        message=f"sharding changed through the "
                                f"repro/plan@1 round trip: "
                                f"{lp.sharding} -> {lp2.sharding}",
                        fix="to_spec must record the post-demotion dist"))
                if lp2.reshard_in != lp.reshard_in:
                    out.append(Finding(
                        "error", "spec-roundtrip", layer=lp.name,
                        message="reshard point "
                                + ("appeared" if lp2.reshard_in
                                   else "vanished")
                                + " through the repro/plan@1 round trip",
                        fix="reshard flags must be a pure function of "
                            "the recorded dists"))
    return out
