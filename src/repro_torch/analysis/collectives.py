"""Collective auditor — prove costed == executed on one real step, port of
`repro.analysis.collectives`.

The perf model (core.perfmodel.layer_collectives) declares the priced
inventory: every collective the runtime should issue for a layer under its
distribution, with kind, payload bytes, mesh axes and the cost term that
charges it.  The reference walks the traced jaxpr of the step; torch has
no such trace, so here the step runs once under `record()` and the
execution path reports what it does, in issue order (`ExecutedOp`):

  * `launch.mesh.Mesh`'s all-reduce, all-gather, reduce-scatter and
    all-to-all (kinds `psum`, `all_gather`, `reduce_scatter`,
    `all_to_all`);
  * each halo transfer direction (`ppermute`, core.halo), forward and
    backward, each whole-block move of `halo.ring_shift` (the ring's
    K/V, the vocabulary's table) and `halo.shift` (the SSD's prefix
    rounds), also a `ppermute`, and each §IV-A pin (`pin`: the forward's wait between the
    interior and the boundary convs, the backward's post of the halo
    gradients);
  * each conv launch (`conv`, core.spatial_conv) and its backward
    (kernels.conv2d.Conv2d), the schedule checks' anchors.

Layer, region and direction come from the op: each autograd Function
keeps its layer from the forward and names its backward `bwd`
(core.trace.annotate, core.trace.note).  The join flags, rule for rule as
the reference:

  unpriced-collective   comm in the step the solver never charged;
  phantom-charge        priced comm absent from the step;
  payload-mismatch      priced and executed bytes disagree beyond
                        tolerance (>25% error, >5% warning);
  collective-count /    priced and executed op counts or axes disagree
  collective-axes       (warnings);
  uncharged-collective  comm the model knowingly leaves unpriced
                        (charged=False inventory entries) — never error;
  uncharged-minor-comm  BN statistics and per-channel vectors (info);
  schedule-pin-missing  an interior-split layer whose forward does not
                        wait for its halo between the interior and the
                        boundary convs, or whose backward does not post
                        the halo gradients before the interior's dL/dx;
  halo-after-interior   a forward halo issued after the interior conv;
  schedule-pin-unexpected / schedule-reshard-pin (warnings);
  lowering-mismatch /   the profiler cross-check (`hlo_findings`): a
  hlo-count-mismatch    layer's collectives or a region's ranges missing
                        from a torch.profiler trace of the same step.

The port's own differences, by construction:

  * the weight gradients are one bucket: `train.train_loop.reduce_grads`
    sums every gradient in one flat all-reduce over all mesh axes,
    outside any layer (region `grad_bucket`); with more than one data
    rank, the leaves sharded over data (ZeRO, `launch.shardings`) go
    through one reduce-scatter over data instead and the rest through
    the psum.  The join holds the ops the whole gradient enters (the
    psum and the reduce-scatter) against every layer's weight-gradient
    entries as a whole (regions `conv`, `cf_w_vjp`, `gspmd`) and their
    payload against the params' gradient bytes; where the inventory
    prices a weight's psum once per conv application (an interior-split
    layer), the bucket sends it once (`grad-bucket`, info).  The held
    blocks' psum over the other axes, the pod exchange
    (`optim.grad_compress`) and ZeRO-1's post-update all-gather over
    model (region `param_gather`) are reported as `grad-bucket` infos;
  * params held at rest (`launch.shardings.AtUse`): each layer gathers
    its blocks over data where it runs and reduce-scatters their
    gradients over data in its backward (region `fsdp_gather`, in the
    layer), the reference's FSDP collectives, which its plan inventory
    does not price either.  The reduce-scatters join the gradient
    bucket's first stage (the whole gradient enters them); the gathers,
    forward and again in the backward, are reported as a `grad-bucket`
    info;
  * the §III-C reshards are explicit collectives (core.collectives), so
    `plan_inventory` prices each reshard point's collectives too (term
    `shuffle`, region `reshard`), where the reference leaves them to
    GSPMD.

Byte convention, the reference's: an op's payload is the bytes that enter
it on this rank (a halo's tail slice also at a global edge, where nothing
is sent), and inventory entries carry the TOTAL bytes over their `count`
ops.  Every rank joins its own record.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import re
import time
from typing import Callable, Mapping, Sequence

import torch

from repro_torch.analysis.lint import Finding
from repro_torch.core import collectives as coll_lib
from repro_torch.core import perfmodel as pm
from repro_torch.core import trace as trace_lib
from repro_torch.utils import resolve_device

COLLECTIVE_KINDS = ("ppermute", "psum", "all_gather", "reduce_scatter",
                    "all_to_all")

# relative payload error thresholds for the priced-vs-executed join
PAYLOAD_WARN = 0.05
PAYLOAD_ERROR = 0.25

# the inventory's weight-gradient psums: one gradient bucket in the port
WEIGHT_GRAD_REGIONS = ("conv", "cf_w_vjp", "gspmd")
BUCKET = "grad_bucket"
PARAM_GATHER = "param_gather"      # ZeRO-1's post-update all-gather
AT_USE = "fsdp_gather"             # launch.shardings.AT_USE

_CHUNKS_RE = re.compile(r"cf chunks=(\d+)")


@dataclasses.dataclass(frozen=True)
class ExecutedOp:
    """One op of interest the step executed, with attribution."""
    kind: str                 # ppermute | psum | ... | conv | pin
    layer: str | None         # the layer whose region issued it
    direction: str            # fwd | bwd
    region: str | None        # its core.trace region
    bytes: float              # payload entering the op on this rank
    axes: frozenset           # mesh axis names the op runs over
    index: int                # issue order (schedule checks)

    @property
    def path(self) -> str:
        where = self.region or "-"
        return f"{self.layer}/{where}" if self.layer else where


class Recorder:
    """What `record()` collects: the ops in issue order, and how many
    times each (layer, region) was entered (the profiler cross-check)."""

    def __init__(self):
        self.ops: list[ExecutedOp] = []
        self.regions: collections.Counter = collections.Counter()

    def add(self, kind, layer, direction, region, nbytes, axes) -> None:
        self.ops.append(ExecutedOp(kind, layer, direction, region,
                                   float(nbytes), frozenset(axes),
                                   len(self.ops) + 1))

    def enter(self, layer, region) -> None:
        self.regions[(layer, region)] += 1


@contextlib.contextmanager
def record():
    """Collect the ops the body executes (`Recorder`); does not nest."""
    if trace_lib.RECORDER is not None:
        raise RuntimeError("record() is already active")
    rec = Recorder()
    trace_lib.RECORDER = rec
    try:
        yield rec
    finally:
        trace_lib.RECORDER = None


# ---------------------------------------------------------------------------
# the priced-vs-executed join
# ---------------------------------------------------------------------------

def _minor(op: ExecutedOp, cmax: int) -> bool:
    """Small bookkeeping comm the model never prices: BN statistics psums
    and per-channel vectors — O(C) words against the O(N·H·W·C)
    collectives the cost terms track."""
    return op.region == "bn_collective" or op.bytes <= 16 * max(cmax, 1)


def _is_weight_grad(e: pm.CollectiveSpec) -> bool:
    return e.kind == "psum" and e.direction == "bwd" and \
        e.region in WEIGHT_GRAD_REGIONS


def weight_grad_bytes(inventory: Mapping[str, Sequence[pm.CollectiveSpec]]
                      ) -> dict[str, tuple[float, float]]:
    """Per layer, (the bytes its weight gradient takes once, the bytes the
    inventory prices for it over all its psums)."""
    out = {}
    for layer, entries in inventory.items():
        ws = [e for e in entries if _is_weight_grad(e)]
        if ws:
            out[layer] = (max(e.bytes / max(e.count, 1) for e in ws),
                          sum(e.bytes for e in ws if e.charged))
    return out


def _bucket_stages(bucket: Sequence[ExecutedOp]) -> tuple[list, list, list]:
    """The gradient bucket's ops by stage: (the ops the whole gradient
    enters: the reduce-scatter over "data" of the sharded leaves and the
    psum over every reduced axis of the rest; the held blocks' psum over
    the other axes; the pod exchange)."""
    first, blocks, pod = [], [], []
    for o in bucket:
        if o.axes == frozenset({"pod"}):
            pod.append(o)
        elif o.kind == "reduce_scatter" or "data" in o.axes:
            first.append(o)
        else:
            blocks.append(o)
    return first, blocks, pod


def _bucket_findings(weights: Mapping[str, Sequence[pm.CollectiveSpec]],
                     bucket: Sequence[ExecutedOp],
                     specs: Sequence[pm.ConvLayer],
                     gathers: Sequence[ExecutedOp] = ()) -> list[Finding]:
    out: list[Finding] = []
    once = weight_grad_bytes(weights)
    for layer, entries in weights.items():
        for e in entries:
            if e.region == "conv" and e.count > 1:
                out.append(Finding(
                    "info", "grad-bucket", layer=layer,
                    message=f"weight gradient inventoried as {e.count} "
                            f"psums ({e.bytes:.0f} B, one a conv "
                            f"application); the step sends it once, "
                            f"{once[layer][0]:.0f} B, in the gradient "
                            f"bucket",
                    fix=""))
    cmax_of = {s.name: max(s.c, s.f) for s in specs}
    for layer, entries in weights.items():
        for e in entries:
            if not e.charged:
                cmax = cmax_of.get(layer, max(cmax_of.values(), default=1))
                out.append(Finding(
                    "info" if e.bytes <= 16 * cmax else "warning",
                    "uncharged-collective", layer=layer,
                    message=f"bwd psum [{e.region}] over {sorted(e.axes)} "
                            f"({e.bytes:.0f} B) executes in the gradient "
                            f"bucket but no cost term prices it (known "
                            f"gap)",
                    fix="price it in layer_cost and mark the inventory "
                        "entry charged"))
    first, blocks, pod = _bucket_stages(bucket)
    if not first:
        for layer, entries in weights.items():
            for e in entries:
                if e.charged:
                    out.append(Finding(
                        "error", "phantom-charge", layer=layer,
                        message=f"priced bwd psum [{e.region}] over "
                                f"{sorted(e.axes)} ({e.bytes:.0f} B, term "
                                f"{e.term}) absent from the executed step "
                                f"— no gradient bucket was all-reduced",
                        fix="the step must end in train_loop."
                            "reduce_grads"))
        return out
    kinds = collections.Counter(o.kind for o in first if o.region == BUCKET)
    if any(n > 1 for n in kinds.values()):
        out.append(Finding(
            "warning", "collective-count",
            message=f"bwd [{BUCKET}]: one gradient bucket expected (a "
                    f"psum, and a reduce-scatter of the leaves sharded "
                    f"over data), the step issues {dict(kinds)}",
            fix="train_loop.reduce_grads reduces one flat buffer a kind"))
    moved = sum(o.bytes for o in first)
    priced = sum(b for b, _ in once.values())
    what = " + ".join(dict.fromkeys(
        f"bwd {o.kind} [{o.region}] over {sorted(o.axes)}" for o in first))
    rest = moved - priced
    cmax_sum = sum(max(s.c, s.f) for s in specs)
    if rest > 16 * max(cmax_sum, 1):
        out.append(Finding(
            "error", "unpriced-collective",
            message=f"{what} moves {moved:.0f} B, {rest:.0f} B more than "
                    f"the priced weight gradients ({priced:.0f} B)",
            fix="price the gradients the bucket carries in "
                "perfmodel.layer_collectives"))
    elif rest > 0:
        out.append(Finding(
            "info", "uncharged-minor-comm",
            message=f"{rest:.0f} B of the gradient bucket ({moved:.0f} B) "
                    f"are per-channel vectors (BN gamma/beta) — below "
                    f"pricing granularity",
            fix=""))
    elif -rest / max(priced, 1.0) > PAYLOAD_WARN:
        rel = -rest / max(priced, 1.0)
        out.append(Finding(
            "error" if rel > PAYLOAD_ERROR else "warning",
            "payload-mismatch",
            message=f"{what}: priced weight gradients {priced:.0f} B but "
                    f"the bucket moves {moved:.0f} B "
                    f"({rel * 100:.0f}% off)",
            fix="re-derive the weight shapes in layer_collectives"))
    scattered = [o for o in first if o.kind == "reduce_scatter"]
    if scattered:
        held = sum(o.bytes for o in blocks)
        out.append(Finding(
            "info", "grad-bucket",
            message=f"ZeRO over data: {scattered[0].bytes:.0f} B of "
                    f"sharded weight gradients reduce-scattered over data "
                    f"(held against the priced weight gradients with the "
                    f"rest's psum)"
                    + (f"; this rank's blocks and the rest, {held:.0f} B, "
                       f"all-reduced over {sorted(blocks[0].axes)}"
                       if blocks else ""),
            fix=""))
    if pod:
        out.append(Finding(
            "info", "grad-bucket",
            message=f"pod exchange: {len(pod)} op(s) over pod "
                    f"({', '.join(sorted({o.kind for o in pod}))}), "
                    f"{sum(o.bytes for o in pod):.0f} B entering on this "
                    f"rank",
            fix=""))
    if gathers:
        out.append(Finding(
            "info", "grad-bucket",
            message=f"ZeRO-1's all-gather over model after the update: "
                    f"{sum(o.bytes for o in gathers):.0f} B entering on "
                    f"this rank",
            fix=""))
    return out


def _at_use_findings(ops: Sequence[ExecutedOp]) -> list[Finding]:
    """The gathers at use of params held at rest, as one info."""
    if not ops:
        return []
    n = collections.Counter(f"{o.kind}/{o.direction}" for o in ops)
    return [Finding(
        "info", "grad-bucket",
        message=f"params at rest: {dict(sorted(n.items()))} over data in "
                f"the layers (region {AT_USE}), "
                f"{sum(o.bytes for o in ops):.0f} B entering on this rank",
        fix="")]


def join_findings(inventory: Mapping[str, Sequence[pm.CollectiveSpec]],
                  ops: Sequence[ExecutedOp],
                  specs: Sequence[pm.ConvLayer]) -> list[Finding]:
    """Greedy per-entry matching of executed collectives against the
    priced inventory, per (layer, direction, kind): exact axes-set matches
    claim first (largest payload first), then unmatched entries claim any
    remaining same-kind ops.  The weight-gradient entries are held against
    the gradient bucket as a whole: its payload against the priced
    weight gradients, each taken once."""
    out: list[Finding] = []
    spec_by_name = {s.name: s for s in specs}
    cmax_global = max((max(s.c, s.f) for s in specs), default=1)

    coll = [o for o in ops if o.kind in COLLECTIVE_KINDS]
    at_use = [o for o in coll if o.region == AT_USE]
    bucket = [o for o in coll if o.region == BUCKET] + \
        [o for o in at_use if o.kind == "reduce_scatter"]
    gathers = [o for o in coll if o.region == PARAM_GATHER]
    by_key: dict[tuple, list[ExecutedOp]] = {}
    for o in coll:
        if o.region not in (BUCKET, PARAM_GATHER, AT_USE):
            by_key.setdefault((o.layer, o.direction, o.kind), []).append(o)

    ent_by_key: dict[tuple, list[pm.CollectiveSpec]] = {}
    weights: dict[str, list[pm.CollectiveSpec]] = {}
    for layer, entries in inventory.items():
        for e in entries:
            if _is_weight_grad(e):
                weights.setdefault(layer, []).append(e)
            else:
                ent_by_key.setdefault((layer, e.direction, e.kind),
                                      []).append(e)

    leftovers: list[ExecutedOp] = []
    for key in sorted(set(by_key) | set(ent_by_key),
                      key=lambda k: (str(k[0]), k[1], k[2])):
        layer, direction, kind = key
        remaining = sorted(by_key.get(key, []), key=lambda o: -o.bytes)
        entries = sorted(ent_by_key.get(key, []), key=lambda e: -e.bytes)
        claims: list[list[ExecutedOp]] = [[] for _ in entries]
        for i, e in enumerate(entries):          # pass 1: exact axes match
            want = frozenset(e.axes)
            for o in list(remaining):
                if len(claims[i]) >= e.count:
                    break
                if o.axes == want:
                    claims[i].append(o)
                    remaining.remove(o)
        for i, e in enumerate(entries):          # pass 2: any same-kind op
            while len(claims[i]) < e.count and remaining:
                claims[i].append(remaining.pop(0))
        leftovers.extend(remaining)

        for e, claimed in zip(entries, claims):
            what = (f"{direction} {kind} "
                    f"[{e.region}] over {sorted(e.axes)}")
            if not claimed:
                if e.charged:
                    out.append(Finding(
                        "error", "phantom-charge", layer=layer,
                        message=f"priced {what} "
                                f"({e.bytes:.0f} B, term {e.term}) absent "
                                f"from the executed step — the solver "
                                f"charged comm that never executes",
                        fix="fix layer_collectives' geometry for this "
                            "dist, or the runtime dropped a collective"))
                continue
            cb = sum(o.bytes for o in claimed)
            rel = abs(cb - e.bytes) / max(e.bytes, 1.0)
            if rel > PAYLOAD_WARN:
                sev = "error" if rel > PAYLOAD_ERROR else "warning"
                out.append(Finding(
                    sev, "payload-mismatch", layer=layer,
                    message=f"{what}: priced {e.bytes:.0f} B but the "
                            f"step moves {cb:.0f} B "
                            f"({rel * 100:.0f}% off)",
                    fix="re-derive the shard geometry in "
                        "layer_collectives against the executed shapes"))
            if len(claimed) != e.count:
                out.append(Finding(
                    "warning", "collective-count", layer=layer,
                    message=f"{what}: priced as {e.count} op(s) but the "
                            f"step issues {len(claimed)}",
                    fix="check the chunking/boundary-application count"))
            bad_axes = [o for o in claimed if o.axes != frozenset(e.axes)]
            if bad_axes:
                out.append(Finding(
                    "warning", "collective-axes", layer=layer,
                    message=f"{what}: executed over "
                            f"{sorted(bad_axes[0].axes)} instead",
                    fix="the dist's axis mapping and the runtime's "
                        "collective axes disagree"))
            if not e.charged:
                spec = spec_by_name.get(layer)
                cmax = max(spec.c, spec.f) if spec else cmax_global
                out.append(Finding(
                    "info" if e.bytes <= 16 * cmax else "warning",
                    "uncharged-collective", layer=layer,
                    message=f"{what} ({e.bytes:.0f} B) executes but no "
                            f"cost term prices it (known gap)",
                    fix="price it in layer_cost and mark the inventory "
                        "entry charged"))

    minors: dict[tuple, list[ExecutedOp]] = {}
    for o in leftovers:
        spec = spec_by_name.get(o.layer)
        cmax = max(spec.c, spec.f) if spec else cmax_global
        if _minor(o, cmax):
            minors.setdefault((o.layer, o.direction), []).append(o)
        else:
            out.append(Finding(
                "error", "unpriced-collective", layer=o.layer,
                message=f"{o.direction} {o.kind} [{o.region}] over "
                        f"{sorted(o.axes)} moves {o.bytes:.0f} B with no "
                        f"matching priced inventory entry "
                        f"(path {o.path})",
                fix="add it to perfmodel.layer_collectives and charge a "
                    "cost term — unpriced comm is how plans win on paper "
                    "and lose on hardware"))
    for (layer, direction), ms in sorted(
            minors.items(), key=lambda kv: (str(kv[0][0]), kv[0][1])):
        out.append(Finding(
            "info", "uncharged-minor-comm", layer=layer,
            message=f"{len(ms)} {direction} bookkeeping collective(s) "
                    f"({sum(o.bytes for o in ms):.0f} B total: BN stats "
                    f"/ per-channel vectors) — below pricing granularity",
            fix=""))
    out += _bucket_findings(weights, bucket, specs, gathers)
    return out + _at_use_findings(at_use)


# ---------------------------------------------------------------------------
# schedule checks (§IV-A), on the recorded order
# ---------------------------------------------------------------------------

def _first(ops: Sequence[ExecutedOp], **want) -> int | None:
    idx = [o.index for o in ops
           if all(getattr(o, k) == v for k, v in want.items())]
    return min(idx) if idx else None


def schedule_findings(ops: Sequence[ExecutedOp], plan,
                      specs: Sequence[pm.ConvLayer],
                      mesh_shape: Mapping[str, int],
                      overlap: bool, *,
                      grad_wrt_inputs: bool = False) -> list[Finding]:
    """The §IV-A issue order of every interior-split layer, both ways, and
    the reshard points' collectives.  The first layer's backward is not
    checked unless `grad_wrt_inputs` (its input needs no gradient, so it
    sends none)."""
    out: list[Finding] = []
    for li, spec in enumerate(specs):
        lp = plan.layers.get(spec.name)
        dist = lp.dist if lp is not None else None
        if dist is None:
            continue
        mine = [o for o in ops if o.layer == spec.name]
        pins = [o for o in mine if o.kind == "pin"]
        if pm.interior_split(spec, dist, mesh_shape, overlap):
            interior = _first(mine, kind="conv", direction="fwd",
                              region="conv_interior")
            boundary = _first(mine, kind="conv", direction="fwd",
                              region="conv_boundary")
            waited = interior is not None and any(
                o.direction == "fwd" and interior < o.index and
                (boundary is None or o.index < boundary) for o in pins)
            if not waited:
                out.append(Finding(
                    "error", "schedule-pin-missing", layer=spec.name,
                    message="interior-split layer's forward does not wait "
                            "for its halo between the interior and the "
                            "boundary convs — the §IV-A overlap window is "
                            "not pinned",
                    fix="HaloSchedule.pin must follow the interior conv "
                        "(core.spatial_conv)"))
            if li > 0 or grad_wrt_inputs:
                posted = _first(mine, kind="ppermute", direction="bwd")
                dgrad = _first(mine, kind="conv", direction="bwd",
                               region="conv_interior")
                if not (any(o.direction == "bwd" for o in pins) and
                        posted is not None and dgrad is not None and
                        posted < dgrad):
                    out.append(Finding(
                        "error", "schedule-pin-missing", layer=spec.name,
                        message="interior-split layer's backward does not "
                                "post the boundary-gradient sends before "
                                "the interior conv's dL/dx — the mirrored "
                                "§IV-A overlap window is empty",
                        fix="HaloSchedule.pin's backward (core.halo._Pin) "
                            "must post them"))
        elif not overlap and pins:
            out.append(Finding(
                "warning", "schedule-pin-unexpected", layer=spec.name,
                message=f"{len(pins)} pin(s) in a serialized "
                        f"(overlap=False) step",
                fix="the serialized path should not pay pin constraints"))

    moving = sum(1 for pt in reshard_points(plan, specs, mesh_shape)
                 if any(st[0] != "slice" for st in pt[3]))
    got = sum(1 for o in ops if o.region == "reshard" and
              o.kind in COLLECTIVE_KINDS and o.direction == "fwd")
    if moving and got < moving:
        out.append(Finding(
            "warning", "schedule-reshard-pin",
            message=f"{plan.n_reshards} reshard point(s) compiled, "
                    f"{moving} of them moving data, but only {got} "
                    f"reshard collective(s) executed",
            fix="NetworkPlan.reshard moves each redistributed tensor"))

    # halo-before-interior: within each layer's forward, the halo
    # transfers must be issued before the interior conv.
    for spec in specs:
        halo = _first(ops, kind="ppermute", layer=spec.name,
                      direction="fwd", region="halo_exchange")
        interior = _first(ops, kind="conv", layer=spec.name,
                          direction="fwd", region="conv_interior")
        if halo is not None and interior is not None and halo > interior:
            out.append(Finding(
                "error", "halo-after-interior", layer=spec.name,
                message="halo ppermute issued after the interior conv — "
                        "the §IV-A overlap window is empty",
                fix="HaloSchedule must issue halos before the interior "
                    "conv"))
    return out


# ---------------------------------------------------------------------------
# profiler cross-check (the reference's StableHLO one): attribution
# survives into a torch.profiler trace of the same step
# ---------------------------------------------------------------------------

def hlo_findings(ranges: Mapping[str, int], ops: Sequence[ExecutedOp],
                 regions: Mapping[tuple, int]) -> list[Finding]:
    """`ranges`: how many times each range name appears in a
    torch.profiler trace of the step; `regions`: the recorder's entries
    per (layer, region).  Rule ids are the reference's."""
    out: list[Finding] = []
    layers = sorted({o.layer for o in ops
                     if o.layer and o.kind in COLLECTIVE_KINDS})
    for layer in layers:
        if not any(name.startswith(layer + "/") for name in ranges):
            out.append(Finding(
                "warning", "lowering-mismatch", layer=layer,
                message="layer issues collectives but no "
                        "<layer>/<region> range of it is in the profiler "
                        "trace — profiles and the measured-attribution "
                        "join go blind here",
                fix="layer_context must wrap the whole layer body"))
    per_region: collections.Counter = collections.Counter()
    for (_, region), n in regions.items():
        per_region[region] += n
    for region in sorted(per_region):
        got = sum(n for name, n in ranges.items()
                  if name == region or name.endswith("/" + region))
        if got != per_region[region]:
            out.append(Finding(
                "warning", "hlo-count-mismatch",
                message=f"{region}: entered {per_region[region]} time(s) "
                        f"in the recorded step vs {got} range(s) in the "
                        f"profiler trace",
                fix="every core.trace.annotate must open its "
                    "record_function range"))
    return out


# ---------------------------------------------------------------------------
# the inventory
# ---------------------------------------------------------------------------

def reshard_points(plan, specs: Sequence[pm.ConvLayer],
                   mesh_shape: Mapping[str, int]) -> list[tuple]:
    """The reshard points a line plan prices, in execution order, each
    (layer, global NHWC dims of the moved tensor, (src, dst) layouts,
    `collectives.reshard_steps`): into a layer flagged `reshard_in`, from
    the previous layer's output sharding, and after a conv whose output
    has a sharding of its own (`LayerPlan.out`)."""
    from repro_torch.core.plan import _layout
    shape = dict(mesh_shape)
    out = []
    prev = None
    for spec in specs:
        lp = plan.layers.get(spec.name)
        if lp is None:
            continue
        if lp.reshard_in and prev is not None:
            src, dst = _layout(prev, shape), _layout(lp.sharding, shape)
            out.append((spec.name, (spec.n, spec.h, spec.w, spec.c),
                        (src, dst), coll_lib.reshard_steps(src, dst)))
        if lp.out is not None:
            src, dst = _layout(lp.sharding, shape), _layout(lp.out, shape)
            out.append((spec.name, (spec.n, spec.h_out, spec.w_out, spec.f),
                        (src, dst), coll_lib.reshard_steps(src, dst)))
        prev = lp.out_sharding
    return out


def reshard_collectives(plan, specs: Sequence[pm.ConvLayer],
                        mesh_shape: Mapping[str, int],
                        wordsize: int = 4) -> dict[str, list]:
    """The collectives of every priced reshard point, per layer, as
    inventory entries (term `shuffle`, region `reshard`): a gather is an
    all-gather of the block forward and the reduce-scatter of the gathered
    block backward; an axis that moves is an all-to-all each way; a slice
    moves nothing."""
    out: dict[str, list] = {}
    for layer, dims, (src, _), steps in reshard_points(plan, specs,
                                                       mesh_shape):
        block = list(dims)
        for d, axes in enumerate(src):
            for a in axes:
                block[d] //= mesh_shape[a]
        ents = out.setdefault(layer, [])
        for op, a, d1, *rest in steps:
            p = mesh_shape[a]
            words = 1
            for e in block:
                words *= e
            if op == "gather":
                ents.append(pm.CollectiveSpec(
                    "all_gather", "reshard", "fwd", 1, words * wordsize,
                    (a,), term="shuffle"))
                ents.append(pm.CollectiveSpec(
                    "reduce_scatter", "reshard", "bwd", 1,
                    words * p * wordsize, (a,), term="shuffle"))
                block[d1] *= p
            elif op == "slice":
                block[d1] //= p
            else:
                for direction in ("fwd", "bwd"):
                    ents.append(pm.CollectiveSpec(
                        "all_to_all", "reshard", direction, 1,
                        words * wordsize, (a,), term="shuffle"))
                block[d1] *= p
                block[rest[0]] //= p
    return out


def plan_inventory(plan, specs: Sequence[pm.ConvLayer],
                   mesh_shape: Mapping[str, int], *,
                   machine: pm.Machine | None = None,
                   overlap: bool = True,
                   grad_wrt_inputs: bool = False,
                   wordsize: int = 4) -> dict:
    """The priced inventory for `plan` at the step's wordsize, its
    reshard points' collectives included.

    Regenerated (not read from plan.predicted) so the byte comparison is
    dtype-exact: the inventory reads nothing of the machine but its
    wordsize, which is the step's (`machine` defaults to the H100
    preset)."""
    from repro_torch.core.plan import NetworkPlan, _sharding_to_dist
    plan = NetworkPlan.of(plan)
    m = dataclasses.replace(machine or pm.H100, wordsize=wordsize)
    inv = {}
    for i, spec in enumerate(specs):
        lp = plan.layers.get(spec.name)
        if lp is not None and lp.dist is not None:
            dist = lp.dist
        else:
            dist = _sharding_to_dist(plan.sharding(spec.name), spec.name)
        chunks = 1
        if lp is not None:
            mm = _CHUNKS_RE.search(lp.note or "")
            if mm:
                chunks = int(mm.group(1))
        inv[spec.name] = pm.layer_collectives(
            m, spec, dist, mesh_shape, overlap=overlap,
            first=(i == 0 and not grad_wrt_inputs),
            channel_chunks=chunks)
    for layer, ents in reshard_collectives(plan, specs, mesh_shape,
                                           wordsize).items():
        inv[layer] = list(inv.get(layer, [])) + ents
    return inv


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepAudit:
    """One audited step: its findings, the ops it executed, the inventory
    they were joined against and the host seconds of the step."""
    findings: list
    ops: list
    inventory: dict
    seconds: float

    def counts(self) -> dict[str, int]:
        """Ops by `kind/direction`."""
        return dict(sorted(collections.Counter(
            f"{o.kind}/{o.direction}" for o in self.ops).items()))

    def bucket(self) -> tuple[float, float, float]:
        """(bytes the whole gradient takes into the gradient bucket, the
        priced weight gradients' bytes once, and over every psum the
        inventory prices)."""
        moved = sum(o.bytes for o in _bucket_stages(
            [o for o in self.ops if o.kind in COLLECTIVE_KINDS and (
                o.region == BUCKET or (o.region == AT_USE and
                                       o.kind == "reduce_scatter"))])[0])
        w = weight_grad_bytes(self.inventory).values()
        return moved, sum(a for a, _ in w), sum(b for _, b in w)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def audit_step(step: Callable, args: Sequence, plan,
               specs: Sequence[pm.ConvLayer], mesh, *,
               overlap: bool = True, hlo: bool = True,
               machine: pm.Machine | None = None,
               grad_wrt_inputs: bool = False, wordsize: int = 4,
               device="cuda") -> StepAudit:
    """Run `step(*args)` once under `record()` (and, with `hlo`, under
    torch.profiler too, for the cross-check) and join what it executed
    against `plan`'s priced inventory.

    step:  the real step: forward, backward and the gradient reduction
           (`train_loop.reduce_grads`; no optimizer update).
    specs: the ConvLayers of the plan, in execution order.
    `grad_wrt_inputs=False` declares that the first layer's input needs
    no gradient, so its backward halos are never sent.  `wordsize`: the
    step's dtype size; `device`: where the step runs (CUDA unless asked
    otherwise; it is synchronised around the timed step).
    """
    from repro_torch.core.plan import NetworkPlan
    device = resolve_device(device)
    plan = NetworkPlan.of(plan)
    mesh_shape = dict(mesh.shape)
    prof = None
    with contextlib.ExitStack() as stack:
        if hlo:
            prof = stack.enter_context(torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]))
        rec = stack.enter_context(record())
        _sync(device)
        t0 = time.perf_counter()
        step(*args)
        _sync(device)
        seconds = time.perf_counter() - t0
    inv = plan_inventory(plan, specs, mesh_shape, machine=machine,
                         overlap=overlap, grad_wrt_inputs=grad_wrt_inputs,
                         wordsize=wordsize)
    findings = join_findings(inv, rec.ops, specs)
    findings += schedule_findings(rec.ops, plan, specs, mesh_shape, overlap,
                                  grad_wrt_inputs=grad_wrt_inputs)
    if prof is not None:
        ranges = collections.Counter(e.name for e in prof.events())
        findings += hlo_findings(ranges, rec.ops, rec.regions)
    return StepAudit(findings, rec.ops, inv, seconds)


def meshnet_audit(plan, specs: Sequence[pm.ConvLayer], cfg, mesh, *,
                  machine: pm.Machine | None = None, overlap: bool = True,
                  hlo: bool = False, params=None, batch=None,
                  device="cuda", seed: int = 0,
                  pod_compression: str = "none") -> StepAudit:
    """Audit a meshnet plan's real training step: forward and backward of
    `models.cnn.meshnet.loss_fn` in FP32 and the gradient reduction (ZeRO
    over data where the mesh has more than one data rank, the pod
    exchange under `pod_compression`), no update, on `params` and this
    rank's block `batch` (on `device`), or on params from a generator
    seeded with `seed`, held at rest as the trainer holds them, and the
    synthetic batch of step 0.  `params` may be whole or held at rest
    (each leaf its block where `launch.shardings.fsdp_tree_specs` cuts
    it), which the layers gather at their use.  `device` is CUDA unless the caller asks for the CPU.
    The params are unchanged afterwards."""
    import functools

    from repro_torch.data import pipeline
    from repro_torch.models.cnn import meshnet
    from repro_torch.train.train_loop import (TrainStepConfig, make_grad_fn,
                                              reduce_grads)
    from repro_torch.utils import FP32, tree_leaves

    from repro_torch.launch import shardings
    device = resolve_device(device)
    if params is None:          # held at rest, as the trainer holds them
        whole = meshnet.MeshNet(
            cfg, generator=torch.Generator().manual_seed(seed),
            device=device).params()
        params = shardings.param_blocks(
            whole, shardings.rest_dims(whole, mesh), mesh)
    if batch is None:
        n = specs[0].n
        glob = pipeline.synthetic_mesh_batch(
            0, batch=n, hw=cfg.input_hw, channels=cfg.in_channels,
            out_hw=cfg.out_hw)
        batch = pipeline.to_device(pipeline.shard_batch(
            glob, mesh, plan.sharding(specs[0].name), plan.sharding(
                specs[-1].name)), device)
    fwd_bwd = make_grad_fn(functools.partial(
        meshnet.loss_fn, cfg=cfg, plan=plan, mesh=mesh, overlap=overlap),
        TrainStepConfig(precision=FP32))

    rest = shardings.held_rest(params, meshnet.global_params(cfg), mesh)

    def step(p, b):
        _, grads = fwd_bwd(p, b)
        return reduce_grads(grads, mesh, method=pod_compression,
                            rest=rest)[0]

    leaves = tree_leaves(params)
    return audit_step(
        step, (params, batch), plan, specs, mesh, overlap=overlap, hlo=hlo,
        machine=machine, grad_wrt_inputs=False,
        wordsize=leaves[0].element_size(), device=device)
