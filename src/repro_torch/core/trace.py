"""Plan-aware tracing and attribution (the observability half of the §V
loop), port of `repro.core.trace`.

The perf model prices every §III distribution; this module makes the
runtime say where a measured step spends its time, so that the
model-vs-measured comparison splits by layer and by cost term.

  * Named regions.  `annotate(region)` wraps a stretch of the execution
    path in `torch.profiler.record_function` (host ranges in a profiler
    trace), plus an NVTX range where its tensors lie on the card.
    `layer_context(name)` pushes the layer that runs, so every region
    inside is named `<layer>/<region>` (`conv4_2/cf_reduce_scatter`).
    The paths annotate the halo exchange (core.halo), the interior,
    boundary and serialized convs (core.spatial_conv), the BN statistics'
    all-reduce (core.spatial_norm), the CF collectives (core.channel_conv)
    and the §III-C reshards (core.plan).  A region opened inside a region
    of the same name opens no second range.  Annotation never changes a
    value.

  * Segmented re-execution.  `trace_plan(plan, params, batch, ...)` takes
    the activation entering each layer from one forward, then times each
    layer's callable (`models.cnn.meshnet.layer_fns`, the code `apply`
    runs) alone, forward and forward + backward, against the whole step,
    in interleaved rounds (`utils.interleaved_min`).  The result is a
    `StepTrace` (``repro/step_trace@1``, the reference's JSON) with a
    Chrome-trace export.

`NetworkPlan.attribution_report(trace)` (core.plan) joins a StepTrace with
the plan's predictions, per layer and per cost term; `format_attribution`
renders it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Mapping

import torch

SCHEMA = "repro/step_trace@1"

# ---------------------------------------------------------------------------
# named-region annotation
# ---------------------------------------------------------------------------

#: The region names the execution paths annotate with.
REGIONS = (
    "halo_exchange",      # spatial halos (core.halo)
    "conv_interior",      # overlapped interior conv (core.spatial_conv)
    "conv_boundary",      # boundary strips after the halo arrives
    "conv_serialized",    # non-overlapped halo + conv
    "cf_all_gather",      # CF filter-mode x gather (core.channel_conv)
    "cf_reduce_scatter",  # CF channel-mode y scatter
    "bn_collective",      # BN statistics' all-reduce (core.spatial_norm)
    "reshard",            # §III-C reshard points (core.plan)
)

_LAYER_STACK: list[str] = []
# (region, layer, direction) of each open region, innermost last
_REGION_STACK: list[tuple[str, str | None, str]] = []

#: The recorder of an audited step (`analysis.collectives.record`), or None.
#: Every hook on the execution path (the mesh's collectives, the halo
#: transfers, the conv launches) tests it first, so outside an audit a
#: hook costs that one test.
RECORDER = None


def current_layer() -> str | None:
    """The innermost active `layer_context` name, or None outside one."""
    return _LAYER_STACK[-1] if _LAYER_STACK else None


@contextlib.contextmanager
def layer_context(name: str):
    """Run the body as layer `name`: a profiler range of that name, and
    every region annotated inside named `<name>/<region>`."""
    _LAYER_STACK.append(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        _LAYER_STACK.pop()


def qualified(region: str, layer: str | None = None) -> str:
    """`region` prefixed with `layer` (default: the current layer), when
    there is one."""
    layer = layer or current_layer()
    return f"{layer}/{region}" if layer else region


@contextlib.contextmanager
def annotate(region: str, like: torch.Tensor | None = None,
             layer: str | None = None, bwd: bool = False):
    """Mark a region of the execution path; identity on values.

    Opens `record_function(qualified(region, layer))`, and an NVTX range
    of the same name where `like` lies on the card.  `layer` names the
    layer where the caller knows it better than the stack does (an
    autograd backward runs after its layer's context has closed), and
    `bwd` marks a region an autograd backward opens: the ops a recorder
    takes inside carry both (`scope`).  Inside a region of the same name
    it opens nothing."""
    if _REGION_STACK and _REGION_STACK[-1][0] == region:
        yield
        return
    layer = layer or current_layer()
    name = qualified(region, layer)
    nvtx = like is not None and like.is_cuda
    _REGION_STACK.append((region, layer, "bwd" if bwd else "fwd"))
    if RECORDER is not None:
        RECORDER.enter(layer, region)
    try:
        with torch.profiler.record_function(name):
            if nvtx:
                torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                if nvtx:
                    torch.cuda.nvtx.range_pop()
    finally:
        _REGION_STACK.pop()


def scope() -> tuple[str | None, str | None, str]:
    """(layer, region, direction) of the innermost open region; outside
    one, the current layer, no region, forward."""
    if _REGION_STACK:
        region, layer, direction = _REGION_STACK[-1]
        return layer, region, direction
    return current_layer(), None, "fwd"


def note(kind: str, t: torch.Tensor | None = None, axes=(), *,
         nbytes: float | None = None, layer: str | None = None,
         region: str | None = None, direction: str | None = None) -> None:
    """Give the recorder one op of `kind` (call it only where `RECORDER`
    is not None): its payload, the bytes of `t` (or `nbytes`), the mesh
    axes it runs over, and its layer, region and direction, from `scope`
    where the caller does not name them."""
    s_layer, s_region, s_dir = scope()
    if nbytes is None:
        nbytes = 0 if t is None else t.numel() * t.element_size()
    RECORDER.add(kind, layer if layer is not None else s_layer,
                 direction or s_dir, region if region is not None
                 else s_region, float(nbytes), axes)


# ---------------------------------------------------------------------------
# StepTrace: measured per-layer costs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepTrace:
    """Measured per-layer cost breakdown of one training step.

    layers: {layer name: {"fwd_s", "bwd_s", "fwd_bwd_s"}} in execution
            order: seconds a call of the layer's forward / forward +
            backward, run alone.
    step:   {"fwd_s", "bwd_s", "fwd_bwd_s"} of the whole step (the same
            estimator), which the per-layer sums are held against.
    meta:   backend, mesh shape, rank count, timing reps/rounds, the
            measured peak bytes, the overlap flag and the measured η in
            force.
    """
    layers: dict[str, dict]
    step: dict[str, float]
    meta: dict = dataclasses.field(default_factory=dict)
    schema: str = SCHEMA

    @property
    def layer_fwd_sum_s(self) -> float:
        return sum(r["fwd_s"] for r in self.layers.values())

    @property
    def layer_bwd_sum_s(self) -> float:
        return sum(r["bwd_s"] for r in self.layers.values())

    @property
    def layer_sum_s(self) -> float:
        """Sum of the per-layer fwd + bwd times, to hold against
        step['fwd_bwd_s']."""
        return self.layer_fwd_sum_s + self.layer_bwd_sum_s

    def to_dict(self) -> dict:
        return {"schema": self.schema, "layers": self.layers,
                "step": self.step, "meta": self.meta}

    @classmethod
    def from_dict(cls, d: Mapping) -> "StepTrace":
        if d.get("schema") != SCHEMA:
            raise ValueError(f"not a step trace: schema "
                             f"{d.get('schema')!r} != {SCHEMA!r}")
        return cls(layers=dict(d["layers"]), step=dict(d["step"]),
                   meta=dict(d.get("meta", {})))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "StepTrace":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def chrome_trace(self) -> dict:
        """The breakdown as a Chrome-trace / Perfetto JSON object: forward
        segments on one track in execution order, backward segments on a
        second in reverse order, laid end to end from their measured
        durations (microseconds)."""
        events = [
            {"ph": "M", "pid": 0, "name": "process_name",
             "args": {"name": "repro step trace"}},
            {"ph": "M", "pid": 0, "tid": 0, "name": "thread_name",
             "args": {"name": "forward"}},
            {"ph": "M", "pid": 0, "tid": 1, "name": "thread_name",
             "args": {"name": "backward"}},
        ]
        ts = 0.0
        for name, r in self.layers.items():
            dur = r["fwd_s"] * 1e6
            events.append({"ph": "X", "pid": 0, "tid": 0, "name": name,
                           "cat": "fwd", "ts": ts, "dur": dur})
            ts += dur
        for name, r in reversed(list(self.layers.items())):
            dur = r["bwd_s"] * 1e6
            events.append({"ph": "X", "pid": 0, "tid": 1, "name": name,
                           "cat": "bwd", "ts": ts, "dur": dur})
            ts += dur
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": dict(self.meta, schema=self.schema)}

    def save_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)


# ---------------------------------------------------------------------------
# segmented re-execution profiler
# ---------------------------------------------------------------------------

def trace_plan(plan, params, batch, *, cfg, mesh=None, overlap: bool = True,
               reps: int = 3, rounds: int = 3) -> StepTrace:
    """Measure every plan layer's forward and backward by running it alone.

    plan:   a core.plan.NetworkPlan (or what `meshnet.network_plan` takes).
    params: the model's parameter list (models.cnn.meshnet layout).
    batch:  this rank's {"image", "label"} block, on the params' device,
            cut by the plan's first and last layers.
    cfg:    the MeshNetConfig the plan was solved for.

    One forward takes the activation entering each layer, as the plan
    leaves it on this rank.  Each layer's callable (meshnet.layer_fns) is
    then timed alone, forward and forward + backward (the gradient of the
    sum of its output over its params and its input, the params'
    gradients summed over the mesh as a step sums them), against the
    whole step, in interleaved rounds.  The segments run in one order on
    every rank, since a segment that holds a collective must be entered by
    all ranks together; each time is the max over the ranks.  bwd_s is
    fwd_bwd_s - fwd_s, floored at 0.
    """
    from repro_torch.core.calibrate import card_fields, step_peak_bytes
    from repro_torch.core.channel_conv import measured_eta
    from repro_torch.models.cnn import meshnet
    from repro_torch.train.train_loop import reduce_replicated_grads
    from repro_torch.utils import interleaved_min, tree_leaves

    plan = meshnet.network_plan(cfg, plan, mesh)
    fns = meshnet.layer_fns(cfg, plan, mesh, overlap)
    cuda = batch["image"].is_cuda

    def fwd_step():
        with torch.no_grad():
            return meshnet.apply(params, batch["image"], cfg, plan, mesh,
                                 overlap)

    def full_step():
        loss = meshnet.loss_fn(params, batch, cfg, plan, mesh, overlap)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        return reduce_replicated_grads(list(grads), mesh)[0]

    fwd_step()
    peak = step_peak_bytes(full_step)

    xs = []
    with torch.no_grad():
        x = batch["image"]
        for (_, fn), lp in zip(fns, params):
            xs.append(x)
            x = fn(lp, x)

    def seg_fwd(fn, lp, x):
        def run():
            with torch.no_grad():
                return fn(lp, x)
        return run

    def seg_fwd_bwd(fn, lp, x):
        leaves = tree_leaves(lp)

        def run():
            xg = x.detach().requires_grad_()
            y = fn(lp, xg)
            *gw, gx = torch.autograd.grad(y.sum(), leaves + [xg])
            reduce_replicated_grads(gw, mesh)
            return gx
        return run

    segments = {"__step__|fwd": fwd_step, "__step__|fwd_bwd": full_step}
    for (name, fn), lp, x in zip(fns, params, xs):
        segments[f"{name}|fwd"] = seg_fwd(fn, lp, x)
        segments[f"{name}|fwd_bwd"] = seg_fwd_bwd(fn, lp, x)
    for run in segments.values():                     # warm
        run()
    times = interleaved_min(segments, reps=reps, rounds=rounds)
    if mesh is not None:
        times = dict(zip(times, mesh.all_max(times.values())))

    layers = {}
    for name, _ in fns:
        fwd = times[f"{name}|fwd"]
        fb = times[f"{name}|fwd_bwd"]
        layers[name] = {"fwd_s": fwd, "bwd_s": max(fb - fwd, 0.0),
                        "fwd_bwd_s": fb}
    step = {"fwd_s": times["__step__|fwd"],
            "fwd_bwd_s": times["__step__|fwd_bwd"],
            "bwd_s": max(times["__step__|fwd_bwd"]
                         - times["__step__|fwd"], 0.0)}
    eta = measured_eta()
    meta = {"backend": "cuda" if cuda else "cpu",
            "mesh": dict(mesh.shape) if mesh is not None else {},
            "ndevices": mesh.size if mesh is not None else 1,
            "reps": reps, "rounds": rounds,
            "overlap": bool(overlap),
            "overlap_eta_measured": float(eta) if eta is not None else None,
            "measured_peak_bytes": peak}
    if cuda:
        meta.update(card_fields())
    return StepTrace(layers=layers, step=step, meta=meta)


# ---------------------------------------------------------------------------
# attribution rendering
# ---------------------------------------------------------------------------

def format_attribution(report: Mapping) -> str:
    """Render a plan.attribution_report dict as the predicted-vs-measured
    table (seconds in ms; ratio = measured / predicted, > 1 slower than
    the model; flagged rows exceed the tolerance either way)."""
    rows = [f"{'layer':20s} {'pred fwd':>9s} {'meas fwd':>9s} "
            f"{'pred bwd':>9s} {'meas bwd':>9s} {'ratio':>7s}  note"]
    for name, r in report["per_layer"].items():
        flag = " <-- drift" if r["flagged"] else ""
        rows.append(
            f"{name:20s} {r['predicted_fwd_s']*1e3:8.3f}m "
            f"{r['measured_fwd_s']*1e3:8.3f}m "
            f"{r['predicted_bwd_s']*1e3:8.3f}m "
            f"{r['measured_bwd_s']*1e3:8.3f}m "
            f"{r['ratio_total']:7.2f}{flag}")
    t = report["totals"]
    rows.append(
        f"{'TOTAL':20s} {t['predicted_s']*1e3:8.3f}m "
        f"{t['measured_s']*1e3:8.3f}m   ratio "
        f"{t['ratio']:.2f}  (step measured "
        f"{t['step_measured_s']*1e3:.3f}m)")
    terms = report.get("terms", {})
    if terms:
        worst = report.get("worst_term")
        parts = [f"{k}={v['drift']:.2f}x" for k, v in terms.items()]
        rows.append(f"per-term drift (measured/predicted, "
                    f"weighted by predicted seconds): {' '.join(parts)}"
                    + (f"; worst: {worst}" if worst else ""))
    return "\n".join(rows)
