"""Strategy-to-execution plan compiler (paper §V-C output -> runtime), port
of `repro.core.plan`.

`strategy.solve_line` answers the paper's optimization problem with a Dist
per layer; this module lowers it into a `NetworkPlan` the models execute:

  * each layer's `Dist` becomes the runtime sharding descriptor: a
    `ConvSharding` for sample/spatial distributions (core.spatial_conv) or
    a `CFSharding` for channel/filter ones (§III-D, core.channel_conv);
  * a distribution change between a layer and the one that feeds it
    becomes a reshard point, the paper's Shuffle(D_i, D_j) (§III-C).  The
    reference lowers it to `with_sharding_constraint` and lets GSPMD find
    the source layout; here the model names the producer at each call
    (`NetworkPlan.reshard(x, name, mesh, src)`), and this rank's block
    moves from the producer's output sharding to the layer's with
    `core.collectives.reshard` — all-to-alls, all-gathers and local
    slices, each differentiable.  A residual add joins its shortcut to
    the block's last conv output sharding (`NetworkPlan.reshard_add`), a
    move GSPMD makes unasked in the reference;
  * every layer is validated against its geometry (§III-A): a
    distribution the runtime would demote is demoted at compile time and
    recorded in the layer's note, so the cost report stays honest, and
    the reshard follows the demoted sharding;
  * mesh axes of size 1 are dropped;
  * the compiled plan carries the predicted cost and memory report
    (core.perfmodel).

`NetworkPlan.uniform` is one sharding for every layer; given the layers'
geometry it is fitted per layer too, with a reshard wherever the fit
drops a spatial axis.

Line networks (meshnet) solve with `plan_line`; branchy ones (ResNet-50)
with `plan_graph`, the §V-C longest-path-first solve over a
`core.dag.DiGraph`, whose reshard flags follow the graph's predecessors.
Both take `table=`, a measured `EmpiricalTable` (core.calibrate), and
price the solve and the report on it.  `NetworkPlan.attribution_report`
joins a measured `core.trace.StepTrace` with the report.  Every reshard
is the named region `reshard` (`core.trace.annotate`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import torch

from repro_torch.core import collectives, dag, trace
from repro_torch.core.channel_conv import CFSharding, chunks_decision
from repro_torch.core.distribution import Dist
from repro_torch.core.perfmodel import (ConvLayer, EmpiricalTable, Machine,
                                        cf_mode_for, layer_collectives,
                                        layer_memory,
                                        network_cost, network_memory,
                                        shuffle_block_bytes, shuffle_time)
from repro_torch.core.spatial_conv import ConvSharding
from repro_torch.core.strategy import (CapacityError, candidate_dists,
                                       parse_search, solve_dag,
                                       solve_dag_beam, solve_hillclimb,
                                       solve_line)
from repro_torch.launch.mesh import Mesh
from repro_torch.utils import human_bytes


class PlanError(ValueError):
    """A distribution map cannot be lowered to an executable plan.

    Messages name the offending layer (when known) and dist, and suggest
    the nearest executable demotion so callers can fix their map."""


PLAN_SCHEMA = "repro/plan@1"


# ---------------------------------------------------------------------------
# Dist -> ConvSharding lowering
# ---------------------------------------------------------------------------

def normalize_dist(d: Dist, mesh_shape: Mapping[str, int]) -> Dist:
    """Drop mesh axes of size 1 — they contribute no parallelism, and
    dropping them lets size-1 meshes take the dense single-device path."""
    dims = {k: tuple(a for a in axes if mesh_shape.get(a, 1) > 1)
            for k, axes in d.dims.items()}
    dims = {k: v for k, v in dims.items() if v}
    return Dist(d.name, dims)


def _demoted(d: Dist, keep: set[str]) -> Dist:
    """The nearest executable demotion: `d` restricted to dims in `keep`."""
    return Dist(d.name + "-demoted",
                {k: v for k, v in d.dims.items() if k in keep})


def _dist_str(d: Dist) -> str:
    dims = " ".join(f"{k}:{','.join(v)}" for k, v in d.dims.items())
    return f"{d.name!r} ({dims or 'replicated'})"


def _spatial_axis(axes: tuple[str, ...]):
    """A spatial dim's runtime axis spec: None / bare axis / product tuple
    (core.halo's linearized product-axis convention)."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def dist_to_sharding(d: Dist, mesh_shape: Mapping[str, int],
                     layer: str | None = None):
    """Lower a Dist to its runtime sharding descriptor, or raise PlanError.

    Sample (N) and spatial distributions — H and/or W, each over one mesh
    axis or a *product* of axes (core.halo) — lower to `ConvSharding`;
    channel/filter distributions (§III-D, C and F paired on one mesh axis),
    optionally composed with spatial sharding on different axes, lower to
    `CFSharding` (core.channel_conv).  `layer` (when known) names the
    offending layer in diagnostics.
    """
    d = normalize_dist(d, mesh_shape)
    who = f"layer {layer!r}: " if layer else ""
    c_ax, f_ax = d.axes("C"), d.axes("F")
    h_ax, w_ax = d.axes("H"), d.axes("W")
    if c_ax or f_ax:
        if c_ax != f_ax:
            raise PlanError(
                f"{who}dist {_dist_str(d)} shards C over {c_ax} but F over "
                f"{f_ax} — the CF runtime pairs C and F on the same mesh "
                "axis (layer i's F-shard is layer i+1's C-shard); nearest "
                "executable demotion: "
                f"{_dist_str(_demoted(d, {'N', 'H', 'W'}))}")
        if len(c_ax) > 1:
            raise PlanError(
                f"{who}dist {_dist_str(d)} shards C/F over {c_ax} — the CF "
                "runtime supports one mesh axis per group; nearest "
                "executable demotion: "
                f"{_dist_str(_demoted(d, {'N', 'H', 'W'}))}")
        if c_ax[0] in h_ax + w_ax:
            raise PlanError(
                f"{who}dist {_dist_str(d)} puts the CF group and a spatial "
                f"dim on the same mesh axis {c_ax[0]!r} — the composed "
                "runtime needs the halo exchange and the CF collective on "
                "different axes; nearest executable demotion: "
                f"{_dist_str(_demoted(d, {'N', 'H', 'W'}))}")
        unknown = set(d.dims) - {"N", "C", "F", "H", "W"}
        if unknown:
            raise PlanError(f"{who}dist {_dist_str(d)} shards non-CNN dims "
                            f"{unknown}")
        return CFSharding(batch_axes=d.axes("N"), cf_axis=c_ax[0],
                          h_axis=_spatial_axis(h_ax),
                          w_axis=_spatial_axis(w_ax))
    unknown = set(d.dims) - {"N", "H", "W"}
    if unknown:
        raise PlanError(f"{who}dist {_dist_str(d)} shards non-CNN dims "
                        f"{unknown}; nearest executable demotion: "
                        f"{_dist_str(_demoted(d, {'N', 'H', 'W'}))}")
    return ConvSharding(batch_axes=d.axes("N"),
                        h_axis=_spatial_axis(h_ax),
                        w_axis=_spatial_axis(w_ax))


def is_executable(d: Dist, mesh_shape: Mapping[str, int]) -> bool:
    try:
        dist_to_sharding(d, mesh_shape)
        return True
    except PlanError:
        return False


def executable_candidates(layer: ConvLayer, mesh_shape: Mapping[str, int],
                          allow_w_split: bool = True,
                          allow_channel_filter: bool = True,
                          wide: bool = False) -> list[Dist]:
    """The §V-C candidate set restricted to runtime-executable dists.

    Channel/filter candidates (§III-D) are included by default now that
    core.channel_conv executes them — including CF x spatial compositions
    (CF on one axis, H/W on others) and spatial dims split over *products*
    of mesh axes (core.halo), the hybrids 16x16 meshes need.  The few
    combinations the runtime still rejects (C and F on different axes,
    multi-axis CF groups) are filtered out here, so the solver only ever
    sees what it can run.  Never empty: a fully replicated layer is always
    executable (the solver then pays pure redundancy for it, which
    correctly prices it out whenever any parallel candidate exists).

    `wide` forwards to candidate_dists: the beam/hillclimb search space
    also lets mesh axes go unassigned (partial replication) — every such
    dist still lowers through dist_to_sharding, so is_executable keeps the
    widened set honest.
    """
    out = [d for d in candidate_dists(
               layer, mesh_shape,
               allow_channel_filter=allow_channel_filter,
               allow_w_split=allow_w_split,
               wide=wide)
           if is_executable(d, mesh_shape)]
    return out or [Dist("replicated", {})]


def _sharding_to_dist(sh, name: str = "uniform") -> Dist:
    dims: dict[str, tuple[str, ...]] = {}
    if sh.batch_axes:
        dims["N"] = tuple(sh.batch_axes)
    if sh.h_axes:
        dims["H"] = sh.h_axes
    if sh.w_axes:
        dims["W"] = sh.w_axes
    if isinstance(sh, CFSharding) and sh.cf_axis:
        dims["C"] = dims["F"] = (sh.cf_axis,)
    return Dist(name, dims)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerPlan:
    name: str
    sharding: "ConvSharding | CFSharding"   # fitted to the layer
    dist: Dist | None = None      # the COMPILED Dist
    reshard_in: bool = False      # §III-C shuffle on this layer's input
    note: str = ""                # e.g. geometry demotion record
    # the pre-demotion solved Dist, recorded only when compile_plan demoted
    # it
    solved: Dist | None = None
    # where it differs from `sharding`: the sharding of the layer's output
    # (its BN, and what the next layer reshards from), reached by a
    # reshard after the conv.  Only an unfitted uniform sharding has one:
    # the reference fits it 1x1 to the conv's output for BN, which keeps
    # an axis that the conv's own fit dropped.
    out: "ConvSharding | CFSharding | None" = None

    @property
    def out_sharding(self):
        return self.out if self.out is not None else self.sharding


def _layout(sh, mesh_shape: Mapping[str, int]) -> collectives.Layout:
    """The block layout of `sh` without the mesh axes of size 1."""
    return tuple(tuple(a for a in axes if mesh_shape.get(a, 1) > 1)
                 for axes in collectives.layout(sh))


def _demotion_note(sh, fitted, spec: ConvLayer) -> str:
    dropped = [ax for ax in ("h_axis", "w_axis")
               if getattr(sh, ax) and not getattr(fitted, ax)]
    return (f"demoted {'/'.join(dropped)}: "
            f"{spec.h}x{spec.w} shard vs k={spec.k},s={spec.s}")


def _fitted_layers(shardings, specs: Sequence[ConvLayer],
                   mesh_shape: Mapping[str, int],
                   graph: dag.DiGraph | None = None) -> dict[str, LayerPlan]:
    """One LayerPlan a layer, as the reference runs an unfitted sharding:
    the conv under the sharding fitted to its input geometry (§III-A),
    with a demotion note where the fit dropped an axis; its output (BN)
    under the sharding fitted 1x1 to the conv's output, except where the
    layer has no BN (a pool, and a line's last layer); a reshard wherever
    the block layout changes from the layer that feeds it (the previous
    one, or its predecessors in `graph`)."""
    out, outs = {}, {}
    for i, (sh, spec) in enumerate(zip(shardings, specs)):
        fitted = sh.fit(spec.h, spec.w, spec.k, spec.s, mesh_shape)
        lay = _layout(fitted, mesh_shape)
        no_bn = spec.kind == "pool" or (graph is None and
                                        i == len(specs) - 1)
        after = fitted if no_bn else \
            sh.fit(spec.h_out, spec.w_out, 1, 1, mesh_shape)
        lay_out = _layout(after, mesh_shape)
        if graph is None:
            prev = [outs[specs[i - 1].name]] if i else []
        else:
            prev = [outs[p] for p in graph.predecessors(spec.name)
                    if p in outs]
        out[spec.name] = LayerPlan(
            spec.name, fitted, _sharding_to_dist(fitted),
            reshard_in=any(p != lay for p in prev),
            note="" if fitted == sh else _demotion_note(sh, fitted, spec),
            out=after if lay_out != lay else None)
        outs[spec.name] = lay_out
    return out


@dataclasses.dataclass
class NetworkPlan:
    """Executable per-layer distribution plan.

    `layers` is keyed by layer name in execution order; `default` (if set)
    answers for layer names not in the map.  `predicted` is the perf-model
    cost report from compile time (core.perfmodel.network_cost dict), if a
    machine was supplied.
    """
    layers: dict[str, LayerPlan] = dataclasses.field(default_factory=dict)
    default: ConvSharding | None = None
    predicted: dict | None = None

    # -- construction -------------------------------------------------------
    @classmethod
    def uniform(cls, sharding: ConvSharding, names: Sequence[str] = (), *,
                specs: Sequence[ConvLayer] = (), mesh=None,
                graph: dag.DiGraph | None = None) -> "NetworkPlan":
        """One sharding for every layer.  Given the layers' `specs` and a
        `mesh`, each layer gets the sharding fitted to its geometry, and a
        layer whose fit drops a spatial axis a reshard point (§III-C),
        flagged against its `graph` predecessors where a graph is given;
        else every layer gets `sharding` as it is, with no reshard."""
        mesh_shape = _mesh_shape(mesh)
        if specs and mesh_shape:
            return cls(layers=_fitted_layers([sharding] * len(specs), specs,
                                             mesh_shape, graph),
                       default=sharding)
        d = _sharding_to_dist(sharding)
        return cls(layers={n: LayerPlan(n, sharding, d) for n in names},
                   default=sharding)

    @classmethod
    def from_shardings(cls, names: Sequence[str], shardings, *,
                       specs: Sequence[ConvLayer] = (), mesh=None
                       ) -> "NetworkPlan":
        """A sharding a layer, fitted and resharded as `uniform` does
        where `specs` and `mesh` are given."""
        assert len(names) == len(shardings), (len(names), len(shardings))
        mesh_shape = _mesh_shape(mesh)
        if specs and mesh_shape:
            return cls(layers=_fitted_layers(shardings, specs, mesh_shape))
        return cls(layers={n: LayerPlan(n, s)
                           for n, s in zip(names, shardings)})

    @classmethod
    def of(cls, obj, *, specs: Sequence[ConvLayer] = (), mesh=None,
           graph: dag.DiGraph | None = None) -> "NetworkPlan":
        """Normalize NetworkPlan | ConvSharding | CFSharding | None (one
        sharding for every layer) | a list of them (one a layer) into a
        plan, fitted to the layers' `specs` on `mesh` where given (a
        branchy network's with its `graph`)."""
        if isinstance(obj, NetworkPlan):
            return obj
        names = [s.name for s in specs]
        if isinstance(obj, (list, tuple)):
            return cls.from_shardings(names, obj, specs=specs, mesh=mesh)
        if obj is None:
            obj = ConvSharding()
        if isinstance(obj, (ConvSharding, CFSharding)):
            return cls.uniform(obj, names, specs=specs, mesh=mesh,
                               graph=graph)
        raise TypeError(f"cannot build a NetworkPlan from {type(obj)}")

    # -- queries ------------------------------------------------------------
    def sharding(self, name: str) -> "ConvSharding | CFSharding":
        lp = self.layers.get(name)
        if lp is not None:
            return lp.sharding
        if self.default is not None:
            return self.default
        raise PlanError(f"plan has no entry for layer {name!r} "
                        f"(knows {list(self.layers)[:8]}...)")

    def out_sharding(self, name: str) -> "ConvSharding | CFSharding":
        """The sharding of layer `name`'s output (its BN)."""
        lp = self.layers.get(name)
        return lp.out_sharding if lp is not None else self.sharding(name)

    @property
    def n_reshards(self) -> int:
        return sum(lp.reshard_in + (lp.out is not None)
                   for lp in self.layers.values())

    def input_spec(self, name: str, h: int, w: int, k: int, s: int,
                   mesh=None) -> tuple:
        """The placement (NHWC mesh axes, the reference's PartitionSpec as
        a tuple) of the tensor feeding layer `name`, with the geometry fit
        applied, so that a batch can be cut by it directly."""
        return self.sharding(name).fit(h, w, k, s,
                                       _mesh_shape(mesh) or None).x_spec()

    # -- persistence --------------------------------------------------------
    def to_spec(self, mesh=None, *, mem_limit: float | None = None,
                config_hash: str | None = None,
                calibration_fingerprint: str | None = None) -> dict:
        """The JSON-able plan record checkpoints carry (``repro/plan@1``):
        per-layer solved Dists, the mesh shape the solve ran on, the
        capacity limit it honored, and config/calibration fingerprints —
        everything an elastic restart needs to lower this plan onto a new
        mesh (plan_from_spec) or re-solve it under the same constraints."""
        layers = {}
        for lp in self.layers.values():
            d = lp.dist if lp.dist is not None \
                else _sharding_to_dist(lp.sharding, lp.name)
            layers[lp.name] = {"name": d.name,
                               "dims": {k: list(v)
                                        for k, v in d.dims.items()}}
        return {"schema": PLAN_SCHEMA,
                "layers": layers,
                "mesh": _mesh_shape(mesh) or None,
                "mem_limit": mem_limit,
                "config_hash": config_hash,
                "calibration_fingerprint": calibration_fingerprint}

    # -- execution ----------------------------------------------------------
    def _move(self, x: torch.Tensor, src, dst, mesh: Mesh | None
              ) -> torch.Tensor:
        if mesh is None:
            return x
        shape = dict(mesh.shape)
        with trace.annotate("reshard", x):
            return collectives.reshard(x, _layout(src, shape),
                                       _layout(dst, shape), mesh)

    def reshard(self, x: torch.Tensor, name: str, mesh: Mesh | None = None,
                src: str | None = None) -> torch.Tensor:
        """Apply the §III-C shuffle entering layer `name`: this rank's
        block moves from the output sharding of layer `src`, which made
        `x`, to `name`'s sharding (`core.collectives.reshard`,
        differentiable; nothing moves where the layouts agree).  `src`
        None: `x` is the network's input, cut by `name`'s sharding."""
        if src is None or name not in self.layers:
            return x
        return self._move(x, self.out_sharding(src), self.sharding(name),
                          mesh)

    def reshard_add(self, x: torch.Tensor, src: str, name: str,
                    mesh: Mesh | None = None) -> torch.Tensor:
        """The shortcut of a residual add, made by layer `src` (a
        projection, or the block input's producer), moved to the output
        sharding of layer `name`, the branch it is added to."""
        return self._move(x, self.out_sharding(src), self.out_sharding(name),
                          mesh)

    def reshard_out(self, x: torch.Tensor, name: str,
                    mesh: Mesh | None = None) -> torch.Tensor:
        """The reshard from layer `name`'s conv output to its output
        sharding, where a LayerPlan has one (`LayerPlan.out`)."""
        lp = self.layers.get(name)
        if lp is None or lp.out is None:
            return x
        return self._move(x, lp.sharding, lp.out, mesh)

    def reshard_report(self, specs: Sequence[ConvLayer], mesh,
                       wordsize: int = 4,
                       flow: Sequence[tuple] | None = None) -> list[dict]:
        """Each reshard the plan executes over `specs`: the collectives it
        runs, the bytes one rank sends in its forward (the backward sends
        as many) and the perf model's per-rank shuffle block
        (`perfmodel.shuffle_block_bytes` of the layer that made the
        tensor).

        `flow` lists the tensors that move between layers, each (src,
        name, "in") for layer `src`'s output feeding layer `name`, or
        (src, name, "add") for a shortcut made by `src` added to `name`'s
        output (`reshard_add`); None: a line, each layer feeding the next.
        A (src, name) pair whose layouts agree moves nothing and is not
        listed."""
        shape = _mesh_shape(mesh)
        p = 1
        for n in shape.values():
            p *= n
        by_name = {s.name: s for s in specs}
        if flow is None:
            flow = [(a.name, b.name, "in") for a, b in zip(specs, specs[1:])]
        out = []

        def point(where, layer, src, dst, dims):
            src, dst = _layout(src, shape), _layout(dst, shape)
            if src == dst:
                return
            out.append({
                "layer": where,
                "steps": collectives.reshard_steps(src, dst),
                "bytes": collectives.reshard_bytes(dims, src, dst, shape,
                                                   wordsize),
                "model_bytes": shuffle_block_bytes(layer, p, wordsize)})

        into = {}
        for src, name, kind in flow:
            into.setdefault(name, []).append((src, kind))
        for spec in specs:
            lp = self.layers.get(spec.name)
            if lp is None:
                continue
            for src, kind in into.get(spec.name, ()):
                if kind == "in":
                    point(spec.name, by_name[src], self.out_sharding(src),
                          lp.sharding, (spec.n, spec.h, spec.w, spec.c))
            if lp.out is not None:
                point(spec.name + " (out)", spec, lp.sharding, lp.out,
                      (spec.n, spec.h_out, spec.w_out, spec.f))
            for src, kind in into.get(spec.name, ()):
                if kind == "add":
                    point(spec.name + " (add)", by_name[src],
                          self.out_sharding(src), lp.out_sharding,
                          (spec.n, spec.h_out, spec.w_out, spec.f))
        return out

    # -- static analysis ----------------------------------------------------
    def audit(self, specs: Sequence[ConvLayer] | None = None, mesh=None, *,
              cfg=None, machine: Machine | None = None,
              overlap: bool = True, hlo: bool = False, params=None,
              batch=None, device="cuda") -> list:
        """Verification of this plan (repro_torch.analysis): the pure plan
        linter always runs; with `specs`, a live `mesh` AND `cfg` (the
        MeshNetConfig the plan executes) the collective auditor also runs
        one real step (forward, backward and the gradient bucket, no
        update: on `params` and this rank's block `batch`, else on seeded
        params and the synthetic batch; on `device`, CUDA unless the caller
        asks for the CPU) and joins every
        collective it executed against the priced inventory.  Returns the
        list of `Finding` records (render with
        repro_torch.analysis.format_findings; error-severity findings mean
        the costed and executed plans disagree)."""
        from repro_torch import analysis
        findings = list(analysis.lint_plan(
            self, specs=specs, mesh_shape=_mesh_shape(mesh) or None))
        if cfg is not None and mesh is not None and specs is not None:
            findings += analysis.meshnet_audit(
                self, specs, cfg, mesh, machine=machine, overlap=overlap,
                hlo=hlo, params=params, batch=batch, device=device).findings
        return findings

    # -- attribution --------------------------------------------------------
    def attribution_report(self, trace, *, tol: float = 5.0) -> dict:
        """Join a measured `core.trace.StepTrace` with this plan's
        perf-model predictions, per layer and per cost term.

        Per layer: predicted fwd (layer_cost fp + the incoming shuffle) and
        bwd (bpx + bpw + bpa) seconds next to the trace's measured isolated
        fwd/bwd, with ratio = measured / predicted; layers whose ratio
        exceeds `tol` in either direction are flagged.

        Per term: the model's cost decomposition {fp_compute, fp_comm,
        bp_compute, bp_comm, bpa, shuffle} each gets a drift estimate — the
        predicted-seconds-weighted mean of the per-layer measured/predicted
        ratio in that term's direction (fwd or bwd).  The measurement only
        resolves whole fwd/bwd segments, so a term's drift is the layer
        ratio weighted by how much of the prediction that term carries:
        terms that dominate the predicted time in layers that drift most
        are named as `worst_term` — the §V model-vs-measured mystery
        decomposed into named per-term suspects.

        Requires a plan compiled with a `machine` (predicted cost report).
        """
        if not self.predicted or "layer_costs" not in self.predicted:
            raise PlanError("attribution needs a plan compiled with a "
                            "`machine` (no predicted layer costs attached)")
        costs = self.predicted["layer_costs"]
        shuf = self.predicted.get("shuffle_per_layer", {})
        missing = [n for n in costs if n not in trace.layers]
        if missing:
            raise PlanError(f"trace has no measurement for plan layers "
                            f"{missing} (knows {list(trace.layers)[:8]}...)")

        per_layer: dict[str, dict] = {}
        flagged: list[str] = []
        for name, c in costs.items():
            # float() everywhere: perf-model terms may be numpy scalars,
            # and the report must stay json.dump-able as-is
            pf = float(c.fp + shuf.get(name, 0.0))
            pb = float(c.bpx + c.bpw + c.bpa)
            mf = float(trace.layers[name]["fwd_s"])
            mb = float(trace.layers[name]["bwd_s"])
            ratio = (mf + mb) / (pf + pb) if pf + pb > 0 else float("nan")
            flag = bool(ratio == ratio
                        and (ratio > tol or ratio < 1.0 / tol))
            if flag:
                flagged.append(name)
            per_layer[name] = {
                "predicted_fwd_s": pf, "measured_fwd_s": mf,
                "predicted_bwd_s": pb, "measured_bwd_s": mb,
                "ratio_total": ratio, "flagged": flag}

        # per-term drift: terms split by the direction they live in
        def terms_of(name):
            c = costs[name]
            return {"fp_compute": (float(c.fp_compute), "f"),
                    "fp_comm": (float(c.fp - c.fp_compute + c.fp_saved),
                                "f"),
                    "shuffle": (float(shuf.get(name, 0.0)), "f"),
                    "bp_compute": (float(c.bp_compute), "b"),
                    "bp_comm": (float(c.bpx + c.bpw - c.bp_compute
                                      + c.bp_saved), "b"),
                    "bpa": (float(c.bpa), "b")}

        acc: dict[str, list[float]] = {}
        for name in costs:
            r = per_layer[name]
            dir_ratio = {
                "f": (r["measured_fwd_s"] / r["predicted_fwd_s"]
                      if r["predicted_fwd_s"] > 0 else None),
                "b": (r["measured_bwd_s"] / r["predicted_bwd_s"]
                      if r["predicted_bwd_s"] > 0 else None)}
            for term, (w, d) in terms_of(name).items():
                if w > 0 and dir_ratio[d] is not None:
                    s = acc.setdefault(term, [0.0, 0.0])
                    s[0] += w * dir_ratio[d]
                    s[1] += w
        terms = {t: {"drift": s[0] / s[1], "predicted_s": s[1]}
                 for t, s in acc.items() if s[1] > 0}
        worst = None
        if terms:
            worst = max(terms, key=lambda t: abs(math.log(
                max(terms[t]["drift"], 1e-12))))

        pred_total = sum(r["predicted_fwd_s"] + r["predicted_bwd_s"]
                         for r in per_layer.values())
        meas_total = sum(r["measured_fwd_s"] + r["measured_bwd_s"]
                         for r in per_layer.values())
        return {"schema": "repro/attribution@1",
                "tolerance": tol,
                "per_layer": per_layer,
                "flagged": flagged,
                "terms": terms,
                "worst_term": worst,
                "totals": {"predicted_s": pred_total,
                           "measured_s": meas_total,
                           "ratio": (meas_total / pred_total
                                     if pred_total > 0 else float("nan")),
                           "step_measured_s": trace.step["fwd_bwd_s"]}}

    # -- reporting ----------------------------------------------------------
    def describe(self) -> str:
        rows = []
        for lp in self.layers.values():
            tag = "shuffle <- " if lp.reshard_in else ""
            lay = _sharding_str(lp.sharding)
            if lp.out is not None:
                lay += f" -> shuffle -> {_sharding_str(lp.out)}"
            note = f"   [{lp.note}]" if lp.note else ""
            ov = ""
            if self.predicted is not None:
                credit = self.predicted.get("overlap_credit", {})
                if credit.get(lp.name, 0.0) > 0:
                    ov = f"   overlap -{credit[lp.name]*1e3:.3f} ms"
            rows.append(f"  {lp.name:20s} {tag}{lay}{ov}{note}")
        head = [f"NetworkPlan: {len(self.layers)} layers, "
                f"{self.n_reshards} reshard points"]
        if self.predicted is not None:
            head.append(
                f"  predicted step: {self.predicted['total']*1e3:.3f} ms "
                f"(fp {self.predicted['fp']*1e3:.3f} + "
                f"shuffle {self.predicted['shuffle']*1e3:.3f} + "
                f"bp {self.predicted['bp']*1e3:.3f})")
            credit = self.predicted.get("overlap_credit")
            if credit is not None:
                head.append(
                    f"  overlap credit: "
                    f"{sum(credit.values())*1e3:.3f} ms hidden at "
                    f"eta={self.predicted.get('overlap_eta', 1.0):.2f} "
                    f"(per-layer rows below)")
            mem = self.predicted.get("memory")
            if mem is not None:
                lim = mem.get("limit_bytes")
                head.append(
                    f"  predicted peak memory: "
                    f"{human_bytes(mem['peak_bytes'])}/device at "
                    f"{mem['peak_layer']!r}"
                    + (f" (limit {human_bytes(lim)})" if lim else ""))
        return "\n".join(head + rows)


def _sharding_str(sh) -> str:
    parts = []
    if sh.batch_axes:
        parts.append(f"N:{','.join(sh.batch_axes)}")
    if sh.h_axes:
        parts.append(f"H:{'x'.join(sh.h_axes)}")
    if sh.w_axes:
        parts.append(f"W:{'x'.join(sh.w_axes)}")
    if isinstance(sh, CFSharding) and sh.cf_axis:
        parts.append(f"CF:{sh.cf_axis}({sh.mode})")
    return " ".join(parts) or "replicated"


def reshard_lines(report: list[dict]) -> str:
    """`NetworkPlan.reshard_report` as text, one line a reshard point."""
    rows = [f"  {r['layer']:20s} "
            + ", ".join(f"{op} {a} {'/'.join('NHWC'[d] for d in dims)}"
                        for op, a, *dims in r["steps"])
            + f": {human_bytes(r['bytes'])} sent a rank "
            f"(perf-model shuffle block {human_bytes(r['model_bytes'])})"
            for r in report]
    return "\n".join([f"reshards: {len(report)}"] + rows)


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------

def _mesh_shape(mesh) -> dict[str, int]:
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(mesh.shape)


def compile_plan(dists: Mapping[str, Dist] | Sequence[Dist],
                 specs: Sequence[ConvLayer], mesh=None, *,
                 graph: dag.DiGraph | None = None,
                 machine: Machine | None = None,
                 table: EmpiricalTable | None = None,
                 overlap: bool = True,
                 cost_specs: Sequence[ConvLayer] | None = None,
                 mem_limit: float | None = None,
                 opt_words: float = 1.0
                 ) -> NetworkPlan:
    """Lower a solved distribution map into an executable NetworkPlan.

    dists:   {layer name: Dist} (solve_dag) or a Dist per spec (solve_line).
    specs:   ConvLayers in execution order (the geometry to validate against).
    graph:   optional DiGraph: reshard points are flagged against the
             layer's predecessors compiled before it instead of list
             order (branchy networks), as the reference flags them.
    machine: if given, attach the §V-B cost report under the *compiled*
             (post-demotion) distributions, evaluated over `cost_specs`
             (default: `specs`) — branchy networks pass their main path so
             side branches are not costed as line continuations.  The
             report carries the §VI memory rollup too (predicted['memory']:
             per-layer LayerMemory breakdowns + peak_bytes/peak_layer),
             over every compiled layer.
    table:   measured local conv and shuffle costs (core.calibrate) the
             report prices before the analytic model.
    mem_limit: per-device capacity in bytes.  The compiled (post-demotion)
             plan is validated against it: a plan whose per-layer resident
             set or whole-network peak exceeds the limit raises PlanError
             with the offending layers' footprint breakdowns, and demotion
             notes record when a demotion itself violates capacity (a
             geometry demotion can *grow* the footprint — the layer falls
             back to a coarser split).
    """
    mesh_shape = _mesh_shape(mesh)
    if not isinstance(dists, Mapping):
        assert len(dists) == len(specs), (len(dists), len(specs))
        dists = {l.name: d for l, d in zip(specs, dists)}

    compiled: dict[str, LayerPlan] = {}
    final: dict[str, Dist] = {}
    cf_chunks: dict[str, int] = {}
    for i, spec in enumerate(specs):
        if spec.name not in dists:
            raise PlanError(f"no solved dist for layer {spec.name!r}")
        d = d_solved = normalize_dist(dists[spec.name], mesh_shape)
        sh = dist_to_sharding(d, mesh_shape, layer=spec.name)
        n_ways = d.ways("N", mesh_shape)
        if spec.n % n_ways:
            raise PlanError(
                f"layer {spec.name!r}: N={spec.n} not divisible by "
                f"{n_ways}-way {_dist_str(d)}; nearest executable "
                f"demotion: {_dist_str(_demoted(d, set(d.dims) - {'N'}))}")
        note = ""
        # the §III-A geometry fit applies to both descriptor kinds now that
        # CFSharding may compose spatial axes: record any demotion so the
        # executed and costed plans stay identical.
        fitted = sh.fit(spec.h, spec.w, spec.k, spec.s, mesh_shape) \
            if mesh_shape else sh
        if fitted != sh:
            note = _demotion_note(sh, fitted, spec)
            sh = fitted
            d = _sharding_to_dist(sh, d.name + "-demoted")
        if isinstance(sh, CFSharding):
            if not sh.fits_channels(spec.c, spec.f, mesh_shape):
                # the CF edge case: channel counts must divide the mesh
                # axis; demote to the sample/spatial remainder at compile
                # time and record it so the cost report stays honest.
                ways = mesh_shape.get(sh.cf_axis, 1)
                note = (note + "; " if note else "") + (
                    f"demoted C/F: {spec.c}->{spec.f} channels vs "
                    f"{ways}-way {sh.cf_axis}")
                d = _demoted(d, {"N", "H", "W"})
                sh = dist_to_sharding(d, mesh_shape, layer=spec.name)
            else:
                # per-layer 'filter' vs 'channel' pick: the runtime executes
                # whichever §III-D collective moves fewer words — AG(x) vs
                # RS(y) at the sub-mesh shard shapes (perfmodel).
                sh = dataclasses.replace(
                    sh, mode=cf_mode_for(spec, d, mesh_shape))
                if sh.mode == "channel":
                    # record the calibrated chunked-CF resolution so the
                    # cost report says what the runtime will actually do
                    nblk, why = chunks_decision()
                    cf_chunks[spec.name] = nblk
                    note = (note + "; " if note else "") + (
                        f"cf chunks={nblk} ({why})")
        if note and machine is not None and mem_limit and mesh_shape:
            # a demotion falls back to a *coarser* split, so it can grow
            # the footprint past capacity — record that in the note (the
            # whole-plan validation below then raises with the breakdown)
            lm = layer_memory(machine, spec, d, mesh_shape, opt_words)
            if lm.total > mem_limit:
                note += (f"; demotion violates capacity: "
                         f"{human_bytes(lm.total)} > "
                         f"{human_bytes(mem_limit)}/device "
                         f"({lm.breakdown()})")
        if graph is not None:
            preds = [final[p] for p in graph.predecessors(spec.name)
                     if p in final]
            reshard = any(not p.same_as(d) for p in preds)
        else:
            prev = final.get(specs[i - 1].name) if i else None
            reshard = prev is not None and not prev.same_as(d)
        compiled[spec.name] = LayerPlan(
            spec.name, sh, d, reshard_in=reshard, note=note,
            solved=None if d_solved.same_as(d) else d_solved)
        final[spec.name] = d

    predicted = None
    if mem_limit and machine is None:
        raise PlanError("mem_limit validation needs a `machine` (the memory "
                        "model's wordsize and accounting live there)")
    if machine is not None and mesh_shape:
        cs = list(cost_specs if cost_specs is not None else specs)
        dists_c = [final[l.name] for l in cs]
        predicted = network_cost(machine, cs, dists_c, mesh_shape, table,
                                 overlap)
        # per-layer η-scaled overlap credit: the seconds of communication
        # the schedule is credited with hiding (0 when nothing overlaps),
        # surfaced so describe() can report the latency-hiding budget.
        predicted["overlap_eta"] = machine.overlap_eta if overlap else 0.0
        predicted["overlap_credit"] = {
            l.name: c.overlap_credit
            for l, c in zip(cs, predicted["per_layer"])}
        # name-keyed views of the per-layer cost terms.  The shuffle of
        # transition i -> i+1 is charged to the *receiving* layer (where
        # NetworkPlan.reshard executes it).
        predicted["layer_costs"] = {
            l.name: c for l, c in zip(cs, predicted["per_layer"])}
        predicted["shuffle_per_layer"] = {cs[0].name: 0.0} if cs else {}
        for i in range(len(cs) - 1):
            predicted["shuffle_per_layer"][cs[i + 1].name] = shuffle_time(
                machine, cs[i], dists_c[i], dists_c[i + 1], mesh_shape,
                table)
        # the priced-collective inventory (perfmodel.layer_collectives).
        # first=True: training losses grad wrt params only, so the first
        # layer's backward input halos are never sent.
        predicted["collectives_per_layer"] = {
            l.name: layer_collectives(
                machine, l, final[l.name], mesh_shape, overlap=overlap,
                first=(i == 0), channel_chunks=cf_chunks.get(l.name, 1))
            for i, l in enumerate(cs)}
        # memory rolls up over ALL compiled layers: a side branch's
        # weights and stashes are resident too, so a branchy network does
        # not escape the capacity validation because its time is costed
        # over the main path (cost_specs) only.
        mem = network_memory(machine, list(specs),
                             [final[l.name] for l in specs], mesh_shape,
                             opt_words)
        mem["per_layer"] = {l.name: lm
                            for l, lm in zip(specs, mem["per_layer"])}
        mem["limit_bytes"] = mem_limit
        predicted["memory"] = mem
        if mem_limit:
            over = [(name, lm) for name, lm in mem["per_layer"].items()
                    if lm.total > mem_limit]
            if over or mem["peak_bytes"] > mem_limit:
                lines = [f"  {name}: {human_bytes(lm.total)} "
                         f"({lm.breakdown()})" for name, lm in (
                             over or [(mem["peak_layer"],
                                       mem["per_layer"][mem["peak_layer"]])])]
                notes = [f"  {lp.name}: {lp.note}"
                         for lp in compiled.values()
                         if "violates capacity" in lp.note]
                raise PlanError(
                    f"compiled plan does not fit the "
                    f"{human_bytes(mem_limit)}/device memory limit: "
                    f"predicted peak {human_bytes(mem['peak_bytes'])} at "
                    f"layer {mem['peak_layer']!r}; offending per-layer "
                    f"footprints (weights/acts/halo/grads):\n"
                    + "\n".join(lines + notes))
    return NetworkPlan(layers=compiled, predicted=predicted)


# ---------------------------------------------------------------------------
# plan-spec recovery (the checkpoint round trip)
# ---------------------------------------------------------------------------

def dists_from_spec(spec: Mapping) -> dict[str, Dist]:
    """Reconstruct the solved {layer: Dist} map from a ``repro/plan@1``
    record (NetworkPlan.to_spec / a checkpoint manifest's "plan" entry)."""
    if spec.get("schema") != PLAN_SCHEMA:
        raise PlanError(f"not a {PLAN_SCHEMA} record "
                        f"(schema={spec.get('schema')!r})")
    return {name: Dist(o["name"],
                       {k: tuple(v) for k, v in o["dims"].items()})
            for name, o in spec["layers"].items()}


def plan_from_spec(spec: Mapping, specs: Sequence[ConvLayer], mesh, *,
                   machine: Machine | None = None,
                   table: EmpiricalTable | None = None,
                   overlap: bool = True,
                   mem_limit: float | None = None,
                   opt_words: float = 1.0) -> NetworkPlan:
    """Lower a stored plan spec onto `mesh` — reshard-on-restore.

    The recorded Dists name mesh *axes* ("data", "model"), not device
    counts, so the same spec lowers onto any factorization: compile_plan's
    normalization drops axes the new mesh collapsed to size 1 and the
    §III-A geometry fit demotes splits the new axis sizes no longer divide
    — both recorded in the plan notes.  Pass the checkpoint's own
    `mem_limit` to re-validate capacity on the new mesh; a spec that
    cannot fit (or that covers different layers than `specs`) raises
    PlanError, at which point the caller re-solves plan_line/plan_graph
    from scratch under the same limit.
    """
    dists = dists_from_spec(spec)
    missing = [l.name for l in specs if l.name not in dists]
    if missing:
        raise PlanError(
            f"stored plan ({PLAN_SCHEMA}) has no entry for layers "
            f"{missing} — the architecture changed; re-solve instead")
    return compile_plan(dists, specs, mesh, machine=machine, table=table,
                        overlap=overlap, mem_limit=mem_limit,
                        opt_words=opt_words)


# ---------------------------------------------------------------------------
# solve + compile in one step
# ---------------------------------------------------------------------------

# the per-layer capacity constraint (strategy.prune_by_memory) bounds each
# layer's own resident set, but the whole-network peak also accumulates the
# forward stashes of earlier layers — so a per-layer-feasible solve can
# still overflow.  plan_line and plan_graph close that gap by re-solving with a
# tightened per-layer budget, scaled by the overflow ratio, a few times.
_MEM_REFINE_ROUNDS = 4


def _solve_under_limit(solve, compile_, mem_limit):
    """Shared capacity refinement loop: `solve(per_layer_limit)` returns a
    dist map, `compile_(dists, validate)` a NetworkPlan whose predicted
    memory is inspected.  Raises PlanError/CapacityError when no fitting
    plan is found within the refinement budget."""
    if not mem_limit:
        return compile_(solve(None), None)
    limit, dists = mem_limit, None
    for _ in range(_MEM_REFINE_ROUNDS):
        try:
            dists = solve(limit)
        except CapacityError:
            if dists is None:
                raise              # infeasible at the user's own limit
            break                  # tightened past the per-layer floors
        plan = compile_(dists, None)
        if plan.predicted["memory"]["peak_bytes"] <= mem_limit:
            # the network peak bounds every per-layer resident set, so the
            # fit is already proven — record the limit, no recompile
            plan.predicted["memory"]["limit_bytes"] = mem_limit
            return plan
        # overflow: the stash accumulation ate the headroom — tighten the
        # per-layer budget proportionally and re-solve
        limit *= 0.9 * mem_limit / plan.predicted["memory"]["peak_bytes"]
    return compile_(dists, mem_limit)          # raises with the breakdown


def plan_line(machine: Machine, specs: Sequence[ConvLayer], mesh, *,
              table: EmpiricalTable | None = None, overlap: bool = True,
              allow_w_split: bool = True,
              allow_channel_filter: bool = True,
              mem_limit: float | None = None,
              opt_words: float = 1.0,
              search: str = "greedy") -> NetworkPlan:
    """Line networks (meshnet): §V-C shortest path over executable
    candidates (sample, spatial and channel/filter), compiled to a
    NetworkPlan.

    `mem_limit` (bytes/device) makes the solve memory-aware: min-time
    subject to every layer's resident set AND the whole-network peak
    (stash accumulation included) fitting — the §VI Table-2 capability.

    `search` widens the space beyond the paper's heuristic: "greedy" is
    the default one-target-per-axis DP; "beam[:N]" runs the same exact
    line DP over the *wide* candidate set (axes may go unassigned), a
    strict superset, so its predicted optimum is never worse; "hillclimb"
    is the stochastic local-search baseline over the same wide set.
    """
    mode, width = parse_search(search)
    mesh_shape = _mesh_shape(mesh)
    cands = [executable_candidates(l, mesh_shape, allow_w_split,
                                   allow_channel_filter,
                                   wide=mode != "greedy")
             for l in specs]

    def solve(limit):
        if mode == "hillclimb":
            return solve_hillclimb(machine, specs, cands, mesh_shape, table,
                                   overlap, mem_limit=limit,
                                   opt_words=opt_words).dists
        # a line's beam search IS the exact DP (solve_line); the widened
        # candidate set is where beam mode's advantage lives
        return solve_line(machine, specs, cands, mesh_shape, table, overlap,
                          mem_limit=limit, opt_words=opt_words).dists

    def compile_(dists, validate_limit):
        return compile_plan(dists, specs, mesh, machine=machine,
                            table=table, overlap=overlap,
                            mem_limit=validate_limit, opt_words=opt_words)

    return _solve_under_limit(solve, compile_, mem_limit)


def compile_order(graph: dag.DiGraph,
                  specs: Sequence[ConvLayer]) -> list[ConvLayer]:
    """The layers a branchy network's plan holds, in the order
    `plan_graph` compiles them: `specs` (its main path), then the graph's
    other nodes (side branches) in graph order."""
    names = {l.name for l in specs}
    return list(specs) + [graph.nodes[n]["layer"] for n in graph.nodes
                          if n not in names]


def plan_graph(machine: Machine, graph: dag.DiGraph,
               specs: Sequence[ConvLayer], mesh, *,
               table: EmpiricalTable | None = None,
               overlap: bool = True,
               allow_w_split: bool = True,
               allow_channel_filter: bool = True,
               mem_limit: float | None = None,
               opt_words: float = 1.0,
               search: str = "greedy") -> NetworkPlan:
    """Branchy networks (ResNet): §V-C longest-path-first over the DAG.

    `specs` fixes the execution/validation order and may be a subset of the
    graph (e.g. the main path); side-branch nodes present in the graph but
    not in `specs` are compiled too, after them, in graph order.
    `mem_limit` applies the same capacity constraint as plan_line.

    `search` = "beam[:N]" replaces longest-path-first with the global
    reshard-cost-aware beam DP (strategy.solve_dag_beam) over the wide
    candidate set — every cross edge between paths is priced, not just
    the fixed paths'.  "hillclimb" runs the stochastic baseline over the
    DAG's full edge set.
    """
    mode, width = parse_search(search)
    mesh_shape = _mesh_shape(mesh)
    all_specs = compile_order(graph, specs)

    def candidate_fn(l):
        return executable_candidates(l, mesh_shape, allow_w_split,
                                     allow_channel_filter,
                                     wide=mode != "greedy")

    def solve(limit):
        if mode == "beam":
            return solve_dag_beam(machine, graph, mesh_shape, candidate_fn,
                                  table, overlap, mem_limit=limit,
                                  opt_words=opt_words, width=width)
        if mode == "hillclimb":
            order = list(graph.nodes)
            pos = {n: i for i, n in enumerate(order)}
            layers = [graph.nodes[n]["layer"] for n in order]
            res = solve_hillclimb(
                machine, layers, [candidate_fn(l) for l in layers],
                mesh_shape, table, overlap,
                edges=[(pos[u], pos[v]) for u, v in graph.edges],
                mem_limit=limit, opt_words=opt_words)
            return {n: d for n, d in zip(order, res.dists)}
        return solve_dag(machine, graph, mesh_shape, candidate_fn, table,
                         overlap, mem_limit=limit, opt_words=opt_words)

    def compile_(dists, validate_limit):
        return compile_plan(dists, all_specs, mesh, graph=graph,
                            machine=machine, table=table, overlap=overlap,
                            cost_specs=specs, mem_limit=validate_limit,
                            opt_words=opt_words)

    return _solve_under_limit(solve, compile_, mem_limit)
