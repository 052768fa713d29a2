"""Parallel execution strategies (paper §V-C), port of `repro.core.strategy`.

Given a line network, a machine and a mesh, pick a distribution for every
layer:

  1. generate per-layer candidate distributions — load-balanced assignments
     of mesh axes to tensor dimensions, preferring cheaper methods (sample
     over spatial over channel/filter) exactly as the paper's heuristic;
  2. line networks: single-source shortest path over the layered DAG whose
     edge (D_i at ℓ_i) -> (D_j at ℓ_{i+1}) costs Cost_{D_i}(ℓ_i) +
     Shuffle(D_i, D_j); solved by DP in topological order (linear time).

  3. branchy networks (ResNet-50): longest-path-first over the layer DAG
     (`solve_dag`): solve the most compute-intensive path as a line, fix
     it, zero its edges and repeat; or the global beam DP over the whole
     DAG (`solve_dag_beam`).  The DAG is `core.dag.DiGraph`, whose order
     and tie-breaking are networkx's, so both solve the reference's plan.

Channel/filter parallelism — sketched-only in the paper (§III-D) — is a
selectable candidate here (beyond-paper), so the optimizer can discover it
for many-filter/small-spatial layers.

Every edge cost flows through perfmodel.layer_cost, so the §IV-A overlap
credit the solver optimizes against is η-scaled.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Mapping, Sequence


from repro_torch.core import dag
from repro_torch.core.distribution import Dist
from repro_torch.core.perfmodel import (ConvLayer, EmpiricalTable, Machine,
                                        layer_cost, layer_memory,
                                        shuffle_time)
from repro_torch.utils import human_bytes


class CapacityError(ValueError):
    """No candidate distribution of some layer fits the per-device memory
    limit.  Follows core.plan.PlanError's diagnostics discipline: messages
    name the layer and report its smallest-achievable footprint, which
    distribution achieves it, and the footprint breakdown — so users can
    see whether the wall is weights, activations, halo or gradients."""


# ---------------------------------------------------------------------------
# candidate generation
# ---------------------------------------------------------------------------

def prune_by_memory(m: Machine, layer: ConvLayer,
                    candidates: Sequence[Dist],
                    mesh_shape: Mapping[str, int],
                    mem_limit: float | None,
                    opt_words: float = 1.0) -> list[Dist]:
    """Drop candidate dists whose per-layer resident set exceeds
    `mem_limit` bytes/device (perfmodel.layer_memory) — the capacity
    constraint of the memory-aware solve.  Raises CapacityError when
    *nothing* fits, naming the layer and the smallest-achievable footprint
    (this is how the paper's 'unreachable' workloads surface: sample
    parallelism cannot reduce per-device activations below one sample)."""
    if not mem_limit or mem_limit <= 0:
        return list(candidates)
    mems = [(layer_memory(m, layer, d, mesh_shape, opt_words), d)
            for d in candidates]
    kept = [d for lm, d in mems if lm.total <= mem_limit]
    if not kept:
        best_mem, best = min(mems, key=lambda md: md[0].total)
        raise CapacityError(
            f"layer {layer.name!r}: no candidate distribution fits the "
            f"{human_bytes(mem_limit)}/device memory limit; smallest "
            f"achievable footprint is {human_bytes(best_mem.total)} "
            f"under dist {best.name!r} ({best_mem.breakdown()})")
    return kept


def candidate_dists(layer: ConvLayer, mesh_shape: Mapping[str, int],
                    allow_channel_filter: bool = False,
                    allow_w_split: bool = True,
                    wide: bool = False) -> list[Dist]:
    """Load-balanced assignments of every mesh axis to one tensor dim.

    Each mesh axis independently partitions one of N / H / W / (C&F); an
    assignment is valid iff every dim divides evenly and spatial shards stay
    at least kernel-sized (the paper's edge case).  Ordered cheapest-first
    (sample < spatial < channel/filter) so ties break toward the paper's
    preference.

    `wide` (the --search beam/hillclimb space, per Jia et al. 1802.04924)
    additionally lets a mesh axis go *unassigned* ("R": the layer replicates
    over it) — a strict superset of the default space, so a wide solve's
    predicted optimum is never worse than the greedy one's.
    """
    axes = list(mesh_shape)
    targets = ["N", "H"]
    if allow_w_split:
        targets.append("W")
    if allow_channel_filter and layer.kind == "conv":
        targets.append("CF")
    if wide:
        targets.append("R")

    def rank(assign):  # cheaper methods first
        order = {"N": 0, "H": 1, "W": 1, "CF": 2, "R": 3}
        return tuple(sorted(order[t] for t in assign))

    seen, out = set(), []
    for assign in sorted(itertools.product(targets, repeat=len(axes)),
                         key=rank):
        dims: dict[str, tuple[str, ...]] = {}
        for ax, tgt in zip(axes, assign):
            if tgt == "R":      # axis left unassigned: replicate over it
                continue
            for d in (("C", "F") if tgt == "CF" else (tgt,)):
                dims[d] = dims.get(d, ()) + (ax,)
        d = Dist("+".join(sorted(set(assign))).lower(), dims)
        ways = {k: d.ways(k, mesh_shape) for k in ("N", "H", "W", "C", "F")}
        if layer.n % ways["N"] or layer.h % ways["H"] or \
           layer.w % ways["W"] or layer.c % ways["C"] or layer.f % ways["F"]:
            continue
        if ways["H"] > 1 and layer.h // ways["H"] < layer.k:
            continue
        if ways["W"] > 1 and layer.w // ways["W"] < layer.k:
            continue
        if layer.kind == "pool" and (ways["C"] > 1 or ways["F"] > 1):
            continue
        key = tuple(sorted((k, v) for k, v in dims.items()))
        if key in seen:
            continue
        seen.add(key)
        out.append(d)
    return out


# ---------------------------------------------------------------------------
# line-network shortest path (paper §V-C)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StrategyResult:
    dists: list[Dist]
    cost: float


def solve_line(m: Machine, layers: Sequence[ConvLayer],
               candidates: Sequence[Sequence[Dist]],
               mesh_shape: Mapping[str, int],
               table: EmpiricalTable | None = None,
               overlap: bool = True,
               mem_limit: float | None = None,
               opt_words: float = 1.0) -> StrategyResult:
    """DP shortest path over the candidate-distribution DAG.

    With `mem_limit` (bytes/device) the solve is min-time *subject to*
    every layer's resident set fitting: infeasible dists are pruned from
    the candidate sets (prune_by_memory), and a layer with no fitting
    candidate raises CapacityError with its footprint diagnostics.
    """
    n = len(layers)
    assert n and all(candidates), "every layer needs >= 1 candidate"
    if mem_limit:
        candidates = [prune_by_memory(m, layers[i], candidates[i],
                                      mesh_shape, mem_limit, opt_words)
                      for i in range(n)]
    lcost = [[layer_cost(m, layers[i], d, mesh_shape, table, overlap).total
              for d in candidates[i]] for i in range(n)]

    best = list(lcost[0])                      # source -> first-layer nodes
    back: list[list[int]] = [[-1] * len(candidates[0])]
    for i in range(1, n):
        cur = []
        bk = []
        for j, dj in enumerate(candidates[i]):
            best_prev, arg = float("inf"), -1
            for p, dp in enumerate(candidates[i - 1]):
                w = best[p] + shuffle_time(m, layers[i - 1], dp, dj,
                                           mesh_shape, table)
                if w < best_prev:
                    best_prev, arg = w, p
            cur.append(best_prev + lcost[i][j])
            bk.append(arg)
        best, back = cur, back + [bk]

    j = min(range(len(best)), key=best.__getitem__)
    total = best[j]
    picks = [j]
    for i in range(n - 1, 0, -1):
        j = back[i][j]
        picks.append(j)
    picks.reverse()
    return StrategyResult([candidates[i][picks[i]] for i in range(n)], total)


# ---------------------------------------------------------------------------
# branchy networks: longest-path-first (paper §V-C)
# ---------------------------------------------------------------------------

def solve_dag(m: Machine, graph: dag.DiGraph,
              mesh_shape: Mapping[str, int],
              candidate_fn: Callable[[ConvLayer], Sequence[Dist]],
              table: EmpiricalTable | None = None,
              overlap: bool = True,
              mem_limit: float | None = None,
              opt_words: float = 1.0) -> dict[str, Dist]:
    """graph: a DiGraph whose nodes carry a 'layer': ConvLayer attribute.

    `candidate_fn(layer) -> [Dist]` gives each layer's candidates — the plan
    compiler (core.plan) passes the distributions the runtime can execute.
    `mem_limit` applies the per-device capacity constraint to every path
    solve (see solve_line).

    Returns {layer name: Dist}.
    """
    if not dag.is_dag(graph):
        raise ValueError("solve_dag needs an acyclic graph")
    fixed: dict[str, Dist] = {}
    g = graph.copy()
    for u, v in g.edges:
        g[u][v]["w"] = g.nodes[u]["layer"].flops_fwd()

    while len(fixed) < graph.number_of_nodes():
        # longest (most compute-intensive) path among unfixed-containing ones
        path = dag.dag_longest_path(g, weight="w")
        if all(p in fixed for p in path):
            # fall back: any unfixed node, treated as a singleton path
            path = [next(n for n in g.nodes if n not in fixed)]
        layers = [graph.nodes[p]["layer"] for p in path]
        cands = [[fixed[p]] if p in fixed else candidate_fn(layers[i])
                 for i, p in enumerate(path)]
        res = solve_line(m, layers, cands, mesh_shape, table, overlap,
                         mem_limit=mem_limit, opt_words=opt_words)
        for p, d in zip(path, res.dists):
            fixed.setdefault(p, d)
        # de-prioritize the fixed path so the next longest path is found
        for u, v in zip(path, path[1:]):
            if g.has_edge(u, v):
                g[u][v]["w"] = 0.0
    return fixed


# ---------------------------------------------------------------------------
# global search (beyond-paper: Jia et al. 1802.04924): reshard-cost-aware
# beam DP over the whole DAG, and a stochastic hill-climbing baseline
# ---------------------------------------------------------------------------

def solve_dag_beam(m: Machine, graph: dag.DiGraph,
                   mesh_shape: Mapping[str, int],
                   candidate_fn: Callable[[ConvLayer], Sequence[Dist]],
                   table: EmpiricalTable | None = None,
                   overlap: bool = True,
                   mem_limit: float | None = None,
                   opt_words: float = 1.0,
                   width: int = 4) -> dict[str, Dist]:
    """Global beam-searched DP over the *whole* DAG in topological order.

    Unlike longest-path-first (solve_dag), which zeroes already-fixed path
    edges and so never re-prices the cross edges between paths, every beam
    state here carries a full partial assignment and each extension pays the
    shuffle cost on *every* incoming DAG edge.  `width` beam states survive
    per layer; width -> inf is the exact (exponential) DP.

    Returns {layer name: Dist}.
    """
    if not dag.is_dag(graph):
        raise ValueError("solve_dag_beam needs an acyclic graph")
    order = dag.topological_sort(graph)
    pos = {name: i for i, name in enumerate(order)}
    layers = [graph.nodes[p]["layer"] for p in order]
    cands: list[list[Dist]] = []
    for lay in layers:
        cs = list(candidate_fn(lay))
        if mem_limit:
            cs = prune_by_memory(m, lay, cs, mesh_shape, mem_limit,
                                 opt_words)
        cands.append(cs)
    lcost = [[layer_cost(m, layers[i], d, mesh_shape, table, overlap).total
              for d in cands[i]] for i in range(len(order))]
    preds = [[pos[u] for u in graph.predecessors(p)] for p in order]

    # beam state: (cost, (dist index per already-placed layer, ...))
    beam: list[tuple[float, tuple[int, ...]]] = [(0.0, ())]
    for i in range(len(order)):
        nxt = []
        for cost, picks in beam:
            for j, dj in enumerate(cands[i]):
                w = cost + lcost[i][j]
                for u in preds[i]:
                    w += shuffle_time(m, layers[u], cands[u][picks[u]], dj,
                                      mesh_shape, table)
                nxt.append((w, picks + (j,)))
        nxt.sort(key=lambda s: s[0])
        beam = nxt[:max(width, 1)]
    _, picks = beam[0]
    return {order[i]: cands[i][picks[i]] for i in range(len(order))}


def solve_hillclimb(m: Machine, layers: Sequence[ConvLayer],
                    candidates: Sequence[Sequence[Dist]],
                    mesh_shape: Mapping[str, int],
                    table: EmpiricalTable | None = None,
                    overlap: bool = True,
                    edges: Sequence[tuple[int, int]] | None = None,
                    seed: int = 0,
                    iters: int = 400,
                    restarts: int = 4,
                    mem_limit: float | None = None,
                    opt_words: float = 1.0) -> StrategyResult:
    """Stochastic local-search baseline (the rebuilt benchmarks/hillclimb):
    random restarts + single-layer moves accepted when they lower the total
    predicted cost.  `edges` are (i, j) index pairs that pay Shuffle(D_i,
    D_j) on ℓ_i's output; None means the line network's consecutive pairs.
    Deterministic under `seed`.
    """
    import random
    n = len(layers)
    assert n and all(candidates), "every layer needs >= 1 candidate"
    if mem_limit:
        candidates = [prune_by_memory(m, layers[i], candidates[i],
                                      mesh_shape, mem_limit, opt_words)
                      for i in range(n)]
    if edges is None:
        edges = [(i, i + 1) for i in range(n - 1)]
    touching = [[] for _ in range(n)]
    for e in edges:
        touching[e[0]].append(e)
        touching[e[1]].append(e)
    lcost = [[layer_cost(m, layers[i], d, mesh_shape, table, overlap).total
              for d in candidates[i]] for i in range(n)]
    shuf_memo: dict[tuple, float] = {}

    def edge_cost(picks, e):
        i, j = e
        key = (i, j, picks[i], picks[j])
        t = shuf_memo.get(key)
        if t is None:
            t = shuffle_time(m, layers[i], candidates[i][picks[i]],
                             candidates[j][picks[j]], mesh_shape, table)
            shuf_memo[key] = t
        return t

    def total(picks):
        return sum(lcost[i][picks[i]] for i in range(n)) + \
            sum(edge_cost(picks, e) for e in edges)

    rng = random.Random(seed)
    best_picks, best_cost = None, float("inf")
    for _ in range(max(restarts, 1)):
        picks = [rng.randrange(len(candidates[i])) for i in range(n)]
        cost = total(picks)
        for _ in range(iters):
            i = rng.randrange(n)
            if len(candidates[i]) < 2:
                continue
            j = rng.randrange(len(candidates[i]))
            if j == picks[i]:
                continue
            old = picks[i]
            delta = lcost[i][j] - lcost[i][old]
            before = sum(edge_cost(picks, e) for e in touching[i])
            picks[i] = j
            after = sum(edge_cost(picks, e) for e in touching[i])
            delta += after - before
            if delta < 0:
                cost += delta
            else:
                picks[i] = old
        if cost < best_cost:
            best_cost, best_picks = cost, list(picks)
    return StrategyResult([candidates[i][best_picks[i]] for i in range(n)],
                          best_cost)


def parse_search(spec: str) -> tuple[str, int]:
    """'greedy' | 'beam[:N]' | 'hillclimb' -> (mode, beam width)."""
    s = (spec or "greedy").strip().lower()
    if s == "greedy":
        return "greedy", 0
    if s == "hillclimb":
        return "hillclimb", 0
    if s == "beam":
        return "beam", 4
    if s.startswith("beam:"):
        try:
            w = int(s.split(":", 1)[1])
        except ValueError:
            raise ValueError(f"bad beam width in --search {spec!r}")
        if w < 1:
            raise ValueError(f"beam width must be >= 1, got {w}")
        return "beam", w
    raise ValueError(
        f"unknown search mode {spec!r} (expected greedy, beam[:N] or "
        f"hillclimb)")
