"""A small directed graph for the branchy-network solve (paper §V-C), in
place of the reference's networkx.DiGraph.

Only what `models.cnn.resnet.resnet_graph`, `core.strategy.solve_dag` /
`solve_dag_beam` and `core.plan.plan_graph` use: nodes with attributes,
edges with attributes, predecessors and successors, a copy, and three
algorithms written as networkx 3.x writes them, so that they visit and
break ties in the same order:

  * `topological_sort`: Kahn's generations, the first in node-insertion
    order, each later one in the order its nodes reach in-degree 0 (a
    parent's children in edge-insertion order);
  * `dag_longest_path(g, weight)`: in that order each node keeps its
    first predecessor of greatest distance; the path ends on the first
    node of greatest distance and is walked back from there;
  * `is_dag`.

Ties are the rule in the solve, not the exception: `solve_dag` zeroes the
weights of every path it fixes, so another order picks another path and
solves another plan.
"""
from __future__ import annotations

from typing import Any, Hashable, Iterator


class DiGraph:
    """Nodes and edges in insertion order, each with an attribute dict."""

    def __init__(self):
        self.nodes: dict[Hashable, dict[str, Any]] = {}
        self._succ: dict[Hashable, dict[Hashable, dict[str, Any]]] = {}
        self._pred: dict[Hashable, dict[Hashable, dict[str, Any]]] = {}

    def add_node(self, n: Hashable, **attr) -> None:
        if n not in self.nodes:
            self.nodes[n] = {}
            self._succ[n] = {}
            self._pred[n] = {}
        self.nodes[n].update(attr)

    def add_edge(self, u: Hashable, v: Hashable, **attr) -> None:
        """The edge u -> v (its nodes added where new); an edge that exists
        keeps its place and takes the new attributes."""
        self.add_node(u)
        self.add_node(v)
        data = self._succ[u].get(v)
        if data is None:
            data = self._succ[u][v] = self._pred[v][u] = {}
        data.update(attr)

    def has_edge(self, u: Hashable, v: Hashable) -> bool:
        return u in self._succ and v in self._succ[u]

    def __getitem__(self, u: Hashable) -> dict[Hashable, dict[str, Any]]:
        """`g[u][v]` is the attribute dict of the edge u -> v."""
        return self._succ[u]

    def __contains__(self, n: Hashable) -> bool:
        return n in self.nodes

    def __len__(self) -> int:
        return len(self.nodes)

    def number_of_nodes(self) -> int:
        return len(self.nodes)

    @property
    def edges(self) -> list[tuple[Hashable, Hashable]]:
        """(u, v) for u in node order, v in the order u's edges were
        added, as networkx lists them."""
        return [(u, v) for u, nbrs in self._succ.items() for v in nbrs]

    def successors(self, n: Hashable) -> Iterator[Hashable]:
        return iter(self._succ[n])

    def predecessors(self, n: Hashable) -> Iterator[Hashable]:
        """In the order the edges into `n` were added."""
        return iter(self._pred[n])

    def copy(self) -> "DiGraph":
        """A graph of the same nodes and edges in the same order, with
        copies of their attribute dicts."""
        g = DiGraph()
        for n, attr in self.nodes.items():
            g.add_node(n, **attr)
        for u, v in self.edges:
            g.add_edge(u, v, **self._succ[u][v])
        return g


class CycleError(ValueError):
    """The graph has a cycle, so it has no topological order."""


def topological_sort(g: DiGraph) -> list[Hashable]:
    """networkx's `topological_sort` order (its `topological_generations`
    flattened); raises CycleError on a cycle."""
    indegree = {v: len(g._pred[v]) for v in g.nodes if g._pred[v]}
    gen = [v for v in g.nodes if not g._pred[v]]
    order: list[Hashable] = []
    while gen:
        nxt = []
        for u in gen:
            for child in g._succ[u]:
                indegree[child] -= 1
                if indegree[child] == 0:
                    nxt.append(child)
                    del indegree[child]
        order.extend(gen)
        gen = nxt
    if indegree:
        raise CycleError("the graph has a cycle")
    return order


def is_dag(g: DiGraph) -> bool:
    try:
        topological_sort(g)
    except CycleError:
        return False
    return True


def dag_longest_path(g: DiGraph, weight: str = "weight",
                     default_weight: float = 1) -> list[Hashable]:
    """The nodes of a path of greatest total edge `weight`, as networkx's
    `dag_longest_path` finds it (the same path among equal ones)."""
    if not g.nodes:
        return []
    dist: dict[Hashable, tuple[float, Hashable]] = {}
    for v in topological_sort(g):
        us = [(dist[u][0] + data.get(weight, default_weight), u)
              for u, data in g._pred[v].items()]
        best = max(us, key=lambda t: t[0]) if us else (0, v)
        dist[v] = best if best[0] >= 0 else (0, v)
    u, v = None, max(dist, key=lambda n: dist[n][0])
    path = []
    while u != v:
        path.append(v)
        u, v = v, dist[v][1]
    path.reverse()
    return path
