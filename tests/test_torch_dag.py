"""The port's DAG (`core/dag.py`) against networkx, and the port's
`resnet_graph` against the reference's.

`core/dag.py` stands in for networkx in `repro_torch` (the card's machine
has no networkx).  On hypothesis-drawn DAGs whose edge weights are drawn
from a few values, so that ties are common (as they are in `solve_dag`,
which zeroes every fixed path's weights), its `topological_sort` and
`dag_longest_path` equal networkx's as lists, and its edge and
predecessor orders are networkx's.  `is_dag` agrees with networkx on
graphs with cycles too.

`resnet_graph` of RESNET50, the reference's SMOKE config and a
`stages=(1, 1), widths=(8, 16)` tiny config, at batches 1 and 32: the same
nodes in the same order, the same edges in the same order, the same
predecessors, and the same ConvLayer on every node.
"""
import dataclasses

import networkx as nx
import pytest

from _hyp import given, settings, st
from repro.configs import resnet50 as jcfgs
from repro.models.cnn import resnet as jres
from repro_torch.configs import resnet50 as tcfgs
from repro_torch.core import dag
from repro_torch.models.cnn import resnet as tres


def _pair(n_nodes, edges, weights, names):
    """The same graph in both packages, nodes and edges added in one
    order (some nodes only through their edges, as networkx allows)."""
    g, h = nx.DiGraph(), dag.DiGraph()
    for i in range(0, n_nodes, 2):
        g.add_node(names[i], tag=i)
        h.add_node(names[i], tag=i)
    for (u, v), w in zip(edges, weights):
        g.add_edge(names[u], names[v], w=w)
        h.add_edge(names[u], names[v], w=w)
    for i in range(1, n_nodes, 2):
        g.add_node(names[i], tag=i)
        h.add_node(names[i], tag=i)
    return g, h


@st.composite
def dags(draw, acyclic=True):
    n = draw(st.integers(1, 12))
    pairs = [(u, v) for u in range(n) for v in range(n)
             if (u < v if acyclic else u != v)]
    edges = draw(st.lists(st.sampled_from(pairs), max_size=30,
                          unique=True)) if pairs else []
    weights = draw(st.lists(st.sampled_from([0.0, 0.0, 1.0, 2.0, 2.0, 5.0]),
                            min_size=len(edges), max_size=len(edges)))
    # node names in a drawn order, so insertion order is not index order
    names = draw(st.permutations([f"n{i}" for i in range(n)]))
    return n, edges, weights, names


@settings(max_examples=300, deadline=None)
@given(dags())
def test_sort_and_longest_path_equal_networkx(case):
    g, h = _pair(*case)
    assert list(h.nodes) == list(g.nodes)
    assert h.edges == list(g.edges)
    for v in g.nodes:
        assert list(h.predecessors(v)) == list(g.predecessors(v))
        assert list(h.successors(v)) == list(g.successors(v))
    assert dag.topological_sort(h) == list(nx.topological_sort(g))
    assert dag.dag_longest_path(h, weight="w") == \
        nx.dag_longest_path(g, weight="w")
    assert dag.dag_longest_path(h) == nx.dag_longest_path(g)
    # solve_dag's step: zero the path's weights, take the next longest
    c, d = g.copy(), h.copy()
    for _ in range(3):
        p = nx.dag_longest_path(c, weight="w")
        assert dag.dag_longest_path(d, weight="w") == p
        for u, v in zip(p, p[1:]):
            c[u][v]["w"] = 0.0
            d[u][v]["w"] = 0.0


@settings(max_examples=200, deadline=None)
@given(dags(acyclic=False))
def test_is_dag_equals_networkx(case):
    g, h = _pair(*case)
    assert dag.is_dag(h) == nx.is_directed_acyclic_graph(g)
    if not dag.is_dag(h):
        with pytest.raises(dag.CycleError):
            dag.topological_sort(h)


def test_copy_is_independent_and_edges_keep_their_place():
    h = dag.DiGraph()
    h.add_edge("a", "b", w=1.0)
    h.add_edge("a", "c", w=2.0)
    h.add_edge("a", "b", w=3.0)           # updates, keeps its place
    assert h.edges == [("a", "b"), ("a", "c")] and h["a"]["b"]["w"] == 3.0
    c = h.copy()
    c["a"]["b"]["w"] = 0.0
    assert h["a"]["b"]["w"] == 3.0 and h.has_edge("a", "b")
    assert not h.has_edge("b", "a") and len(h) == h.number_of_nodes() == 3
    assert dag.dag_longest_path(dag.DiGraph()) == []


TINY = {"name": "tiny", "input_hw": 32, "n_classes": 10, "stages": (1, 1),
        "widths": (8, 16)}
CONFIGS = [("resnet50", jres.RESNET50, tres.RESNET50),
           ("smoke", jcfgs.SMOKE, tcfgs.SMOKE),
           ("tiny", jres.ResNetConfig(**TINY), tres.ResNetConfig(**TINY))]


@pytest.mark.parametrize("n", [1, 32])
@pytest.mark.parametrize("name,jcfg,tcfg", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_resnet_graph_equals_the_reference(name, jcfg, tcfg, n):
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    g, h = jres.resnet_graph(n, jcfg), tres.resnet_graph(n, tcfg)
    assert list(h.nodes) == list(g.nodes)
    assert h.edges == list(g.edges)
    for v in g.nodes:
        assert list(h.predecessors(v)) == list(g.predecessors(v))
        assert dataclasses.asdict(h.nodes[v]["layer"]) == \
            dataclasses.asdict(g.nodes[v]["layer"])
    assert [dataclasses.asdict(l) for l in tres.layer_specs(n, tcfg)] == \
        [dataclasses.asdict(l) for l in jres.layer_specs(n, jcfg)]
    assert dag.topological_sort(h) == list(nx.topological_sort(g))
    if name == "resnet50":
        assert len(h) == 54 and sum(v.endswith("branch1") for v in h.nodes) \
            == 4
