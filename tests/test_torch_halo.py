"""The port's mesh and halo exchange (`launch/mesh.py`, `core/halo.py`) on
gloo CPU ranks, against slicing the global tensor.

Each mesh runs once, in a subprocess of 2 or 4 ranks
(`torch_dist_cases.run`); every test then checks one case of its blocks.
The halo rows are copies and their gradients sums of the cotangents that
cover a row, so both are held exactly (equal arrays); a product axis
(data, model) crosses the data boundary major-to-minor.
"""
import numpy as np
import pytest

import torch_dist_cases as cases
from repro.launch import mesh as jmesh
from repro_torch.core import halo
from repro_torch.launch import mesh as tmesh

MESHES = [(1, 2), (2, 2)]


@pytest.fixture(scope="module", params=MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
def halo_run(request, tmp_path_factory):
    dims = request.param
    return dims, cases.run("halo", dims, str(tmp_path_factory.mktemp("h")))


def _group(rank, dims, axis):
    """The ranks sharing rank's coordinates off `axis`, by shard index."""
    axes = cases.axes_of(axis)
    c = cases.coords(rank, dims)
    members = [r for r in range(dims[0] * dims[1])
               if all(cases.coords(r, dims)[a] == c[a]
                      for a in cases.AXES if a not in axes)]
    return sorted(members, key=lambda r: cases.shard(r, dims, axis)[0])


@pytest.mark.parametrize("name,axis,dim,lo,hi,edge", cases.HALO_CASES,
                         ids=[c[0] for c in cases.HALO_CASES])
def test_halo_rows_and_grads_match_global_slices(halo_run, name, axis, dim,
                                                 lo, hi, edge):
    dims, outs = halo_run
    x = cases.halo_input()
    pad = [(0, 0)] * 4
    pad[dim] = (lo, hi)
    xp = np.pad(x, pad, constant_values=edge)
    for r in range(dims[0] * dims[1]):
        i, n = cases.shard(r, dims, axis)
        m = x.shape[dim] // n
        want = np.take(xp, range(i * m, i * m + m + lo + hi), axis=dim)
        np.testing.assert_array_equal(outs[r][f"{name}/ext"], want)
        # dx: every cotangent of r's group scattered onto the padded rows
        acc = np.zeros_like(xp)
        for q in _group(r, dims, axis):
            j = cases.shard(q, dims, axis)[0]
            sl = [slice(None)] * 4
            sl[dim] = slice(j * m, j * m + m + lo + hi)
            acc[tuple(sl)] += cases.halo_cotangent(
                name, q, outs[q][f"{name}/ext"].shape)
        inner = np.take(acc, range(lo, lo + x.shape[dim]), axis=dim)
        want_dx = np.take(inner, range(i * m, (i + 1) * m), axis=dim)
        np.testing.assert_allclose(outs[r][f"{name}/dx"], want_dx,
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("axis", ["model", ("data", "model")],
                         ids=["model", "prod"])
@pytest.mark.parametrize("reverse", [False, True])
def test_ring_shift_both_ways(halo_run, axis, reverse):
    dims, outs = halo_run
    key = f"ring_{'prod' if isinstance(axis, tuple) else 'model'}_{reverse}"
    step = -1 if reverse else 1
    for r in range(dims[0] * dims[1]):
        grp = _group(r, dims, axis)
        i, n = cases.shard(r, dims, axis)
        src, dst = grp[(i - step) % n], grp[(i + step) % n]
        np.testing.assert_array_equal(outs[r][f"{key}/y"],
                                      np.full((2, 3), float(src)))
        np.testing.assert_array_equal(outs[r][f"{key}/dx"],
                                      np.full((2, 3), 1.0 + dst))


def test_mesh_index_on_the_ranks(halo_run):
    dims, outs = halo_run
    for r in range(dims[0] * dims[1]):
        assert int(outs[r]["index_model"]) == cases.shard(r, dims, "model")[0]
        assert int(outs[r]["index_prod"]) == \
            cases.shard(r, dims, ("data", "model"))[0]


@pytest.mark.parametrize("dims", [(2, 4), (4, 2), (1, 8), (2, 1)])
def test_mesh_layout_linearizes_major_to_minor(dims):
    for r in range(dims[0] * dims[1]):
        m = tmesh.Mesh({"data": dims[0], "model": dims[1]}, rank=r)
        assert m.coords == cases.coords(r, dims)
        for axis in ("data", "model", ("data", "model"), ("model", "data")):
            i, n = cases.shard(r, dims, axis)
            assert m.index(axis) == i and m.axis_size(axis) == n
            grp = m.ranks(axis)
            assert len(grp) == n and grp[i] == r
            assert [cases.shard(q, dims, axis)[0] for q in grp] == \
                list(range(n))


def test_mesh_helpers_match_reference():
    for n in (1, 2, 3, 4, 6, 8, 12, 16):
        for batch in (None, 1, 2, 4, 8):
            assert tmesh.elastic_factorization(n, batch=batch) == \
                jmesh.elastic_factorization(n, batch=batch)
    m = tmesh.Mesh({"pod": 2, "data": 2, "model": 2}, rank=5)
    assert tmesh.batch_axes(m) == ("pod", "data")
    assert tmesh.model_axis_size(m) == 2
    assert m.index(("pod", "data")) == 2 and m.coords == {
        "pod": 1, "data": 0, "model": 1}
    assert tmesh.batch_axes(None) == () and tmesh.model_axis_size(None) == 1
    assert halo.product_size(("data", "model"), {"data": 2, "model": 4}) == 8
    assert halo.axes_tuple(None) == () and halo.axes_tuple("m") == ("m",)
    with pytest.raises(ValueError, match="outside"):
        tmesh.Mesh({"data": 2, "model": 2}, rank=4)


def test_halo_on_one_shard_fills_the_edges():
    import torch
    x = torch.arange(12.0).reshape(1, 3, 4, 1).requires_grad_()
    ext = halo.halo_exchange(x, 1, 1, 2, "model", None, float("-inf"))
    assert ext.shape == (1, 6, 4, 1)
    assert torch.isinf(ext[:, 0]).all() and torch.isinf(ext[:, 4:]).all()
    assert torch.equal(ext[:, 1:4], x)
    ext[:, 1:4].sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    assert halo.ring_shift(x, "model", None) is x
