"""ZeRO-1 over ("data", "model") in the port's train step, on 4 gloo CPU
ranks (data 2 x model 2): the step with the optimizer state cut over
both axes (the reference's opt / vpz variants,
`launch.shardings.zero1_spec`) against the step with it cut over "data"
alone, from the same params and batch, and the opt variant's blocks
(the vocabulary and the experts each rank's block over "model",
`shardings.leaf_roles`) on top of it; and the three on 4 ranks of pod
2 x data 1 x model 2 under int8_ef, the pod exchange compressing each
pod's blocks.

    python tests/torch_dist_cases.py zero1 2,2 DIR
    python tests/torch_dist_cases.py zero1_pod 2,1,2 DIR
"""
import numpy as np
import pytest

import torch_dist_cases as cases

DIMS = (2, 2)
POD_DIMS = (2, 1, 2)                  # (pod, data, model)
# the opt variant's gradient norm under int8_ef against the data run's:
# its vocabulary block rounded once on the pods' sum instead of on each
# pod's share, int8 units of about 1/254 of a leaf's largest element
POD_NORM_RTOL = 1e-3
# the updated params of the two ZeRO layouts: the same sums in another
# order (one reduce-scatter over both axes against one over data and a
# psum over model), through AdamW's normalised update
PARAM_TOL = 1e-6
# the opt variant's: the vocab-parallel cross entropy and the experts'
# all-to-alls sum in other orders still
OPT_TOL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return cases.run("zero1", DIMS, str(tmp_path_factory.mktemp("zero1")))


@pytest.fixture(scope="module")
def pod_ranks(tmp_path_factory):
    return cases.run("zero1_pod", POD_DIMS,
                     str(tmp_path_factory.mktemp("zero1_pod")))


def _params(r: dict, name: str) -> list:
    n = sum(k.startswith(f"{name}.param.") for k in r)
    return [r[f"{name}.param.{i}"] for i in range(n)]


@pytest.mark.parametrize("name,tol", [("zero1", PARAM_TOL),
                                      ("opt", OPT_TOL)])
def test_step_against_zero_over_data(ranks, name, tol):
    want = ranks[0]
    for r in ranks:
        got = r[f"{name}.losses"]
        assert got[0] == want["data.losses"][0]
        np.testing.assert_allclose(got, want["data.losses"], rtol=1e-6)
        for a, b in zip(_params(r, name), _params(want, "data")):
            assert a.shape == b.shape
            assert float(np.abs(a - b).max()) <= tol


@pytest.mark.parametrize("name", ["data", "zero1", "opt"])
def test_every_rank_holds_the_same_params(ranks, name):
    for r in ranks[1:]:
        for a, b in zip(_params(r, name), _params(ranks[0], name)):
            np.testing.assert_array_equal(a, b)


def test_moments_a_rank(ranks):
    """ZeRO-1 cuts the leaves that "data" alone leaves whole or cuts in
    two: fewer moment elements a rank."""
    r = ranks[0]
    assert int(r["zero1.moments"]) < int(r["data.moments"])
    assert int(r["opt.moments"]) < int(r["data.moments"])


def test_pod_compression_zero1_against_zero_over_data(pod_ranks):
    """ZeRO-1 under int8_ef: its blocks cut over model, their int8 scale
    the maximum over model, the same rounding as the whole leaves that
    ZeRO over one data rank keeps."""
    want = pod_ranks[0]
    for r in pod_ranks:
        assert r["zero1.losses"][0] == want["data.losses"][0]
        np.testing.assert_allclose(r["zero1.grad_norms"],
                                   want["data.grad_norms"], rtol=1e-6)
        for a, b in zip(_params(r, "zero1"), _params(want, "data")):
            assert float(np.abs(a - b).max()) <= PARAM_TOL
    assert int(want["zero1.moments"]) < int(want["data.moments"])


def test_pod_compression_opt_blocks(pod_ranks):
    """The opt variant under int8_ef.  Its expert blocks and whole leaves
    round each pod's share as ZeRO over data does.  Its vocabulary block
    arrives summed over the pods and is rounded as it is (the reference's
    rounding of a gradient summed over every axis), so the tied table
    differs from the data run by rounding: a first AdamW step moves an
    element by at most the learning rate, and the two differ by at most
    twice it.  The gradient norms agree to the int8 rounding (POD_NORM_RTOL;
    a vocabulary block scaled by the pod count a second time would put
    them 37 % apart)."""
    from repro_torch.configs import registry
    from repro_torch.launch import shardings
    from repro_torch.models.lm import transformer
    import torch
    cfg = registry.get(cases.ZERO1_ARCH, smoke=True)
    roles = shardings.leaf_roles(
        transformer.init(torch.Generator().manual_seed(0), cfg,
                         device="cpu"), vocab=True, experts=True)
    assert "vocab" in roles and "expert" in roles
    want = pod_ranks[0]
    for r in pod_ranks:
        assert r["opt.losses"][0] == want["data.losses"][0]
        np.testing.assert_allclose(r["opt.grad_norms"],
                                   want["data.grad_norms"],
                                   rtol=POD_NORM_RTOL)
        for a, b, role in zip(_params(r, "opt"), _params(want, "data"),
                              roles):
            assert a.shape == b.shape
            tol = 2 * cases.ZERO1_LR if role == "vocab" else OPT_TOL
            assert float(np.abs(a - b).max()) <= tol, role
    for name in ("data", "zero1", "opt"):
        for r in pod_ranks[1:]:
            for a, b in zip(_params(r, name), _params(want, name)):
                np.testing.assert_array_equal(a, b)
