"""W-only and H x W spatial decompositions in the port, on a 2 x 2 mesh of
gloo CPU ranks: tests/dist_checks.py `check_spatial2d`'s cases.  Conv
forward and the gradients of sum(y^2) for (K, s) in {(3,1), (3,2), (7,2)},
with and without the §IV-A split, and max / avg pooling, against the JAX
single-device oracles.  Tolerances as there: 2e-5 forward, 3e-4
gradients, 1e-6 pooling.
"""
import pytest

import torch_dist_cases as cases
from test_torch_spatial_conv import check_conv_case, check_pool_case

DIMS = (2, 2)


@pytest.fixture(scope="module")
def run2d(tmp_path_factory):
    return cases.run("spatial2d", DIMS, str(tmp_path_factory.mktemp("s")))


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("k,s", cases.SPATIAL2D_KS)
@pytest.mark.parametrize("name", sorted(cases.SPATIAL2D))
def test_conv_w_and_hw_splits_match_oracle(run2d, name, k, s, overlap):
    check_conv_case(run2d, DIMS, f"{name}_{k}{s}_{overlap}",
                    (k, s, 16, 16, 3, 5), cases.SPATIAL2D[name], n=2)


@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("name", sorted(cases.SPATIAL2D))
def test_pool_w_and_hw_splits_match_oracle(run2d, name, kind):
    x, g = cases.pool_input(n=2, h=16, w=16, c=3)
    check_pool_case(run2d, DIMS, f"{name}_pool_{kind}",
                    cases.SPATIAL2D[name], kind, x, g)
