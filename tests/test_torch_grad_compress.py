"""The port's cross-pod gradient compression (`optim/grad_compress.py`)
against the reference's (`repro.optim.grad_compress`).

- `_quantize_int8` / `_dequantize` bit for bit on seeded inputs (a zero
  tensor among them: the 1e-12 floor of the scale).
- `cross_pod_mean` on 2 gloo pod ranks (`torch_dist_cases.py compress`)
  with the same tree on both pods, against the reference's on a pod-2
  mesh of host devices (`jax_mesh_oracles.py compress`): none, bf16, and
  int8_ef over 3 steps with the residual carried: each step's mean bit
  for bit, the residual (the reference's is (npods, ...), a pod's row is
  the port rank's) within one ulp of |x + e| a step, since XLA fuses the
  reference's x - q * scale into one multiply-add.
- Each pod's own tree against a numpy emulation of the documented mean:
  fp32 sum / npods; the bf16-rounded payloads summed in fp32 / npods; the
  int8 payloads dequantized with each pod's scale and averaged, the
  residual x + e - dequant(q).
- tests/dist_checks.py check_compress's assertions on the port.
- No pod axis: the tree and the residual come back unchanged.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_mesh_oracles
import torch_dist_cases as cases
from repro.optim import grad_compress as jgc
from repro_torch.launch.mesh import Mesh
from repro_torch.optim import grad_compress as tgc

POD = (2, 1, 1)          # (pod, data, model)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    dp, dr = (tmp_path_factory.mktemp(n) for n in ("port", "ref"))
    p = cases.start("compress", POD, str(dp))
    r = jax_mesh_oracles.popen("compress", str(dr))
    ranks = cases.collect(p, POD, str(dp))
    jax_mesh_oracles.wait(r)
    return ranks, dict(np.load(dr / "compress.npz"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_bit_for_bit(seed):
    g = np.random.default_rng(seed)
    xs = [g.standard_normal((33, 7)).astype(np.float32) * 10 ** seed,
          np.zeros((5,), np.float32),
          (g.standard_normal(64) * 1e-30).astype(np.float32)]
    for x in xs:
        jq, js = jgc._quantize_int8(jnp.asarray(x))
        tq, ts = tgc._quantize_int8(torch.from_numpy(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            tgc._dequantize(tq, ts).numpy(),
            np.asarray(jgc._dequantize(jq, js)))


def _keys(tag, method):
    steps = cases.COMPRESS_STEPS if method == "int8_ef" else 1
    return [f"{tag}/{method}/{t}/{k}" for t in range(steps)
            for k in sorted(cases.COMPRESS_SHAPES)]


@pytest.mark.parametrize("method", cases.COMPRESS_METHODS)
def test_same_tree_on_both_pods_matches_the_reference(runs, method):
    ranks, ref = runs
    g = cases.compress_inputs()
    for pod, rank in enumerate(ranks):
        for key in _keys("same", method):
            np.testing.assert_array_equal(rank[key], ref[key], err_msg=key)
            if method == "int8_ef":
                head, leaf = key.rsplit("/", 1)
                ef = f"{head}/ef/{leaf}"
                # the reference's x32 - q * scale is one fused multiply-add
                # on XLA's CPU, the port's two roundings: one ulp of |x32|
                # a step, carried in the residual (the means stay equal)
                t = int(head.split("/")[2])
                x32 = np.abs(g[leaf]).max() + np.abs(ref[ef][pod]).max()
                np.testing.assert_allclose(
                    rank[ef], ref[ef][pod], rtol=0,
                    atol=(t + 1) * np.spacing(np.float32(x32)), err_msg=ef)


def _emulate(method, pods, steps):
    """The documented mean of each pod's tree over `steps` steps: each
    step's mean, each pod's residual."""
    out, ef = [], [{k: np.zeros_like(v) for k, v in g.items()}
                   for g in pods]
    for _ in range(steps):
        red, new = {}, []
        for k in pods[0]:
            xs = [g[k].astype(np.float32) for g in pods]
            if method == "none":
                red[k] = (xs[0] + xs[1]) / np.float32(2)
            elif method == "bf16":
                bf = [torch.from_numpy(x).bfloat16().float().numpy()
                      for x in xs]
                red[k] = (bf[0] + bf[1]) / np.float32(2)
            else:
                deq = []
                for x, e in zip(xs, ef):
                    x32 = x + e[k]
                    s = np.maximum(np.abs(x32).max(), np.float32(1e-12)) \
                        / np.float32(127)
                    q = np.clip(np.round(x32 / s), -127, 127)
                    deq.append(q.astype(np.float32) * s)
                    e[k] = x32 - deq[-1]
                red[k] = (deq[0] + deq[1]) / np.float32(2)
        out.append(red)
    return out, ef


@pytest.mark.parametrize("method", cases.COMPRESS_METHODS)
def test_own_tree_per_pod_matches_the_emulation(runs, method):
    ranks, _ = runs
    steps = cases.COMPRESS_STEPS if method == "int8_ef" else 1
    pods = [cases.compress_inputs(p) for p in range(2)]
    want, ef = _emulate(method, pods, steps)
    for pod, rank in enumerate(ranks):
        for t in range(steps):
            for k in cases.COMPRESS_SHAPES:
                np.testing.assert_allclose(
                    rank[f"diff/{method}/{t}/{k}"], want[t][k], rtol=1e-6,
                    atol=1e-7, err_msg=f"{method} step {t} {k}")
        if method == "int8_ef":
            for k in cases.COMPRESS_SHAPES:
                np.testing.assert_allclose(
                    rank[f"diff/int8_ef/{steps - 1}/ef/{k}"], ef[pod][k],
                    rtol=1e-6, atol=1e-7)
    # every pod ends with the same mean, bit for bit
    for key in _keys("diff", method):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])


def test_check_compress_assertions_on_the_port(runs):
    """tests/dist_checks.py check_compress, on the port's results: the
    same tree on every pod comes back from none as it was, from bf16
    within bf16's rounding, and int8 + EF carries its error: two steps'
    mean is no further from the tree than one step, which is close."""
    ranks, _ = runs
    g = cases.compress_inputs()
    for rank in ranks:
        np.testing.assert_allclose(rank["same/none/0/a"], g["a"],
                                   rtol=1e-6)
        np.testing.assert_allclose(rank["same/bf16/0/a"], g["a"],
                                   rtol=2e-2, atol=2e-2)
        out1, out2 = rank["same/int8_ef/0/a"], rank["same/int8_ef/1/a"]
        err1 = float(np.abs(out1 - g["a"]).mean())
        err2 = float(np.abs((out1 + out2) / 2 - g["a"]).mean())
        assert err2 < err1 + 1e-7, (err1, err2)
        assert err1 < 0.05


def test_no_pod_axis_returns_the_tree_unchanged():
    g = {"a": torch.ones(3)}
    mesh = Mesh({"data": 2, "model": 1}, rank=0)
    for method in cases.COMPRESS_METHODS:
        out, ef = tgc.cross_pod_mean(g, mesh=mesh, method=method,
                                     error_feedback="state")
        assert out is g and ef == "state"
    assert tgc.cross_pod_mean(g, mesh=None)[0] is g
    assert tgc.init_error_feedback([g["a"]], mesh, "int8_ef") is None
