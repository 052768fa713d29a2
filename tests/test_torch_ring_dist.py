"""Ring attention and the sequence-parallel state prefix on gloo CPU
ranks (`torch_dist_cases.py` cases `ring` and `prefix`) against the JAX
reference.

- `core.ring_attention.ring_attention` with S over `model` on model 2,
  model 4 and data 2 x model 2 (B over data), in the four cases of
  `tests/dist_checks.py` check_attention (causal; window 7;
  bidirectional; window 12 with softcap 30) at B 2, S 32, 8 / 4 heads,
  D 16: every rank's output block against the reference's one-shard
  `ring_attention` at 2e-5 (dist_checks' tolerance: the partial softmaxes
  merge in another order), and its q, k and v gradient blocks of sum(o *
  g) against `jax.grad` of the one-shard reference at rtol 1e-4 / atol
  1e-5 (each K/V block's gradient comes home through the ring's
  backward).  Each rank makes as many block calls as the ring derives:
  under causality the blocks of later shards are skipped, under a window
  the ring stops after 1 + ceil((window - 1) / S_local) steps.
- `core.seq_ssm.seq_prefix_state` over 2, 3 and 4 shards against the
  sequential recurrence in float64, forward and the gradients of
  sum(s_in * g) in the decays and states, at 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from repro.core import ring_attention as jra
from repro_torch.core import ring_attention as tra

OUT_TOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
PREFIX_TOL = 1e-5


RUNS = [("ring", (1, 2)), ("ring", (1, 4)), ("ring", (2, 2)),
        ("prefix", (1, 3))]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every RUNS entry's ranks, started at once: `run(case, dims)`."""
    started = {}
    for case, dims in RUNS:
        d = str(tmp_path_factory.mktemp(f"{case}_{dims[0]}x{dims[1]}"))
        started[case, dims] = (cases.start(case, dims, d), d)
    done = {key: cases.collect(p, key[1], d)
            for key, (p, d) in started.items()}
    return lambda case, dims: done[case, dims]


@functools.lru_cache(maxsize=None)
def _reference(ci: int):
    """The one-shard reference's output and its q, k, v gradients of
    sum(o * g) in RING_CASES row `ci`."""
    causal, window, cap = cases.RING_CASES[ci]
    x = cases.ring_inputs()

    def ref(q, k, v):
        return jra.ring_attention(q, k, v, mesh=None, seq_axis=None,
                                  causal=causal, window=window, softcap=cap)
    o, vjp = jax.vjp(jax.jit(ref), *(jnp.asarray(x[n]) for n in "qkv"))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(x["g"]))]


def _stitch(blocks: list, dims: tuple) -> np.ndarray:
    """The global (B, S, ...) array from each rank's block (B over data,
    S over model)."""
    b, s = blocks[0].shape[:2]
    out = np.full((b * dims[0], s * dims[1]) + blocks[0].shape[2:], np.nan,
                  np.float32)
    for r, blk in enumerate(blocks):
        bi, si = cases.shard(r, dims, ("data",))[0], \
            cases.shard(r, dims, "model")[0]
        out[bi * b:(bi + 1) * b, si * s:(si + 1) * s] = blk
    assert not np.isnan(out).any()
    return out


def _blocks_wanted(rank: int, dims: tuple, causal: bool, window) -> int:
    """The block calls the ring makes on `rank`."""
    n, idx = dims[1], cases.shard(rank, dims, "model")[0]
    steps = tra.ring_steps(n, cases.RING_SHAPE[1] // n, window)
    return min(idx + 1, steps) if causal else steps


@pytest.mark.parametrize("dims", [(1, 2), (1, 4), (2, 2)])
def test_ring_attention_matches_jax(dims, run):
    ranks = run("ring", dims)
    for ci, (causal, window, cap) in enumerate(cases.RING_CASES):
        want, grads = _reference(ci)
        np.testing.assert_allclose(
            _stitch([r[f"ring.{ci}.o"] for r in ranks], dims), want,
            rtol=OUT_TOL, atol=OUT_TOL, err_msg=str(ci))
        for name, g in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(
                _stitch([r[f"ring.{ci}.{name}"] for r in ranks], dims), g,
                rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=f"{ci} {name}")
        assert [int(r[f"ring.{ci}.blocks"]) for r in ranks] == \
            [_blocks_wanted(r, dims, causal, window)
             for r in range(len(ranks))], ci


def _recurrence(x: dict):
    """The incoming state of every shard by the sequential recurrence, in
    float64, and the gradients of sum(s_in * g) in a and s."""
    a = torch.from_numpy(x["a"]).double().requires_grad_()
    s = torch.from_numpy(x["s"]).double().requires_grad_()
    st, outs = torch.zeros_like(s[0]), []
    for i in range(a.shape[0]):
        outs.append(st)
        st = st * a[i] + s[i]
    s_in = torch.stack(outs)
    (s_in * torch.from_numpy(x["g"]).double()).sum().backward()
    return s_in.detach().numpy(), a.grad.numpy(), s.grad.numpy()


@pytest.mark.parametrize("n", [2, 3, 4])
def test_seq_prefix_state_matches_the_recurrence(n, run):
    ranks = run("ring", (1, n)) if n in (2, 4) else run("prefix", (1, n))
    want = _recurrence(cases.prefix_inputs(n))
    for name, w in zip(("s_in", "da", "ds"), want):
        got = np.stack([r[f"prefix.{name}"] for r in ranks])
        np.testing.assert_allclose(got, w, rtol=PREFIX_TOL, atol=PREFIX_TOL,
                                   err_msg=name)


def test_seq_prefix_state_over_data_rows(run):
    """On data 2 x model 2 each data row runs its own prefix over model."""
    ranks = run("ring", (2, 2))
    want = _recurrence(cases.prefix_inputs(2))[0]
    for r, x in enumerate(ranks):
        np.testing.assert_allclose(x["prefix.s_in"],
                                   want[cases.shard(r, (2, 2), "model")[0]],
                                   rtol=PREFIX_TOL, atol=PREFIX_TOL)


def test_ring_refuses_a_tuple_of_axes():
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="one mesh axis"):
        tra.ring_attention(q, q, q, seq_axis=("data", "model"))


@pytest.mark.parametrize("n,sl,window,want", [
    (4, 8, None, 4), (4, 8, 7, 2), (4, 8, 12, 3), (4, 8, 8, 2), (4, 8, 9, 2),
    (4, 8, 10, 3), (2, 1024, 1024, 2), (8, 16, 1, 1), (3, 4, 100, 3)])
def test_ring_steps_match_the_reference(n, sl, window, want):
    """The reference's n_steps: min(P, 1 + cdiv(max(window - 1, 0),
    S_local))."""
    ref = n if window is None else min(n, 1 + -(-max(window - 1, 0) // sl))
    assert tra.ring_steps(n, sl, window) == ref == want
