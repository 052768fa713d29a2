"""The sequence-sharded decode on gloo CPU ranks (`torch_dist_cases.py`
cases `decode` and `serve`) against the JAX reference's one-shard path
and the port's one-rank server.

- `decode_attention` with the KV cache split along S over `model` 2,
  `model` 4, and on data 2 x model 2 over `model` (B over data) and over
  the product axis ("data", "model") with B whole (the reference's
  long_500k layout, `tests/dist_checks.py:115-122`): every rank's output
  block against the reference's `decode_attention` at one shard, at
  2e-5 (dist_checks' tolerance: the partial softmaxes are summed in
  another order); `cache_append` exact, each rank's block of the cache.
- `launch.serve` with `--model 2` and with `--data 2 --model 2`, hymba
  and qwen1.5 SMOKE, a prompt of 20 (past hymba's window of 16) and 6
  generated tokens: the ids equal the one-rank run's, and every step's
  logits, and every entry of the final caches gathered whole on each
  rank (`shardings.gather_caches`), lie within 1e-5 of the largest
  one-rank magnitude (fp32 merges in another order through five blocks
  and 25 steps).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_cases as cases
from repro.core import decode_attention as jda
from repro_torch.launch import serve

ATTN_TOL = 2e-5
SERVE_TOL = 1e-5


def _stitch_rows(blocks: list, dims: tuple, batch_axes) -> np.ndarray:
    """The global (B, ...) array from each rank's block of B (ranks that
    hold the same block must agree)."""
    n = cases.shard(0, dims, batch_axes)[1]
    rows = blocks[0].shape[0]
    out = [None] * n
    for r, b in enumerate(blocks):
        i = cases.shard(r, dims, batch_axes)[0]
        if out[i] is not None:
            np.testing.assert_array_equal(out[i], b)
        out[i] = b
    assert all(o is not None and o.shape[0] == rows for o in out)
    return np.concatenate(out)


def _stitch_cache(blocks: list, dims: tuple, batch_axes, seq_axis
                  ) -> np.ndarray:
    b, s = (blocks[0].shape[0] * cases.shard(0, dims, batch_axes)[1],
            blocks[0].shape[1] * cases.shard(0, dims, seq_axis)[1])
    out = np.full((b, s) + blocks[0].shape[2:], np.nan, np.float32)
    for r, blk in enumerate(blocks):
        bi, si = cases.shard(r, dims, batch_axes)[0], \
            cases.shard(r, dims, seq_axis)[0]
        sl = (slice(bi * blk.shape[0], (bi + 1) * blk.shape[0]),
              slice(si * blk.shape[1], (si + 1) * blk.shape[1]))
        prev = out[sl]
        if not np.isnan(prev).all():
            np.testing.assert_array_equal(prev, blk)
        out[sl] = blk
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("dims", [(1, 2), (1, 4), (2, 2)])
def test_sharded_decode_attention_matches_jax(dims, tmp_path):
    ranks = cases.run("decode", dims, str(tmp_path))
    x = cases.decode_inputs()
    for li, (seq, ba) in enumerate(cases.decode_layouts(dims)):
        for window, cap in cases.DECODE_OPTS:
            for length in cases.DECODE_LENGTHS:
                want = jda.decode_attention(
                    x["q"], x["k"], x["v"], jnp.int32(length), mesh=None,
                    seq_axis=None, window=window, softcap=cap)
                got = _stitch_rows(
                    [r[f"attn.{li}.{window}.{cap}.{length}"] for r in ranks],
                    dims, ba)
                np.testing.assert_allclose(got, np.asarray(want),
                                           rtol=ATTN_TOL, atol=ATTN_TOL)
        for pos in cases.DECODE_APPEND:
            kr, vr = jda.cache_append(x["k"], x["v"], x["kn"], x["vn"], pos,
                                      mesh=None, seq_axis=None)
            for name, want in (("k", kr), ("v", vr)):
                got = _stitch_cache([r[f"append.{li}.{pos}.{name}"]
                                     for r in ranks], dims, ba, seq)
                np.testing.assert_array_equal(got, np.asarray(want))


@pytest.fixture(scope="module")
def one_rank():
    """The one-rank server's ids, every step's logits and the final
    caches, per arch."""
    out = {}
    for arch in cases.SERVE_ARCHS:
        res = serve.run(serve.parse_args(cases.serve_argv(arch, (1, 1))),
                        keep=range(cases.SERVE_STEPS))
        out[arch] = (res["ids"], np.stack([
            res["logits"][i].numpy() for i in range(cases.SERVE_STEPS)]),
            cases.serve_caches(res["caches"]))
    return out


@pytest.mark.parametrize("dims", [(1, 2), (2, 2)])
def test_sharded_serve_matches_one_rank(dims, one_rank, tmp_path):
    ranks = cases.run("serve", dims, str(tmp_path))
    for arch in cases.SERVE_ARCHS:
        ids, logits, caches = one_rank[arch]
        for r in ranks:
            np.testing.assert_array_equal(r[f"{arch}.ids"], ids)
        # each rank's logits are its block of the batch: (steps, B, V)
        got = np.swapaxes(_stitch_rows(
            [np.swapaxes(r[f"{arch}.logits"], 0, 1) for r in ranks], dims,
            ("data",)), 0, 1)
        err = np.abs(got - logits).max()
        assert err <= SERVE_TOL * np.abs(logits).max(), (arch, err)
        # every rank gathers the same whole caches, the one rank's
        for name, want in caches.items():
            for r in ranks:
                got = r[f"{arch}.{name}"]
                assert got.shape == want.shape, name
                assert np.abs(got - want).max() <= \
                    SERVE_TOL * np.abs(want).max(), (arch, name)
