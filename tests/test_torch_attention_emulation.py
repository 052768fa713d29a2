"""The CPU emulation of the flash-attention kernel's tiling
(`kernels/flash_attention.flash_attention_emulated`).

The emulation walks `plan` as `csrc/flash_attention.cu` does: 128-query x
64-key tiles, query tiles longest first under causality, key tiles from
the first one the window admits to the last one causality admits, fp32
running max and sum rescaled per key tile in log2 units, masked logits at
-1e30 on the tiles a diagonal or window edge crosses, the softcap, P
rounded to bf16 before P.V on the `wgmma` path, l clamped at 1e-30.  It
is held against the reference's Pallas kernel in interpret mode and the
plain version at test_torch_kernels' tolerances (f32 2e-5; bf16 3e-2,
one bf16 rounding of the output), and the bf16 rows element by element
to one bf16 ulp of softmax(S).|v| + |o32|, the limit the card's kernel is
held to (tests/test_torch_cuda.py).  `tests/test_torch_cuda.py::
test_flash_emulation_matches_the_kernel` holds it against the card's
kernel (that file imports no jax, so it runs on the card's machine).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels.ref import flash_attention_ref

TOL = {"float32": 2e-5, "bfloat16": 3e-2}

# (b, sq, hq, hkv, d, causal, window, softcap): several 128-query and
# 64-key tiles with ragged ends, GQA g = 1, 2, 3, 5; a window inside one
# key tile (5) and one straddling two (70); softcap; D = 128 (two swizzle
# atoms on wgmma), D = 20 (bf16 on the fma path) and D = 8
ATTN = [
    (1, 300, 4, 2, 16, True, None, None),
    (2, 200, 6, 3, 32, True, 70, None),
    (1, 260, 5, 1, 64, True, 5, 30.0),
    (1, 150, 2, 2, 128, False, None, None),
    (1, 129, 3, 1, 20, True, None, 20.0),
    (1, 64, 2, 1, 8, False, 5, None),
]


def _inputs(b, sq, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, sq, hkv, d), (b, sq, hkv, d))]


def _ulp_worst(got, q, k, v, opts) -> float:
    """The largest |got - o32| over one bf16 ulp of softmax(S).|v| +
    |o32|, o32 the plain version in fp32 on the same bf16 inputs."""
    q, k, v = q.float(), k.float(), v.float()
    o32 = flash_attention_ref(q, k, v, **opts)
    limit = 2.0 ** -7 * (flash_attention_ref(q, k, v.abs(), **opts)
                         + o32.abs())
    return float(((got.float() - o32).abs() / limit).max())


@pytest.mark.parametrize("b,sq,hq,hkv,d,causal,window,cap", ATTN)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulation_matches_pallas_and_plain(b, sq, hq, hkv, d, causal,
                                            window, cap, dtype):
    arrays = _inputs(b, sq, hq, hkv, d)
    opts = dict(causal=causal, window=window, softcap=cap)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays)
    got = tfa.flash_attention_emulated(q, k, v, **opts)
    assert got.dtype == tdt and got.shape == q.shape
    assert not torch.isnan(got.float()).any(), "a query tile unwritten"
    kernel = pallas_flash(*(jnp.asarray(a, dtype) for a in arrays),
                          interpret=True, **opts)
    plan = tfa.plan(tuple(q.shape), tuple(k.shape), tdt, causal, window)
    for want in (np.asarray(kernel, np.float32),
                 flash_attention_ref(q, k, v, **opts).float().numpy()):
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=TOL[dtype], atol=TOL[dtype],
                                   err_msg=str(plan))
    if dtype == "bfloat16":
        assert _ulp_worst(got, q, k, v, opts) <= 1.0


def test_emulation_rounds_p_on_the_wgmma_path_only():
    """bf16 at D = 64 takes `wgmma`, whose P is rounded to bf16 before
    P.V: the emulation then differs from the same tiling with P kept in
    fp32 (the plain version's), and at D = 20 (the fma path) it does
    not round."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(1, 192, 2, 1, 64, seed=3))
    assert tfa.plan(tuple(q.shape), tuple(k.shape), torch.bfloat16, True,
                    None).path == "wgmma"
    got = tfa.flash_attention_emulated(q, k, v).float()
    f32 = tfa.flash_attention_emulated(q.float(), k.float(), v.float())
    assert not torch.equal(got, f32.to(torch.bfloat16).float())
    assert _ulp_worst(got, q, k, v, {}) <= 1.0
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(1, 192, 2, 1, 20, seed=3))
    assert tfa.plan(tuple(q.shape), tuple(k.shape), torch.bfloat16, True,
                    None).path == "fma"
    got = tfa.flash_attention_emulated(q, k, v)
    f32 = tfa.flash_attention_emulated(q.float(), k.float(), v.float())
    assert torch.equal(got, f32.to(torch.bfloat16))


def test_emulation_refuses_what_the_kernel_refuses():
    q = torch.zeros(1, 8, 2, 160)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_emulated(q, q, q)
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="see no"):
        tfa.flash_attention_emulated(q, q[:, :2], q[:, :2], causal=False,
                                     window=1)
