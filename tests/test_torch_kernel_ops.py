"""The kernels' custom ops (`repro::flash_attention`,
`repro::flash_attention_block`, `repro::ssd_chunk`, `repro::conv2d`) as a
dry run's trace sees them, on the CPU.

- The FLOP formulas: `admitted_pairs` against a brute-force count of the
  plain version's masks over a grid of extents, causality, windows and
  ring offsets; `ssd_flops` and `conv_flops` against the operation counts
  that `chip_smoke.py`'s bounds use (and the conv's against PyTorch's own
  conv formula).
- The fake implementations: each op called under FakeTensorMode on CPU
  tensors gives its plain version's output shapes and dtypes, counts no
  launch, and FlopCounterMode's total over it is the formula's.
"""
import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

import chip_smoke
from repro_torch.kernels import conv2d as tconv
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd as tssd
from repro_torch.kernels.ref import conv2d_ref, flash_attention_ref

torch.set_num_threads(2)

EXTENTS = (1, 5, 16, 33)
WINDOWS = (None, 1, 3, 7, 40)
DELTAS = (-40, -3, 0, 5, 17, 64)


def _brute_pairs(sq, sk, causal, window, delta) -> int:
    """The pairs the plain version's masks keep: key j against query row i
    at position i + delta, j <= position under causality, position - j <
    window under a window."""
    pos = np.arange(sq)[:, None] + delta
    key = np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= key <= pos
    if window is not None:
        keep &= pos - key < window
    return int(keep.sum())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", WINDOWS)
def test_admitted_pairs_against_brute_force(causal, window):
    for sq, sk, delta in itertools.product(EXTENTS, EXTENTS, DELTAS):
        want = _brute_pairs(sq, sk, causal, window, delta)
        assert tfa.admitted_pairs(sq, sk, causal, window, delta) == want, \
            (sq, sk, delta)


@pytest.mark.parametrize("window", WINDOWS)
def test_admitted_pairs_against_the_bound(window):
    """The bound's count in `chip_smoke.py` (square blocks, causal)."""
    for s, delta in itertools.product(EXTENTS, DELTAS):
        assert tfa.admitted_pairs(s, s, True, window, delta) == \
            chip_smoke.admitted_pairs(s, window, delta), (s, delta)


def test_admitted_pairs_against_the_mask_of_the_plain_version():
    """The pairs counted from the plain version itself: with v all ones,
    a row's lse is the log of its admitted keys' count when q is zero."""
    for sq, sk, causal, window, delta in [(7, 9, True, None, 2),
                                          (16, 16, True, 5, 0),
                                          (5, 33, False, 7, 20),
                                          (33, 16, True, 3, -3)]:
        q = torch.zeros(1, sq, 1, 4, dtype=torch.float64)
        k = torch.zeros(1, sk, 1, 4, dtype=torch.float64)
        _, lse = flash_attention_ref(q, k, k, causal=causal, window=window,
                                     delta=delta, return_lse=True)
        seen = lse[0, 0] > -1e29
        count = int(torch.exp(lse[0, 0][seen]).round().sum())
        assert count == tfa.admitted_pairs(sq, sk, causal, window, delta)


def _fake_flops(fn, *args):
    """(outputs, FLOPs, launches) of fn(*args) under FakeTensorMode on
    fake copies of the CPU tensors `args`."""
    ops.reset_launch_counts()
    with FakeTensorMode() as mode:
        fargs = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                 for a in args]
        with FlopCounterMode(display=False) as counter:
            out = fn(*fargs)
    return out, counter.get_total_flops(), sum(ops.launch_counts().values())


def _like(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]


ATTN = [  # b, sq, sk, hq, hkv, d, causal, window, delta
    (2, 16, 16, 4, 2, 8, True, None, 0),
    (1, 9, 13, 2, 1, 16, True, 4, 0),
    (1, 12, 12, 2, 2, 8, False, None, 0),
    (2, 8, 8, 2, 1, 8, True, None, 8),
    (1, 8, 16, 4, 4, 8, True, 5, -4),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN)
def test_attention_op_fake(case, dtype):
    b, sq, sk, hq, hkv, d, causal, window, delta = case
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, sq, hq, d, generator=g).to(dtype)
    k = torch.randn(b, sk, hkv, d, generator=g).to(dtype)
    v = torch.randn(b, sk, hkv, d, generator=g).to(dtype)
    want_flops = 4 * b * hq * d * _brute_pairs(sq, sk, causal, window, delta)
    if delta == 0 and (not causal or sq <= sk):
        out, flops, launches = _fake_flops(
            lambda *a: torch.ops.repro.flash_attention(*a, causal, window,
                                                       None, None), q, k, v)
        _like(out, ops.flash_attention(q, k, v, causal=causal,
                                       window=window))
        assert (flops, launches) == (want_flops, 0)
    out, flops, launches = _fake_flops(
        lambda *a: torch.ops.repro.flash_attention_block(
            *a, delta, causal, window, None, None), q, k, v)
    _like(out, ops.flash_attention_block(q, k, v, delta=delta,
                                         causal=causal, window=window))
    assert (flops, launches) == (want_flops, 0)


SSD = [  # b, l, h, p, n, chunk
    (1, 16, 2, 4, 8, 8), (2, 32, 3, 8, 4, 16), (1, 64, 1, 16, 16, 64),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD)
def test_ssd_op_fake(case, dtype):
    b, l, h, p, n, chunk = case
    g = torch.Generator().manual_seed(0)
    xdt = torch.randn(b, l, h, p, generator=g).to(dtype)
    la = -torch.rand(b, l, h, generator=g)
    B = torch.randn(b, l, n, generator=g).to(dtype)
    C = torch.randn(b, l, n, generator=g).to(dtype)
    (y, S), flops, launches = _fake_flops(
        lambda *a: torch.ops.repro.ssd_chunk(*a, chunk), xdt, la, B, C)
    _like((y, S), ops.ssd_chunk(xdt, la, B, C, chunk=chunk))
    assert launches == 0
    assert flops == tssd.ssd_flops((b, l, h, p), n, chunk)
    assert flops == chip_smoke.ssd_work(xdt, la, B, S, chunk)[0]


CONV = [  # n, h, w, c, f, k, stride
    (2, 9, 9, 3, 5, 3, 1), (1, 17, 12, 18, 8, 3, 2), (2, 8, 8, 32, 1, 1, 1),
    (1, 23, 9, 6, 16, 7, 2),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CONV)
def test_conv_op_fake(case, dtype):
    n, h, w, c, f, k, s = case
    g = torch.Generator().manual_seed(0)
    x = torch.randn(n, h, w, c, generator=g).to(dtype)
    wt = torch.randn(k, k, c, f, generator=g).to(dtype)
    y, flops, launches = _fake_flops(
        lambda *a: torch.ops.repro.conv2d(*a, s, False), x, wt)
    want = conv2d_ref(x, wt, stride=s)
    _like(y, want)
    assert launches == 0
    assert flops == tconv.conv_flops(x.shape, wt.shape, s)
    # the bound's count in `chip_smoke.py` and PyTorch's own conv formula
    assert flops == 2 * n * want.shape[1] * want.shape[2] * f * k * k * c
    with FlopCounterMode(display=False) as counter:
        F.conv2d(x.float().permute(0, 3, 1, 2),
                 wt.float().permute(3, 2, 0, 1), stride=s)
    assert flops == counter.get_total_flops()
