"""Plain PyTorch versions of the kernels (the allclose targets).

These are the semantic definitions, the counterparts of the oracles in the
reference's `kernels/ref.py`.  The CPU path runs them; on the card they
exist only to be compared with the kernels.
"""
from __future__ import annotations

import torch


def conv2d_ref(x: torch.Tensor, w: torch.Tensor,
               stride: int = 1) -> torch.Tensor:
    """VALID conv, NHWC x HWIO -> NHWC, accumulated in fp32 and cast to
    x's dtype (padding is the caller's job).

    Written as the implicit GEMM the kernel computes: for each of the K*K
    taps, a (N*H_out*W_out, C) @ (C, F) product of the strided input slice
    with that tap's weights, summed in fp32.  Differentiable by autograd.
    """
    _, h, wd, _ = x.shape
    kh, kw, _, _ = w.shape
    h_out = (h - kh) // stride + 1
    w_out = (wd - kw) // stride + 1
    xf = x.float()
    wf = w.float()
    acc = None
    for i in range(kh):
        for j in range(kw):
            xs = xf[:, i:i + (h_out - 1) * stride + 1:stride,
                    j:j + (w_out - 1) * stride + 1:stride, :]
            t = torch.matmul(xs, wf[i, j])
            acc = t if acc is None else acc + t
    return acc.to(x.dtype)
