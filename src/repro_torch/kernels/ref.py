"""Plain PyTorch versions of the kernels (the allclose targets).

These are the semantic definitions, the counterparts of the oracles in the
reference's `kernels/ref.py`.  The CPU path runs them; on the card they
exist only to be compared with the kernels.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30     # masked logits / exponents: exp() of it is exactly 0


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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        softcap: float | None = None,
                        scale: float | None = None, delta: int = 0,
                        return_lse: bool = False):
    """Attention, q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) with Hq % Hkv == 0
    -> (B, Sq, Hq, D) in q's dtype.

    GQA maps q head hi to kv head hi // (Hq // Hkv).  Query row i sits at
    position i + delta and key j at j (`delta` = the query block's global
    offset less the key block's, as the reference's `_block_attend` takes
    q_off and k_off); causal keeps qpos >= kpos, the window keeps
    qpos - kpos < window.  Masked logits are set to -1e30 (not -inf), the
    softmax and both products run in fp32.  Differentiable by autograd.

    With `return_lse`, returns (o in fp32, lse (B, Hq, Sq) in fp32): the
    block's partial softmax for a merge by log-sum-exp, lse = m + log l.
    A row that no key of the block is admitted to has lse <= -1e29 (its
    weight in a merge is exactly 0) and a finite o.
    """
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None] + delta
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, s.new_tensor(NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float()).reshape(b, sq, hq, d)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(b, hq, sq)
    return o.to(q.dtype)


def ssd_chunk_ref(xdt: torch.Tensor, la: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-chunk SSD: y_i = sum_{j<=i} C_i.B_j exp(cum_i - cum_j) xdt_j
    and the chunk's outgoing state from zero inflow,
    S = sum_j xdt_j (x) B_j exp(cum_end - cum_j).

    xdt: (b, l, h, p); la: (b, l, h) log-decay; B/C: (b, l, n).  Returns
    y (b, l, h, p) in xdt's dtype and S (b, h, p, n) in fp32; all the
    math runs in fp32, the upper triangle masked in the exponent."""
    xf, Bf = xdt.float(), B.float()
    cum = torch.cumsum(la.float(), dim=1)                   # (b, l, h)
    y = torch.einsum("bijh,bjhp->bihp", ssd_scores(cum, B, C), xf)
    dec_end = torch.exp(cum[:, -1:, :] - cum)               # (b, l, h)
    S = torch.einsum("bjhp,bjn->bhpn", xf * dec_end[..., None], Bf)
    return y.to(xdt.dtype), S


def ssd_scores(cum: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor) -> torch.Tensor:
    """M[b, i, j, h] = C_i.B_j exp(cum_i - cum_j) for j <= i, else 0 (the
    upper triangle masked in the exponent), in fp32; cum: (b, l, h)."""
    l = cum.shape[1]
    seg = cum[:, :, None, :] - cum[:, None, :, :]           # (b, i, j, h)
    mask = torch.ones((l, l), dtype=torch.bool, device=cum.device).tril()
    seg = torch.where(mask[None, :, :, None], seg, seg.new_tensor(NEG_INF))
    G = torch.einsum("bin,bjn->bij", C.float(), B.float())
    return G[..., None] * torch.exp(seg)


def ssd_chunked_ref(xdt: torch.Tensor, la: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, chunk: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """`ssd_chunk_ref` on every `chunk`-long slice of the sequence (what the
    kernel computes): y (b, l, h, p) in xdt's dtype and the per-chunk
    zero-inflow states S (b, l // chunk, h, p, n) in fp32."""
    b, l, h, p = xdt.shape
    n = B.shape[-1]
    nc = l // chunk
    y, S = ssd_chunk_ref(xdt.reshape(b * nc, chunk, h, p),
                         la.reshape(b * nc, chunk, h),
                         B.reshape(b * nc, chunk, n),
                         C.reshape(b * nc, chunk, n))
    return y.reshape(b, l, h, p), S.reshape(b, nc, h, p, n)
