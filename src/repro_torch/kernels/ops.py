"""Dispatch by the tensor's device: CUDA tensors go to the hand-written
kernel, CPU tensors to its plain version.  There is no other switch and no
fallback between the two.

On CUDA tensors each kernel launch is one call of a custom op
(`repro::conv2d`, `repro::flash_attention`,
`repro::flash_attention_block`, `repro::ssd_chunk`, registered by
`_build.define_op`).  Its CUDA implementation is the ctypes launch; its
fake implementation returns the
outputs' shapes and dtypes only, so the dry run (`launch.dryrun`) traces
the card's path on fake tensors, and each op has a FLOP formula
(`torch.utils.flop_counter`) that counts the work its bound counts.  The
launch counters count real launches only.

`conv2d` is the bare forward (`conv2d.Conv2d` wraps it for autograd).
`flash_attention`, `flash_attention_block` and `ssd_chunk` are
differentiable: on CUDA through
their autograd Functions (the kernel forward, a backward recomputed
through the plain version), on the CPU through the plain version itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import conv2d as _conv
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd as _ssd


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           interior_first: bool = False) -> torch.Tensor:
    """VALID conv, NHWC x HWIO -> NHWC (x's dtype, fp32 accumulation).
    `interior_first` orders the kernel's tiles (the plain version computes
    the same result at once)."""
    if x.is_cuda:
        return _conv.conv2d(x, w, stride=stride,
                            interior_first=interior_first)
    if x.device.type == "cpu":
        _conv.check_args(x, w, stride)
        return _ref.conv2d_ref(x, w, stride=stride)
    raise ValueError(f"no conv2d for device {x.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Attention, q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) -> (B,Sq,Hq,D) in q's
    dtype (GQA, causal / window masks, softcap; fp32 softmax)."""
    if q.is_cuda:
        return _fa.FlashAttention.apply(q, k, v, causal, window, softcap,
                                        scale)
    if q.device.type == "cpu":
        _fa.check_args(q, k, v, window, softcap, scale)
        return _ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window, softcap=softcap,
                                        scale=scale)
    raise ValueError(f"no flash_attention for device {q.device}")


def flash_attention_block(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, delta: int,
                          causal: bool = True, window: int | None = None,
                          softcap: float | None = None,
                          scale: float | None = None):
    """One (query block, key block) tile of ring attention: query row i at
    position i + delta, key j at j -> (o (B,Sq,Hq,D) fp32, lse (B,Hq,Sq)
    fp32), differentiable in both.  A row that no key of the block is
    admitted to comes back with lse <= -1e29 and a finite o."""
    if q.is_cuda:
        return _fa.FlashAttentionBlock.apply(q, k, v, delta, causal, window,
                                             softcap, scale)
    if q.device.type == "cpu":
        _fa.check_args(q, k, v, window, softcap, scale, block=True)
        return _ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window, softcap=softcap,
                                        scale=scale, delta=delta,
                                        return_lse=True)
    raise ValueError(f"no flash_attention_block for device {q.device}")


def ssd_chunk(xdt: torch.Tensor, la: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor, *, chunk: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD intra-chunk pass: y (b,l,h,p) in xdt's dtype and the per-chunk
    zero-inflow states S (b, l // chunk, h, p, n) in fp32."""
    if xdt.is_cuda:
        return _ssd.SsdChunk.apply(xdt, la, B, C, chunk)
    if xdt.device.type == "cpu":
        _ssd.check_args(xdt, la, B, C, chunk)
        return _ref.ssd_chunked_ref(xdt, la, B, C, chunk)
    raise ValueError(f"no ssd_chunk for device {xdt.device}")


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    _conv.conv2d.launches = 0
    _fa.flash_attention.launches = 0
    _ssd.ssd_chunk.launches = 0


def launch_counts() -> dict[str, int]:
    return {"conv2d": _conv.conv2d.launches,
            "flash_attention": _fa.flash_attention.launches,
            "ssd_chunk": _ssd.ssd_chunk.launches}
