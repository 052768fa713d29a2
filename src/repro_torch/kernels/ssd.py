"""The SSD-chunk kernel's wrapper and its autograd Function.

`ssd_chunk` launches `csrc/ssd.cu` (the Hopper counterpart of the Pallas
kernel `repro/kernels/ssd.py::ssd_chunk`) on CUDA tensors and counts its
launches in `ssd_chunk.launches`.  It never falls back: anything the
kernel does not take raises.  The plain version is `ref.ssd_chunked_ref`;
`ops.ssd_chunk` picks between the two by the tensor's device.

`SsdChunk` is the differentiable op on the card.  Its forward is the
kernel; its backward recomputes both outputs through the plain version and
differentiates that with autograd, as the reference differentiates its
jnp `_ssd_chunked` (the TPU kernel is forward-only).  A backward kernel is
later work.
"""
from __future__ import annotations

import ctypes

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_I64 = ctypes.c_int64
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128


def _lib():
    from repro_torch.kernels import _build
    lib = _build.load("ssd")
    fn = lib.repro_ssd_chunk
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, _I64, _I64, _I64, _I64, _I64,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def check_args(xdt: torch.Tensor, la: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, chunk: int) -> None:
    """Raise on anything the kernel does not take: ranks and shapes, a
    chunk that does not divide l or exceeds 128, p > 64, n > 128, dtypes
    (xdt, B, C of one float32/bfloat16 dtype; la float32 or that dtype),
    devices and contiguity."""
    if xdt.dim() != 4 or la.dim() != 3 or B.dim() != 3 or C.dim() != 3:
        raise ValueError(f"ssd_chunk wants xdt (b,l,h,p), la (b,l,h), B/C "
                         f"(b,l,n); got ranks {xdt.dim()}, {la.dim()}, "
                         f"{B.dim()}, {C.dim()}")
    b, l, h, p = xdt.shape
    n = B.shape[-1]
    if tuple(la.shape) != (b, l, h) or tuple(B.shape) != (b, l, n) \
            or tuple(C.shape) != (b, l, n):
        raise ValueError(f"shapes do not match: xdt {tuple(xdt.shape)}, "
                         f"la {tuple(la.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)}")
    if min(b, l, h, p, n) < 1:
        raise ValueError(f"no extent may be 0: xdt {tuple(xdt.shape)}, "
                         f"n {n}")
    if not isinstance(chunk, int) or not 1 <= chunk <= MAX_CHUNK \
            or l % chunk:
        raise ValueError(f"chunk {chunk!r} must divide l = {l} and lie in "
                         f"1..{MAX_CHUNK}")
    if p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"head dim {p} > {MAX_HEAD_DIM} or state {n} > "
                         f"{MAX_STATE}")
    if xdt.dtype not in _DTYPES or B.dtype != xdt.dtype \
            or C.dtype != xdt.dtype \
            or la.dtype not in (torch.float32, xdt.dtype):
        raise TypeError(f"ssd_chunk takes float32 or bfloat16 xdt, B, C of "
                        f"one dtype and la in float32 or that dtype; got "
                        f"{xdt.dtype}, {B.dtype}, {C.dtype}, {la.dtype}")
    if not (xdt.device == la.device == B.device == C.device):
        raise ValueError("xdt, la, B and C lie on different devices")
    if not all(t.is_contiguous() for t in (xdt, la, B, C)):
        raise ValueError("ssd_chunk wants contiguous xdt, la, B and C")


def ssd_chunk(xdt: torch.Tensor, la: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor, *, chunk: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The intra-chunk pass on the card: y (b, l, h, p) in xdt's dtype and
    the per-chunk zero-inflow states S (b, l // chunk, h, p, n) in fp32.

    la is read in fp32 (a bfloat16 la is widened first).  Launches on the
    current stream and does not synchronise; raises if the launch is
    refused."""
    check_args(xdt, la, B, C, chunk)
    if not xdt.is_cuda:
        raise ValueError(f"the ssd_chunk kernel runs on CUDA tensors; got "
                         f"{xdt.device} (ops.ssd_chunk takes the plain "
                         f"version on the CPU)")
    b, l, h, p = xdt.shape
    n = B.shape[-1]
    nc = l // chunk
    la = la.float()
    y = torch.empty_like(xdt)
    S = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=xdt.device)
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(xdt.data_ptr(), la.data_ptr(), B.data_ptr(),
                     C.data_ptr(), y.data_ptr(), S.data_ptr(),
                     _DTYPES[xdt.dtype], b * nc, chunk, h, p, n, stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed: cudaError_t "
                           f"{err} (xdt {tuple(xdt.shape)}, n {n}, chunk "
                           f"{chunk})")
    ssd_chunk.launches += 1
    return y, S


ssd_chunk.launches = 0


class SsdChunk(torch.autograd.Function):
    """Differentiable intra-chunk pass on the card: forward through the
    kernel, backward by autograd through the plain version, recomputed."""

    @staticmethod
    def forward(ctx, xdt, la, B, C, chunk: int):
        ctx.save_for_backward(xdt, la, B, C)
        ctx.chunk = chunk
        return ssd_chunk(xdt, la, B, C, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gS):
        from repro_torch.kernels.ref import ssd_chunked_ref
        xdt, la, B, C = (t.detach().requires_grad_()
                         for t in ctx.saved_tensors)
        with torch.enable_grad():
            y, S = ssd_chunked_ref(xdt, la, B, C, ctx.chunk)
            grads = torch.autograd.grad((y, S), (xdt, la, B, C), (gy, gS))
        return (*grads, None)
