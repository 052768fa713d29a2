"""The implicit-GEMM conv kernel's wrapper and its autograd Function.

`conv2d` launches `csrc/conv2d.cu` (the Hopper counterpart of the Pallas
kernel `repro/kernels/conv2d.py::conv2d`) on CUDA tensors and counts its
launches in `conv2d.launches`.  It never falls back: anything the kernel
does not take raises.  The plain version is `ref.conv2d_ref`; `ops.conv2d`
picks between the two by the tensor's device.

`Conv2d` is the differentiable op the model calls.  Its forward is
`ops.conv2d`; its backward is PyTorch's `conv2d_input` / `conv2d_weight`
(cuDNN on the card) on NCHW/OIHW views of the same tensors.  That mirrors
the reference, whose Pallas kernel is forward-only and whose gradients are
XLA's conv transposes.  Hand-written dgrad/wgrad kernels come only if the
card's measurements show they pay.
"""
from __future__ import annotations

import ctypes

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_I64 = ctypes.c_int64


def _lib():
    from repro_torch.kernels import _build
    lib = _build.load("conv2d")
    fn = lib.repro_conv2d
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, _I64, _I64, _I64, _I64, _I64, _I64,
                       _I64, _I64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def check_args(x: torch.Tensor, w: torch.Tensor, stride: int) -> None:
    """Raise on anything the kernel does not take: rank, dtype, matching
    devices and channels, contiguity, stride, and a kernel larger than the
    input."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv2d wants x (N,H,W,C) and w (KH,KW,C,F); "
                         f"got ranks {x.dim()} and {w.dim()}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"conv2d takes float32 or bfloat16 x and w of one "
                        f"dtype; got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if w.shape[2] != x.shape[3]:
        raise ValueError(f"channels differ: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv2d wants contiguous x and w")
    if not isinstance(stride, int) or stride < 1:
        raise ValueError(f"stride must be a positive int, got {stride!r}")
    if x.shape[1] < w.shape[0] or x.shape[2] < w.shape[1]:
        raise ValueError(f"kernel {tuple(w.shape[:2])} larger than input "
                         f"{tuple(x.shape[1:3])} (VALID conv)")


def conv2d(x: torch.Tensor, w: torch.Tensor, *,
           stride: int = 1) -> torch.Tensor:
    """VALID conv, NHWC x HWIO -> NHWC in x's dtype, on the card.

    Launches on the current stream and does not synchronise; raises if the
    launch is refused."""
    check_args(x, w, stride)
    if not x.is_cuda:
        raise ValueError(f"the conv2d kernel runs on CUDA tensors; got "
                         f"{x.device} (ops.conv2d takes the plain version "
                         f"on the CPU)")
    n, h, wd, c = x.shape
    kh, kw, _, f = w.shape
    y = torch.empty((n, (h - kh) // stride + 1, (wd - kw) // stride + 1, f),
                    dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                     _DTYPES[x.dtype], n, h, wd, c, kh, kw, f, stride,
                     stream)
    if err != 0:
        raise RuntimeError(f"conv2d kernel launch failed: cudaError_t {err} "
                           f"(x {tuple(x.shape)}, w {tuple(w.shape)}, "
                           f"stride {stride})")
    conv2d.launches += 1
    return y


conv2d.launches = 0


class Conv2d(torch.autograd.Function):
    """Differentiable VALID conv: forward through `ops.conv2d` (the kernel
    on CUDA, the plain version on the CPU), backward through PyTorch's conv
    gradients."""

    @staticmethod
    def forward(ctx, x, w, stride: int):
        from repro_torch.kernels import ops
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return ops.conv2d(x, w, stride=stride)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        s = ctx.stride
        g = gy.permute(0, 3, 1, 2)                  # NHWC -> NCHW view
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # input_size given explicitly: with stride 2 and VALID, the
            # input extent is not determined by the output's
            dx = torch.nn.grad.conv2d_input(
                (x.shape[0], x.shape[3], x.shape[1], x.shape[2]),
                w.permute(3, 2, 0, 1), g, stride=s).permute(0, 2, 3, 1)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(
                x.permute(0, 3, 1, 2),
                (w.shape[3], w.shape[2], w.shape[0], w.shape[1]), g,
                stride=s).permute(2, 3, 1, 0)
        return dx, dw, None
