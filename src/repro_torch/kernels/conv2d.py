"""The implicit-GEMM conv kernel's wrapper and its autograd Function.

`conv2d` launches `csrc/conv2d.cu` (the Hopper counterpart of the Pallas
kernel `repro/kernels/conv2d.py::conv2d`) on CUDA tensors and counts its
launches in `conv2d.launches`, one per call (a split-K call's second,
summing kernel included).  `plan` picks from the shapes alone the path
(bf16 on `wgmma`, f32 on FMAs), the tiles, the K splits and the zero
padding of C and F that the kernel's 16-byte copies need.  It never
falls back: anything the kernel does not take raises.  The plain
version is `ref.conv2d_ref`; `ops.conv2d` picks between the two by the
tensor's device.

`tile_order` gives the order in which the kernel's CTAs take the pixel
tiles: the plain order, or with `interior_first` the tiles that read the
halo rows last (the reference's `interior_first` grid order).
`conv2d_emulated` runs `plan` and `tile_order` in plain PyTorch on the
CPU, tile by tile, as the CUDA kernel does.

`Conv2d` is the differentiable op the model calls.  Its forward is
`ops.conv2d`; its backward is PyTorch's `conv2d_input` / `conv2d_weight`
(cuDNN on the card) on NCHW/OIHW views of the same tensors.  That mirrors
the reference, whose Pallas kernel is forward-only and whose gradients are
XLA's conv transposes.  Hand-written dgrad/wgrad kernels come only if the
card's measurements show they pay.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch.utils import same_pads

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_I64 = ctypes.c_int64
SMS = 132            # streaming multiprocessors of an H100 SXM
MAX_SPLITS = 16


@dataclasses.dataclass(frozen=True)
class Plan:
    """How `csrc/conv2d.cu` runs one call, from the shapes alone.

    path: "wgmma" (bf16 on the tensor cores) or "fma" (f32 on the CUDA
    cores); tile_m x tile_n output pixels x filters per CTA; tile_k
    channels per K step; splits: CTAs that share one tile's K steps (1: no
    split-K); c_pad / f_pad: x's channels and w's filters after zero
    padding, so that every copy is 16 aligned bytes."""
    path: str
    tile_m: int
    tile_n: int
    tile_k: int
    splits: int
    c_pad: int
    f_pad: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def plan(x_shape, w_shape, stride: int, dtype: torch.dtype) -> Plan:
    """The launch plan for x (N,H,W,C) * w (KH,KW,C,F) at `stride`.

    C and F are zero-padded to a multiple of 8 (bf16) or 4 (f32).  The
    filter tile is 64 where F <= 64, else 128; the pixel tile is 128, or
    256 for a bf16 128-filter tile where those tiles still fill the card's
    SMs (a taller tile reuses each B tile over more pixels).  A K step is
    64 channels (bf16), or 16 (f32; 8 where C is not a multiple of 16).
    Where the tiles make less than one wave on the card's SMs, the K steps
    (KH*KW taps x C / tile_k slices) are split over up to MAX_SPLITS CTAs,
    each keeping at least 8 K steps."""
    n, h, wd, c = x_shape
    kh, kw, _, f = w_shape
    bf16 = dtype == torch.bfloat16
    align = 8 if bf16 else 4
    tile_n = 64 if f <= 64 else 128
    c_pad = _ceil(c, align) * align
    tile_k = 64 if bf16 else (16 if c_pad % 16 == 0 else 8)
    m = n * ((h - kh) // stride + 1) * ((wd - kw) // stride + 1)
    tile_m = 256 if bf16 and tile_n == 128 and \
        _ceil(m, 256) * _ceil(f, tile_n) >= SMS else 128
    tiles = _ceil(m, tile_m) * _ceil(f, tile_n)
    ksteps = kh * kw * _ceil(c_pad, tile_k)
    splits = 1
    if tiles < SMS:
        splits = max(1, min(_ceil(SMS, tiles), MAX_SPLITS, ksteps // 8))
    return Plan(path="wgmma" if bf16 else "fma", tile_m=tile_m,
                tile_n=tile_n, tile_k=tile_k, splits=splits, c_pad=c_pad,
                f_pad=_ceil(f, align) * align)


@functools.lru_cache(maxsize=1024)
def tile_order(x_shape, w_shape, stride: int, dtype: torch.dtype,
               interior_first: bool) -> tuple[int, ...] | None:
    """The pixel tiles (of `plan`'s tile_m) in the order the kernel's CTAs
    take them; None for the plain order.

    With `interior_first`, the tiles holding an output row that reads the
    first lo or last hi input rows of its sample, (lo, hi) the SAME pads of
    (KH, stride) -- the halo rows `core.spatial_conv` puts there -- come
    after all the others, each group in ascending order.  Every tile
    appears once; a 1x1 kernel has no such rows."""
    if not interior_first:
        return None
    n, h, wd, _ = x_shape
    kh, kw = w_shape[0], w_shape[1]
    p = plan(tuple(x_shape), tuple(w_shape), stride, dtype)
    ho, wo = (h - kh) // stride + 1, (wd - kw) // stride + 1
    lo, hi = same_pads(kh, stride)
    oh = torch.arange(ho)
    edge_row = (oh * stride < lo) | (oh * stride + kh > h - hi)
    m = n * ho * wo
    tiles = _ceil(m, p.tile_m)
    edge = torch.zeros(tiles * p.tile_m, dtype=torch.bool)
    edge[:m] = edge_row[(torch.arange(m) % (ho * wo)) // wo]
    edge = edge.view(tiles, p.tile_m).any(dim=1)
    order = torch.cat([torch.nonzero(~edge).flatten(),
                       torch.nonzero(edge).flatten()])
    return tuple(order.tolist())


@functools.lru_cache(maxsize=256)
def _order_on(device: torch.device, order: tuple[int, ...]) -> torch.Tensor:
    return torch.tensor(order, dtype=torch.int32, device=device)


def pad_operands(x: torch.Tensor, w: torch.Tensor, p: Plan
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """x and w with C zero-padded to p.c_pad and w's F to p.f_pad (the
    same tensors where nothing is padded).  Zero channels and filters add
    exact zeros, so y[..., :F] is unchanged."""
    dc, df = p.c_pad - x.shape[3], p.f_pad - w.shape[3]
    if dc:
        x = F.pad(x, (0, dc))
    if dc or df:
        w = F.pad(w, (0, df, 0, dc))
    return x, w


def _lib():
    from repro_torch.kernels import _build
    lib = _build.load("conv2d")
    fn = lib.repro_conv2d
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [_I64] * 13 \
            + [ctypes.c_void_p] * 2
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


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           interior_first: bool = False) -> torch.Tensor:
    """VALID conv, NHWC x HWIO -> NHWC in x's dtype, on the card.

    Pads C and F as `plan` says, allocates y and any split-K workspace,
    takes the pixel tiles in `tile_order`, launches on the current stream
    and does not synchronise; raises if a launch is refused."""
    check_args(x, w, stride)
    if not x.is_cuda:
        raise ValueError(f"the conv2d kernel runs on CUDA tensors; got "
                         f"{x.device} (ops.conv2d takes the plain version "
                         f"on the CPU)")
    n, h, wd, _ = x.shape
    kh, kw, _, f = w.shape
    p = plan(tuple(x.shape), tuple(w.shape), stride, x.dtype)
    xp, wp = pad_operands(x, w, p)
    ho, wo = (h - kh) // stride + 1, (wd - kw) // stride + 1
    y = torch.empty((n, ho, wo, f), dtype=x.dtype, device=x.device)
    ws = torch.empty((p.splits, n * ho * wo, f), dtype=torch.float32,
                     device=x.device) if p.splits > 1 else None
    order = tile_order(tuple(x.shape), tuple(w.shape), stride, x.dtype,
                       interior_first)
    order_t = None if order is None else _order_on(x.device, order)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(xp.data_ptr(), wp.data_ptr(), y.data_ptr(),
                     None if ws is None else ws.data_ptr(),
                     _DTYPES[x.dtype], n, h, wd, p.c_pad, kh, kw, f,
                     p.f_pad, stride, p.tile_m, p.tile_n, p.tile_k,
                     p.splits,
                     None if order_t is None else order_t.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"conv2d kernel launch failed: cudaError_t {err} "
                           f"(x {tuple(x.shape)}, w {tuple(w.shape)}, "
                           f"stride {stride}, {p})")
    conv2d.launches += 1
    return y


conv2d.launches = 0


class Conv2d(torch.autograd.Function):
    """Differentiable VALID conv: forward through `ops.conv2d` (the kernel
    on CUDA, the plain version on the CPU), backward through PyTorch's conv
    gradients."""

    @staticmethod
    def forward(ctx, x, w, stride: int, interior_first: bool = False):
        from repro_torch.kernels import ops
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return ops.conv2d(x, w, stride=stride, interior_first=interior_first)

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
        return dx, dw, None, None


def conv2d_emulated(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                    interior_first: bool = False) -> torch.Tensor:
    """`csrc/conv2d.cu`'s tiling in plain PyTorch (any device; meant for
    the CPU): VALID conv, NHWC x HWIO -> NHWC in x's dtype, as `conv2d`.

    It follows `plan` and `tile_order`: C and F zero-padded; the pixel
    tiles in the kernel's order, each written once (a tile left unwritten
    stays NaN); per tile and filter tile, the K steps (tap by tap, tile_k
    channels at a time, channels past the padded C cut off) split over
    `splits` ranges, each range's fp32 partial summed over its steps, the
    partials then added in split order; the stores cut at the last pixel
    and the real F; the result rounded once to x's dtype (bf16 operands
    are exact in their fp32 products)."""
    check_args(x, w, stride)
    p = plan(tuple(x.shape), tuple(w.shape), stride, x.dtype)
    xp, wp = pad_operands(x, w, p)
    n, h, wd, cp = xp.shape
    kh, kw, _, f = w.shape
    ho, wo = (h - kh) // stride + 1, (wd - kw) // stride + 1
    m = n * ho * wo
    taps = [xp[:, i:i + (ho - 1) * stride + 1:stride,
               j:j + (wo - 1) * stride + 1:stride, :].reshape(m, cp).float()
            for i in range(kh) for j in range(kw)]
    wf = wp.float().reshape(kh * kw, cp, p.f_pad)
    csteps = _ceil(cp, p.tile_k)
    ksteps = kh * kw * csteps
    per = _ceil(ksteps, p.splits)
    tiles = _ceil(m, p.tile_m)
    order = tile_order(tuple(x.shape), tuple(w.shape), stride, x.dtype,
                       interior_first) or tuple(range(tiles))
    y = torch.full((m, f), float("nan"), dtype=x.dtype, device=x.device)
    for t in order:
        rows = slice(t * p.tile_m, min((t + 1) * p.tile_m, m))
        for f0 in range(0, f, p.tile_n):
            total = None
            for z in range(p.splits):
                acc = torch.zeros((rows.stop - rows.start, p.tile_n),
                                  device=x.device)
                for ks in range(z * per, min((z + 1) * per, ksteps)):
                    tap, c0 = ks // csteps, (ks % csteps) * p.tile_k
                    b = wf[tap, c0:c0 + p.tile_k, f0:f0 + p.tile_n]
                    acc[:, :b.shape[1]] += taps[tap][rows, c0:c0 + p.tile_k] @ b
                total = acc if total is None else total + acc
            cols = min(p.tile_n, f - f0)
            y[rows, f0:f0 + cols] = total[:, :cols].to(x.dtype)
    return y.reshape(n, ho, wo, f)
