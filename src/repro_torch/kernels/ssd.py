"""The SSD-chunk kernel's wrapper, its plan, its CPU emulation and its
autograd Function.

`ssd_chunk` launches `csrc/ssd.cu` (the Hopper counterpart of the Pallas
kernel `repro/kernels/ssd.py::ssd_chunk`) on CUDA tensors and counts its
launches in `ssd_chunk.launches`.  It never falls back: anything the
kernel does not take raises.  The plain version is `ref.ssd_chunked_ref`;
`ops.ssd_chunk` picks between the two by the tensor's device.

`plan` states the tiles, threads, heads per CTA and ring stages that the
kernel derives from the dtype, the chunk and the state size.
`ssd_chunk_emulated` runs that tiling in plain PyTorch on any device:
16-row tiles, the tiles above the diagonal skipped, the partial last tile
masked and, for bf16, M and xdt * w split into a bf16 high and low part
at the kernel's places.  `elem_limit` is the element-wise bound the bf16
kernel is held to.

`SsdChunk` is the differentiable op on the card.  Its forward is the
kernel; its backward recomputes both outputs through the plain version and
differentiates that with autograd, as the reference differentiates its
jnp `_ssd_chunked` (the TPU kernel is forward-only).  A backward kernel is
later work.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels.ref import NEG_INF, ssd_chunked_ref, ssd_scores

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_I64 = ctypes.c_int64
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128
TILE = 16               # rows of one tile of M, y and the S product
# the bf16 kernel's element-wise bound: |y - y32| <= ELEM_ULP |y32| +
# ELEM_SPLIT A, A = |M|.|xdt| (see `elem_limit`)
ELEM_ULP, ELEM_SPLIT = 2.0 ** -7, 2.0 ** -12


@dataclasses.dataclass(frozen=True)
class Plan:
    """How `csrc/ssd.cu` runs one call, from the shapes alone.  The kernel
    derives all of it from the dtype, the chunk and n; this mirrors it for
    printing and tests.

    path: "mma" (bf16: `mma.sync.m16n8k16` with bf16 operands and fp32
    accumulators; M and xdt * w each split into a bf16 high and low part,
    two products each) or "fma" (fp32 register-tiled CUDA-core FMAs);
    chunk_tile: the chunk length the CTA is built for, 64 or 128; threads:
    the CTA's, 4 x chunk_tile (each warp a pair of row tiles from both
    ends of the chunk and a quarter of p); row_tiles: 16-row tiles
    covering the chunk, the last one masked when chunk % 16 != 0; heads:
    heads per CTA, which share one G = C.B^T (2 where G is cheap, n <= 32;
    else 4); stages: the cp.async ring of xdt and la slices, one head a
    stage."""
    path: str
    chunk_tile: int
    threads: int
    row_tiles: int
    heads: int
    stages: int


@functools.lru_cache(maxsize=64)
def plan(chunk: int, n: int, dtype: torch.dtype) -> Plan:
    """The launch plan of one call at this chunk, state size and dtype."""
    tile = 64 if chunk <= 64 else 128
    return Plan("mma" if dtype == torch.bfloat16 else "fma", tile, 4 * tile,
                -(-chunk // TILE), 2 if n <= 32 else 4, 2)


_fn = None


def _lib():
    """The C entry point, resolved once."""
    global _fn
    if _fn is None:
        from repro_torch.kernels import _build
        fn = _build.load("ssd").repro_ssd_chunk
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, _I64, _I64, _I64, _I64, _I64,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def occupancy(chunk: int, n: int, dtype: torch.dtype) -> int:
    """CTAs of the kernel that fit one SM of the current card at this
    chunk, state size and dtype (the CUDA occupancy query); builds the
    kernel if needed."""
    from repro_torch.kernels import _build
    fn = _build.load("ssd").repro_ssd_ctas_per_sm
    fn.argtypes = [ctypes.c_int, _I64, _I64]
    fn.restype = ctypes.c_int
    blocks = fn(_DTYPES[dtype], chunk, n)
    if blocks < 1:
        raise RuntimeError(f"the occupancy query failed for chunk {chunk}, "
                           f"n {n}, {dtype}")
    return blocks


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
    args = (xdt.data_ptr(), la.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), S.data_ptr(), _DTYPES[xdt.dtype], b * nc, chunk,
            h, p, n)
    if xdt.device.index == torch.cuda.current_device():
        err = _lib()(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(xdt.device):
            err = _lib()(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed: cudaError_t "
                           f"{err} (xdt {tuple(xdt.shape)}, n {n}, chunk "
                           f"{chunk})")
    ssd_chunk.launches += 1
    return y, S


ssd_chunk.launches = 0


def _by_chunk(xdt, la, B, C, chunk: int, rows: int):
    """fp32 (b * nc, rows, ...) views of the inputs, each chunk zero-padded
    from `chunk` to `rows` steps."""
    b, l, h, p = xdt.shape
    n = B.shape[-1]
    pad = rows - chunk
    x = xdt.float().reshape(b * (l // chunk), chunk, h, p)
    lam = la.float().reshape(b * (l // chunk), chunk, h)
    Bz = B.float().reshape(b * (l // chunk), chunk, n)
    Cz = C.float().reshape(b * (l // chunk), chunk, n)
    return [torch.nn.functional.pad(t, (0,) * (2 * t.dim() - 4) + (0, pad))
            for t in (x, lam, Bz, Cz)]


def _split(t: torch.Tensor, low: bool) -> list[torch.Tensor]:
    """An fp32 operand as the bf16 parts the kernel multiplies: the high
    part, then (if `low`) the low part, each widened back to fp32."""
    hi = t.to(torch.bfloat16).float()
    return [hi, (t - hi).to(torch.bfloat16).float()] if low else [hi]


def ssd_chunk_emulated(xdt: torch.Tensor, la: torch.Tensor, B: torch.Tensor,
                       C: torch.Tensor, chunk: int, *, split: bool = True
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """`csrc/ssd.cu`'s tiling in plain PyTorch: y (b, l, h, p) in xdt's
    dtype and S (b, l // chunk, h, p, n) in fp32, as `ssd_chunk`.

    It follows `plan`: the chunk in 16-row tiles, padded to whole tiles
    with the padding masked; y tile by tile over the tiles on or below the
    diagonal only, each M tile G * exp(cum_i - cum_j) with the exponent
    masked at -1e30 above the diagonal and past the chunk; S in 16-step
    slices of the chunk.  On the bf16 path ("mma") M and xdt * w are split
    into a bf16 high and low part and multiplied by the exact bf16 xdt or
    B, two products summed in fp32; `split=False` drops the low part (M
    rounded to bf16 alone, as attention rounds P)."""
    check_args(xdt, la, B, C, chunk)
    b, l, h, p = xdt.shape
    n = B.shape[-1]
    pl = plan(chunk, n, xdt.dtype)
    mma = pl.path == "mma"
    rows = pl.row_tiles * TILE
    x, lam, Bz, Cz = _by_chunk(xdt, la, B, C, chunk, rows)
    cum = torch.cumsum(lam, dim=1)                          # (bc, rows, h)
    G = torch.einsum("bin,bjn->bij", Cz, Bz)
    idx = torch.arange(rows, device=xdt.device)
    y = torch.zeros_like(x)
    for it in range(pl.row_tiles):
        ti = slice(it * TILE, (it + 1) * TILE)
        for kt in range(it + 1):
            tj = slice(kt * TILE, (kt + 1) * TILE)
            keep = (idx[ti, None] >= idx[None, tj]) & (idx[ti, None] < chunk)
            seg = cum[:, ti, None, :] - cum[:, None, tj, :]
            M = G[:, ti, tj, None] * torch.exp(
                torch.where(keep[None, :, :, None], seg,
                            seg.new_tensor(NEG_INF)))
            for part in (_split(M, split) if mma else [M]):
                y[:, ti] += torch.einsum("bijh,bjhp->bihp", part, x[:, tj])
    w = torch.exp(cum[:, chunk - 1:chunk] - cum) * (idx < chunk)[:, None]
    xw = x * w[..., None]
    S = torch.zeros((x.shape[0], h, p, n), device=xdt.device)
    for kt in range(pl.row_tiles):
        tj = slice(kt * TILE, (kt + 1) * TILE)
        for part in (_split(xw[:, tj], split) if mma else [xw[:, tj]]):
            S += torch.einsum("bjhp,bjn->bhpn", part, Bz[:, tj])
    return (y[:, :chunk].reshape(b, l, h, p).to(xdt.dtype),
            S.reshape(b, l // chunk, h, p, n))


def elem_limit(xdt: torch.Tensor, la: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, chunk: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y32, limit) for the bf16 kernel: the plain version in fp32 on the
    same inputs, and ELEM_ULP |y32| + ELEM_SPLIT A per element with
    A = |M|.|xdt| (M the decayed scores of each chunk).

    Rounding y to bf16 moves an element by at most 2^-8 |y|; the hi/lo
    split leaves at most 2^-16 |M_ij| per term of M.xdt, 2^-16 A in all.
    The limit is twice the first and 16 times the second.  Rounding M to
    bf16 alone would leave up to 2^-8 A, which it does not admit."""
    b, l, h, p = xdt.shape
    x, lam, Bz, Cz = _by_chunk(xdt, la, B, C, chunk, chunk)
    y32, _ = ssd_chunked_ref(xdt.float(), la.float(), B.float(), C.float(),
                             chunk)
    A = torch.einsum("bijh,bjhp->bihp",
                     ssd_scores(torch.cumsum(lam, dim=1), Bz, Cz).abs(),
                     x.abs()).reshape(b, l, h, p)
    return y32, ELEM_ULP * y32.abs() + ELEM_SPLIT * A


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
        xdt, la, B, C = (t.detach().requires_grad_()
                         for t in ctx.saved_tensors)
        with torch.enable_grad():
            y, S = ssd_chunked_ref(xdt, la, B, C, ctx.chunk)
            grads = torch.autograd.grad((y, S), (xdt, la, B, C), (gy, gS))
        return (*grads, None)
