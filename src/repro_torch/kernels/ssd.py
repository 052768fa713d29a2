"""The SSD-chunk kernel's wrapper, its plan, its CPU emulation and its
autograd Function.

`ssd_chunk` launches `csrc/ssd.cu` (the Hopper counterpart of the Pallas
kernel `repro/kernels/ssd.py::ssd_chunk`) on CUDA tensors and counts its
launches in `ssd_chunk.launches`.  It never falls back: anything the
kernel does not take raises.  The plain version is `ref.ssd_chunked_ref`;
`ops.ssd_chunk` picks between the two by the tensor's device.

The kernel takes every chunk, head dim p and state size n, as the Pallas
kernel does.  `plan` states the path, tiles, threads, heads per CTA, ring
stages and slices that the kernel derives from the dtype, the chunk, p
and n: a chunk up to 128 with p <= 64 and n <= 128 runs on the first
path ("mma" in bf16, "fma" in f32), whose CTA holds the chunk whole;
anything else on "wide", which tiles the chunk into 64-row blocks, p
and n into slices (`WIDE_*`).  `ssd_chunk_emulated` runs either tiling
in plain PyTorch on any device: on the first path 16-row tiles, the
tiles above the diagonal skipped, the partial last tile masked and, for
bf16, M and xdt * w split into a bf16 high and low part at the kernel's
places; on "wide" its row and column blocks, p and n slices and masked
last block, in fp32.  `elem_limit` is the element-wise bound the bf16
kernel is held to on both.

The launch is the custom op `repro::ssd_chunk` (`ops` says why); its
FLOP formula (`ssd_flops`) counts what the bound counts.

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
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF, ssd_chunked_ref, ssd_scores

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_I64 = ctypes.c_int64
# the first path's CTA holds the chunk whole: it is built for these
FIRST_CHUNK, FIRST_HEAD_DIM, FIRST_STATE = 128, 64, 128
TILE = 16               # rows of one tile of M, y and the S product
# the wide path: rows of a row (and column) block, p columns a y CTA (and
# p rows of an S tile), n columns a slice of G's contraction, n columns of
# an S tile
WIDE_ROWS, WIDE_P, WIDE_N, WIDE_S = 64, 64, 32, 64
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
    two products each), "fma" (fp32 register-tiled CUDA-core FMAs) or
    "wide" (chunk > 128, p > 64 or n > 128, either dtype: fp32 FMAs, bf16
    widened as it is staged); chunk_tile: the chunk length the CTA is
    built for, 64 or 128 (wide: the 64 rows of a row block); threads: the
    CTA's, 4 x chunk_tile (each warp a pair of row tiles from both ends of
    the chunk and a quarter of p; wide: 256, each a 4 x 4 block of a
    64 x 64 tile); row_tiles: 16-row tiles covering the chunk, the last
    one masked when chunk % 16 != 0 (wide: 64-row blocks, the last masked
    when chunk % 64 != 0); heads: heads per CTA, which share one G = C.B^T
    (2 where G is cheap, n <= 32; else 4; wide: 1); stages: the cp.async
    ring of xdt and la slices, one head a stage (wide: 1, no ring);
    p_slices: the 64-column slices of p a row block's y is split over,
    each CTA recomputing G (1 but on wide); n_slices: the 32-column slices
    of n that G's contraction stages (1 but on wide: the first path
    stages n whole)."""
    path: str
    chunk_tile: int
    threads: int
    row_tiles: int
    heads: int
    stages: int
    p_slices: int = 1
    n_slices: int = 1


def first_path(chunk: int, p: int, n: int) -> bool:
    """Whether the first path's CTA is built for this chunk, head dim and
    state size (else the call runs on "wide")."""
    return chunk <= FIRST_CHUNK and p <= FIRST_HEAD_DIM and n <= FIRST_STATE


@functools.lru_cache(maxsize=64)
def plan(chunk: int, n: int, dtype: torch.dtype, p: int = 64) -> Plan:
    """The launch plan of one call at this chunk, state size, dtype and
    head dim p (the default, 64, plans as every p up to it does)."""
    if not first_path(chunk, p, n):
        return Plan("wide", WIDE_ROWS, 256, -(-chunk // WIDE_ROWS), 1, 1,
                    -(-p // WIDE_P), -(-n // WIDE_N))
    tile = 64 if chunk <= 64 else 128
    return Plan("mma" if dtype == torch.bfloat16 else "fma", tile, 4 * tile,
                -(-chunk // TILE), 2 if n <= 32 else 4, 2)


_fn = None


def _lib():
    """The C entry point, resolved once."""
    global _fn
    if _fn is None:
        fn = _build.load("ssd").repro_ssd_chunk
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, _I64, _I64, _I64, _I64, _I64,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def occupancy(chunk: int, n: int, dtype: torch.dtype, p: int = 64) -> int:
    """CTAs of the kernel that fit one SM of the current card at this
    chunk, state size, dtype and head dim (the CUDA occupancy query);
    builds the kernel if needed."""
    fn = _build.load("ssd").repro_ssd_ctas_per_sm
    fn.argtypes = [ctypes.c_int, _I64, _I64, _I64]
    fn.restype = ctypes.c_int
    blocks = fn(_DTYPES[dtype], chunk, p, n)
    if blocks < 1:
        raise RuntimeError(f"the occupancy query failed for chunk {chunk}, "
                           f"p {p}, n {n}, {dtype}")
    return blocks


def check_args(xdt: torch.Tensor, la: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, chunk: int) -> None:
    """Raise on anything the kernel does not take: ranks and shapes, an
    extent of 0, a chunk that does not divide l, dtypes (xdt, B, C of one
    float32/bfloat16 dtype; la float32 or that dtype), devices and
    contiguity.  Every chunk, p and n is taken."""
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
    if not isinstance(chunk, int) or chunk < 1 or l % chunk:
        raise ValueError(f"chunk {chunk!r} must be a positive divisor of "
                         f"l = {l}")
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

    la is read in fp32 (a bfloat16 la is widened first).  One call of the
    custom op `repro::ssd_chunk`: on CUDA tensors it launches the kernel
    on the current stream and does not synchronise (raises if the launch
    is refused); on fake tensors (a dry run's trace, `launch.dryrun`) it
    computes nothing and returns the outputs' shapes and dtypes, and
    counts no launch."""
    check_args(xdt, la, B, C, chunk)
    return _ssd_op(xdt, la.float(), B, C, int(chunk))


def _ssd_launch(xdt: torch.Tensor, la: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The launch: the custom op's real implementation (la in fp32)."""
    if not xdt.is_cuda:
        raise ValueError(f"the ssd_chunk kernel runs on CUDA tensors; got "
                         f"{xdt.device} (ops.ssd_chunk takes the plain "
                         f"version on the CPU)")
    b, l, h, p = xdt.shape
    n = B.shape[-1]
    nc = l // chunk
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


def _ssd_fake(xdt, la, B, C, chunk):
    b, l, h, p = xdt.shape
    return (torch.empty_like(xdt),
            xdt.new_empty((b, l // chunk, h, p, B.shape[-1]),
                          dtype=torch.float32))


_ssd_op = _build.define_op(
    "ssd_chunk(Tensor xdt, Tensor la, Tensor B, Tensor C, int chunk) "
    "-> (Tensor, Tensor)", _ssd_launch, _ssd_fake)


def ssd_flops(xdt_shape, n: int, chunk: int) -> int:
    """The operations of one call that the bound counts: G = C.B^T once
    per chunk (2 cl^2 n), then per head y over the causal pairs (p cl
    (cl + 1)) and S (2 cl p n)."""
    b, l, h, p = xdt_shape
    return b * (l // chunk) * (2 * chunk * chunk * n
                               + h * (p * chunk * (chunk + 1)
                                      + 2 * chunk * p * n))


@register_flop_formula(torch.ops.repro.ssd_chunk)
def _(xdt_shape, la_shape, B_shape, C_shape, chunk, *args, out_shape=None,
      **kwargs) -> int:
    return ssd_flops(xdt_shape, B_shape[-1], chunk)


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
    rounded to bf16 alone, as attention rounds P).  On "wide" it follows
    `_wide_emulated` (`split` does not apply: that path is fp32)."""
    check_args(xdt, la, B, C, chunk)
    b, l, h, p = xdt.shape
    n = B.shape[-1]
    pl = plan(chunk, n, xdt.dtype, p)
    if pl.path == "wide":
        return _wide_emulated(xdt, la, B, C, chunk, pl)
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


def _wide_emulated(xdt, la, B, C, chunk: int, pl: Plan
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The wide path's tiling: the chunk padded to whole 64-row blocks, the
    padding masked; cum a block at a time, each block's scan carried from
    the last row of the one before; for each row block i and p slice, the
    column blocks j <= i, G_ij summed over 32-column slices of n, M_ij =
    G_ij exp(cum_i - cum_j) with the exponent at -1e30 above the diagonal
    and past the chunk, y_i += M_ij xdt_j; S a (64 p x 64 n) tile at a
    time over the row blocks, xdt_j scaled by w_j = exp(cum_end - cum_j).
    All in fp32, y rounded once to xdt's dtype."""
    b, l, h, p = xdt.shape
    n = B.shape[-1]
    R, nrb = WIDE_ROWS, pl.row_tiles
    x, lam, Bz, Cz = _by_chunk(xdt, la, B, C, chunk, nrb * R)
    blocks = [slice(k * R, (k + 1) * R) for k in range(nrb)]
    cum = torch.empty_like(lam)                             # (bc, rows, h)
    carry = torch.zeros_like(lam[:, :1])
    for blk in blocks:
        cum[:, blk] = carry + torch.cumsum(lam[:, blk], dim=1)
        carry = cum[:, blk.stop - 1:blk.stop]
    idx = torch.arange(nrb * R, device=xdt.device)
    y = torch.zeros_like(x)
    for i, ti in enumerate(blocks):
        for tj in blocks[:i + 1]:
            G = sum(torch.einsum("bin,bjn->bij", Cz[:, ti, n0:n0 + WIDE_N],
                                 Bz[:, tj, n0:n0 + WIDE_N])
                    for n0 in range(0, n, WIDE_N))
            keep = (idx[ti, None] >= idx[None, tj]) & (idx[ti, None] < chunk)
            seg = cum[:, ti, None, :] - cum[:, None, tj, :]
            M = G[..., None] * torch.exp(torch.where(
                keep[None, :, :, None], seg, seg.new_tensor(NEG_INF)))
            for p0 in range(0, p, WIDE_P):
                ps = slice(p0, p0 + WIDE_P)
                y[:, ti, :, ps] += torch.einsum("bijh,bjhp->bihp", M,
                                                x[:, tj, :, ps])
    w = torch.exp(carry - cum) * (idx < chunk)[:, None]
    S = torch.zeros((x.shape[0], h, p, n), device=xdt.device)
    for p0 in range(0, p, WIDE_P):
        ps = slice(p0, p0 + WIDE_P)
        for s0 in range(0, n, WIDE_S):
            ns = slice(s0, s0 + WIDE_S)
            for tk in blocks:
                S[:, :, ps, ns] += torch.einsum(
                    "bjhp,bjn->bhpn", x[:, tk, :, ps] * w[:, tk, :, None],
                    Bz[:, tk, ns])
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
