"""The flash-attention kernel's wrapper and its autograd Function.

`flash_attention` launches `csrc/flash_attention.cu` (the Hopper
counterpart of the Pallas kernel `repro/kernels/flash_attention.py::
flash_attention`) on CUDA tensors and counts its launches in
`flash_attention.launches`.  `plan` picks the path from the shapes alone
(bf16 on `wgmma`, everything else on fp32 FMAs) and states the tiles, the
padded head dim and the K/V ring's stages that the kernel derives from
them.  It never falls back: anything the kernel does not take raises.
The plain version is `ref.flash_attention_ref`; `ops.flash_attention`
picks between the two by the tensor's device.

`flash_attention_block` is the same kernel called on one (query block,
key block) tile of ring attention (`core.ring_attention`): the query rows
sit `delta` positions after the key rows (the blocks' global offsets),
the output comes back in fp32 whatever the inputs' dtype, beside the
fp32 log-sum-exp of each row, and a row that the masks admit no key of
the block to is allowed (lse <= -1e29, a finite output: its weight in
the ring's merge is 0).

`FlashAttention` is the differentiable op on the card.  Its forward is the
kernel, which on the `wgmma` path rounds P to bf16 before P.V, as the
Pallas kernel does (`p.astype(v.dtype)`); the plain version keeps P in
fp32, as the reference's jnp oracle does.  Its backward recomputes the
attention through the plain version and differentiates that with
autograd: the TPU kernel is forward-only and the reference differentiates
its jnp attention (`ring_attention._block_attend`), so the gradient is the
same function's.  A backward kernel is later work.  `FlashAttentionBlock`
is the block call's, differentiated in both its outputs.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PATHS = {"fma": 0, "wgmma": 1}
_I64 = ctypes.c_int64
MAX_HEAD_DIM = 256


@dataclasses.dataclass(frozen=True)
class Plan:
    """How `csrc/flash_attention.cu` runs one call, from the shapes alone.

    path: "wgmma" (bf16 on the tensor cores) or "fma" (fp32 on the CUDA
    cores), the one choice passed to the kernel.  The rest states what the
    kernel derives from the path, D and causality, for printing and tests:
    tile_q x tile_k queries x keys per score tile; d_pad: the head dim as
    the kernel stages it (zero columns past D); stages: K/V tiles in shared
    memory; order: "longest-first" (causal: the query tiles that see the
    most keys launch first) or "in-order"."""
    path: str
    tile_q: int
    tile_k: int
    d_pad: int
    stages: int
    order: str


@functools.lru_cache(maxsize=256)
def plan(q_shape, k_shape, dtype: torch.dtype, causal: bool,
         window: int | None) -> Plan:
    """The launch plan for q (B,Sq,Hq,D) against k/v (B,Sk,Hkv,D).

    bf16 with D a multiple of 8 (16-byte rows for the copies) takes
    `wgmma`: 128 queries x 64 keys, D padded to 64 (one swizzle atom; two
    CTAs share an SM), 128 or 256 (two or four atoms; one CTA an SM), a
    2-stage K/V ring.  f32, and bf16 with any other D, take `fma`: 64
    keys a tile, D padded to 64 with a 2-stage ring, to 128 with one stage
    (two do not fit in shared memory), both at 128 queries, or to 256 with
    one stage at 64 queries (128 would not fit either).  The window does
    not change the plan: masks cost only on the tiles they cross."""
    d = q_shape[3]
    d_pad = 64 if d <= 64 else 128 if d <= 128 else 256
    order = "longest-first" if causal else "in-order"
    if dtype == torch.bfloat16 and d % 8 == 0:
        return Plan("wgmma", 128, 64, d_pad, 2, order)
    return Plan("fma", 64 if d_pad == 256 else 128, 64, d_pad,
                2 if d_pad == 64 else 1, order)


_fn = None


def _lib():
    """The C entry point, resolved once."""
    global _fn
    if _fn is None:
        from repro_torch.kernels import _build
        fn = _build.load("flash_attention").repro_flash_attention
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, _I64, _I64, _I64, _I64,
                       _I64, _I64, ctypes.c_float, ctypes.c_float,
                       ctypes.c_int, _I64, ctypes.c_int, _I64,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: int | None, softcap: float | None,
               scale: float | None, block: bool = False) -> None:
    """Raise on anything the kernel does not take: ranks and shapes, GQA
    grouping, dtype, devices, contiguity, head dim > 256, a window below 1,
    a softcap that is not positive, and, unless this is a `block` call
    (which returns each row's lse for a merge), rows that no key is
    admitted to."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention wants q (B,Sq,Hq,D) and k/v "
                         f"(B,Sk,Hkv,D); got ranks {q.dim()}, {k.dim()}, "
                         f"{v.dim()}")
    b, sq, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    sk, hkv = k.shape[1], k.shape[2]
    if min(b, sq, sk, hq, hkv, d) < 1 or hq % hkv:
        raise ValueError(f"q heads {hq} must be a multiple of kv heads "
                         f"{hkv}, and no extent may be 0")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on "
                         f"{v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention wants contiguous q, k and v")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if scale is not None and not math.isfinite(scale):
        raise ValueError(f"scale must be finite, got {scale}")
    if not block and window is not None and sq >= sk + window:
        raise ValueError(f"query rows {sk + window - 1}.. of {sq} see no "
                         f"key (Sk {sk}, window {window})")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window: int | None, softcap: float | None,
            scale: float | None, delta: int, block: bool):
    """One launch of the kernel: o in q's dtype, or with `block` (o in
    fp32, lse (B, Hq, Sq) in fp32)."""
    check_args(q, k, v, window, softcap, scale, block)
    if not q.is_cuda:
        raise ValueError(f"the flash_attention kernel runs on CUDA tensors; "
                         f"got {q.device} (ops.flash_attention takes the "
                         f"plain version on the CPU)")
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    p = plan(tuple(q.shape), tuple(k.shape), q.dtype, causal, window)
    # the kernel's 16-byte copies want 16-byte aligned buffers: a view at
    # an odd offset is copied (the data, not the function, changes nothing)
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty(q.shape, dtype=torch.float32 if block else q.dtype,
                    device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) \
        if block else None
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPES[q.dtype], b, sq, sk, hq, hkv, d, scale, softcap or 0.0,
            int(causal), window if window is not None else 0,
            _PATHS[p.path], int(delta), lse.data_ptr() if block else None)
    if q.device.index == torch.cuda.current_device():
        err = _lib()(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(q.device):
            err = _lib()(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {err} (q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}, delta {delta}, {p})")
    flash_attention.launches += 1
    return (o, lse) if block else o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Attention on the card: q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) ->
    (B,Sq,Hq,D) in q's dtype, as `plan` says.

    Launches on the current stream and does not synchronise; raises if the
    launch is refused."""
    return _launch(q, k, v, causal=causal, window=window, softcap=softcap,
                   scale=scale, delta=0, block=False)


flash_attention.launches = 0


def flash_attention_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, delta: int, causal: bool = True,
                          window: int | None = None,
                          softcap: float | None = None,
                          scale: float | None = None):
    """One tile of ring attention on the card: query row i at position
    i + delta against key j at j -> (o (B,Sq,Hq,D) fp32, lse (B,Hq,Sq)
    fp32), the block's partial softmax normalised by its own sum and the
    log of that sum plus the row max.  Rows that no key of the block is
    admitted to come back with lse <= -1e29 and a finite o.  One launch,
    counted in `flash_attention.launches`."""
    return _launch(q, k, v, causal=causal, window=window, softcap=softcap,
                   scale=scale, delta=delta, block=True)


class FlashAttention(torch.autograd.Function):
    """Differentiable attention on the card: forward through the kernel
    (P rounded to bf16 before P.V on the `wgmma` path, like the Pallas
    kernel), backward by autograd through the plain version (P in fp32),
    recomputed."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window, softcap, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale)
        return flash_attention(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, go):
        from repro_torch.kernels.ref import flash_attention_ref
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            o = flash_attention_ref(q, k, v, **ctx.opts)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), go)
        return dq, dk, dv, None, None, None, None


class FlashAttentionBlock(torch.autograd.Function):
    """Differentiable block call on the card: forward through the kernel
    (`flash_attention_block`), backward by autograd through the plain
    version (`ref.flash_attention_ref(return_lse=True)`), recomputed from
    q, k and v alone, with the gradients of both o and lse: the block's P
    is never kept."""

    @staticmethod
    def forward(ctx, q, k, v, delta: int, causal: bool, window, softcap,
                scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(delta=delta, causal=causal, window=window,
                        softcap=softcap, scale=scale)
        return flash_attention_block(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, go, glse):
        from repro_torch.kernels.ref import flash_attention_ref
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            o, lse = flash_attention_ref(q, k, v, return_lse=True,
                                         **ctx.opts)
            outs, grads = zip(*[(t, g) for t, g in ((o, go), (lse, glse))
                                if g is not None])
            dq, dk, dv = torch.autograd.grad(outs, (q, k, v), grads)
        return dq, dk, dv, None, None, None, None, None


_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
_NEG_BIG = -1e30


def flash_attention_emulated(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int | None = None,
                             softcap: float | None = None,
                             scale: float | None = None, delta: int = 0,
                             return_lse: bool = False):
    """`csrc/flash_attention.cu`'s tiling in plain PyTorch (any device;
    meant for the CPU): q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) -> (B,Sq,Hq,D) in
    q's dtype, as `flash_attention`; with `delta` (query row i at position
    i + delta) and `return_lse`, (o in fp32, lse (B,Hq,Sq) in fp32), as
    `flash_attention_block`.

    It follows `plan`: query tiles of tile_q rows, longest first under
    causality (each written once; a tile left unwritten stays NaN), each
    walking its key tiles of tile_k keys from the first one the window
    admits to the last one causality admits, both shifted by `delta` (a
    tile that no key is admitted to walks none: m stays -1e30, l 0, o 0).
    Per key tile: S = Q.K^T in
    fp32; logits in log2 units, the softcap applied first, and on the
    tiles that a diagonal, a window edge or the end of Sk crosses the
    masked ones at -1e30 (keys past Sk, which add exactly 0 in the
    kernel, are left out); the fp32 running max m
    and sum l rescaled by 2^(m_old - m_new), as is the accumulator; on the
    `wgmma` path P rounded to bf16 before P.V (l sums it in fp32).  At the
    end l is clamped at 1e-30, the output rounded once to q's dtype (kept
    in fp32 with `return_lse`) and lse = (m + log2 l) ln 2."""
    check_args(q, k, v, window, softcap, scale, block=return_lse)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    p = plan(tuple(q.shape), tuple(k.shape), q.dtype, causal, window)
    bq, bk = p.tile_q, p.tile_k
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    # (B, Hkv, G, S, D) and (B, Hkv, S, D) in fp32 (bf16 is exact in it)
    qf = q.float().reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    o = torch.full((b, hkv, g, sq, d), float("nan"),
                   dtype=torch.float32 if return_lse else q.dtype,
                   device=q.device)
    lse = torch.full((b, hkv, g, sq), float("nan"), device=q.device)
    tiles_q = -(-sq // bq)
    order = range(tiles_q - 1, -1, -1) if causal else range(tiles_q)
    for qt in order:
        q0 = qt * bq
        q_last = min(q0 + bq - 1, sq - 1)
        k_lo, k_hi = 0, sk - 1
        if causal:
            k_hi = min(k_hi, q_last + delta)
        if window is not None:
            k_lo = max(k_lo, q0 + delta - window + 1)
        qpos = torch.arange(q0, q_last + 1, device=q.device)[:, None] + delta
        m = torch.full((b, hkv, g, q_last + 1 - q0), _NEG_BIG * _LOG2E,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(m.shape + (d,), device=q.device)
        for kt in range(k_lo // bk, k_hi // bk + 1 if k_hi >= k_lo else 0):
            k0 = kt * bk
            k1 = min(k0 + bk, sk)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qf[:, :, :, q0:q_last + 1],
                             kf[:, :, k0:k1])
            edge = k0 + bk > sk or (causal and k0 + bk - 1 > q0 + delta) \
                or (window is not None and q_last + delta - k0 >= window)
            if softcap or edge:
                x = s * scale
                if softcap:
                    x = softcap * torch.tanh(x / softcap)
                kpos = torch.arange(k0, k1, device=q.device)[None, :]
                keep = torch.ones_like(kpos - qpos, dtype=torch.bool)
                if causal:
                    keep &= qpos >= kpos
                if window is not None:
                    keep &= (qpos - kpos) < window
                x = torch.where(keep, x * _LOG2E, x.new_tensor(
                    _NEG_BIG * _LOG2E))
            else:
                x = s * (scale * _LOG2E)
            m_new = torch.maximum(m, x.amax(-1))
            corr = torch.exp2(m - m_new)
            pt = torch.exp2(x - m_new[..., None])
            l = l * corr + pt.sum(-1)
            if p.path == "wgmma":
                pt = pt.to(torch.bfloat16).float()
            vt = vf[:, :, k0:k1]
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", pt, vt)
            m = m_new
        lc = l.clamp_min(1e-30)
        o[:, :, :, q0:q_last + 1] = (acc / lc[..., None]).to(o.dtype)
        lse[:, :, :, q0:q_last + 1] = (m + torch.log2(lc)) * _LN2
    o = o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    if return_lse:
        return o, lse.reshape(b, hq, sq)
    return o
