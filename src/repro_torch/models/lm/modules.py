"""Transformer/SSM building blocks, port of `repro.models.lm.modules`.

Parameters are plain dicts of tensors with the reference's names; every
function takes them as its first argument, as the reference does.
Attention goes through `core.ring_attention` (the flash-attention kernel
on the card) and the SSD's intra-chunk pass through `kernels.ops.
ssd_chunk` (the SSD-chunk kernel on the card).  `ssm_decode_step` is the
one-token recurrence that decoding runs in place of the chunked scan, and
`ShardCtx` says how the sequence is split over the mesh: for training
and prefill, attention runs as the ring over the sequence shards
(`core.ring_attention`) and the SSD block as its sharded form (the
conv's (k-1)-row halo, a local pass from zero state, the state entering
the shard by `core.seq_ssm.seq_prefix_state`); for a decode step, the KV
cache is split (`core.decode_attention`).  MoE, encoder and
cross-attention wait for their slices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core import collectives
from repro_torch.core.halo import halo_exchange
from repro_torch.core.ring_attention import ring_attention
from repro_torch.core.seq_ssm import seq_prefix_state
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.lm.config import LMConfig


# ---------------------------------------------------------------------------
# context: where the model is sharded
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """The mesh (`launch.mesh.Mesh`, None for one device), the axis (a
    name or a tuple of names, ranked major-to-minor) that splits the
    sequence, the axes that split the batch, and the axis that splits the
    experts of a MoE layer (`tp_axis`: each rank holds its block of E,
    `launch.shardings.expert_blocks`; None keeps every expert on every
    rank).  The reference's `unroll` serves its dry-run probes, which are
    not ported."""
    mesh: Any = None
    seq_axis: str | tuple[str, ...] | None = None
    batch_axes: tuple[str, ...] = ()
    tp_axis: str | None = None

    @property
    def seq_size(self) -> int:
        if self.mesh is None or self.seq_axis is None:
            return 1
        return self.mesh.axis_size(self.seq_axis)

    @property
    def seq_index(self) -> int:
        """This rank's shard index along the sequence axis."""
        return 0 if self.seq_size == 1 else self.mesh.index(self.seq_axis)

    @property
    def sharded(self) -> bool:
        """Whether the sequence is split over more than one shard."""
        return self.seq_size > 1


def normal_init(gen: torch.Generator, shape, scale: float, device):
    """N(0, scale^2) in fp32 drawn from `gen` (on the generator's device),
    placed on `device`."""
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(cfg: LMConfig, d: int, device=None) -> torch.Tensor:
    if cfg.norm == "nonparam_ln":        # olmo: no learnable affine
        return torch.zeros((0,), device=device)
    return torch.ones((d,), device=device)


def norm_apply(cfg: LMConfig, w: torch.Tensor, x: torch.Tensor
               ) -> torch.Tensor:
    """rmsnorm / layernorm / non-parametric layernorm over the last dim, in
    fp32, returned in x's dtype."""
    xf = x.float()
    if cfg.norm == "rmsnorm":
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6)
        return (y * w).to(x.dtype)
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + 1e-5)
    if cfg.norm == "layernorm":
        y = y * w
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (S,) or (B, S)."""
    d = x.shape[-1]
    freqs = torch.exp(-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / d))
    if positions.dim() == 1:
        ang = positions[:, None].float() * freqs[None, :]
        ang = ang[None, :, None, :]                      # (1, S, 1, D/2)
    else:
        ang = positions[..., None].float() * freqs
        ang = ang[:, :, None, :]                         # (B, S, 1, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attn_init(gen: torch.Generator, cfg: LMConfig, device) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sc = 1.0 / math.sqrt(d)
    p = {"wq": normal_init(gen, (d, hq * hd), sc, device),
         "wk": normal_init(gen, (d, hkv * hd), sc, device),
         "wv": normal_init(gen, (d, hkv * hd), sc, device),
         "wo": normal_init(gen, (hq * hd, d), 1.0 / math.sqrt(hq * hd),
                           device)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq * hd,), device=device)
        p["bk"] = torch.zeros((hkv * hd,), device=device)
        p["bv"] = torch.zeros((hkv * hd,), device=device)
    return p


def attn_qkv(p: dict, cfg: LMConfig, x: torch.Tensor,
             positions: torch.Tensor, rope_on: bool = True):
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if rope_on:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_apply(p: dict, x: torch.Tensor, *, cfg: LMConfig,
               positions: torch.Tensor, window: int | None,
               causal: bool = True, return_kv: bool = False,
               ctx: ShardCtx = ShardCtx()):
    """Self-attention of x (B, S, d): on one device, or with the sequence
    split under `ctx` (x, `positions` and the result this rank's block;
    the ring).  With `return_kv` also its (k, v), rotated, (B, S, Hkv, hd)
    each: what a KV cache holds (this rank's block)."""
    q, k, v = attn_qkv(p, cfg, x, positions)
    scale = cfg.attn_scale or 1.0 / math.sqrt(cfg.head_dim)
    o = ring_attention(q, k, v, mesh=ctx.mesh, seq_axis=ctx.seq_axis,
                       scale=scale, causal=causal, window=window,
                       softcap=cfg.attn_softcap)
    b, s = x.shape[:2]
    out = o.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# MLP / MoE
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: LMConfig, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    sc_in, sc_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"wi": normal_init(gen, (d, f), sc_in, device)}
    if cfg.mlp in ("swiglu", "geglu"):
        p["wg"] = normal_init(gen, (d, f), sc_in, device)
    p["wo"] = normal_init(gen, (f, d), sc_out, device)
    return p


def mlp_apply(p: dict, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    h = x @ p["wi"]
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["wg"]) * h
    elif cfg.mlp == "geglu":
        h = F.gelu(x @ p["wg"], approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["wo"]


def moe_init(gen: torch.Generator, cfg: LMConfig, device) -> dict:
    """The router (d, e), always fp32, and the experts' `wi`, `wg` (e, d,
    f) and `wo` (e, f, d)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    sc_in, sc_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    return {"router": normal_init(gen, (d, e), sc_in, device),
            "wi": normal_init(gen, (e, d, f), sc_in, device),
            "wg": normal_init(gen, (e, d, f), sc_in, device),
            "wo": normal_init(gen, (e, f, d), sc_out, device)}


MOE_GROUP = 256      # tokens per routing group (GShard "group" dimension)


@dataclasses.dataclass
class Routing:
    """One MoE layer's routing of this rank's tokens (b, s): each token's
    `k` experts `idx` and renormalised gates `gate` (b, s, k), the gap
    between its k-th and (k+1)-th router probability (`margin`, (b, s):
    how near its choice is to a tie), each (token, choice) pair's `slot`
    in its expert's buffer of its group and whether it is kept (`slot <
    cap`), the group of each token counted from this rank's first
    (`group`, (s,)), the number of groups this rank touches, the group
    size and the capacity."""
    idx: torch.Tensor
    gate: torch.Tensor
    margin: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    group: torch.Tensor
    n_groups: int
    gs: int
    cap: int


def moe_route(router: torch.Tensor, x: torch.Tensor, cfg: LMConfig,
              ctx: ShardCtx = ShardCtx()) -> Routing:
    """The reference's routing: groups of gs = min(S, MOE_GROUP)
    consecutive positions of the global sequence S (this rank's x is its
    block under `ctx`), fp32 router logits (a bf16 router is used as its
    rounded value) and softmax, top-k gates renormalised by max(sum,
    1e-9), cap = max(1, int(capacity_factor * k * gs / e)), and each
    (token, choice) pair's slot its expert's running count over the
    group's pairs in token-major, choice-minor order: where a group spans
    sequence shards, this rank's counts start from those of the group's
    earlier shards (an exclusive prefix over the sequence axis)."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    seq = s * ctx.seq_size
    gs = min(seq, MOE_GROUP)
    if seq % gs:
        raise ValueError(f"MoE: sequence {seq} is not a multiple of the "
                         f"routing group {gs} (MOE_GROUP {MOE_GROUP})")
    cap = max(1, int(cfg.capacity_factor * k * gs / e))
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    # one top-(k+1): its first k are the choices, the last the runner-up
    top, idx = torch.topk(probs, min(k + 1, e), dim=-1)
    gate, idx = top[..., :k], idx[..., :k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    with torch.no_grad():
        margin = top[..., k - 1] - top[..., k] if k < e \
            else torch.full_like(top[..., 0], math.inf)
        off = ctx.seq_index * s
        group = (off + torch.arange(s, device=x.device)) // gs - off // gs
        n_groups = (off + s - 1) // gs - off // gs + 1
        oh = F.one_hot(idx, e)                                # (b,s,k,e)
        inc = oh.reshape(b, s * k, e).cumsum(1).reshape(b, s, k, e)
        cnt = oh.new_zeros((b, n_groups, e)).index_add_(1, group, oh.sum(2))
        base = cnt.cumsum(1) - cnt            # this rank's earlier tokens
        if ctx.sharded and s % gs:
            base = base - _group_prefix(cnt, off // gs, seq // gs, ctx)
        slot = ((inc - base[:, group, None]) * oh).sum(-1) - 1   # (b,s,k)
    return Routing(idx, gate, margin, slot, slot < cap, group, n_groups,
                   gs, cap)


def _group_prefix(cnt: torch.Tensor, g0: int, n_global: int,
                  ctx: ShardCtx) -> torch.Tensor:
    """Each of this rank's groups' per-expert pair counts on the earlier
    shards of the sequence axis: cnt (b, n, e) are this rank's counts of
    the global groups g0 .. g0+n-1 of n_global."""
    b, n, e = cnt.shape
    mine = cnt.new_zeros((1, b, n_global, e))
    mine[0, :, g0:g0 + n] = cnt
    every = ctx.mesh.all_gather(mine, ctx.seq_axis, 0)   # (P, b, G, e)
    before = every[:ctx.seq_index].sum(0)
    return before[:, g0:g0 + n]


def _ep_size(ctx: ShardCtx, e: int) -> int:
    """The number of expert blocks: the size of `ctx.tp_axis` where it
    divides the expert count (the reference's condition), else 1."""
    if ctx.mesh is None or ctx.tp_axis is None:
        return 1
    n = ctx.mesh.axis_size(ctx.tp_axis)
    return n if e % n == 0 else 1


def moe_apply(p: dict, x: torch.Tensor, cfg: LMConfig,
              ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    """The reference's `moe_apply` on x (b, s, d), this rank's block
    under `ctx`.  The kept pairs' tokens are copied into the experts'
    capacity buffers (e, b * groups * cap, d), the experts run as batched
    products over them, and each token sums its kept outputs weighted by
    its gates (cast to x's dtype): the reference's one-hot dispatch and
    combine as an index copy and an index add over the kept slots.  A
    dropped pair adds nothing.  With `ctx.tp_axis` splitting the experts
    (p's expert leaves this rank's block of E), the buffers go to the
    ranks that own their experts and come back by all-to-all on that
    axis; the groups must not span sequence shards there."""
    b, s, d = x.shape
    e = cfg.n_experts
    r = moe_route(p["router"], x, cfg, ctx)
    n_ep = _ep_size(ctx, e)
    if p["wi"].shape[0] * n_ep != e:
        raise ValueError(f"MoE: {p['wi'].shape[0]} experts held on {n_ep} "
                         f"expert block(s), {e} wanted")
    if n_ep > 1 and ctx.sharded and s % r.gs:
        raise NotImplementedError(
            f"MoE expert parallelism with routing groups ({r.gs}) that span "
            f"sequence shards ({s} tokens a rank)")
    nb = b * r.n_groups * r.cap                 # one expert's buffer rows
    kb, kt, kc = r.keep.nonzero(as_tuple=True)  # token-major, choice-minor
    dest = r.idx[kb, kt, kc] * nb \
        + (kb * r.n_groups + r.group[kt]) * r.cap + r.slot[kb, kt, kc]
    tok = kb * s + kt
    xs = x.reshape(b * s, d).index_select(0, tok)
    xe = x.new_zeros((e * nb, d)).index_copy(0, dest, xs).view(e, nb, d)
    if n_ep > 1:        # (e, nb, d) -> this rank's experts' (e/P, P nb, d)
        xe = collectives.all_to_all(xe, ctx.mesh, ctx.tp_axis, 0, 1,
                                    name="moe_dispatch")
    h = torch.bmm(xe, p["wi"])
    if cfg.mlp == "swiglu":
        h = F.silu(torch.bmm(xe, p["wg"])) * h
    elif cfg.mlp == "geglu":
        h = F.gelu(torch.bmm(xe, p["wg"]), approximate="tanh") * h
    ye = torch.bmm(h, p["wo"])
    if n_ep > 1:
        ye = collectives.all_to_all(ye, ctx.mesh, ctx.tp_axis, 1, 0,
                                    name="moe_combine")
    ys = ye.reshape(e * nb, d).index_select(0, dest) \
        * r.gate[kb, kt, kc].to(x.dtype)[:, None]
    return x.new_zeros((b * s, d)).index_add(0, tok, ys).view(b, s, d)


# ---------------------------------------------------------------------------
# SSD (mamba2) — chunked state-space duality
# ---------------------------------------------------------------------------

def ssm_init(gen: torch.Generator, cfg: LMConfig, device) -> dict:
    d, di, ds, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * ds
    return {
        "in_proj": normal_init(gen, (d, 2 * di + 2 * ds + h),
                               1.0 / math.sqrt(d), device),
        "conv_w": normal_init(gen, (cfg.ssm_conv, conv_dim),
                              1.0 / math.sqrt(cfg.ssm_conv), device),
        "conv_b": torch.zeros((conv_dim,), device=device),
        "dt_bias": torch.zeros((h,), device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=device)),
        "D": torch.ones((h,), device=device),
        "gate_norm": torch.ones((di,), device=device),
        "out_proj": normal_init(gen, (di, d), 1.0 / math.sqrt(di), device),
    }


def _ssd_chunked(xdt: torch.Tensor, la: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, chunk: int, h0: torch.Tensor | None = None):
    """Exact chunked SSD scan.

    xdt: (b, l, h, p) dt-scaled inputs; la: (b, l, h) log-decay; B, C:
    (b, l, n); h0: optional initial state (b, h, p, n).  Returns y
    (b, l, h, p) and h_final (b, h, p, n) in fp32.

    The intra-chunk pass and the chunk summaries are `ops.ssd_chunk` (the
    kernel on the card); the inter-chunk recurrence over the chunks and
    the inflowing-state term stay in PyTorch, as they stay in jnp in the
    reference.
    """
    b, l, h, p = xdt.shape
    n = B.shape[-1]
    chunk = min(chunk, l)
    while l % chunk:            # largest divisor of l not exceeding `chunk`
        chunk -= 1
    nc = l // chunk
    y, S = ops.ssd_chunk(xdt, la, B, C, chunk=chunk)   # S: (b,nc,h,p,n) f32
    cum = torch.cumsum(la.reshape(b, nc, chunk, h), dim=2)   # (b,nc,cl,h)
    h_in, h_fin = inter_chunk_states(cum[:, :, -1, :], S, h0)

    # inflowing-state contribution to each position
    Cz = C.reshape(b, nc, chunk, n)
    y_inter = torch.einsum("bzin,bzhpn->bzihp", Cz, h_in.to(xdt.dtype)) \
        * torch.exp(cum).to(xdt.dtype)[..., None]
    y = (y.reshape(b, nc, chunk, h, p) + y_inter).reshape(b, l, h, p)
    return y, h_fin


def inter_chunk_states(log_a: torch.Tensor, S: torch.Tensor,
                       h0: torch.Tensor | None = None):
    """The recurrence over chunks, h_z = h_{z-1} * a[z-1] + S[z-1] from
    h_0 = h0 (zeros if None), in closed form.

    log_a: (b, nc, h) each chunk's log total decay (not its exp: the log
    of an underflowed decay would be -inf, and -inf - -inf is NaN); S:
    (b, nc, h, p, n) each chunk's zero-inflow state.  Returns the inflowing
    states (b, nc, h, p, n) and the final state (b, h, p, n), in fp32.

    With h0 taken as a chunk -1, the state after z chunks is
    sum_k L[z, k] S'[k] with L[z, k] = exp(sum_{k <= m < z} log_a[m]) for
    k <= z (Mamba-2's segment sum): one product instead of the
    reference's `lax.scan`.  Each exponent is a cumulative sum over its
    own segment's chunks, not a difference of two long prefix sums, which
    would cancel in fp32; the exponent, not the result, is masked above
    the diagonal, so the backward sees no 0 * inf."""
    b, nc, h, p, n = S.shape
    init = torch.zeros((b, 1, h, p, n), dtype=torch.float32,
                       device=S.device) if h0 is None \
        else h0.float()[:, None]
    Sx = torch.cat([init, S.float()], dim=1)                 # (b,nc+1,h,p,n)
    # x[t] = log_a[t - 1]: the decay from chunk t-1 into chunk t
    x = F.pad(log_a.float().transpose(1, 2), (1, 0))         # (b, h, nc+1)
    lower = torch.ones((nc + 1, nc + 1), dtype=torch.bool,
                       device=S.device).tril()
    # seg[z, k] = sum of x[t] over k < t <= z
    seg = torch.cumsum(x[..., :, None].masked_fill(~lower.tril(-1), 0.0),
                       dim=-2)
    L = torch.exp(torch.where(lower, seg, seg.new_tensor(NEG_INF)))
    states = torch.einsum("bhzk,bkhpn->bzhpn", L, Sx)
    return states[:, :nc], states[:, nc]


def _causal_depthwise_conv(xp: torch.Tensor, w: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """xp: (b, k-1+l, c), the sequence after its k-1 preceding rows (zeros
    before the sequence, the reference's left-padded windows, or the
    predecessor shard's tail); w: (k, c): y_t = sum_i w_i * xp_{t+i} +
    bias, (b, l, c)."""
    k = w.shape[0]
    l = xp.shape[1] - (k - 1)
    y = xp[:, 0:l] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + l] * w[i]
    return y + bias


def _ssd_local(x: torch.Tensor, p: dict, cfg: LMConfig,
               ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    """The SSD block body on this rank's block x (b, l, d): the whole
    sequence, or its shard under `ctx`."""
    b, l, d = x.shape
    di, ds, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    zxbcdt = x @ p["in_proj"]
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * ds, h], dim=-1)

    # depthwise causal conv over the sequence (plain PyTorch: no TPU
    # kernel of the reference computes it); under sequence sharding the
    # (ssm_conv - 1)-row tail of the predecessor shard is a literal halo
    k = cfg.ssm_conv
    xbc_pad = halo_exchange(xbc, 1, k - 1, 0, ctx.seq_axis, ctx.mesh) \
        if ctx.sharded else F.pad(xbc, (0, 0, k - 1, 0))
    xbc = F.silu(_causal_depthwise_conv(xbc_pad, p["conv_w"], p["conv_b"]))

    xin, B, C = torch.split(xbc, [di, ds, ds], dim=-1)
    xin = xin.reshape(b, l, h, cfg.ssm_head_dim)
    dt = F.softplus(dt.float() + p["dt_bias"])                # (b,l,h)
    A = -torch.exp(p["A_log"])
    la = dt * A                                               # log decay
    xdt = xin * dt[..., None].to(xin.dtype)

    B, C = B.contiguous(), C.contiguous()
    if not ctx.sharded:
        y, _ = _ssd_chunked(xdt, la, B, C, cfg.ssm_chunk)
    else:
        # local pass from zero state -> the shard's (decay, state) summary
        # -> the state entering it (the boundary halo) and its term
        y, s_loc = _ssd_chunked(xdt, la, B, C, cfg.ssm_chunk)
        cum = torch.cumsum(la, dim=1)                         # (b, l, h)
        a_tot = torch.exp(cum[:, -1])[:, :, None, None]       # (b, h, 1, 1)
        h_in = seq_prefix_state(a_tot, s_loc, ctx.seq_axis, ctx.mesh)
        y_in = torch.einsum("bln,bhpn->blhp", C, h_in.to(xdt.dtype)) \
            * torch.exp(cum).to(xdt.dtype)[..., None]
        y = y + y_in

    y = y + p["D"][None, None, :, None].to(y.dtype) * xin
    y = y.reshape(b, l, di)
    y = y * F.silu(z)
    yf = y.float()
    y = (yf * torch.rsqrt(yf.square().mean(-1, keepdim=True) + 1e-6)
         * p["gate_norm"]).to(x.dtype)
    return y @ p["out_proj"]


def ssm_apply(p: dict, x: torch.Tensor, cfg: LMConfig,
              ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    """The SSD block: on one device, or on this rank's block of the
    sequence under `ctx` (the reference's `ssm_apply`)."""
    return _ssd_local(x, p, cfg, ctx)


def ssm_decode_step(p: dict, x: torch.Tensor, cfg: LMConfig,
                    state: torch.Tensor, conv_buf: torch.Tensor):
    """One-token SSD update, the recurrence the chunked scan sums in
    closed form.  x: (b, 1, d); state: (b, h, p, n) fp32; conv_buf:
    (b, k-1, conv_dim), the previous k-1 inputs of the causal conv.
    Returns (the block's output (b, 1, d), the new state, the new
    buffer), new tensors."""
    b = x.shape[0]
    di, ds, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    zxbcdt = x[:, 0] @ p["in_proj"]
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * ds, h], dim=-1)
    win = torch.cat([conv_buf, xbc[:, None]], dim=1)     # (b, k, conv)
    new_buf = win[:, 1:]
    xbc = F.silu(torch.einsum("bkc,kc->bc", win, p["conv_w"])
                 + p["conv_b"])
    xin, B, C = torch.split(xbc, [di, ds, ds], dim=-1)
    xin = xin.reshape(b, h, cfg.ssm_head_dim)
    dt = F.softplus(dt.float() + p["dt_bias"])                # (b, h)
    a = torch.exp(dt * -torch.exp(p["A_log"]))                # (b, h)
    xdt = xin * dt[..., None].to(xin.dtype)
    state = state * a[..., None, None] \
        + torch.einsum("bhp,bn->bhpn", xdt, B).float()
    y = torch.einsum("bhpn,bn->bhp", state.to(xin.dtype), C)
    y = y + p["D"][None, :, None].to(y.dtype) * xin
    y = y.reshape(b, di) * F.silu(z)
    yf = y.float()
    y = (yf * torch.rsqrt(yf.square().mean(-1, keepdim=True) + 1e-6)
         * p["gate_norm"]).to(x.dtype)
    return (y @ p["out_proj"])[:, None], state, new_buf.contiguous()
