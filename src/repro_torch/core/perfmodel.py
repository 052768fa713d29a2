"""Performance model for parallel CNN/transformer training (paper §V), port
of `repro.core.perfmodel` (the same functions and numbers; the TPU preset
is replaced by an `H100` one).

Structure mirrors the paper exactly:

  * compute: C(n,c,h,w,f), Cw(...), Cx(...) — per-layer local runtimes.  The
    paper times cuDNN empirically; we use an analytic FLOP/byte roofline with
    a calibratable efficiency term, plus an `EmpiricalTable` hook so measured
    timings (the paper's method) can be dropped in when hardware is at hand.
  * communication: linear α-β model (§II-B); collectives per Thakur et al. —
    the allreduce picks the min over ring / recursive-doubling / Rabenseifner
    exactly like MPICH's size-based algorithm selection.
  * layer cost (§V-A):  Cost_D(ℓ) = FP + BPx + BPw + BPa, with halo SR terms
    when H/W are partitioned and overlap adjustments (§IV-A).
  * network cost (§V-B): Σ layer costs + Shuffle(D_i, D_j) redistribution on
    distribution changes + greedy one-at-a-time allreduce/backprop overlap.

Units: seconds, bytes, FLOPs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

from repro_torch.core.distribution import Dist
from repro_torch.utils import cdiv, human_bytes, same_pads


# ---------------------------------------------------------------------------
# machines
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Machine:
    name: str
    peak_flops: float          # per device, training dtype
    mem_bw: float              # HBM bytes/s
    alpha: float               # p2p latency, s (halo-scale messages)
    beta: float                # p2p inverse bandwidth, s/byte (per link)
    alpha_coll: float          # latency for collective steps
    beta_coll: float           # inverse bandwidth on the allreduce fabric
    wordsize: int = 4
    # fraction of peak a well-shaped conv/matmul reaches; the calibration
    # hook (EmpiricalTable / calibrate_efficiency) can override per layer.
    compute_efficiency: float = 0.55
    # half-performance work (FLOPs): achieved efficiency for a kernel with
    # local work `fl` is eff·fl/(fl + eff_halfwork) — the empirical
    # small-kernel saturation the paper captures by measuring cuDNN
    # directly ("local convolution kernels not scaling linearly", §VI-B1).
    eff_halfwork: float = 0.0
    # per-device memory capacity in bytes (0 = unknown/unlimited).  The
    # planning layers treat this as the §VI Table-2 forcing function:
    # sample parallelism cannot reduce per-device activations below one
    # sample, so large-sample workloads are *unreachable* without the
    # spatial/hybrid decompositions a capacity-constrained solve picks.
    mem_capacity: float = 0.0
    # achieved-overlap efficiency η ∈ [0, 1] (§IV-A latency hiding): the
    # fraction of min(comm, compute) the interior/boundary schedule really
    # hides on this machine, fitted by core.calibrate from interleaved
    # overlapped-vs-serialized microbenchmarks.  The analytic default 1.0
    # reproduces the paper's full credit max(comm, compute); η = 0 degrades
    # to fully serialized, so the solver is never rewarded for overlap the
    # hardware cannot deliver.
    overlap_eta: float = 1.0
    # composition correction factors, fitted by core.calibrate from fused
    # microbenchmarks (the 4–13× model/measured gap on the composed
    # workloads lives in exactly these terms).  All default to 1.0 (pure
    # analytic model).  They scale priced *seconds* only, never payload
    # bytes, so the static collective auditor is unaffected.
    #   composed_cf_factor: CF data collectives executing inside a halo'd
    #     spatial block (CF × spatial shard_maps) vs the standalone α-β fit.
    #   composed_halo_factor: product-axis halo exchange with its
    #     boundary-crossing hops vs the single-axis p2p fit.
    #   shuffle_factor: §III-C all-to-all reshard vs the analytic pairwise
    #     model, used when no measured `shuffle:` table entry is near.
    composed_cf_factor: float = 1.0
    composed_halo_factor: float = 1.0
    shuffle_factor: float = 1.0


# Lassen (paper's machine): V100 fp32 ~15.7 TF; NVLINK2 ~150 GB/s/dir
# on-node, dual-rail EDR IB ~ 2x12.5 GB/s across nodes.  Halo exchanges in
# the paper's large runs cross nodes (8/16-way spatial), so p2p constants
# use the IB path; allreduces are NCCL ring across everything (IB-bound).
LASSEN = Machine("lassen-v100", peak_flops=15.7e12, mem_bw=900e9,
                 alpha=4.0e-6, beta=1 / 21.0e9,
                 alpha_coll=6.0e-6, beta_coll=1 / 21.0e9, wordsize=4,
                 compute_efficiency=0.50, mem_capacity=16e9)

# H100 SXM5 80 GB (the port's card): NVIDIA's published data-sheet values,
# not measured — fp32 67 TFLOP/s outside the tensor cores (the CNNs train
# in FP32), 3.35 TB/s HBM3, NVLink 450 GB/s a direction, 80 GB.  The data
# sheet gives no latencies: alpha and alpha_coll are Lassen's.  A
# calibration on the card (core.calibrate, not ported yet) replaces them.
H100 = Machine("h100-sxm5", peak_flops=67e12, mem_bw=3.35e12,
               alpha=4.0e-6, beta=1 / 450.0e9,
               alpha_coll=6.0e-6, beta_coll=1 / 450.0e9, wordsize=4,
               mem_capacity=80e9)


# ---------------------------------------------------------------------------
# communication (paper §II-B; Thakur et al. collectives)
# ---------------------------------------------------------------------------

def sr_time(m: Machine, nbytes: float, hops: int = 1) -> float:
    """SR(n): send+receive n bytes between two processors (full duplex).

    `hops`: link hops the message traverses.  1 for torus neighbors; a
    spatial dim split over a *product* of mesh axes (core.halo) pays more —
    the boundary-crossing sends of the linearized neighbor pattern travel
    across the outer torus dimension — so callers pass the number of axes
    in the product.  Latency scales with hops; bandwidth stays per-link
    (wormhole routing)."""
    if nbytes <= 0:
        return 0.0
    return max(hops, 1) * m.alpha + m.beta * nbytes


def allreduce_time(m: Machine, p: int, nbytes: float) -> float:
    """AR(p, n): MPICH-style min over candidate algorithms (Thakur et al.)."""
    if p <= 1 or nbytes <= 0:
        return 0.0
    lg = math.log2(p)
    ring = 2 * (p - 1) * m.alpha_coll + 2 * (p - 1) / p * nbytes * m.beta_coll
    rec_dbl = math.ceil(lg) * (m.alpha_coll + nbytes * m.beta_coll)
    rabens = 2 * math.ceil(lg) * m.alpha_coll \
        + 2 * (p - 1) / p * nbytes * m.beta_coll
    return min(ring, rec_dbl, rabens)


def reduce_scatter_time(m: Machine, p: int, nbytes: float) -> float:
    if p <= 1 or nbytes <= 0:
        return 0.0
    return (p - 1) * m.alpha_coll + (p - 1) / p * nbytes * m.beta_coll


def all_gather_time(m: Machine, p: int, nbytes: float) -> float:
    return reduce_scatter_time(m, p, nbytes)


def all_to_all_time(m: Machine, p: int, nbytes_local: float) -> float:
    """Each processor exchanges its local block with everyone (pairwise)."""
    if p <= 1 or nbytes_local <= 0:
        return 0.0
    return (p - 1) * m.alpha + (p - 1) / p * nbytes_local * m.beta


# ---------------------------------------------------------------------------
# layer specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """One conv (or conv-like) layer: N samples, C->F channels, HxW, KxK/S."""
    name: str
    n: int; c: int; h: int; w: int; f: int
    k: int = 3
    s: int = 1
    kind: str = "conv"           # conv | pool | fc(=1x1 on 1x1) | bn ...

    @property
    def h_out(self) -> int: return cdiv(self.h, self.s)
    @property
    def w_out(self) -> int: return cdiv(self.w, self.s)
    @property
    def o(self) -> int: return self.k // 2

    def flops_fwd(self) -> float:
        if self.kind == "pool":
            return self.n * self.f * self.h_out * self.w_out * self.k ** 2
        return 2.0 * self.n * self.c * self.h_out * self.w_out \
            * self.k ** 2 * self.f

    def weight_words(self) -> float:
        return 0.0 if self.kind == "pool" else self.k ** 2 * self.c * self.f

    def act_words(self) -> float:          # output activation size
        return self.n * self.f * self.h_out * self.w_out


# key families beyond the conv-shape 8-tuples: measured §III-C reshard
# shuffles keyed (SHUFFLE_KIND, p_total, local_bytes) — one direction's
# seconds; shuffle_time charges 2×.  Composed-microbench provenance rows
# use the "composed:" prefix (calibrate writes them; lookup ignores them).
SHUFFLE_KIND = "shuffle:a2a"


class EmpiricalTable:
    """Optional measured-runtime lookup, the paper's own methodology: keys
    (kind, n, c, h, w, f, k, s) -> seconds.  Falls back to the analytic
    model for missing entries.  `core.calibrate` fills it by timing local
    convolutions at the shard shapes the solver's candidates produce, and
    round-trips it through JSON (BENCH_calibration.json).  Also holds the
    measured `shuffle:`/`composed:` key families (see SHUFFLE_KIND)."""

    def __init__(self, entries: Mapping[tuple, float] | None = None):
        self.entries = dict(entries or {})

    def lookup(self, layer: ConvLayer, n, c, h, w, f) -> float | None:
        return self.entries.get((layer.kind, n, c, h, w, f, layer.k, layer.s))

    def lookup_shuffle(self, p: int, nbytes: int) -> float | None:
        """Measured one-direction shuffle seconds at group size `p` and
        `nbytes` local bytes: exact hit, else piecewise-linear interpolation
        between the nearest measured sizes at the same p (clamped to the
        endpoints outside the measured range)."""
        t = self.entries.get((SHUFFLE_KIND, p, nbytes))
        if t is not None:
            return t
        rows = sorted((k[2], v) for k, v in self.entries.items()
                      if k[0] == SHUFFLE_KIND and k[1] == p)
        if not rows:
            return None
        # outside 2× of the measured range the table says nothing — fall
        # back to the analytic model (× shuffle_factor) rather than clamp.
        if nbytes < rows[0][0] // 2 or nbytes > 2 * rows[-1][0]:
            return None
        if nbytes <= rows[0][0]:
            return rows[0][1]
        if nbytes >= rows[-1][0]:
            return rows[-1][1]
        for (b0, t0), (b1, t1) in zip(rows, rows[1:]):
            if b0 <= nbytes <= b1:
                frac = (nbytes - b0) / max(b1 - b0, 1)
                return t0 + frac * (t1 - t0)
        return None

    def __len__(self) -> int:
        return len(self.entries)

    def __eq__(self, other) -> bool:
        return isinstance(other, EmpiricalTable) and \
            self.entries == other.entries

    def to_json(self) -> list:
        """JSON-serializable form: sorted [[kind, n, c, h, w, f, k, s], t]
        rows (tuple keys cannot be JSON object keys)."""
        return [[list(k), v] for k, v in sorted(self.entries.items())]

    @classmethod
    def from_json(cls, rows: Sequence) -> "EmpiricalTable":
        return cls({(str(k[0]), *(int(v) for v in k[1:])): float(t)
                    for k, t in rows})


# fixed kernel-launch overhead added to every conv roofline estimate; the
# calibrator (core.calibrate) subtracts it before attributing the linear-fit
# intercept to eff_halfwork, so the two must stay one constant.
LAUNCH_OVERHEAD = 4e-6


def conv_compute_time(m: Machine, layer: ConvLayer, n, c, h, w, f,
                      table: EmpiricalTable | None = None,
                      eff: float | None = None) -> float:
    """C(n,c,h,w,f): local forward runtime on the per-processor shard."""
    if table is not None:
        t = table.lookup(layer, n, c, h, w, f)
        if t is not None:
            return t
    if n <= 0 or h <= 0 or w <= 0:
        return 0.0
    h_out, w_out = cdiv(h, layer.s), cdiv(w, layer.s)
    if layer.kind == "pool":
        flops = n * f * h_out * w_out * layer.k ** 2
        byts = (n * c * h * w + n * f * h_out * w_out) * m.wordsize
        return max(flops / (0.05 * m.peak_flops), byts / m.mem_bw) + 2e-6
    flops = 2.0 * n * c * h_out * w_out * layer.k ** 2 * f
    byts = (n * c * h * w + n * f * h_out * w_out
            + layer.k ** 2 * c * f) * m.wordsize
    e = eff if eff is not None else m.compute_efficiency
    if m.eff_halfwork > 0:
        e = e * flops / (flops + m.eff_halfwork)
    # roofline max(compute, memory) + a fixed kernel-launch overhead; the
    # launch overhead is what caps strong scaling of tiny local convs
    # (paper Fig. 2, res3b fwd) — without it the model is wildly optimistic.
    return max(flops / (e * m.peak_flops), byts / m.mem_bw) + LAUNCH_OVERHEAD


# ---------------------------------------------------------------------------
# layer cost under a distribution (paper §V-A)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LayerCost:
    fp: float = 0.0
    bpx: float = 0.0
    bpw: float = 0.0
    bpa: float = 0.0          # dL/dw allreduce (overlappable, §V-B)
    fp_compute: float = 0.0   # components, for the overlap simulation
    bp_compute: float = 0.0
    fp_saved: float = 0.0     # η·min(comm, compute) credited in FP
    bp_saved: float = 0.0     # η·min(halo_dy, BPw compute) credited in BP

    @property
    def overlap_credit(self) -> float:
        """Seconds of communication the §IV-A schedule is credited with
        hiding, already scaled by the machine's achieved η — what
        plan.describe() reports per layer."""
        return self.fp_saved + self.bp_saved

    @property
    def total(self) -> float:
        return self.fp + self.bpx + self.bpw + self.bpa


def _halo_time(m: Machine, o: int, n_l: int, c_l: int, h_l: int, w_l: int,
               h_hops: int, w_hops: int) -> float:
    """2 SR(O·n·c·w) + 2 SR(O·n·c·h) + 4 SR(O²·n·c) as applicable (§V-A).

    `h_hops`/`w_hops`: 0 when the dim is unsplit; else the number of mesh
    axes in its (possibly product) split — product-axis halos pay extra
    link hops on the boundary-crossing sends (see sr_time)."""
    if o == 0:
        return 0.0
    t = 0.0
    ws = m.wordsize
    if h_hops:
        t += 2 * sr_time(m, o * n_l * c_l * w_l * ws, h_hops)
    if w_hops:
        t += 2 * sr_time(m, o * n_l * c_l * h_l * ws, w_hops)
    if h_hops and w_hops:
        t += 4 * sr_time(m, o * o * n_l * c_l * ws, h_hops + w_hops)
    return t


def layer_cost(m: Machine, layer: ConvLayer, dist: Dist,
               mesh_shape: Mapping[str, int],
               table: EmpiricalTable | None = None,
               overlap: bool = True,
               eff: float | None = None) -> LayerCost:
    """Cost_D(ℓ) (§V-A).  `mesh_shape` maps mesh axis -> size."""
    n_l = layer.n // max(dist.ways("N", mesh_shape), 1)
    h_l = layer.h // max(dist.ways("H", mesh_shape), 1)
    w_l = layer.w // max(dist.ways("W", mesh_shape), 1)
    c_l = layer.c // max(dist.ways("C", mesh_shape), 1)
    f_l = layer.f // max(dist.ways("F", mesh_shape), 1)
    # hop counts for the halo terms: the number of mesh axes each spatial
    # dim is split over (0 = unsplit) — a product-axis split's boundary
    # messages cross the outer torus dimension (see sr_time).
    h_hops = len(dist.axes("H")) if dist.ways("H", mesh_shape) > 1 else 0
    w_hops = len(dist.axes("W")) if dist.ways("W", mesh_shape) > 1 else 0

    c = LayerCost()
    # Channel/filter parallelism (§III-D) is costed as the single-axis
    # scheme where x enters C-sharded, each processor contracts its channel
    # block against full-F weight rows, and a reduce-scatter over the group
    # completes the channel sum leaving y F-sharded (the conv analogue of
    # Megatron row-parallel): compute sees (c_l, full f), comm is RS(y).
    # This is exactly what core.channel_conv's 'channel' mode executes
    # (benchmarks/strategy_exec.py cross-checks these terms against its
    # measured step times); its 'filter' mode trades the RS(y) for AG(x).
    p_c = dist.ways("C", mesh_shape)
    p_f = dist.ways("F", mesh_shape)
    h_out_l = layer.h_out // max(dist.ways("H", mesh_shape), 1)
    w_out_l = layer.w_out // max(dist.ways("W", mesh_shape), 1)
    f_fwd = layer.f if p_c > 1 else f_l
    fp_comp = conv_compute_time(m, layer, n_l, c_l, h_l, w_l, f_fwd, table,
                                eff)
    # composition correction factors (fitted by core.calibrate from fused
    # microbenchmarks; 1.0 = pure analytic).  halo_f applies when a spatial
    # dim is split over a *product* of mesh axes (boundary-crossing hops);
    # cf_f applies to the CF collectives when they execute inside a halo'd
    # spatial block (CF × spatial composition).
    halo_f = m.composed_halo_factor if (h_hops > 1 or w_hops > 1) else 1.0
    cf_f = m.composed_cf_factor if (p_c > 1 or p_f > 1) and \
        (h_hops or w_hops) else 1.0
    halo_x = halo_f * _halo_time(m, layer.o, n_l, c_l, h_l, w_l,
                                 h_hops, w_hops)
    if p_c > 1:
        # the CF data collective runs at the *sub-mesh* size p_c with the
        # spatially-local payload (h_out_l/w_out_l already divide out any
        # composed H/W split).  The runtime executes whichever §III-D mode
        # moves fewer words — RS(y) in 'channel' mode vs AG(x) in 'filter'
        # mode (core.plan picks it with cf_mode_for) — so the forward term
        # prices that min and the costed plan matches the executed one.
        words = cf_collective_words(layer, dist, mesh_shape)
        halo_x += cf_f * min(
            reduce_scatter_time(m, p_c, words["rs_y"] * m.wordsize),
            all_gather_time(m, p_c, words["ag_x"] * m.wordsize))
    # overlap credit (§IV-A): the schedule can hide at most min(comm,
    # compute); the machine's measured η says what fraction it actually
    # hides.  η = 1 (analytic default) makes the overlapped cost exactly
    # max(comm, compute); η = 0 makes it comm + compute (serialized).
    eta = min(max(m.overlap_eta, 0.0), 1.0) if overlap else 0.0
    c.fp_compute = fp_comp
    c.fp_saved = eta * min(halo_x, fp_comp)
    c.fp = fp_comp + halo_x - c.fp_saved

    if layer.kind == "pool":
        # backward pool ~ forward pool cost; halo on the error signal.
        c.bpx = fp_comp + halo_x - eta * min(halo_x, fp_comp)
        c.bp_saved = eta * min(halo_x, fp_comp)
        c.bp_compute = fp_comp
        return c

    # BPx: halo on dL/dy (F channels) + data-conv compute; under filter
    # parallelism the sum over f ∈ I_F^(p) (Eq. 3) is completed with a
    # reduce-scatter across the F-group, mirroring the forward.  (The
    # backward CF terms below charge both the x-payload RS and the
    # y-payload AG; each mode actually pays only one of them, so backward
    # is priced as an upper bound across modes.)
    c_bpx = layer.c if p_f > 1 else c_l
    bpx_comp = conv_compute_time(m, layer, n_l, c_bpx, h_l, w_l, f_l, table,
                                 eff)
    # dL/dy lives at the *output* extents (h_out/w_out): for strided layers
    # the backward halo messages are stride-times smaller than the forward
    # ones — using the input extents here over-charged BPx comm.
    halo_dy = halo_f * _halo_time(m, layer.o, n_l, f_l, h_out_l, w_out_l,
                                  h_hops, w_hops)
    if p_f > 1:
        halo_dy += cf_f * reduce_scatter_time(
            m, p_f, n_l * layer.c * h_l * w_l * m.wordsize)
    # BPw: local filter-gradient contraction, needs no halo (§IV-A); under
    # CF parallelism it needs full-F dL/dy — an all-gather over the group.
    bpw_comp = conv_compute_time(m, layer, n_l, c_l, h_l, w_l, f_fwd, table,
                                 eff)
    if p_f > 1:
        bpw_comp += cf_f * all_gather_time(
            m, p_f, n_l * layer.f * h_out_l * w_out_l * m.wordsize)
    if overlap:
        # §IV-A: the dL/dx halo exchange hides inside the dL/dw conv —
        # up to the machine's achieved η of the hideable min.
        c.bp_saved = eta * min(halo_dy, bpw_comp)
        c.bpx = bpx_comp
        c.bpw = bpw_comp + halo_dy - c.bp_saved
    else:
        c.bpx = bpx_comp + halo_dy
        c.bpw = bpw_comp
    c.bp_compute = bpx_comp + bpw_comp

    # BPa: allreduce of dL/dw over processors sharing the same (C, F)
    # indices — all of them when weights are replicated (§V-A).
    p_total = 1
    for ax, sz in mesh_shape.items():
        p_total *= sz
    p_cf = dist.ways("C", mesh_shape) * dist.ways("F", mesh_shape)
    p_ar = p_total // max(p_cf, 1)
    c.bpa = allreduce_time(m, p_ar,
                           f_l * c_l * layer.k ** 2 * m.wordsize)
    return c


def cf_collective_words(layer: ConvLayer, dist: Dist,
                        mesh_shape: Mapping[str, int]) -> dict:
    """Payload sizes (words) of the two §III-D data collectives at the
    local shard shapes: 'filter' mode all-gathers x over the CF group,
    'channel' mode reduce-scatters y.  Both run at the sub-mesh size
    `p_cf`; any composed H/W split divides the spatial extents out.  The
    plan compiler picks the runtime mode with the smaller payload."""
    n_l = layer.n // max(dist.ways("N", mesh_shape), 1)
    h_l = layer.h // max(dist.ways("H", mesh_shape), 1)
    w_l = layer.w // max(dist.ways("W", mesh_shape), 1)
    h_out_l = layer.h_out // max(dist.ways("H", mesh_shape), 1)
    w_out_l = layer.w_out // max(dist.ways("W", mesh_shape), 1)
    return {"ag_x": n_l * layer.c * h_l * w_l,
            "rs_y": n_l * layer.f * h_out_l * w_out_l,
            "p_cf": dist.ways("C", mesh_shape)}


def cf_mode_for(layer: ConvLayer, dist: Dist,
                mesh_shape: Mapping[str, int]) -> str:
    """'filter' when the AG(x) payload is smaller than the RS(y) payload,
    else 'channel' — the per-layer mode rule the solver applies."""
    words = cf_collective_words(layer, dist, mesh_shape)
    return "filter" if words["ag_x"] < words["rs_y"] else "channel"


# ---------------------------------------------------------------------------
# priced-collective inventory (the costed==executed contract, repro.analysis)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CollectiveSpec:
    """One priced collective of a layer under a distribution — the unit the
    static auditor (repro.analysis.collectives) joins the traced jaxpr's
    collectives against.

    kind:       normalized primitive name: ppermute | psum | reduce_scatter
                | all_gather.
    region:     the trace region the runtime issues it under (descriptive).
    direction:  fwd | bwd.
    count:      number of primitive ops the runtime issues.
    bytes:      TOTAL payload bytes across all `count` ops (sum over the
                ops' input avals — the auditor's byte convention).
    axes:       mesh axes the collective runs over (matched as a set).
    term:       the LayerCost term that prices it: fp | bpx | bpw | bpa,
                or 'none' for comm the model knowingly does not charge.
    visibility: 'jaxpr' when the op appears in the traced program (inside
                a shard_map body); 'gspmd' when the partitioner inserts it
                after lowering (invisible to the static walk — exempt from
                phantom-charge checks).
    charged:    whether layer_cost/network_cost actually prices it.  A
                charged=False + visibility='jaxpr' entry is a *known*
                unpriced collective (reported as a warning, not an error).
    """
    kind: str
    region: str
    direction: str
    count: int
    bytes: float
    axes: tuple
    term: str
    visibility: str = "jaxpr"
    charged: bool = True


def _conv_split_geometry(layer: ConvLayer, dist: Dist,
                         mesh_shape: Mapping[str, int]):
    """(d_loc, do_loc, lo, hi, t_lo, t_hi) of the conv-split spatial dim —
    W when W is split (H is fully exchanged first in the both-split path,
    core.spatial_conv._local_conv), else H.  None when neither is split or
    the kernel needs no halo (same_pads == (0, 0))."""
    h_ways = dist.ways("H", mesh_shape)
    w_ways = dist.ways("W", mesh_shape)
    if h_ways <= 1 and w_ways <= 1:
        return None
    lo, hi = same_pads(layer.k, layer.s)
    if lo == 0 and hi == 0:
        return None
    if w_ways > 1:
        d_loc, do_loc = layer.w // w_ways, layer.w_out // w_ways
    else:
        d_loc, do_loc = layer.h // h_ways, layer.h_out // h_ways
    t_lo = cdiv(lo, layer.s)
    i_hi = cdiv(d_loc + lo - layer.k + 1, layer.s)
    t_hi = do_loc - i_hi
    return d_loc, do_loc, lo, hi, t_lo, t_hi


def interior_split(layer: ConvLayer, dist: Dist,
                   mesh_shape: Mapping[str, int],
                   overlap: bool = True) -> bool:
    """Whether the runtime pins the §IV-A interior/boundary split for this
    layer — i.e. core.spatial_conv issues conv_interior under an
    optimization_barrier pin (one forward + one mirrored backward).  False
    for CF-composed layers (channel_conv serializes its spatial halo), for
    kernels needing no halo, without overlap, and when the boundary tiles
    swallow the whole local output (the serialized fallback)."""
    if not overlap:
        return False
    if dist.ways("C", mesh_shape) > 1 or dist.ways("F", mesh_shape) > 1:
        return False
    g = _conv_split_geometry(layer, dist, mesh_shape)
    if g is None:
        return False
    _, do_loc, _, _, t_lo, t_hi = g
    return t_lo + t_hi < do_loc


def layer_collectives(m: Machine, layer: ConvLayer, dist: Dist,
                      mesh_shape: Mapping[str, int], *,
                      overlap: bool = True, first: bool = False,
                      channel_chunks: int = 1) -> list[CollectiveSpec]:
    """THE priced inventory: every collective the runtime issues for
    `layer` under `dist`, with execution-accurate geometry derived from
    the same distribution `layer_cost` prices — each entry tagged with the
    cost term that charges it (or charged=False for comm the model
    knowingly leaves unpriced).

    Conventions (pinned against the traced jaxpr of the real execution
    paths — tests/dist_checks.py `audit` group):

      * halo ppermutes use SAME-padding amounts (lo, hi) = same_pads(k, s)
        per split dim — stride-2 k=3 sends ONE message, k=1 none; H is
        exchanged first with full local W rows, and when both H and W are
        split the W messages carry H-extended rows (corners ride inside
        them — the model's separate 4·SR(o²) corner term is a pricing
        approximation of the same bytes);
      * backward halos are the exact transposes, identical payloads;
        `first=True` marks a first layer whose input gradient is dead
        (loss wrt params only) — its backward halos are DCE'd away;
      * the spatial dL/dw contraction psums once per conv application:
        1 (serialized / no split) or 1 + (t_lo>0) + (t_hi>0) when the
        interior/boundary split is live, each over the full replicated
        weight shape;
      * CF runs the cf_mode_for min-payload mode: 'channel' reduce-
        scatters y forward / all-gathers local dy backward, 'filter'
        all-gathers x forward / reduce-scatters full-C dx backward; the
        weight-block psum over the non-CF processors is charged by BPa
        only when p_ar > 1, and the slice-VJP's full-weight psum over the
        CF axis is genuinely unpriced (charged=False — the standing
        suspect for the mesh16cf drift);
      * pure sample-parallel layers execute no shard_map: their dL/dw
        allreduce is GSPMD-inserted (visibility='gspmd').
    """
    ws = m.wordsize
    n_l = layer.n // max(dist.ways("N", mesh_shape), 1)
    h_ways = dist.ways("H", mesh_shape)
    w_ways = dist.ways("W", mesh_shape)
    h_l = layer.h // max(h_ways, 1)
    w_l = layer.w // max(w_ways, 1)
    h_out_l = layer.h_out // max(h_ways, 1)
    w_out_l = layer.w_out // max(w_ways, 1)
    p_c = dist.ways("C", mesh_shape)
    p_f = dist.ways("F", mesh_shape)
    p_cf = max(p_c, p_f)
    cf = p_cf > 1
    spatial = h_ways > 1 or w_ways > 1
    mode = cf_mode_for(layer, dist, mesh_shape) if cf else None

    batch_axes = tuple(dist.axes("N"))
    h_axes = tuple(dist.axes("H")) if h_ways > 1 else ()
    w_axes = tuple(dist.axes("W")) if w_ways > 1 else ()
    cf_axes = tuple(dist.axes("C")) if p_c > 1 else tuple(dist.axes("F"))
    grad_axes = batch_axes + h_axes + w_axes

    specs: list[CollectiveSpec] = []

    # ---- spatial halo ppermutes (fwd + transposed bwd) --------------------
    if spatial:
        lo, hi = same_pads(layer.k, layer.s)
        nper = (lo > 0) + (hi > 0)
        if cf:
            # CF x spatial: 'channel' mode halos the local C-block,
            # 'filter' mode halos the already-gathered full-C x.
            c_halo = layer.c // p_cf if mode == "channel" else layer.c
        else:
            c_halo = layer.c // max(p_c, 1)
        halos = []
        if nper and h_ways > 1:
            halos.append((h_axes, n_l * (lo + hi) * w_l * c_halo * ws))
        if nper and w_ways > 1:
            rows = h_l + ((lo + hi) if h_ways > 1 else 0)
            halos.append((w_axes, n_l * rows * (lo + hi) * c_halo * ws))
        for axes, nbytes in halos:
            specs.append(CollectiveSpec(
                "ppermute", "halo_exchange", "fwd", nper, nbytes, axes,
                term="fp"))
            if not first:
                specs.append(CollectiveSpec(
                    "ppermute", "halo_exchange", "bwd", nper, nbytes, axes,
                    term="bpw" if overlap else "bpx"))

    if layer.kind != "conv":
        return specs

    # ---- weight-gradient psums -------------------------------------------
    w_words = layer.k ** 2 * layer.c * layer.f
    if cf:
        blk_words = w_words // p_cf
        p_total = 1
        for _, sz in mesh_shape.items():
            p_total *= sz
        p_ar = p_total // max(p_c * p_f, 1)
        # CF x spatial layers run the same interior/boundary halo split as
        # the pure-spatial path, and the weight-block contraction psums
        # once per conv application there too.
        apps = 1
        if spatial and overlap:
            g = _conv_split_geometry(layer, dist, mesh_shape)
            if g is not None:
                _, do_loc, lo, hi, t_lo, t_hi = g
                if (lo or hi) and t_lo + t_hi < do_loc:
                    apps = 1 + (t_lo > 0) + (t_hi > 0)
        specs.append(CollectiveSpec(
            "psum", "conv", "bwd", apps, apps * blk_words * ws, grad_axes,
            term="bpa", charged=p_ar > 1))
        # slice-VJP of the weight block: the cotangent is scattered back
        # into the full weight shape and psummed over the CF axis — comm
        # no cost term prices.
        specs.append(CollectiveSpec(
            "psum", "cf_w_vjp", "bwd", 1, w_words * ws, cf_axes,
            term="none", charged=False))
    elif spatial:
        g = _conv_split_geometry(layer, dist, mesh_shape)
        apps = 1
        if g is not None and interior_split(layer, dist, mesh_shape,
                                            overlap):
            _, _, _, _, t_lo, t_hi = g
            apps = 1 + (t_lo > 0) + (t_hi > 0)
        specs.append(CollectiveSpec(
            "psum", "conv", "bwd", apps, apps * w_words * ws, grad_axes,
            term="bpa"))
    else:
        # no shard_map at all: GSPMD inserts the data-parallel grad
        # allreduce after partitioning — invisible to the jaxpr walk.
        p_total = 1
        for _, sz in mesh_shape.items():
            p_total *= sz
        if p_total > 1:
            specs.append(CollectiveSpec(
                "psum", "gspmd", "bwd", 1, w_words * ws, batch_axes,
                term="bpa", visibility="gspmd"))

    # ---- CF data collectives ---------------------------------------------
    if cf:
        n_blk = channel_chunks if (overlap and not spatial) else 1
        n_blk = max(1, min(n_blk, layer.c // p_cf))
        if mode == "channel":
            specs.append(CollectiveSpec(
                "reduce_scatter", "cf_reduce_scatter", "fwd", n_blk,
                n_l * h_out_l * w_out_l * layer.f * ws, cf_axes,
                term="fp"))
            specs.append(CollectiveSpec(
                "all_gather", "cf_reduce_scatter", "bwd", n_blk,
                n_blk * n_l * h_out_l * w_out_l * (layer.f // p_cf) * ws,
                cf_axes, term="bpw"))
        else:
            specs.append(CollectiveSpec(
                "all_gather", "cf_all_gather", "fwd", 1,
                n_l * h_l * w_l * (layer.c // p_cf) * ws, cf_axes,
                term="fp"))
            specs.append(CollectiveSpec(
                "reduce_scatter", "cf_all_gather", "bwd", 1,
                n_l * h_l * w_l * layer.c * ws, cf_axes, term="bpx"))
    return specs


# ---------------------------------------------------------------------------
# per-device memory under a distribution (the §VI Table-2 forcing function)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LayerMemory:
    """Per-device resident bytes of one layer under a distribution — the
    memory companion of LayerCost.  All fields are bytes on ONE device.

    `stash` is what the layer leaves resident for the backward pass,
    calibrated against XLA buffer assignments of the compiled runtime:
    the input activation (dL/dw contracts against x; max-pool backward
    needs its input), the halo-extended input copy autodiff saves inside
    the shard_map (its conv-transpose primal), and the pre-BN output (BN
    backward) — 2 x act_in + act_out.  The post-ReLU tensor is the next
    layer's act_in, counted there.  The stash *contains* the act_in/
    act_out working buffers, so `total` adds it (not them) on top of the
    persistent words and communication scratch; `network_memory`
    accumulates it across layers — the residency that dominates
    whole-network peaks.
    """
    weights: float = 0.0      # resident weight shard (replicated unless CF)
    grads: float = 0.0        # dL/dw, sharded like the weights
    opt: float = 0.0          # optimizer state (opt_words x weight words)
    act_in: float = 0.0       # input activation shard (local extents)
    act_out: float = 0.0      # output activation shard (h_out/w_out extents)
    stash: float = 0.0        # fwd residency for backward (2*act_in+act_out)
    halo: float = 0.0         # neighbor-halo recv buffers (max of fwd/bwd)
    cf: float = 0.0           # CF AG(x)/RS(y) staging buffer (executed mode)

    @property
    def persistent(self) -> float:
        """Bytes resident for the whole step (weights + grads + opt)."""
        return self.weights + self.grads + self.opt

    @property
    def transient(self) -> float:
        """Communication scratch live only while this layer runs."""
        return self.halo + self.cf

    @property
    def total(self) -> float:
        """This layer's own resident set — the per-layer solver constraint:
        persistent words + the backward stash (which includes the act_in/
        act_out working buffers) + communication scratch."""
        return self.persistent + self.stash + self.transient

    def breakdown(self) -> str:
        parts = [(k, getattr(self, k))
                 for k in ("weights", "grads", "opt", "act_in", "act_out",
                           "halo", "cf")]
        return " ".join(f"{k}={human_bytes(v)}" for k, v in parts if v)


def layer_memory(m: Machine, layer: ConvLayer, dist: Dist,
                 mesh_shape: Mapping[str, int],
                 opt_words: float = 1.0) -> LayerMemory:
    """Per-device memory footprint of `layer` under `dist` (bytes).

    Accounts, per shard: weights (replicated across sample/spatial
    processors; C/F-sharded by the CF group size under a CF dist — both
    §III-D modes hold weight_words/p_cf resident), input/output activations
    at the sharded extents (outputs at h_out/w_out — pooling and strided
    layers shrink, matching act_words), the forward stash kept for
    backward, halo recv buffers (the core.halo geometry: lo+hi slabs per
    split dim plus the 4 corner blocks when both H and W split; product
    axes divide the extents through dist.ways, so the buffers are
    hop-count independent), the CF collective staging buffer of the mode
    the runtime executes (cf_mode_for's min), and gradient + optimizer
    words (`opt_words` per weight word; SGD+momentum = 1, Adam = 2).
    """
    ws = m.wordsize
    n_l = layer.n / max(dist.ways("N", mesh_shape), 1)
    h_l = layer.h / max(dist.ways("H", mesh_shape), 1)
    w_l = layer.w / max(dist.ways("W", mesh_shape), 1)
    c_l = layer.c / max(dist.ways("C", mesh_shape), 1)
    f_l = layer.f / max(dist.ways("F", mesh_shape), 1)
    h_out_l = layer.h_out / max(dist.ways("H", mesh_shape), 1)
    w_out_l = layer.w_out / max(dist.ways("W", mesh_shape), 1)
    p_cf = max(dist.ways("C", mesh_shape), dist.ways("F", mesh_shape))

    mem = LayerMemory()
    w_words = layer.weight_words() / max(p_cf, 1)
    mem.weights = w_words * ws
    mem.grads = w_words * ws
    mem.opt = opt_words * w_words * ws
    mem.act_in = n_l * c_l * h_l * w_l * ws
    mem.act_out = n_l * f_l * h_out_l * w_out_l * ws
    mem.stash = 2 * mem.act_in + mem.act_out

    o = layer.o
    h_split = dist.ways("H", mesh_shape) > 1
    w_split = dist.ways("W", mesh_shape) > 1
    if o and (h_split or w_split):
        # forward halo carries C channels at input extents; the backward
        # halo carries F channels of dL/dy at output extents.  They do not
        # coexist, so the resident buffer is the max of the two.
        halo_x = halo_dy = 0.0
        if h_split:
            halo_x += 2 * o * n_l * c_l * w_l
            halo_dy += 2 * o * n_l * f_l * w_out_l
        if w_split:
            halo_x += 2 * o * n_l * c_l * h_l
            halo_dy += 2 * o * n_l * f_l * h_out_l
        if h_split and w_split:
            halo_x += 4 * o * o * n_l * c_l
            halo_dy += 4 * o * o * n_l * f_l
        mem.halo = max(halo_x, halo_dy) * ws
    if p_cf > 1:
        # the staging buffer of the executed §III-D mode: 'filter' holds
        # the gathered full-C x, 'channel' the full-F partial y before its
        # reduce-scatter — cf_mode_for picks whichever is smaller.
        words = cf_collective_words(layer, dist, mesh_shape)
        mem.cf = min(words["ag_x"], words["rs_y"]) * ws
    return mem


def network_memory(m: Machine, layers: Sequence[ConvLayer],
                   dists: Sequence[Dist], mesh_shape: Mapping[str, int],
                   opt_words: float = 1.0) -> dict:
    """Per-device peak resident bytes for a network under per-layer dists.

    The rollup mirrors a training step's residency: every layer's
    weights/grads/optimizer words are live throughout; walking forward,
    layer i's working set (act_in/out, halo, CF staging) coexists with the
    stashed activations of all *earlier* layers — the accumulation that
    makes large-sample workloads unreachable under sample parallelism
    (paper §VI, Table 2).  Returns per-layer LayerMemory breakdowns plus
    `peak_bytes` and the layer where the peak occurs.
    """
    assert len(layers) == len(dists)
    mems = [layer_memory(m, l, d, mesh_shape, opt_words)
            for l, d in zip(layers, dists)]
    persistent = sum(lm.persistent for lm in mems)
    peak, peak_layer, stash_acc = 0.0, None, 0.0
    for l, lm in zip(layers, mems):
        stash_acc += lm.stash          # this layer's working set included
        live = persistent + stash_acc + lm.transient
        if live > peak:
            peak, peak_layer = live, l.name
    return {"per_layer": mems, "persistent_bytes": persistent,
            "peak_bytes": peak, "peak_layer": peak_layer}


def shuffle_block_bytes(layer: ConvLayer, p: int, wordsize: int) -> int:
    """Per-processor payload of a §III-C shuffle of ℓ's output: the one
    definition shared by shuffle_time and calibrate's shuffle-size grid, so
    measured `shuffle:` table keys match the keys priced plans look up."""
    return int(layer.act_words() / max(p, 1) * wordsize)


def shuffle_time(m: Machine, layer: ConvLayer, d_i: Dist, d_j: Dist,
                 mesh_shape: Mapping[str, int],
                 table: EmpiricalTable | None = None) -> float:
    """Shuffle(D_i, D_j): all-to-all redistribution of ℓ's output (§III-C).

    Prefers a measured `shuffle:` table entry at (p, local_bytes) — exact or
    size-interpolated — over the analytic pairwise model; the analytic
    fallback is scaled by the machine's fitted shuffle_factor."""
    if d_i.same_as(d_j):
        return 0.0
    p = 1
    for ax, sz in mesh_shape.items():
        p *= sz
    local_bytes = shuffle_block_bytes(layer, p, m.wordsize)
    # forward shuffle of y and backward shuffle of dL/dx
    if table is not None:
        t = table.lookup_shuffle(p, local_bytes)
        if t is not None:
            return 2 * t
    return 2 * all_to_all_time(m, p, local_bytes) * m.shuffle_factor


# ---------------------------------------------------------------------------
# whole-network cost (paper §V-B)
# ---------------------------------------------------------------------------

def network_cost(m: Machine, layers: Sequence[ConvLayer],
                 dists: Sequence[Dist], mesh_shape: Mapping[str, int],
                 table: EmpiricalTable | None = None,
                 overlap: bool = True,
                 eff: float | None = None) -> dict:
    """End-to-end mini-batch time for a line network under per-layer dists.

    Greedy allreduce overlap (§V-B): walking backprop from the last layer,
    each dL/dw allreduce starts when (a) its layer's backprop is done and
    (b) the previous allreduce finished (one at a time); it runs concurrent
    with the remaining backprop compute.  The mini-batch ends when both the
    compute timeline and the last allreduce finish.
    """
    assert len(layers) == len(dists)
    costs = [layer_cost(m, l, d, mesh_shape, table, overlap, eff)
             for l, d in zip(layers, dists)]

    fp_time = sum(c.fp for c in costs)
    shuf = sum(shuffle_time(m, layers[i], dists[i], dists[i + 1], mesh_shape,
                            table)
               for i in range(len(layers) - 1))

    # backward timeline with greedy allreduce overlap
    t = 0.0          # compute-stream clock
    ar_free = 0.0    # when the collective stream is free
    ar_end = 0.0
    for c in reversed(costs):
        t += c.bpx + c.bpw
        if c.bpa > 0:
            start = max(t, ar_free)
            ar_free = start + c.bpa
            ar_end = ar_free
    bp_time = max(t, ar_end) if overlap else \
        sum(c.bpx + c.bpw + c.bpa for c in costs)

    return {"total": fp_time + shuf + bp_time, "fp": fp_time,
            "bp": bp_time, "shuffle": shuf,
            "exposed_allreduce": max(0.0, ar_end - t) if overlap else
            sum(c.bpa for c in costs),
            "per_layer": costs}
