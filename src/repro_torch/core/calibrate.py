"""Measured-cost calibration, the paper's §V feedback loop, port of
`repro.core.calibrate`.

The paper's performance model is fed by measured primitive costs: the
authors time cuDNN kernels and MPI collectives on the target machine and
only then trust the model to rank distributions.  This module is that
loop on the card:

  1. time the local convolution at every shard shape the strategy
     optimizer's candidate distributions give the network (the forward
     shape, and the BPx data-conv shape where it differs), as the step
     runs it: SAME pads, then the hand-written conv kernel
     (`spatial_conv._conv_nhwc`, `kernels/csrc/conv2d.cu`), which stands
     where the paper's cuDNN call stands.  These fill the per-shape
     `EmpiricalTable`, the model's first-choice lookup;
  2. time the communication primitives at the message sizes the plan
     compiler emits: one halo-pattern ring step (`batch_isend_irecv`, the
     §III-A stencil pattern) and the collectives (all-reduce,
     reduce-scatter, all-gather) on each mesh axis;
  3. fit the `Machine` constants from those samples: α/β for p2p and for
     the collective fabric (least squares on the linear α-β model,
     §II-B), the achieved peak FLOP/s, memory bandwidth, the
     efficiency / half-performance-work pair of the analytic fallback,
     the achieved-overlap η and the composition factors.

A calibration round-trips through JSON (``repro/calibration@1``, the
reference's format: a file either package wrote loads in the other).
`train.py --calibrate[=path]` solves `--strategy auto` on it.

One process a rank: every rank must solve on the same calibration, or the
ranks compile different plans and hang in their first collective.  So the
local conv/pool table and the memory bandwidth are measured by rank 0
alone while the others wait at a barrier (two processes timing on one
card at once would time their contention); the communication benches run
on every rank, each sample the max over the ranks; rank 0 fits and writes
the file, and its JSON is broadcast to the others.  A gloo collective
stages CUDA tensors through the host, so its samples are host-clock times
ended by `torch.cuda.synchronize()`.

Every entry point takes an explicit `device`: CUDA unless the caller asks
for the CPU.  Nothing falls back: a conv kernel that does not build or
launch raises here.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import channel_conv
from repro_torch.core.perfmodel import (LAUNCH_OVERHEAD, SHUFFLE_KIND,
                                        ConvLayer, EmpiricalTable, Machine,
                                        _halo_time, all_to_all_time,
                                        reduce_scatter_time,
                                        shuffle_block_bytes)
from repro_torch.core.plan import executable_candidates
from repro_torch.launch.mesh import Mesh
from repro_torch.utils import fingerprint, resolve_device, same_pads, time_fn

SCHEMA = "repro/calibration@1"
DEFAULT_PATH = "BENCH_calibration.json"

# starting point for constants a calibration without live communication
# cannot fit: loopback-ish host comm (shared memory), overwritten whenever
# the mesh has an axis of size > 1 to measure on.
HOST_BASE = Machine("host-base", peak_flops=1e11, mem_bw=20e9,
                    alpha=5e-6, beta=1 / 10.0e9,
                    alpha_coll=8e-6, beta_coll=1 / 10.0e9, wordsize=4,
                    compute_efficiency=1.0)


# ---------------------------------------------------------------------------
# the card, its memory, and the measured peak of a step
# ---------------------------------------------------------------------------

def card_fields() -> dict:
    """{"card": name and power limit} of the current CUDA device, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them (the device name alone where nvidia-smi does not answer); {} off
    the card.  Every measured number is stored beside it."""
    if not torch.cuda.is_available():
        return {}
    idx = torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={idx}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        line = out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            and out.stdout.strip() else ""
    except (OSError, subprocess.TimeoutExpired):
        line = ""
    return {"card": line or torch.cuda.get_device_name(idx)}


@functools.lru_cache(maxsize=None)
def _detect_mem_capacity(kind: str, index: int | None, ranks: int,
                         default: float) -> tuple[float, str]:
    env = os.environ.get("REPRO_MEM_CAPACITY")
    if env:
        try:
            cap = float(env)
            if cap > 0:
                return cap, "env:REPRO_MEM_CAPACITY"
        except ValueError:
            print(f"calibrate: WARNING: ignoring non-numeric "
                  f"REPRO_MEM_CAPACITY={env!r}")
    if kind == "cuda":
        dev = torch.device("cuda", index) if index is not None else \
            torch.device("cuda")
        return float(torch.cuda.mem_get_info(dev)[1]), \
            "device:torch.cuda.mem_get_info"
    try:
        avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        return float(avail) / max(ranks, 1), "host:SC_AVPHYS_PAGES"
    except (OSError, ValueError):
        return float(default), "default"


def detect_mem_capacity(device: torch.device | str = "cuda", ranks: int = 1,
                        default: float = 8 << 30) -> float:
    """Memory capacity a device in bytes, for Machine.mem_capacity and
    `--mem-limit auto`.

    A REPRO_MEM_CAPACITY env var (plain bytes) wins outright, the
    deterministic knob for tests.  On the card, its memory
    (`torch.cuda.mem_get_info`); on the CPU, the host's available memory
    shared among the `ranks` processes on it.  Memoized per device and
    rank count: the host's free memory jitters from call to call, and a
    calibration must stay deterministic within a process."""
    dev = torch.device(device)
    return _detect_mem_capacity(dev.type, dev.index, ranks, default)[0]


def mem_capacity_source(device: torch.device | str = "cuda", ranks: int = 1,
                        default: float = 8 << 30) -> str:
    """Which source detect_mem_capacity's answer came from."""
    dev = torch.device(device)
    return _detect_mem_capacity(dev.type, dev.index, ranks, default)[1]


detect_mem_capacity.cache_clear = _detect_mem_capacity.cache_clear


def step_peak_bytes(fn, *args) -> int | None:
    """Peak bytes allocated on the card over one call of `fn(*args)`
    (`torch.cuda.max_memory_allocated`, reset before); None where the
    call's result is not on the card (the CPU keeps no such count)."""
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    out = fn(*args)
    leaf = out[0] if isinstance(out, (tuple, list)) else out
    if not (cuda and isinstance(leaf, torch.Tensor) and leaf.is_cuda):
        return None
    del out, leaf
    torch.cuda.synchronize()
    return int(torch.cuda.max_memory_allocated())


def crosscheck_memory(plan, fn, *args) -> dict:
    """The §VI memory-model check: a compiled plan's predicted peak
    (plan.predicted['memory'], core.perfmodel.network_memory) against the
    measured peak of the step `fn(*args)` that executes it on the card.
    Predicted and measured bytes and their ratio (nan where nothing was
    measured)."""
    predicted = float(plan.predicted["memory"]["peak_bytes"])
    measured = step_peak_bytes(fn, *args)
    return {"predicted_bytes": predicted, "measured_bytes": measured,
            "ratio": predicted / measured if measured else float("nan")}


# ---------------------------------------------------------------------------
# what to measure: the shapes and message sizes the model will ask about
# ---------------------------------------------------------------------------

def _local_shards(layer: ConvLayer, dist, mesh_shape):
    """Mirror of perfmodel.layer_cost's shard arithmetic for one dist."""
    n_l = layer.n // max(dist.ways("N", mesh_shape), 1)
    h_l = layer.h // max(dist.ways("H", mesh_shape), 1)
    w_l = layer.w // max(dist.ways("W", mesh_shape), 1)
    c_l = layer.c // max(dist.ways("C", mesh_shape), 1)
    f_l = layer.f // max(dist.ways("F", mesh_shape), 1)
    p_c = dist.ways("C", mesh_shape)
    p_f = dist.ways("F", mesh_shape)
    return n_l, c_l, h_l, w_l, f_l, p_c, p_f


def table_shapes(specs: Sequence[ConvLayer], mesh_shape: Mapping[str, int],
                 allow_w_split: bool = True,
                 allow_channel_filter: bool = True) -> list[tuple]:
    """Every EmpiricalTable key `layer_cost` can query while solving these
    layers over this mesh: for each executable candidate distribution, the
    local forward/BPw conv shape and the BPx data-conv shape (Eq. 2/3)."""
    keys = set()
    for layer in specs:
        for d in executable_candidates(layer, mesh_shape, allow_w_split,
                                       allow_channel_filter):
            n_l, c_l, h_l, w_l, f_l, p_c, p_f = \
                _local_shards(layer, d, mesh_shape)
            f_fwd = layer.f if p_c > 1 else f_l
            keys.add((layer.kind, n_l, c_l, h_l, w_l, f_fwd,
                      layer.k, layer.s))
            if layer.kind != "pool":
                c_bpx = layer.c if p_f > 1 else c_l
                keys.add((layer.kind, n_l, c_bpx, h_l, w_l, f_l,
                          layer.k, layer.s))
    return sorted(keys)


def comm_sizes(specs: Sequence[ConvLayer], mesh_shape: Mapping[str, int],
               wordsize: int = 4,
               allow_w_split: bool = True,
               allow_channel_filter: bool = True
               ) -> tuple[list[int], list[int]]:
    """(p2p bytes, collective bytes) the §V-A/B cost terms will charge for
    these layers: halo SR messages, CF reduce-scatter/all-gather payloads,
    the dL/dw allreduce and the §III-C shuffle blocks."""
    p_total = 1
    for sz in mesh_shape.values():
        p_total *= sz
    p2p, coll = set(), set()
    for layer in specs:
        coll.add(int(layer.weight_words()) * wordsize)       # BPa allreduce
        # §III-C shuffle: priced by all_to_all_time with the *p2p* α/β
        # (pairwise exchange), so its per-processor block must be sampled
        # by the p2p grid, not the collective one
        p2p.add(int(layer.act_words() / max(p_total, 1)) * wordsize)
        for d in executable_candidates(layer, mesh_shape, allow_w_split,
                                       allow_channel_filter):
            n_l, c_l, h_l, w_l, f_l, p_c, p_f = \
                _local_shards(layer, d, mesh_shape)
            o = layer.o
            h_out_l = layer.h_out // max(d.ways("H", mesh_shape), 1)
            w_out_l = layer.w_out // max(d.ways("W", mesh_shape), 1)
            # dL/dy halos run at the *output* extents (layer_cost's
            # halo_dy), so strided layers sample the smaller message too
            if o and d.ways("H", mesh_shape) > 1:
                p2p.add(o * n_l * c_l * w_l * wordsize)      # halo on x
                p2p.add(o * n_l * f_l * w_out_l * wordsize)  # halo on dL/dy
            if o and d.ways("W", mesh_shape) > 1:
                p2p.add(o * n_l * c_l * h_l * wordsize)
                p2p.add(o * n_l * f_l * h_out_l * wordsize)
            if p_c > 1:
                coll.add(n_l * layer.f * h_out_l * w_out_l * wordsize)
            if p_f > 1:
                coll.add(n_l * layer.c * h_l * w_l * wordsize)
    return (sorted(b for b in p2p if b > 0),
            sorted(b for b in coll if b > 0))


def _representative(values: Sequence, cap: int) -> list:
    """A deterministic <=cap subset spread evenly over the sorted range
    (always keeping the extremes): the benchmark grid stays bounded while
    covering the span the model will interpolate over."""
    values = sorted(set(values))
    if len(values) <= cap:
        return values
    idx = np.linspace(0, len(values) - 1, cap).round().astype(int)
    return [values[i] for i in sorted(set(idx.tolist()))]


def _choose_shapes(wanted: Sequence[tuple], max_shapes: int) -> list[tuple]:
    """The deterministic <=max_shapes subset a calibration run measures,
    spread over the FLOP range so both the launch-bound tail and the
    throughput-bound head are covered.  `coverage` recomputes it, so a
    capped calibration is judged against what a fresh run would measure,
    not the full candidate set."""
    by_flops = sorted(wanted, key=lambda k: (_conv_flops_bytes(k)[0], k))
    return [by_flops[i]
            for i in _representative(range(len(by_flops)), max_shapes)]


# ---------------------------------------------------------------------------
# ranks: who measures, and how the ranks agree
# ---------------------------------------------------------------------------

Timer = Callable[..., float]        # timer(fn, *args) -> seconds a call


def _live(mesh) -> Mesh | None:
    """`mesh` where it is a mesh of running processes (a process group
    behind it), else None: a plain {axis: size} mapping, or a layout-only
    `Mesh`, measures no communication."""
    if isinstance(mesh, Mesh) and mesh.backend != "none":
        return mesh
    return None


def _lead(live: Mesh | None) -> bool:
    return live is None or live.rank == 0


def _barrier(live: Mesh | None) -> None:
    if live is not None:
        live.barrier()


def _broadcast(obj, live: Mesh | None):
    """Rank 0's JSON-able `obj` on every rank (its own through a JSON
    round trip too, so every rank holds the same values)."""
    blob = json.dumps(obj) if live is None or live.rank == 0 else None
    if live is not None:
        blob = live.broadcast_object(blob)
    return json.loads(blob)


def _comm_timer(timer: Timer, live: Mesh | None) -> Timer:
    """`timer` for a bench that every rank runs together: the ranks start
    it at a barrier, and its sample is the max over them."""
    def run(fn, *args):
        _barrier(live)
        t = timer(fn, *args)
        return t if live is None else live.all_max([t])[0]
    return run


def _default_timer(reps: int, host: bool = False) -> Timer:
    return lambda fn, *a: time_fn(fn, *a, reps=reps, host=host)


# ---------------------------------------------------------------------------
# microbenchmarks (timer-injectable: tests pass a deterministic fake)
# ---------------------------------------------------------------------------

def _randn(shape, seed: int, device: torch.device, scale: float = 1.0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device) * scale


def _local_conv(k: int, s: int):
    """The local dense conv of one shard, as the step runs it."""
    from repro_torch.core.spatial_conv import _conv_nhwc
    pads = (same_pads(k, s), same_pads(k, s))
    return lambda x, w: _conv_nhwc(x, w, (s, s), pads)


def _bench_conv_shape(key: tuple, timer: Timer,
                      device: torch.device) -> float | None:
    """Time the local dense kernel for one table key on the device: the
    per-shard compute the paper times as cuDNN.  The timer gets x
    (n, h, w, c) and, for a conv, w (k, k, c, f)."""
    kind, n, c, h, w, f, k, s = key
    if min(n, c, h, w, f) <= 0:
        return None
    x = _randn((n, h, w, c), 0, device)
    if kind == "pool":
        from repro_torch.core.spatial_conv import _pool_windows
        pads = (same_pads(k, s), same_pads(k, s))
        return timer(lambda x: _pool_windows(x, (k, k), (s, s), pads,
                                             "max"), x)
    wt = _randn((k, k, c, f), 1, device, 0.1)
    with torch.no_grad():
        return timer(_local_conv(k, s), x, wt)


def _bench_p2p(mesh: Mesh, axis: str, nbytes: int, timer: Timer,
               device: torch.device) -> float:
    """One halo-pattern ring step: every rank sends and receives `nbytes`
    (`batch_isend_irecv`), the perf model's SR(n) primitive."""
    from repro_torch.core.halo import ring_shift
    x = torch.zeros((max(1, nbytes // 4),), device=device)
    return timer(lambda v: ring_shift(v, axis, mesh), x)


def _bench_collective(mesh: Mesh, axis: str, op: str, nbytes: int,
                      timer: Timer, device: torch.device) -> float:
    """all-reduce / reduce-scatter / all-gather of an `nbytes` buffer over
    one mesh axis, the collective terms of §V-A (CF conv, BPa)."""
    from repro_torch.core import collectives
    n = mesh.shape[axis]
    elems = max(n, nbytes // 4) // n * n      # divisible by the group
    if op == "allreduce":
        x = torch.ones((elems,), device=device)
        fn = lambda v: mesh.all_reduce(v, axis)              # noqa: E731
    elif op == "reduce_scatter":
        x = torch.ones((elems,), device=device)
        fn = lambda v: collectives.reduce_scatter(           # noqa: E731
            v, mesh, axis, 0, "calibrate")
    elif op == "all_gather":
        x = torch.ones((elems // n,), device=device)
        fn = lambda v: collectives.all_gather(               # noqa: E731
            v, mesh, axis, 0, "calibrate")
    else:
        raise ValueError(op)
    with torch.no_grad():
        return timer(fn, x)


def _bench_membw(timer: Timer, device: torch.device,
                 nbytes: int | None = None) -> float:
    """Achieved streaming bandwidth (read + write) of a saxpy-style pass:
    32 MiB on the CPU, as the reference; 256 MiB on the card, five times
    its 50 MB L2, so that the pass streams from HBM."""
    if nbytes is None:
        nbytes = (256 << 20) if device.type == "cuda" else (32 << 20)
    x = torch.zeros((nbytes // 4,), device=device)
    t = timer(lambda v: v + 1.0, x)
    return 2 * nbytes / max(t, 1e-9)


def _spatial_conv(mesh: Mesh, sh, overlap: bool):
    """The spatially split conv of `sh` as a (x, w) callable."""
    from repro_torch.core.spatial_conv import spatial_conv2d
    return lambda x, w: spatial_conv2d(x, w, strides=(1, 1), sharding=sh,
                                       mesh=mesh, overlap=overlap)


def _bench_overlap(mesh: Mesh, axis: str, timer: Timer,
                   device: torch.device, rounds: int = 3, n: int = 2,
                   c: int = 8, f: int = 8, k: int = 3) -> dict:
    """Interleaved overlapped-vs-serialized A/B of the §IV-A schedule on
    one mesh axis: the same H-split conv with the interior/boundary
    schedule on and forced serial, plus a halo-free local conv at the
    shard shape as the compute-only anchor.  The achieved-overlap
    efficiency is the measured gain over the hideable min(comm, compute):

        η = (t_serial − t_overlap) / min(t_serial − t_compute, t_compute)

    clamped to [0, 1]; None when the comm term is too small to resolve
    above timing noise (the sample is kept in meta and left out of the
    fit)."""
    from repro_torch.core.spatial_conv import ConvSharding
    p = mesh.shape[axis]
    h_l = max(4 * k, 16)
    w = 64
    sh = ConvSharding(h_axis=axis)
    x = _randn((n, h_l, w, c), mesh.rank, device)          # this rank's block
    wt = _randn((k, k, c, f), 1, device, 0.1)
    ov_fn = _spatial_conv(mesh, sh, True)
    ser_fn = _spatial_conv(mesh, sh, False)
    x_loc = _randn((n, h_l, w, c), 2, device)
    t_ov, t_ser = [], []
    with torch.no_grad():
        for _ in range(rounds):   # alternate arms so drift hits both
            t_ov.append(timer(ov_fn, x, wt))
            t_ser.append(timer(ser_fn, x, wt))
        t_loc = timer(_local_conv(k, 1), x_loc, wt)
    t_ov, t_ser = min(t_ov), min(t_ser)
    comm = max(t_ser - t_loc, 0.0)
    hideable = min(comm, t_loc)
    eta = None
    if hideable > 0.05 * t_ser:
        eta = min(max((t_ser - t_ov) / hideable, 0.0), 1.0)
    return {"axis": axis, "p": p, "t_overlap": t_ov, "t_serial": t_ser,
            "t_compute": t_loc, "eta": eta}


def fit_eta(mesh, *, timer: Timer | None = None, reps: int = 5,
            base: Machine = HOST_BASE,
            device: torch.device | str = "cuda") -> tuple[float, list]:
    """Measure the achieved-overlap efficiency η (Machine.overlap_eta)
    over every mesh axis of size > 1 and take the median across axes.

    (base.overlap_eta, []) when `mesh` has no live axis of size > 1 (a
    plain {axis: size} mapping, or one rank): a calibration that measures
    nothing keeps the optimistic default rather than inventing a
    measurement.  On a live mesh every rank calls it together."""
    live = _live(mesh)
    mesh_shape = _mesh_shape_of(mesh)
    axes = sorted(ax for ax, sz in mesh_shape.items() if sz > 1) \
        if live is not None else []
    if not axes:
        return base.overlap_eta, []
    device = resolve_device(str(device))
    timer = _comm_timer(timer or _default_timer(reps, host=True), live)
    samples = [_bench_overlap(live, ax, timer, device) for ax in axes]
    etas = [s["eta"] for s in samples if s["eta"] is not None]
    eta = float(np.median(etas)) if etas else base.overlap_eta
    return eta, samples


# ---------------------------------------------------------------------------
# composition microbenchmarks: what a §III-C shuffle, a product-axis halo
# and a CF collective inside a halo'd spatial block cost
# ---------------------------------------------------------------------------

def shuffle_sizes(specs: Sequence[ConvLayer],
                  mesh_shape: Mapping[str, int],
                  wordsize: int = 4) -> list[tuple[int, int]]:
    """The (p_total, local_bytes) shuffle keys a plan transition over these
    layers can price: shuffle_block_bytes is the shared definition, so the
    measured `shuffle:` entries land on the keys shuffle_time asks for."""
    p_total = 1
    for sz in mesh_shape.values():
        p_total *= sz
    out = set()
    for layer in specs:
        nb = shuffle_block_bytes(layer, p_total, wordsize)
        if nb > 0:
            out.add((p_total, nb))
    return sorted(out)


def _bench_shuffle(mesh: Mesh, axes: Sequence[str], nbytes: int,
                   timer: Timer, device: torch.device) -> float:
    """One direction of a §III-C shuffle: a (p, elems) array moved from
    row-sharded to column-sharded over the product of `axes`, the
    all-to-all every dist change pays, at `nbytes` local."""
    from repro_torch.core import collectives
    p = mesh.axis_size(tuple(axes))
    elems = max(p, nbytes // 4) // p * p
    x = torch.zeros((1, elems), device=device)          # this rank's row
    with torch.no_grad():
        return timer(lambda v: collectives.all_to_all(
            v, mesh, tuple(axes), 1, 0, "calibrate"), x)


def _bench_product_halo(mesh: Mesh, axes: tuple[str, str], timer: Timer,
                        device: torch.device, n: int = 2, c: int = 8,
                        f: int = 8, k: int = 3) -> dict:
    """Serialized H-split conv with H over a product of two mesh axes
    (boundary-crossing hops), plus the local conv at the shard shape as
    the compute-only anchor: (t_fused − t_compute) isolates the measured
    halo exchange the model prices with sr_time(…, hops=2)."""
    from repro_torch.core.spatial_conv import ConvSharding
    p = mesh.axis_size(tuple(axes))
    h_l = max(4 * k, 16)
    w = 32
    sh = ConvSharding(h_axis=tuple(axes))
    x = _randn((n, h_l, w, c), mesh.rank, device)
    wt = _randn((k, k, c, f), 1, device, 0.1)
    x_loc = _randn((n, h_l, w, c), 2, device)
    with torch.no_grad():
        t_fused = timer(_spatial_conv(mesh, sh, False), x, wt)
        t_compute = timer(_local_conv(k, 1), x_loc, wt)
    return {"axes": list(axes), "p": p,
            "t_fused": t_fused, "t_compute": t_compute,
            "geom": {"o": k // 2, "n": n, "c": c, "h_l": h_l, "w_l": w,
                     "hops": 2}}


def _bench_composed_cf(mesh: Mesh, cf_axis: str, sp_axis: str, timer: Timer,
                       device: torch.device, n: int = 2, k: int = 3) -> dict:
    """Serialized fused CF x spatial conv (the §III-D reduce-scatter
    running inside an H-split block) plus its local-conv anchor: what the
    CF collective costs composed with a halo'd spatial block, against the
    standalone collective fit."""
    from repro_torch.core.channel_conv import CFSharding, cf_conv2d
    p_cf, p_sp = mesh.shape[cf_axis], mesh.shape[sp_axis]
    c = f = 8 * p_cf
    h_l = max(4 * k, 16)
    w = 32
    sh = CFSharding(cf_axis=cf_axis, h_axis=sp_axis, mode="channel")
    x = _randn((n, h_l, w, c // p_cf), mesh.rank, device)
    wt = _randn((k, k, c, f), 1, device, 0.1)
    # channel mode computes (c_l -> full F) locally, then the
    # reduce-scatter completes the channel sum: the anchor is that local
    # conv at the shard shape
    x_loc = _randn((n, h_l, w, c // p_cf), 2, device)
    wt_loc = wt[:, :, : c // p_cf, :].contiguous()
    with torch.no_grad():
        t_fused = timer(lambda x, w: cf_conv2d(
            x, w, strides=(1, 1), sharding=sh, mesh=mesh, overlap=False),
            x, wt)
        t_compute = timer(_local_conv(k, 1), x_loc, wt_loc)
    return {"cf_axis": cf_axis, "sp_axis": sp_axis,
            "p_cf": p_cf, "p_sp": p_sp,
            "t_fused": t_fused, "t_compute": t_compute,
            "geom": {"o": k // 2, "n": n, "c_l": c // p_cf, "f": f,
                     "h_l": h_l, "w_l": w}}


def _clamp(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def _fit_composed_factors(m: Machine, cf_samples: Sequence[Mapping],
                          halo_samples: Sequence[Mapping]
                          ) -> tuple[float, float]:
    """(composed_cf_factor, composed_halo_factor) from the fused
    microbenchmarks, decomposed against the fitted machine `m` so the
    factors isolate what composition adds on top of the standalone α-β
    fits.  Per-sample ratios are clamped to [0.25, 8] (a factor outside
    that is a measurement failure, not a model truth) and the median is
    taken; 1.0 when nothing was measured."""
    ws = 4                       # the benches allocate float32
    halo_ratios = []
    for s in halo_samples:
        g = s["geom"]
        pred = _halo_time(m, g["o"], g["n"], g["c"], g["h_l"], g["w_l"],
                          g["hops"], 0)
        meas = s["t_fused"] - s["t_compute"]
        if pred > 0 and meas > 0:
            halo_ratios.append(_clamp(meas / pred, 0.25, 8.0))
    cf_ratios = []
    for s in cf_samples:
        g = s["geom"]
        pred_halo = _halo_time(m, g["o"], g["n"], g["c_l"], g["h_l"],
                               g["w_l"], 1, 0)
        pred_cf = reduce_scatter_time(
            m, s["p_cf"], g["n"] * g["f"] * g["h_l"] * g["w_l"] * ws)
        meas = s["t_fused"] - s["t_compute"] - pred_halo
        if pred_cf > 0 and meas > 0:
            cf_ratios.append(_clamp(meas / pred_cf, 0.25, 8.0))
    cf = float(np.median(cf_ratios)) if cf_ratios else 1.0
    halo = float(np.median(halo_ratios)) if halo_ratios else 1.0
    return cf, halo


def _measure_composition(specs: Sequence[ConvLayer], live: Mesh | None,
                         mesh_shape: Mapping[str, int],
                         comm_axes: Sequence[str], machine: Machine,
                         timer: Timer, max_sizes: int, wordsize: int,
                         device: torch.device) -> dict:
    """Run the composed-cost microbenchmarks against an already fitted
    `machine` and return the table entries and fitted correction factors,
    shared by calibrate() and load_or_run's backfill of files written
    before them.  No live comm axes: the analytic defaults (factors 1.0,
    no entries), as fit_eta."""
    entries: dict[tuple, float] = {}
    shuffle_samples: list[list] = []       # [p, nbytes, seconds]
    if comm_axes:
        for p_tot, nb in _representative(
                shuffle_sizes(specs, mesh_shape, wordsize), max_sizes):
            t = _bench_shuffle(live, comm_axes, nb, timer, device)
            entries[(SHUFFLE_KIND, p_tot, nb)] = t
            shuffle_samples.append([p_tot, nb, t])
    ratios = []
    for p, nb, t in shuffle_samples:
        pred = all_to_all_time(machine, p, nb)
        if pred > 0 and t > 0:
            ratios.append(_clamp(t / pred, 0.25, 8.0))
    shuffle_factor = float(np.median(ratios)) if ratios else 1.0

    cf_samples, halo_samples = [], []
    if len(comm_axes) >= 2:
        a0, a1 = comm_axes[0], comm_axes[1]
        cf_samples = [_bench_composed_cf(live, a0, a1, timer, device),
                      _bench_composed_cf(live, a1, a0, timer, device)]
        halo_samples = [_bench_product_halo(live, (a0, a1), timer, device)]
        for s in cf_samples:
            entries[("composed:cf", s["p_cf"], s["p_sp"])] = s["t_fused"]
        for s in halo_samples:
            entries[("composed:halo", s["p"], s["geom"]["hops"])] = \
                s["t_fused"]
    cf_factor, halo_factor = _fit_composed_factors(machine, cf_samples,
                                                   halo_samples)
    return {"entries": entries,
            "shuffle_factor": shuffle_factor,
            "cf_factor": cf_factor,
            "halo_factor": halo_factor,
            "shuffle_samples": shuffle_samples,
            "cf_samples": cf_samples,
            "halo_samples": halo_samples}


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------

def _fit_alpha_beta(rows: Sequence[tuple[float, float, float]],
                    default: tuple[float, float]) -> tuple[float, float]:
    """Least squares for t = a_coef*α + b_coef*β over (a_coef, b_coef, t)
    samples; falls back to `default` when the system is degenerate."""
    if len(rows) < 2:
        return default
    A = np.array([[r[0], r[1]] for r in rows], dtype=np.float64)
    y = np.array([r[2] for r in rows], dtype=np.float64)
    if np.linalg.matrix_rank(A) < 2:
        return default
    (alpha, beta), *_ = np.linalg.lstsq(A, y, rcond=None)
    return max(float(alpha), 1e-8), max(float(beta), 1e-13)


def _fit_compute(samples: Sequence[tuple[float, float]],
                 base: Machine) -> tuple[float, float, float]:
    """(peak_flops, efficiency, halfwork) from (flops, seconds) conv samples.

    The analytic model prices a compute-bound conv at
    t = (fl + halfwork) / (eff * peak) + launch, so a linear fit of t vs fl
    yields eff*peak from the slope and halfwork from the intercept; peak is
    anchored at the best achieved rate so eff lands in (0, 1]."""
    samples = [(fl, t) for fl, t in samples if fl > 0 and t > 0]
    if not samples:
        return base.peak_flops, base.compute_efficiency, base.eff_halfwork
    peak = max(fl / t for fl, t in samples)
    if len({fl for fl, _ in samples}) < 2:
        return peak, 1.0, 0.0
    A = np.array([[fl, 1.0] for fl, _ in samples], dtype=np.float64)
    y = np.array([t for _, t in samples], dtype=np.float64)
    (slope, intercept), *_ = np.linalg.lstsq(A, y, rcond=None)
    if slope <= 0:
        return peak, 1.0, 0.0
    eff = min(1.0, max(0.05, 1.0 / (slope * peak)))
    halfwork = max(0.0, (float(intercept) - LAUNCH_OVERHEAD) / float(slope))
    return peak, eff, halfwork


def _conv_flops_bytes(key: tuple, wordsize: int = 4) -> tuple[float, float]:
    kind, n, c, h, w, f, k, s = key
    h_out, w_out = -(-h // s), -(-w // s)
    if kind == "pool":
        return (float(n * f * h_out * w_out * k * k),
                float((n * c * h * w + n * f * h_out * w_out) * wordsize))
    return (2.0 * n * c * h_out * w_out * k * k * f,
            float((n * c * h * w + n * f * h_out * w_out + k * k * c * f)
                  * wordsize))


# ---------------------------------------------------------------------------
# the calibration object (JSON round-trip)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Calibration:
    """A fitted Machine, the measured EmpiricalTable and provenance
    metadata: everything the solver needs to run on measured costs."""
    machine: Machine
    table: EmpiricalTable
    meta: dict

    def to_json(self) -> dict:
        return {"schema": SCHEMA,
                "machine": dataclasses.asdict(self.machine),
                "table": self.table.to_json(),
                "meta": self.meta}

    @classmethod
    def from_json(cls, obj: Mapping) -> "Calibration":
        if obj.get("schema") != SCHEMA:
            raise ValueError(f"not a calibration file "
                             f"(schema={obj.get('schema')!r}, "
                             f"expected {SCHEMA!r})")
        return cls(machine=Machine(**obj["machine"]),
                   table=EmpiricalTable.from_json(obj["table"]),
                   meta=dict(obj.get("meta", {})))

    @property
    def fingerprint(self) -> str:
        """Content hash of the JSON: equal on every rank that holds the
        same calibration."""
        return fingerprint(self.to_json())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "Calibration":
        with open(path) as f:
            return cls.from_json(json.load(f))

    def summary(self) -> str:
        m = self.machine
        return (f"{m.name}: {len(self.table)} table entries, "
                f"peak {m.peak_flops/1e9:.1f} GFLOP/s "
                f"(eff {m.compute_efficiency:.2f}, "
                f"halfwork {m.eff_halfwork:.2e}), "
                f"capacity {m.mem_capacity/2**30:.1f} GiB/device, "
                f"mem {m.mem_bw/1e9:.1f} GB/s, "
                f"overlap eta {m.overlap_eta:.2f}, "
                f"p2p a={m.alpha*1e6:.1f}us b=1/{1/m.beta/1e9:.2f}GB/s, "
                f"coll a={m.alpha_coll*1e6:.1f}us "
                f"b=1/{1/m.beta_coll/1e9:.2f}GB/s")


def _synced(cal: Calibration, live: Mesh | None) -> Calibration:
    """Rank 0's calibration on every rank, its measured η installed for
    the chunked-CF default (the same on every rank, so their collectives
    agree).  Only a sample that resolved an η installs it: where every
    axis's comm term was too small to resolve, the fit keeps the base η
    without having measured it."""
    cal = Calibration.from_json(_broadcast(cal.to_json(), live))
    ef = cal.meta.get("eta_fit") or {}
    if any(s.get("eta") is not None for s in ef.get("samples") or ()):
        channel_conv.set_measured_eta(ef["eta"])
    return cal


# ---------------------------------------------------------------------------
# the calibration run
# ---------------------------------------------------------------------------

def _mesh_shape_of(mesh) -> dict[str, int]:
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(mesh.shape)


def _say(live: Mesh | None, msg: str) -> None:
    if _lead(live):
        print(msg)


def _measure_table(keys: Sequence[tuple], live: Mesh | None, timer: Timer,
                   device: torch.device) -> dict[tuple, float]:
    """The local conv/pool times of `keys`, measured by rank 0 alone while
    the other ranks wait ({} on them)."""
    entries: dict[tuple, float] = {}
    if _lead(live):
        for key in keys:
            t = _bench_conv_shape(key, timer, device)
            if t is not None:
                entries[key] = t
    return entries


def calibrate(specs: Sequence[ConvLayer], mesh, *,
              base: Machine = HOST_BASE,
              reps: int = 5,
              max_shapes: int = 64,
              max_sizes: int = 5,
              timer: Timer | None = None,
              allow_w_split: bool = True,
              allow_channel_filter: bool = True,
              device: torch.device | str = "cuda") -> Calibration:
    """Microbenchmark and fit for `specs` over `mesh` on `device`.

    `mesh` may be a live `launch.mesh.Mesh` (its axes of size > 1 are
    measured; every rank calls this together) or a plain {axis: size}
    mapping (shapes only: the comm constants keep the `base` values).
    `timer(fn, *args) -> seconds` defaults to `utils.time_fn` (CUDA events
    for the local kernels, the host clock for the communication); tests
    inject a deterministic fake so the logic is checkable without
    clocks."""
    device = resolve_device(str(device))
    live = _live(mesh)
    local_t = timer or _default_timer(reps)
    comm_t = _comm_timer(timer or _default_timer(reps, host=True), live)
    mesh_shape = _mesh_shape_of(mesh)

    # -- 1. local conv table over the candidate shard shapes, and the
    # memory bandwidth: rank 0 alone ----------------------------------------
    wanted = table_shapes(specs, mesh_shape, allow_w_split,
                          allow_channel_filter)
    chosen = _choose_shapes(wanted, max_shapes)
    entries = _measure_table(chosen, live, local_t, device)
    mem_bw = _bench_membw(local_t, device) if _lead(live) else base.mem_bw
    _barrier(live)
    dropped = len(wanted) - len(chosen)
    if dropped:
        _say(live, f"calibrate: capped conv grid at {len(chosen)} of "
                   f"{len(wanted)} shapes (analytic fallback covers the "
                   f"rest)")

    # -- 2. communication primitives at the emitted message sizes: every
    # rank, each sample the max over them ------------------------------------
    p2p_all, coll_all = comm_sizes(specs, mesh_shape,
                                   wordsize=base.wordsize,
                                   allow_w_split=allow_w_split,
                                   allow_channel_filter=allow_channel_filter)
    p2p_sizes = _representative(p2p_all, max_sizes)
    coll_sizes = _representative(coll_all, max_sizes)
    comm_axes = sorted(ax for ax, sz in mesh_shape.items() if sz > 1) \
        if live is not None else []

    p2p_samples: list[list] = []        # [axis, nbytes, seconds]
    coll_samples: list[list] = []       # [op, axis, p, nbytes, seconds]
    for ax in comm_axes:
        p = mesh_shape[ax]
        for nbytes in p2p_sizes:
            p2p_samples.append([ax, nbytes, _bench_p2p(live, ax, nbytes,
                                                       comm_t, device)])
        for op in ("allreduce", "reduce_scatter", "all_gather"):
            for nbytes in coll_sizes:
                coll_samples.append(
                    [op, ax, p, nbytes,
                     _bench_collective(live, ax, op, nbytes, comm_t,
                                       device)])

    # -- 3. fit the Machine constants ---------------------------------------
    alpha, beta = _fit_alpha_beta(
        [(1.0, float(nb), t) for _, nb, t in p2p_samples],
        (base.alpha, base.beta))
    # the collective fabric from the reduce-scatter / all-gather samples
    # only, whose model coefficients are unambiguous ((p-1)·α +
    # (p-1)/p·n·β).  The allreduce samples are kept for validation (meta)
    # but not fitted: perfmodel prices an allreduce as the min over
    # candidate algorithms, so fitting them to any one algorithm's
    # coefficients would under-predict the very samples fitted.
    coll_rows = [(float(p - 1), (p - 1) / p * nb, t)
                 for op, _, p, nb, t in coll_samples
                 if op != "allreduce"]
    alpha_coll, beta_coll = _fit_alpha_beta(
        coll_rows, (base.alpha_coll, base.beta_coll))

    conv_fit = [(_conv_flops_bytes(k)[0], t) for k, t in entries.items()
                if k[0] != "pool"]
    peak, eff, halfwork = _fit_compute(conv_fit, base)
    # achieved-overlap efficiency η: the overlapped-vs-serialized A/B per
    # comm axis (_bench_overlap), which scales the solver's §IV-A overlap
    # credit down to what this machine hides
    overlap_eta, eta_samples = fit_eta(mesh, timer=timer, reps=reps,
                                       base=base, device=device)
    ranks = live.size if live is not None else 1
    machine = Machine(
        name=f"calibrated-{device.type}",
        peak_flops=peak, mem_bw=mem_bw,
        alpha=alpha, beta=beta,
        alpha_coll=alpha_coll, beta_coll=beta_coll,
        wordsize=base.wordsize,
        compute_efficiency=eff, eff_halfwork=halfwork,
        mem_capacity=detect_mem_capacity(device, ranks),
        overlap_eta=overlap_eta)

    # -- 4. composed costs: §III-C shuffles at the real transition sizes,
    # fused CF x spatial, product-axis halo, measured against the fitted
    # constants above so the correction factors isolate composition ------
    comp = _measure_composition(specs, live, mesh_shape, comm_axes,
                                machine, comm_t, max_sizes, base.wordsize,
                                device)
    entries.update(comp["entries"])
    machine = dataclasses.replace(
        machine,
        composed_cf_factor=comp["cf_factor"],
        composed_halo_factor=comp["halo_factor"],
        shuffle_factor=comp["shuffle_factor"])

    meta = {
        "backend": device.type,
        "ndevices": ranks,
        "mesh": dict(mesh_shape),
        "reps": reps,
        "max_shapes": max_shapes,
        "allow_w_split": allow_w_split,
        "allow_channel_filter": allow_channel_filter,
        "shapes": {"requested": len(wanted), "measured": len(entries),
                   "dropped": dropped},
        "p2p_samples": p2p_samples,
        "collective_samples": coll_samples,
        "eta_fit": {"eta": overlap_eta, "samples": eta_samples},
        "shuffle_fit": {"factor": comp["shuffle_factor"],
                        "samples": comp["shuffle_samples"]},
        "composed_fit": {"cf_factor": comp["cf_factor"],
                         "halo_factor": comp["halo_factor"],
                         "cf_samples": comp["cf_samples"],
                         "halo_samples": comp["halo_samples"]},
        "mem_capacity_source": mem_capacity_source(device, ranks),
        "layers": [l.name for l in specs],
    }
    if device.type == "cuda":
        meta.update(card_fields())
    return _synced(Calibration(machine=machine, table=EmpiricalTable(entries),
                               meta=meta), live)


def _chosen_shapes_for(cal: Calibration, specs: Sequence[ConvLayer],
                       mesh_shape: Mapping[str, int]) -> list[tuple]:
    """The conv-shape grid a fresh calibration of `specs` over `mesh_shape`
    would measure under `cal`'s own settings (shape cap, candidate flags):
    the one definition both `coverage` and `grow` judge against."""
    m = cal.meta
    wanted = table_shapes(specs, mesh_shape,
                          allow_w_split=m.get("allow_w_split", True),
                          allow_channel_filter=m.get("allow_channel_filter",
                                                     True))
    return _choose_shapes(wanted, int(m.get("max_shapes", 64)))


def coverage(cal: Calibration, specs: Sequence[ConvLayer],
             mesh_shape: Mapping[str, int]) -> float:
    """Fraction of the table keys a fresh calibration of `specs` over
    `mesh_shape`, run with `cal`'s own settings, would measure that
    `cal`'s table holds: a capped self-calibration scores 1.0, a table
    measured for another network or mesh near 0."""
    chosen = _chosen_shapes_for(cal, specs, mesh_shape)
    if not chosen:
        return 1.0
    return sum(k in cal.table.entries for k in chosen) / len(chosen)


def grow(cal: Calibration, specs: Sequence[ConvLayer], mesh, *,
         reps: int = 5, timer: Timer | None = None,
         device: torch.device | str = "cuda") -> int:
    """Measure the conv shapes a calibration of `specs`/`mesh` would pick
    that `cal`'s table is missing, and merge them in (rank 0 measures;
    every rank ends with its table).  Machine constants are kept: they
    are shape-independent fits.  Returns the number of entries added."""
    device = resolve_device(str(device))
    live = _live(mesh)
    chosen = _chosen_shapes_for(cal, specs, _mesh_shape_of(mesh))
    missing = [k for k in chosen if k not in cal.table.entries]
    found = _measure_table(missing, live, timer or _default_timer(reps),
                           device)
    rows = _broadcast([[list(k), t] for k, t in found.items()], live)
    found = EmpiricalTable.from_json(rows).entries
    if found:
        cal.table.entries.update(found)
        grown = cal.meta.setdefault("grown", [])
        grown.append({"layers": [l.name for l in specs],
                      "mesh": _mesh_shape_of(mesh), "added": len(found)})
    return len(found)


def load_or_run(path: str, specs: Sequence[ConvLayer], mesh, *,
                grow_table: bool = False,
                device: torch.device | str = "cuda",
                **kwargs) -> Calibration:
    """Load a calibration from `path` when it exists, else run one over
    `specs`/`mesh` and save it there: what makes `--calibrate` idempotent
    across runs.  On a live mesh every rank calls it; rank 0 decides,
    reads and writes, and every rank returns its calibration.

    A loaded file is checked against the requested specs/mesh: a table
    measured for another network or mesh mostly misses and degrades to
    the analytic model, so low coverage gets a loud warning (not an
    error).  With `grow_table=True` the missing shard shapes are measured
    instead and merged back into `path`."""
    live = _live(mesh)
    lead = _lead(live)
    exists = _broadcast(bool(path) and lead and os.path.exists(path), live)
    if not exists:
        cal = calibrate(specs, mesh, device=device, **kwargs)
        if path and lead:
            cal.save(path)
        _say(live, f"calibration written to {path}: {cal.summary()}")
        return cal
    cal = Calibration.from_json(_broadcast(
        Calibration.load(path).to_json() if lead else None, live))
    _say(live, f"calibration loaded from {path}: {cal.summary()}")
    mesh_shape = _mesh_shape_of(mesh)
    save = lead and bool(path)
    if cal.meta.get("mesh") not in (None, dict(mesh_shape)):
        _say(live, f"calibrate: WARNING: {path} was measured on mesh "
                   f"{cal.meta['mesh']}, not {dict(mesh_shape)}")
    if "eta_fit" not in cal.meta:
        # a file written before the η fit: backfill the achieved-overlap
        # measurement now (the Machine JSON lacked the field and loaded at
        # the optimistic η = 1 default) and persist it
        eta, samples = fit_eta(mesh, timer=kwargs.get("timer"),
                               reps=kwargs.get("reps", 5), device=device)
        cal.machine = dataclasses.replace(cal.machine, overlap_eta=eta)
        cal.meta["eta_fit"] = {"eta": eta, "samples": samples}
        if save:
            cal.save(path)
        _say(live, f"calibrate: backfilled overlap eta={eta:.2f} into "
                   f"{path}")
    if "mem_capacity_source" not in cal.meta:
        cal.meta["mem_capacity_source"] = mem_capacity_source(
            device, live.size if live is not None else 1)
        if save:
            cal.save(path)
    if "shuffle_fit" not in cal.meta or "composed_fit" not in cal.meta:
        # a file written before the composition benches: measure them now
        # against the stored machine constants (the Machine JSON lacked the
        # factor fields and loaded at the analytic 1.0) and persist
        reps = kwargs.get("reps", 5)
        timer = _comm_timer(kwargs.get("timer")
                            or _default_timer(reps, host=True), live)
        comm_axes = sorted(ax for ax, sz in mesh_shape.items()
                           if sz > 1) if live is not None else []
        comp = _measure_composition(
            specs, live, mesh_shape, comm_axes, cal.machine, timer,
            kwargs.get("max_sizes", 5), cal.machine.wordsize,
            resolve_device(str(device)))
        cal.table.entries.update(comp["entries"])
        cal.machine = dataclasses.replace(
            cal.machine,
            composed_cf_factor=comp["cf_factor"],
            composed_halo_factor=comp["halo_factor"],
            shuffle_factor=comp["shuffle_factor"])
        cal.meta.setdefault(
            "shuffle_fit", {"factor": comp["shuffle_factor"],
                            "samples": comp["shuffle_samples"]})
        cal.meta.setdefault(
            "composed_fit", {"cf_factor": comp["cf_factor"],
                             "halo_factor": comp["halo_factor"],
                             "cf_samples": comp["cf_samples"],
                             "halo_samples": comp["halo_samples"]})
        if save:
            cal.save(path)
        _say(live, f"calibrate: backfilled composed-cost fit into {path} "
                   f"(shuffle x{comp['shuffle_factor']:.2f}, "
                   f"cf x{comp['cf_factor']:.2f}, "
                   f"halo x{comp['halo_factor']:.2f})")
    if grow_table:
        added = grow(cal, specs, mesh, reps=kwargs.get("reps", 5),
                     timer=kwargs.get("timer"), device=device)
        if added:
            if save:
                cal.save(path)
            _say(live, f"calibrate: grew {path} by {added} table entries "
                       f"({len(cal.table)} total)")
    cal = _synced(cal, live)
    cov = coverage(cal, specs, mesh_shape)
    if cov < 0.5:
        _say(live, f"calibrate: WARNING: {path} covers only {cov:.0%} of "
                   f"this network's shard shapes — the rest falls back to "
                   f"the analytic model; delete the file (or pass another "
                   f"path) to re-measure for this network")
    return cal


def refit_from_attribution(cal: Calibration, report: Mapping, *,
                           path: str | None = None,
                           damp: float = 1.0) -> dict:
    """Close the attribution loop: fold a measured per-term drift report
    (NetworkPlan.attribution_report) back into the calibration's
    composition factors, so model/measured drift drives recalibration
    instead of only printing a warning.

    The comm-side term drifts map onto the factors that price them:
    `shuffle` -> shuffle_factor; `fp_comm`/`bp_comm` (halo and CF
    collectives) -> both composed factors, weighted by predicted seconds.
    Compute-side terms (fp/bp_compute, bpa) are left to the conv table and
    the collective fit.

    Each factor takes a multiplicative step drift**damp clamped to
    [0.25, 4] per refit and [0.1, 10] absolute; the applied steps append to
    meta["attribution_refits"].  Saves to `path` when given.  Returns the
    {factor: new value} dict of what changed."""
    terms = report.get("terms") or {}

    def drift_of(*names):
        num = den = 0.0
        for t in names:
            row = terms.get(t)
            if row and row.get("predicted_s", 0) > 0 and \
                    row.get("drift", 0) > 0:
                num += row["predicted_s"] * row["drift"]
                den += row["predicted_s"]
        return (num / den) if den > 0 else None

    def step(cur, drift):
        mult = _clamp(drift ** damp, 0.25, 4.0)
        return _clamp(cur * mult, 0.1, 10.0)

    changed: dict[str, float] = {}
    sh_drift = drift_of("shuffle")
    if sh_drift is not None:
        changed["shuffle_factor"] = step(cal.machine.shuffle_factor,
                                         sh_drift)
    comm_drift = drift_of("fp_comm", "bp_comm")
    if comm_drift is not None:
        changed["composed_cf_factor"] = step(
            cal.machine.composed_cf_factor, comm_drift)
        changed["composed_halo_factor"] = step(
            cal.machine.composed_halo_factor, comm_drift)
    if changed:
        cal.machine = dataclasses.replace(cal.machine, **changed)
        cal.meta.setdefault("attribution_refits", []).append(
            {"worst_term": report.get("worst_term"),
             "drifts": {"shuffle": sh_drift, "comm": comm_drift},
             "applied": dict(changed)})
        if path:
            cal.save(path)
    return changed


# ---------------------------------------------------------------------------
# CLI:  PYTHONPATH=src python -m repro_torch.core.calibrate --arch mesh1k
#       (torchrun --nproc-per-node M ... --model M for a live mesh)
# ---------------------------------------------------------------------------

def main(argv=None) -> Calibration:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.calibrate",
        description="Calibrate the §V perf model on the card (or the CPU) "
                    "and write BENCH_calibration.json")
    ap.add_argument("--arch", default="mesh1k",
                    help="CNN arch whose layer shapes seed the table "
                         "(mesh1k | mesh2k | resnet50)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--max-shapes", type=int, default=64)
    ap.add_argument("--no-cf", action="store_true",
                    help="leave out the channel/filter candidates' shapes")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=DEFAULT_PATH)
    args = ap.parse_args(argv)

    from repro_torch.configs import registry
    from repro_torch.launch.mesh import init_distributed, make_mesh
    arch = registry.canon(args.arch)
    if arch not in registry.CNN_ARCHS:
        ap.error(f"--arch {args.arch}: calibration covers the CNN archs "
                 f"{registry.CNN_ARCHS}")
    cfg = registry.get(arch, smoke=args.smoke)
    if arch == "resnet50":
        from repro_torch.models.cnn import resnet
        specs = resnet.layer_specs(args.batch, cfg)
    else:
        from repro_torch.models.cnn import meshnet
        specs = meshnet.layer_specs(cfg, args.batch)
    device = resolve_device(args.device)
    rank, world, local = init_distributed(device)
    if device.type == "cuda":
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    shape = {"data": args.data, "model": args.model}
    if world > 1:
        mesh = make_mesh(args.data, args.model)
    elif args.data * args.model > 1:
        mesh = shape              # one process: shapes only, no comm
    else:
        mesh = None
    # load_or_run keeps the CLI idempotent: an existing --out is loaded
    # (with the coverage check), never silently re-measured over
    cal = load_or_run(args.out, specs, mesh, reps=args.reps,
                      max_shapes=args.max_shapes,
                      allow_channel_filter=not args.no_cf, device=device)
    if rank == 0:
        print(cal.summary())
        print(f"calibration fingerprint {cal.fingerprint}")
    return cal


if __name__ == "__main__":
    main()
