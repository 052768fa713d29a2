"""The dry run, port of `repro.launch.dryrun`: one rank of every (arch x
shape) cell on the production mesh traced on fake tensors, and the
static-analysis lane (`--audit`).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b \
      --shape train_4k [--multi-pod] [--variant base|opt|vpz] \
      [--out build/dryrun] [--device cuda|cpu] [--rank R]

A cell.  The reference lowers and compiles each cell's SPMD program on
512 host devices and reads XLA's cost and memory analyses.  PyTorch has
no such compile, so the port runs what one rank of the cell runs, once,
abstractly: the process joins torch.distributed's fake group as rank
`--rank` of the mesh's 256 or 512 (default the last, the busiest rank of
the causal ring), builds the cell with the port's own entry points
(`build_lm_cell`, `build_cnn_cell`) and runs its step once under
`FakeTensorMode` (no tensor holds data; a kernel's custom op returns its
outputs' shapes), counting as it goes:

  * `per_device.flops`: `torch.utils.flop_counter.FlopCounterMode`'s
    count (each kernel's custom op by its own formula: attention 4 B Hq D
    a pair the masks admit, the SSD's bound, the conv's 2 N Ho Wo K^2 C F);
  * `hbm_bytes`: the bytes of every op's tensor inputs and outputs (eager
    per-op traffic, each op on its own: no fusion, unlike XLA's count;
    views and empty allocations count nothing);
  * `collective_bytes`, `collectives`: every transfer the step issues
    (`analysis.collectives.record`: the mesh's collectives, halos, ring
    and prefix shifts, all-to-alls, the params' gathers at use and their
    gradients' reduce-scatters, the gradient bucket and ZeRO-1's
    post-update gather), each by the bytes of its result on this rank, as
    the reference's `collective_bytes` counts them, per kind under the
    reference's names;
  * memory (`torch.distributed._tools.mem_tracker.MemTracker`, CUDA
    allocations rounded to 512 bytes as the caching allocator rounds
    them): `argument_bytes` the step's inputs (params, optimizer state,
    batch, caches), `output_bytes` what it returns that is new,
    `alias_bytes` what it returns in its inputs' storage (params and
    optimizer state updated in place, a decode step's caches),
    `peak_bytes` the most held at once, inputs included, and
    `temp_bytes` = peak - argument - output + alias, so that the
    reference's identity peak = argument + output + temp - alias holds;
  * `kernel_calls`: each kernel's custom-op calls (0 on the CPU, where
    the plain versions run).

The roofline is the H100 SXM's data sheet: peak 989e12 FLOP/s (bf16
dense, every LM cell's compute dtype) or 67e12 (fp32, the `H100`
preset's: the CNNs), HBM 3.35e12 B/s and 450e9 B/s per NVLink
direction (the preset's beta).  A 256-card mesh spans 32 nodes, whose
inter-node links are slower than NVLink, so the collective term is a
lower bound.  An eager step counts every layer, so `raw_scan_counted_once`
and `probe` (the reference's depth-2/4 extrapolation) are null.

Params: every LM cell holds them at rest as the reference's
`build_lm_cell` does, each leaf its `fsdp_tree_specs` cuts as this
rank's block over "data" (`launch.shardings.rest_dims`), gathered where
a layer uses it (`transformer.forward`, `prefill`, `decode_step` under
`ShardCtx.rest`), in the reference's dtypes: fp32 masters for the train
cells (bf16 for a MoE whose experts "model" does not divide under `opt`
/ `vpz`), bf16 for prefill and decode, whose KV caches, conv buffers and
encoder memory are bf16 too (the SSM state fp32), with the norms, the
SSD's scalars and the router fp32 in every cell
(`transformer.in_dtype`).  A train cell's optimizer state is the block
(or its cut over "model" under `opt` / `vpz`, ZeRO-1 over "data" x
"model").  Differences by construction: under `opt` / `vpz` the
vocabulary is each rank's block over "model" (a serving cell's only
where "model" divides it, as the reference's) and, where "model"
divides the experts (`opt`), so are the experts, each cut within that
block at rest, where the reference places the vocabulary over "model"
alone; a serving cell, which has no expert axis and no vocab-parallel
loss, gathers such a block whole over "model" at its use
(`ShardCtx.model_blocks`).  A VLM's patch prefix and its text are one
sequence split over "model" (`data.pipeline.shard_lm_batch`), where the
reference splits each on its own.  A cell that cannot be held at rest
or traced raises; nothing is forged.  Fake CUDA tensors need a
CUDA build of torch (no card is used): on a CPU-only build the ops that
take a CUDA device guard (indexing, autograd's bookkeeping) fail, so
there `--device cpu` traces the plain versions' path instead.

Writes one JSON file a cell (`<arch>-<shape>-pod1|pod2[-variant].json`)
under `--out`, with the reference's keys and `rank`, `device`.
`launch.sweep` runs every cell, one process each (the fake group is
global to a process).

The audit lane:

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.dryrun \
      --audit [WORKLOAD ...] [--audit-out FILE] [--no-hlo] \
      [--search greedy|beam[:N]|hillclimb] [--device cuda|cpu]

The bench workloads' plans (`repro_torch.analysis.workloads`, the
reference's registry) are solved on the mesh of the running processes,
data = world // 2 x model 2 on 4 (the reference's 4 host devices), on
the `H100` preset on CUDA and on `LASSEN` (the paper's machine) on the
CPU, as `launch/train.py` solves.  Each is linted and its collectives
audited (`NetworkPlan.audit`: one real step, forward, backward and the
gradient bucket, on seeded params and the synthetic batch, joined against
the priced inventory, and with the profiler cross-check unless
`--no-hlo`).  On a mesh without a model axis of size > 1 the workloads
that need one are skipped, as in the reference.  Every rank audits its
own record; the errors counted are the maximum over the ranks.  Rank 0
prints the findings and writes one `repro/plan_audit@1` JSON (the
reference's keys; `collective_backend`, the torch.distributed backend, in
place of its `replication_policy`).  Any error-severity finding exits
non-zero.  Runs on CUDA unless `--device cpu` is given (gloo ranks on the
CPU, NCCL on the card under torchrun; a process group that already exists
is used as it is).
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import time
from typing import Any

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import analysis
from repro_torch.analysis import workloads as WL
from repro_torch.configs import registry
from repro_torch.core.perfmodel import H100, LASSEN
from repro_torch.core.plan import PlanError
from repro_torch.core.strategy import CapacityError, parse_search
from repro_torch.launch import shardings
from repro_torch.launch.mesh import (PRODUCTION_MESH, Mesh, batch_axes,
                                     init_distributed, init_fake_group,
                                     make_mesh, make_production_mesh)
from repro_torch.utils import BF16, FP32, resolve_device, tree_leaves, tree_map

SCHEMA = "repro/plan_audit@1"

# ---------------------------------------------------------------------------
# the card (NVIDIA H100 SXM data sheet, dense)
# ---------------------------------------------------------------------------
PEAK_FLOPS = {torch.bfloat16: 989e12,      # bf16 on the tensor cores
              torch.float32: H100.peak_flops}   # fp32 (the H100 preset)
HBM_BW = H100.mem_bw                       # 3.35e12 B/s
# one NVLink direction (the preset's beta).  A 256-card mesh spans 32
# nodes of 8, so most of its links are slower: the term is a lower bound.
LINK_BW = 1.0 / H100.beta_coll             # 450e9 B/s
HBM_CAPACITY = 80 * 2 ** 30                # bytes a card

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# the recorder's kinds, under the reference's (XLA's) names
_KIND = {"psum": "all-reduce", "pmax": "all-reduce",
         "all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
         "all_to_all": "all-to-all", "ppermute": "collective-permute"}
# each kernel's custom ops
KERNEL_OPS = {"flash_attention": "flash_attention",
              "flash_attention_block": "flash_attention",
              "ssd_chunk": "ssd_chunk", "conv2d": "conv2d"}
KERNELS = ("conv2d", "flash_attention", "ssd_chunk")


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

def _mesh_of(mesh, rank: int | None) -> Mesh:
    """`mesh` as a `Mesh`: one given, or a dict of axis sizes laid out for
    `rank` alone (shapes only, no process group)."""
    if isinstance(mesh, Mesh):
        return mesh
    shape = dict(mesh)
    n = math.prod(shape.values())
    return Mesh(shape, rank=n - 1 if rank is None else rank)


def _fake() -> bool:
    from torch._guards import active_fake_mode
    return active_fake_mode() is not None


def _rehome(tree: Any, device: torch.device, dtype=None) -> Any:
    """`tree`'s leaves as new leaves on `device` (in `dtype`) that
    require grad: under a fake mode empty ones (a leaf drawn on the host
    moves nowhere), else copies."""
    def move(t):
        dt = dtype if dtype is not None and t.is_floating_point() \
            else t.dtype
        if _fake():
            out = torch.empty(t.shape, dtype=dt, device=device)
        else:
            out = t.detach().to(device=device, dtype=dt)
        return out.requires_grad_(t.is_floating_point())
    return tree_map(move, tree)


def _lm_params(cfg, mesh: Mesh, device: torch.device, dtype, *,
               vocab: bool = False, experts: bool = False):
    """(params, rest): `transformer.init`'s params of `cfg` from seed 0
    in `dtype` (the reference's rule: the norms, the SSD's scalars and
    the router stay fp32), as this rank holds them at rest on `mesh`.
    With `vocab` / `experts` the vocabulary / each MoE layer's experts
    are this rank's block over "model" (`shardings.vocab_blocks`,
    `expert_blocks`); each leaf that `shardings.rest_dims` cuts (`rest`,
    read from the stacked shapes, `transformer.stack_counts`) is this
    rank's block over "data" of that.  The placement is read from the
    shapes first (a fake init); then each layer is drawn, cast and cut
    before the next is drawn (`transformer.init(place=)`), so no whole
    copy of the params is ever held: on the card from a CUDA generator,
    else on the host (under a fake mode shapes only) and moved.  A leaf
    that cannot be held at rest raises (`rest_dims`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models.lm import transformer

    def blocks_over_model(params):
        if vocab:
            params = shardings.vocab_blocks(params, mesh)
        return shardings.expert_blocks(params, mesh) if experts else params
    with contextlib.nullcontext() if _fake() else FakeTensorMode():
        shapes = transformer.init(torch.Generator(), cfg, device="cpu")
        rest = shardings.rest_dims(blocks_over_model(shapes), mesh,
                                   transformer.stack_counts(shapes, cfg))
    del shapes
    on_card = device.type == "cuda" and not _fake()

    def place(path, sub):
        if not on_card:
            sub = _rehome(sub, device)
        name = path[0]
        if vocab and name in shardings.VOCAB_DIMS:
            sub = shardings.vocab_blocks({name: sub}, mesh)[name]
        if experts and name == "layers":
            sub = shardings.expert_blocks({"layers": [sub]},
                                          mesh)["layers"][0]
        at = rest[name] if len(path) == 1 else rest[name][path[1]]
        return shardings.param_blocks(sub, at, mesh)
    gen = torch.Generator(device=device if on_card else "cpu")
    gen.manual_seed(0)
    params = transformer.init(gen, cfg, device=device if on_card else "cpu",
                              dtype=dtype, place=place)
    return params, rest


def _block(shape, spec, mesh: Mesh) -> tuple[int, ...]:
    """This rank's block shape of a global `shape` under `spec` (an axis,
    a tuple of axes or None per dim)."""
    out = []
    for n, axes in zip(shape, tuple(spec) + (None,) * len(shape)):
        m = mesh.axis_size(axes) if axes else 1
        if n % m:
            raise ValueError(f"extent {n} does not divide over {axes} "
                             f"({m} shards)")
        out.append(n // m)
    return tuple(out)


def _ints(shape, high: int, device) -> torch.Tensor:
    return torch.randint(0, high, shape, dtype=torch.int32, device=device)


def _normals(shape, dtype, device) -> torch.Tensor:
    return torch.randn(shape, device=device).to(dtype)


def build_lm_cell(arch: str, shape: str, mesh, variant: str = "base",
                  cfg=None, device="cuda", rank: int | None = None):
    """(step, args, cfg) of one rank of an LM cell on `mesh` (a `Mesh`
    over the running process group, or a dict of axis sizes laid out for
    `rank`, the last by default, which builds the arguments only).

    The reference's placement: the batch B over the batch axes where the
    global batch divides over them (`bspec`), else whole with the
    sequence over ("data", "model"); train and prefill split the sequence
    over "model"; a decode cell's KV cache is split along S over the
    sequence axes (`shardings.kv_cache_specs`) and its step runs at
    length seq - 1 (the whole cache read); an encoder-decoder's frames
    (at most 4096 for decode) over "model" and its memory over the
    sequence axes from seq 8192, else "model".  `variant` "opt" / "vpz":
    the vocab-parallel loss (the vocabulary a block over "model"),
    ZeRO-1 over ("data", "model"), and for a MoE whose experts do not
    divide over "model" bf16 master weights and two micro-batches; "opt"
    adds expert parallelism where they divide.  A serving cell under
    "opt" / "vpz" holds the vocabulary (where "model" divides it) and,
    under "opt", the experts as blocks over "model", gathered whole at
    their use.  Every cell's params are held at rest (`_lm_params`):
    fp32 for training (bf16 for the big MoE's tuned masters), bf16 for
    prefill and decode, whose caches are bf16 blocks.  `cfg` overrides the
    registry's config (a reduced one, as the reference's probes pass
    it); `shape` may then be a dict of SHAPES' keys."""
    from repro_torch.models.lm import transformer
    from repro_torch.models.lm.modules import ShardCtx
    from repro_torch.optim.optimizer import adamw
    from repro_torch.train.train_loop import TrainStepConfig, make_train_step
    dev = torch.device(device)
    mesh = _mesh_of(mesh, rank)
    cfg = cfg or registry.get(arch)
    info = registry.SHAPES[shape] if isinstance(shape, str) else dict(shape)
    seq, gbatch, kind = info["seq_len"], info["global_batch"], info["kind"]
    if variant not in ("base", "opt", "vpz"):
        raise ValueError(f"variant {variant!r}: base, opt or vpz")
    ba = batch_axes(mesh)
    nb = mesh.axis_size(ba)
    bspec = ba if gbatch % max(nb, 1) == 0 and gbatch >= nb else None
    seq_axes = "model" if bspec is not None else ("data", "model")
    b_loc = gbatch // nb if bspec is not None else gbatch
    m_sz = mesh.axis_size("model")
    tuned = variant in ("opt", "vpz")
    if kind == "train":
        if bspec is None:
            raise ValueError(f"train cell: batch {gbatch} does not divide "
                             f"over {ba}")
        ctx = ShardCtx(mesh=mesh, seq_axis="model", batch_axes=ba,
                       tp_axis="model" if variant == "opt" and
                       cfg.n_experts else None)
    else:
        ctx = ShardCtx(mesh=mesh, seq_axis=seq_axes,
                       batch_axes=ba if bspec is not None else ())
    big_moe = bool(cfg.n_experts) and cfg.n_experts % m_sz != 0
    p_dtype = torch.bfloat16 if kind != "train" or (tuned and big_moe) \
        else torch.float32
    ep = variant == "opt" and bool(cfg.n_experts) and \
        cfg.n_experts % m_sz == 0
    # the vocabulary over "model": the train cells' vocab-parallel loss
    # pads it; a serving cell's only where "model" divides it
    vocab = tuned and (kind == "train" or cfg.vocab % m_sz == 0)
    params, rest = _lm_params(cfg, mesh, dev, p_dtype, vocab=vocab,
                              experts=ep)
    ctx = dataclasses.replace(ctx, rest=rest)
    if kind != "train":
        # no tp_axis and no vocab-parallel loss: read whole at their use
        ctx = dataclasses.replace(ctx, model_blocks=("vocab",) * vocab
                                  + ("experts",) * ep)

    extra: dict[str, Any] = {}
    s_loc = seq // mesh.axis_size(ctx.seq_axis)
    if cfg.frontend == "vit_stub" and kind != "decode":
        # the prefix + text sequence cut into equal blocks
        # (`data.pipeline.shard_lm_batch`): this rank's prefix rows
        fl = min(cfg.frontend_len, seq // 2)
        lo = mesh.index(ctx.seq_axis) * s_loc
        n_img = max(0, min(lo + s_loc, fl) - lo)
        extra["patch_embeds"] = _normals((b_loc, n_img, cfg.d_model),
                                         torch.bfloat16, dev)
        n_text = s_loc - n_img
    else:
        fl, n_text = 0, s_loc
    if cfg.frontend == "audio_stub":
        enc_len = seq if kind != "decode" else min(seq, 4096)
        extra["frames"] = _normals(
            _block((gbatch, enc_len, cfg.d_model), (bspec, "model", None),
                   mesh), torch.bfloat16, dev)

    if kind == "train":
        opt = adamw(3e-4)
        roles = shardings.leaf_roles(params, vocab=vocab, experts=ep)
        scfg = TrainStepConfig(
            precision=BF16, grad_accum=2 if tuned and big_moe else 1,
            zero_axes=("data", "model") if tuned else ("data",))
        opt_state = opt.init(shardings.local_shards(
            params, mesh, scfg.zero_axes, roles, rest))
        labels = _ints((b_loc, s_loc), cfg.vocab, dev)
        if fl:
            pos = mesh.index(ctx.seq_axis) * s_loc + torch.arange(
                s_loc, device=dev)
            labels = torch.where(pos < fl, -1, labels)
        batch = {"tokens": _ints((b_loc, n_text), cfg.vocab, dev),
                 "labels": labels}
        batch.update(extra)

        def loss(p, b):
            return transformer.loss_fn(p, b, cfg, remat=True, ctx=ctx,
                                       vocab_parallel=tuned)
        step = make_train_step(loss, opt, scfg, mesh=mesh, roles=roles,
                               rest=rest)
        return step, (params, opt_state, None, batch), cfg

    if kind == "prefill":
        batch = {"tokens": _ints((b_loc, n_text), cfg.vocab, dev)}
        batch.update(extra)

        def prefill_fn(p, b):
            return transformer.prefill(
                p, cfg, b["tokens"], ctx, extra_embeds=b.get("patch_embeds"),
                frames=b.get("frames"))
        return prefill_fn, (params, batch), cfg

    # decode: this rank's blocks of the bf16 caches of the global batch
    # and sequence under the reference's specs (`kv_cache_specs`: K/V B
    # over the batch axes where it is split and S over the sequence axes,
    # the SSM entries B only), allocated as blocks
    caches = transformer.init_decode_state(cfg, b_loc, s_loc, device=dev,
                                           dtype=p_dtype)
    tokens = _ints((b_loc, 1), cfg.vocab, dev)
    mem = None
    if cfg.is_encdec:
        mem_axes = seq_axes if seq >= 8192 else "model"
        mem = _normals(_block((gbatch, min(seq, 4096), cfg.d_model),
                              (bspec, mem_axes, None), mesh),
                       p_dtype, dev)

    def decode_fn(p, t, c, length, m):
        return transformer.decode_step(p, cfg, t, c, length, ctx, memory=m)
    return decode_fn, (params, tokens, caches, seq - 1, mem), cfg


def build_cnn_cell(arch: str, mesh, batch: int = 32, variant: str = "base",
                   device="cuda", rank: int | None = None, cfg=None):
    """(step, args, cfg) of one rank of the paper's own workload on `mesh`
    (as `build_lm_cell`'s): the trainer's uniform plan (every layer's H
    over "model", N over the batch axes, fitted to each layer's
    geometry), SGD with momentum, FP32, one step on this rank's block of
    the global batch.  The CNNs train in FP32 (the trainer's `--bf16`
    refuses them), so `variant` "opt" (the reference's bf16 CNN cell)
    raises."""
    from repro_torch.core.plan import NetworkPlan, compile_order
    from repro_torch.core.spatial_conv import ConvSharding
    from repro_torch.models.cnn import meshnet, resnet
    from repro_torch.optim.optimizer import sgd
    from repro_torch.train.train_loop import TrainStepConfig, make_train_step
    if variant != "base":
        raise ValueError(f"the CNN cells train in FP32; variant "
                         f"{variant!r} (bf16) is the LM archs'")
    dev = torch.device(device)
    mesh = _mesh_of(mesh, rank)
    cfg = cfg or registry.get(arch)
    gen = torch.Generator().manual_seed(0)
    if arch == "resnet50":
        specs = resnet.layer_specs(batch, cfg)
        graph = resnet.resnet_graph(batch, cfg)
        params, mod = resnet.init(gen, cfg), resnet
        labels = ((batch,), cfg.n_classes)
        last = resnet.last_layer(cfg)
    else:
        specs, graph = meshnet.layer_specs(cfg, batch), None
        params, mod = meshnet.init(gen, cfg), meshnet
        labels = ((batch, cfg.out_hw, cfg.out_hw, 1), None)
        last = "pred"
    every = specs if graph is None else compile_order(graph, specs)
    plan = NetworkPlan.uniform(
        ConvSharding(batch_axes=batch_axes(mesh), h_axis="model"),
        specs=every, mesh=mesh, graph=graph)
    rest = shardings.rest_dims(params, mesh)
    params = shardings.param_blocks(_rehome(params, dev), rest, mesh)
    shape = dict(mesh.shape)
    first = plan.sharding(specs[0].name)
    out = plan.out_sharding(last) if arch == "resnet50" else \
        plan.sharding(last)        # the labels cut as the trainer cuts them
    x_shape = (batch, cfg.input_hw, cfg.input_hw, cfg.in_channels)
    y_shape, n_classes = labels
    y_sh = out.fit(y_shape[1], y_shape[2], 1, 1, shape) \
        if len(y_shape) == 4 else out
    bdict = {"image": _normals(_block(x_shape, first.x_spec(), mesh),
                               torch.float32, dev)}
    y_block = _block(y_shape, y_sh.x_spec()[:len(y_shape)], mesh)
    bdict["label"] = _ints(y_block, n_classes, dev).long() if n_classes \
        else (torch.rand(y_block, device=dev) < 0.1).float()
    opt = sgd(0.1, momentum=0.9)
    opt_state = opt.init(shardings.local_shards(params, mesh, rest=rest))
    loss = functools.partial(mod.loss_fn, cfg=cfg, plan=plan, mesh=mesh)
    step = make_train_step(loss, opt, TrainStepConfig(precision=FP32),
                           mesh=mesh, rest=rest)
    return step, (params, opt_state, None, bdict), cfg


# ---------------------------------------------------------------------------
# one step, measured
# ---------------------------------------------------------------------------

class _OpCounter(TorchDispatchMode):
    """Sums the bytes of every op's tensor inputs and outputs and counts
    each kernel's custom-op calls.  Metadata ops (`prim::`), empty
    allocations and views (an op that does not write and returns its
    input's storage) count no bytes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.name()
        if name.startswith("repro::"):
            self.calls[KERNEL_OPS[name.split("::")[1].split(".")[0]]] += 1
        if name.startswith("prim::") or "empty" in name:
            return out
        ins = [t for t in tree_leaves([list(args),
                                       list((kwargs or {}).values())])
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(list(out) if isinstance(
            out, (list, tuple)) else [out]) if isinstance(t, torch.Tensor)]
        if not func._schema.is_mutable:
            seen = {t.untyped_storage()._cdata for t in ins}
            if any(t.untyped_storage()._cdata in seen for t in outs):
                return out
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        return out


def _storages(tree) -> dict[int, int]:
    """{storage: bytes} of the tensors of `tree` (tuples, lists, dicts,
    NamedTuples), each storage once."""
    out = {}
    for t in tree_leaves(_plain(tree)):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def _plain(tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [_plain(t) for t in tree]
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(t) for t in tree]
    return tree


def _rounded(nbytes: int, device: torch.device) -> int:
    """An allocation's bytes as the CUDA caching allocator rounds them."""
    return -(-nbytes // 512) * 512 if device.type == "cuda" else nbytes


def collective_summary(ops, mesh: Mesh) -> dict:
    """The recorder's transfers per kind under the reference's names,
    each op by the bytes of its result on this rank (an all-gather's
    payload times its group, a reduce-scatter's over it), and `count`."""
    out = {k: 0 for k in COLLECTIVES}
    out["count"] = 0
    for op in ops:
        kind = _KIND.get(op.kind)
        if kind is None:
            continue
        p = mesh.axis_size(tuple(op.axes)) if op.axes else 1
        nbytes = op.bytes * p if kind == "all-gather" else \
            op.bytes / p if kind == "reduce-scatter" else op.bytes
        out[kind] += int(nbytes)
        out["count"] += 1
    return out


def measure_step(step, args, mesh: Mesh, device, memory: bool = True):
    """Run `step(*args)` once, counting: FLOPs (`FlopCounterMode`), the
    ops' bytes and each kernel's custom-op calls (`_OpCounter`), the
    transfers (`analysis.collectives.record`) and, with `memory`, the
    memory `MemTracker` sees (the arguments tracked as held before the
    step).  Returns (the step's output, the counts)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    dev = torch.device(device)
    arg_st = _storages(args)
    mt = MemTracker() if memory else None
    if mt is not None:
        mt.track_external(*[t for t in tree_leaves(_plain(args))
                            if isinstance(t, torch.Tensor)])
    counter = _OpCounter()
    with contextlib.ExitStack() as stack:
        rec = stack.enter_context(analysis.record())
        fc = stack.enter_context(FlopCounterMode(display=False))
        if mt is not None:
            stack.enter_context(mt)
        stack.enter_context(counter)
        out = step(*args)
    res = {"flops": int(fc.get_total_flops()), "hbm_bytes": counter.bytes,
           "collectives": collective_summary(rec.ops, mesh),
           "kernel_calls": {k: counter.calls.get(k, 0) for k in KERNELS}}
    res["collective_bytes"] = sum(v for k, v in res["collectives"].items()
                                  if k != "count")
    if mt is not None:
        out_st = _storages(out)
        alias = sum(_rounded(b, dev) for k, b in out_st.items()
                    if k in arg_st)
        res.update(
            argument_bytes=sum(_rounded(b, dev) for b in arg_st.values()),
            output_bytes=sum(_rounded(b, dev) for k, b in out_st.items()
                             if k not in arg_st),
            alias_bytes=alias,
            peak_bytes=max((snap.get("Total", 0) for snap in
                            mt.get_tracker_snapshot("peak").values()),
                           default=0))
        res["temp_bytes"] = max(0, res["peak_bytes"] - res["argument_bytes"]
                                - res["output_bytes"] + alias)
    return out, res


def compute_dtype(kind: str) -> torch.dtype:
    """A cell's compute dtype: bf16 for every LM cell (the train cells'
    BF16 policy, the serving cells' bf16 params), fp32 for the CNNs."""
    return torch.float32 if kind == "cnn" else torch.bfloat16


def cell_kind(arch: str, shape) -> str:
    if arch in registry.CNN_ARCHS:
        return "cnn"
    return (registry.SHAPES[shape] if isinstance(shape, str)
            else shape)["kind"]


def cell_tag(arch: str, shape: str, multi_pod: bool,
             variant: str = "base") -> str:
    tag = f"{arch}-{shape}-{'pod2' if multi_pod else 'pod1'}"
    return tag if variant == "base" else f"{tag}-{variant}"


def build_cell(arch: str, shape, mesh, variant: str = "base", device="cuda",
               cfg=None, batch: int = 32):
    """`build_cnn_cell` for a CNN arch, else `build_lm_cell`."""
    if arch in registry.CNN_ARCHS:
        return build_cnn_cell(arch, mesh, batch, variant, device, cfg=cfg)
    return build_lm_cell(arch, shape, mesh, variant, cfg, device)


def trace_cell(arch: str, shape, mesh: Mesh, variant: str = "base",
               device="cuda", cfg=None, batch: int = 32) -> dict:
    """Build one rank's cell on `mesh` and run its step once under
    `FakeTensorMode`, measured (`measure_step`); the counts, the cell's
    kind and its build and trace seconds."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    dev = torch.device(device)
    kind = cell_kind(arch, shape)
    if dev.type == "cuda" and not torch.backends.cuda.is_built():
        raise RuntimeError(
            "tracing over fake CUDA tensors needs a CUDA build of torch: "
            "on this CPU-only build every op that takes a CUDA device "
            "guard (indexing, autograd's bookkeeping) fails or aborts; "
            "trace on a CUDA build (no card is used), or with --device cpu")
    t0 = time.time()
    with FakeTensorMode():
        step, args, cfg = build_cell(arch, shape, mesh, variant, dev, cfg,
                                     batch)
        t_build = time.time() - t0
        _, res = measure_step(step, args, mesh, dev)
    res.update(kind=kind, cfg=cfg, build_s=t_build,
               trace_s=time.time() - t0 - t_build)
    return res


def model_flops_total(cfg, shape: str) -> float:
    """The reference's model FLOPs of an LM cell over the whole mesh: 6
    (train) or 2 x the active params a token x the tokens (one a row
    for decode)."""
    info = registry.SHAPES[shape]
    toks = info["seq_len"] * info["global_batch"] \
        if info["kind"] != "decode" else info["global_batch"]
    return (6.0 if info["kind"] == "train" else 2.0) \
        * cfg.params_per_token() * toks


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             variant: str = "base", device="cuda",
             rank: int | None = None) -> dict:
    """One cell: join the fake group as `rank` of the production mesh
    (default the last rank), trace its step (`trace_cell`), write
    `<out_dir>/<cell_tag>.json` and return it."""
    shape_map = PRODUCTION_MESH[bool(multi_pod)]
    world = math.prod(shape_map.values())
    rank = world - 1 if rank is None else rank
    init_fake_group(rank, world)
    try:
        mesh = make_production_mesh(multi_pod)
        r = trace_cell(arch, shape, mesh, variant, device)
    finally:
        dist.destroy_process_group()
    cfg = r["cfg"]
    peak = PEAK_FLOPS[compute_dtype(r["kind"])]
    result = {
        "arch": arch, "shape": shape, "variant": variant,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": world,
        "ok": True, "rank": rank, "device": str(torch.device(device)),
        "per_device": {k: r[k] for k in (
            "flops", "hbm_bytes", "collective_bytes", "collectives",
            "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "peak_bytes")},
        "kernel_calls": r["kernel_calls"],
        "compute_dtype": str(compute_dtype(r["kind"])).split(".")[-1],
        "roofline_s": {"compute": r["flops"] / peak,
                       "memory": r["hbm_bytes"] / HBM_BW,
                       "collective": r["collective_bytes"] / LINK_BW},
        "timing": {"build_s": round(r["build_s"], 1),
                   "trace_s": round(r["trace_s"], 1)},
        "raw_scan_counted_once": None,
        "probe": None,
    }
    result["dominant"] = max(result["roofline_s"],
                             key=result["roofline_s"].get)
    if arch not in registry.CNN_ARCHS:
        mf = model_flops_total(cfg, shape)
        result["model_flops_total"] = mf
        result["model_flops_ratio"] = mf / max(r["flops"] * world, 1.0)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cell_tag(arch, shape, multi_pod, variant)
                           + ".json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def cell_line(name: str, shape: str, r: dict) -> str:
    """The reference's printed line of a cell."""
    rl = r["roofline_s"]
    return (f"{name} {shape} {r['mesh']}: OK "
            f"compute={rl['compute']*1e3:.2f}ms "
            f"memory={rl['memory']*1e3:.2f}ms "
            f"collective={rl['collective']*1e3:.2f}ms "
            f"dominant={r['dominant']} "
            f"peak={r['per_device']['peak_bytes']/2**30:.2f}GiB/dev "
            f"(build {r['timing']['build_s']}s trace "
            f"{r['timing']['trace_s']}s)")


def run_audit(workload_names, out_path: str, hlo: bool = True,
              search: str = "greedy", device: str = "cuda") -> int:
    """--audit: lint + collective-audit the bench workloads' solved plans
    on this process group's mesh.  Returns the process exit code (non-zero
    iff any error-severity finding on any rank)."""
    dev = resolve_device(device)
    rank, world, local = init_distributed(dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    data = max(1, world // 2)
    model = max(1, world // data)
    mesh = make_mesh(data=data, model=model)
    lead = rank == 0
    machine = H100 if dev.type == "cuda" else LASSEN
    names = list(workload_names) or list(WL.WORKLOADS)
    report = {
        "schema": SCHEMA,
        "backend": dev.type,
        "collective_backend": mesh.backend,
        "mesh": dict(mesh.shape),
        "search": search,
        "workloads": {},
    }
    n_errors = 0
    for name in names:
        w = WL.WORKLOADS[name]
        if w.needs_model_axis and model <= 1:
            if lead:
                print(f"# audit/{name}: SKIPPED (mesh has no model axis)")
            report["workloads"][name] = {"skipped": True}
            continue
        t0 = time.time()
        try:
            plan, specs, cfg = WL.solve_workload(
                name, machine, dict(mesh.shape), search=search)
        except (PlanError, CapacityError) as e:
            # a memory-fit recipe can have no plan on a small mesh
            if lead:
                print(f"# audit/{name}: SKIPPED (no plan on this mesh: "
                      f"{type(e).__name__}: {str(e).splitlines()[0]})")
            report["workloads"][name] = {"skipped": True,
                                         "reason": str(e)}
            continue
        findings = plan.audit(specs, mesh, cfg=cfg, overlap=True, hlo=hlo,
                              device=dev)
        errs = int(mesh.all_max([analysis.error_count(findings)])[0])
        n_errors += errs
        if lead:
            print(f"# audit/{name}: {len(findings)} finding(s), {errs} "
                  f"error(s) ({time.time() - t0:.1f}s, one step)")
            print(analysis.format_findings(findings))
        report["workloads"][name] = {
            "skipped": False,
            "n_findings": len(findings),
            "n_errors": errs,
            "n_reshards": plan.n_reshards,
            "findings": [f.to_json() for f in findings],
        }
    report["n_errors"] = n_errors
    if lead:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        print(f"# wrote {out_path}")
        if n_errors:
            print(f"# AUDIT FAILED: {n_errors} error-severity finding(s) — "
                  f"costed != executed")
    return 1 if n_errors else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun", allow_abbrev=False,
        description="Trace one rank of an (arch x shape) cell on fake "
                    "tensors, or audit the bench workloads' plans.  Every "
                    "LM cell holds its params at rest as the reference's "
                    "FSDP blocks over data (each layer gathers its blocks "
                    "at their use), in the reference's dtypes: fp32 masters "
                    "for training, bf16 params and caches for prefill and "
                    "decode.")
    ap.add_argument("--arch")
    ap.add_argument("--shape", default="train_4k",
                    choices=list(registry.SHAPES) + ["cnn"],
                    help="every LM cell holds its params as FSDP blocks at "
                         "rest: train_* in fp32, prefill_* / decode_* (and "
                         "long_500k) in bf16 with bf16 caches")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default="base",
                    choices=["base", "opt", "vpz"])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--rank", type=int, default=None,
                    help="the mesh rank traced (default: the last)")
    ap.add_argument("--audit", nargs="*", default=None, metavar="WORKLOAD",
                    help="lint + collective-audit the named bench workload "
                         "plans (all when none named); exits non-zero on "
                         "any error-severity finding")
    ap.add_argument("--audit-out", default="build/audit/PLAN_audit.json")
    ap.add_argument("--no-hlo", action="store_true",
                    help="skip the profiler cross-check of the audited step")
    ap.add_argument("--search", default="greedy",
                    metavar="greedy|beam[:N]|hillclimb",
                    help="solver search mode for the audited workload plans")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    try:
        parse_search(args.search)
    except ValueError as e:
        ap.error(str(e))
    if args.audit is None:
        if not args.arch:
            ap.error("--arch is required (unless running --audit)")
        arch = registry.canon(args.arch)
        if arch not in registry.ARCHS + registry.CNN_ARCHS:
            ap.error(f"unknown arch {args.arch!r}")
        if (arch in registry.CNN_ARCHS) != (args.shape == "cnn"):
            ap.error(f"--shape cnn goes with the CNN archs "
                     f"{registry.CNN_ARCHS}, the LM shapes with the LMs")
        r = run_cell(arch, args.shape, args.multi_pod, args.out,
                     args.variant, args.device, args.rank)
        print(cell_line(args.arch, args.shape, r))
        return 0
    unknown = [n for n in args.audit if n not in WL.WORKLOADS]
    if unknown:
        ap.error(f"unknown workload(s) {unknown}; known: "
                 f"{', '.join(WL.WORKLOADS)}")
    created = not dist.is_initialized()
    try:
        return run_audit(args.audit, args.audit_out, hlo=not args.no_hlo,
                         search=args.search, device=args.device)
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
