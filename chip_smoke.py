#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card and `nvcc` (CUDA_HOME or /usr/local/cuda).  Phases:

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build every kernel under src/repro_torch/kernels/csrc with nvcc, one
   process per source, all at once; count the HGMMA instructions (wgmma)
   in the conv and attention libraries' SASS and the HMMA instructions
   (mma.sync) in the SSD library's, each of which must be > 0;
3. kernel vs plain: for each distinct conv shape of mesh1k at batch 2, in
   float32 and bfloat16, print the conv's launch plan (path, tile, K
   splits), hold the conv kernel against `conv2d_ref` and the
   autograd Function's dx/dw against autograd through `conv2d_ref`; time
   the kernel, the plain version and one `F.conv2d` call (channels_last,
   TF32 off: the yardstick, never called by the port); compute the bound;
   then the same for the flash-attention kernel at hymba-1.5b's shapes
   (window 1024 and none, each row with its plan, the bf16 ones on
   `wgmma` and held element by element to one bf16 ulp of A + |o32|, and
   the CPU emulation of its tiling, `flash_attention_emulated`, run on
   the same inputs, held against it; yardstick
   `F.scaled_dot_product_attention`) and
   the SSD-chunk kernel at hymba's and mamba2-780m's shapes (each row
   with its plan, the bf16 ones on `mma.sync` and held element by element
   to 2^-7 |y32| + 2^-12 |M|.|xdt|; no yardstick: no one PyTorch call
   computes it), forward and gradients of their autograd Functions;
4. mesh1k: run the trainer's own entry (`launch.train.main`) on
   full-width mesh1k, batch 2, 3 steps; check finite losses and 19 x 3
   conv launches; hold the full-width forward loss of one batch-1 sample
   on the card (kernel) against the same params and sample on the CPU
   (plain versions); profile one more step by kind of device kernel;
   time the §IV-A split's interior-slice copy at a 2-way H shard;
4b. spatial mesh1k: spawn 2 ranks on the one card, joined over gloo
   (the kernels are built before; a rank that fails fails the run): the
   19 convs' parity (each rank's block of y, dx and the summed dw against
   the float64 conv, with the split's kernel calls), the 2-rank
   global-BN loss against one rank's, and 3 training steps through the
   trainer's own entry (`--model 2`): equal losses and params on both
   ranks, 49 conv launches and 59 staged halo messages a step a rank,
   one more step profiled and the gradient all-reduce timed; then 4
   ranks (2 x 2, H x W) for block 1's two conv shapes.  Two processes
   sharing one card over gloo: not a scaling result;
4c. the auto plan, the paper's own loop: solve full-width mesh1k at batch
   2 on data 1 x model 2 with the H100 preset (it must have a CF layer
   and a reshard) and print it with each reshard's bytes; spawn 2 ranks
   on the card over gloo: CF conv parity at conv4_2, conv5_1 and conv6_3 (channel mode at
   chunks 1 and 2, filter mode: each rank's blocks of y, dx and the
   summed dw against the float64 conv, the kernel's plan at each shard
   shape), 3 training steps through the trainer's own entry
   (`--strategy auto`): equal losses and params, the conv launches a step
   the plan derives, the bytes the reshards send; the forward loss of one
   global batch under the plan against 2 gloo CPU ranks' (plain
   versions); one more step profiled, with the host time of the
   `cf_reduce_scatter`, `cf_all_gather` and `reshard` ranges.  Not a
   scaling result either;
4d. ResNet-50, the branchy network: the conv kernel against its plain
   version at the 23 distinct forward conv shapes of full-width ResNet-50
   at batch 32 (53 calls a forward), f32 and bf16, also element by
   element (tests/test_torch_cuda.py's TOL), each row with its plan (path,
   tile, K step, K splits, C/F after padding), kernel, plain and
   `F.conv2d` times and the bound, and their sums over one forward; the
   trainer's own entry on full-width ResNet-50, batch 32, 3 steps (finite
   losses, 53 x 3 conv launches); the forward loss at batch 2 on the
   card against the CPU; one profiled step by kind of kernel, and the
   max-pool alone (time and memory); then `--strategy auto`: the
   §V-C longest-path-first solve on the H100 preset on data 1 x model 2
   (it must have a CF layer and a residual-add reshard), printed with the
   reshards the port executes, 2 ranks spawned on the card over gloo: 3
   trainer steps with equal losses and params, the conv launches and
   staged collectives the plan derives, the reshard bytes its report
   predicts, the forward loss of one global batch under the plan against
   the one-device card loss, one profiled step with its host ranges.  Not
   a scaling result;
4e. the paper's §V calibration loop: 2 ranks spawned on the card over
   gloo run `python -m repro_torch.core.calibrate`'s path for full-width
   mesh1k at batch 2 on data 1 x model 2 (every conv table entry timed on
   the conv kernel: its launches must cover each conv key's 6 calls;
   coverage 1.0; one fingerprint on both ranks), print the fitted
   constants beside the H100 preset's and each table row beside the
   preset's analytic time; the plan solved on the calibration beside the
   preset's, the layers whose kind changed marked; 3 trainer steps under
   `--strategy auto --calibrate` (equal losses and params, the forward
   loss against 2 gloo CPU ranks'); `--profile` of that plan, its
   predicted-vs-measured attribution over all 19 layers; then
   full-width ResNet-50 at batch 32 solved on a table of 64 keys measured
   in this process (no live communication) beside the preset's plan.
   Not a scaling result: 2 processes share one card, and their α/β are
   gloo's through the host, not NVLink's;
4f. resilient training (`--ckpt-dir`, `--chaos`, `--elastic`), every
   forward conv on the kernel: full-width ResNet-50 at batch 32 trained 4
   steps, then 2 with a checkpoint, resumed to 4 (losses within 1e-5 of
   the uninterrupted run's, 53 x 2 conv launches), and trained with
   `--chaos raise@3` (rolled back to step 2, step 3 within 1e-5), with
   the bytes of a checkpoint, the host ms of `save()` and the ms of the
   thread's write; the reference's checkpoint-overhead bench on
   full-width mesh1k at batch 2 (the bare step and the step with one
   async save, interleaved: both medians and their ratio, gating
   nothing); full-width mesh1k on 4 ranks spawned on the card over gloo,
   `--data 2 --model 2 --strategy auto --elastic --chaos kill@5x2`: the
   fault, remesh (2 ranks) and rollback (step 4) records, ranks 2-3
   leaving at 5, the survivors' equal losses, the conv launches each
   plan derives before and after the remesh, and steps 4-5 within 1e-5
   of a 2-rank `--data 1 --model 2` run resumed from a copy of the same
   step-4 checkpoint.  Not a scaling result;
4g. the static-analysis lane: 2 ranks spawned on the card over gloo
   audit full-width mesh1k at batch 2 on data 1 x model 2 under the
   uniform H plan (every layer split over model: halos, the §IV-A split
   pinned both ways) and the H100 auto plan (CF layers, reshards): each
   plan linted and one real step of it (forward, backward, the gradient
   bucket) recorded and joined against the priced inventory
   (`repro_torch.analysis`), with the findings table, the recorded ops by
   kind and direction, the gradient bucket's bytes against the priced
   weight gradients', the audited step's host seconds and its conv
   launches (the plan's forward calls); one layer's backward timed with
   and without the split; then `python -m repro_torch.launch.dryrun
   --audit` on 4 ranks over the six bench workloads (its tables in
   build/audit/dryrun.log).  Any error finding fails the phase;
4h. the sharded training state: full-width mesh1k on 4 ranks spawned on
   the card over gloo, pod 2 x data 2 x model 1 at global batch 4, 3
   steps through the trainer's entry once per `--pod-compression`
   (none, bf16, int8_ef): every leaf of >= 2^14 elements sharded over
   data (ZeRO), each rank's momentum exactly its blocks, equal losses
   and params on every rank, the conv launches the plan derives (49 a
   step: the uniform plan splits every layer's rows, on the model axis
   of 1 too), `none` within
   1e-5 of one device on the same global batch (in 4 micro-batches, so
   that BN's statistics are the ranks'), bf16 and int8_ef within a
   rounding bound of `none`; the state bytes, the bytes put on the pod
   axis, the peak memory and step seconds a rank.  Not a scaling result.
   Then full-width hymba-1.5b (cut to 16 layers, `HYMBA_LAYERS`, handed
   to the trainer as its config), FP32, with and without `--remat`:
   losses within 1e-6, 2 x 16 x 3 LM kernel launches against 16 x 3,
   both peaks;
5. hymba-1.5b: the same entry at full width (16 layers), batch 1 x seq
   2048, 3 steps, FP32 (phase 4h's run) and then `--bf16`: each with
   finite losses and 16 x 3 launches of each LM kernel;
   the forward loss of a 4-layer full-width hymba (layer types g, s, g, g)
   at seq 1280 on the card against the CPU; one profiled step and the
   SSD's inter-chunk recurrence timed alone, with its launches per layer;
5b. serving (`launch.serve`, FP32): the attention and SSD-chunk kernels
   held as in phase 5 (`check_attention`, `check_ssd`) at the prefill
   shapes (batch 4 x each prompt); the host-bound decode step (qwen1.5
   at full width, 63 steps) timed in this process and in a fresh one,
   once each, with the thread and process counts of each; full-width
   hymba-1.5b (prompt 1088, 64 past its window) and qwen1.5-0.5b (prompt
   256), batch 4, 32 generated tokens, each in a fresh process (so its
   times owe nothing to the earlier phases), through the serve entry point
   (the prompt replayed a token a step, then greedy decode: no kernel
   launch, asserted), then `transformer.prefill` of the same prompt on
   the kernels (one attention and one SSD launch a hymba layer, 24 / 0
   for qwen1.5): its last logits against
   the replay's at the last prompt position and its K/V against the
   decode caches, within 1e-3 of the largest magnitude; prefill ms and
   tokens/s, decode ms a step (median of the generation steps) and
   tokens/s beside the step's bytes bound (the weights read once), peak
   memory, the state's bytes, and 8 decode steps under torch.profiler
   (device kernels a step, idle share); hymba cut to 4 layers, 16 decode
   steps on the card against the CPU; and the sequence-sharded decode on
   2 gloo ranks sharing the card (model 2, the 4-layer hymba, prompt 64,
   gen 16) against one rank: every step's logits and the caches within
   1e-4, the ids equal.  Not a scaling result.  hymba runs at 16
   layers here and in phase 6 (its prefill launches 16 / 16);
6. the LM on a mesh: the attention kernel's block call (ring attention's
   tile, query rows `delta` after the keys, o in fp32 and the rows' lse)
   at hymba's ring shapes (1 x 1024 rows a block, 25 / 5 heads, D 64):
   the causal diagonal, the full off-diagonal and the window-1024
   off-diagonal (whose last row sees no key), f32 and bf16, against the
   plain version and the emulation (o and lse on the rows that see a
   key, lse <= -1e29 on the others), with its time, bound and SDPA's with
   the block's bool mask; then 2 gloo ranks sharing the card (data 1 x
   model 2, not a scaling result): full-width hymba-1.5b's prefill of
   serving's prompts split over the ranks (544 tokens a rank) against the
   one-device prefill, logits and K/V within 1e-4 of the largest
   magnitude and the first ids serving's; 2 steps of the trainer's entry
   with `--model 2 --remat` (seq 2048, 1024 a rank), losses within 1e-5
   of phase 4h's one-device FP32 run; the launches a rank as the ring
   derives them (attention one / two a layer a forward on rank 0 / 1,
   the causal skip; SSD one a layer); peak memory, step seconds and one profiled step's
   device time by kind and idle share;
7. the vocab-parallel loss: the attention kernel at the shapes of its
   runs, f32 and bf16: gemma2-9b's (D 256, 16 / 8 heads, softcap 50) on
   one device at 1 x 4096, causal and window 4096, and at 1 x 8192, where
   the window binds, and the ring's block call at 2048 rows (the diagonal
   and the off-diagonal, with and without the window); qwen2.5-14b's (D
   128, 40 / 8 heads) on one device at 1 x 2048 and the ring's block call
   at 1024 rows (the diagonal and the off-diagonal); each against its
   plain version (bf16 element by element), timed 20 launches an event
   pair beside the plain version's time, the bound and one library
   call's (gemma2: compiled `flex_attention` with the softcap as its
   score_mod; qwen2.5: SDPA); then full-width
   gemma2-9b cut to one local + global unit (batch 1 x seq 4096, the
   tied table) and qwen2.5-14b cut to one layer (batch 1 x seq 2048, the
   untied unembed), params drawn on the card: the one-device dense
   `loss_fn` and its gradients in a process of its own, then 2 gloo
   ranks sharing the card (data 1 x model 2, not a scaling result) run
   `loss_fn(vocab_parallel=True)` with its backward on their vocabulary
   and sequence blocks: the shares summed within 1e-5 of the one-device
   loss, each rank's table-block gradients and the summed layer
   gradients within 1e-4 of the one-device gradients' largest
   magnitude, the attention launches a rank as the ring derives them,
   the table rotations (4 (P - 1) + P messages of one block a rank, each
   staged through the host), s for forward + backward and peak memory a
   rank against one device;
8. print every kernel's registers, static shared memory and spills (the
   ptxas report), the HGMMA counts, the `kernels` JSON line (with each LM
   kernel's launches in prefill, `serve_launches`, and on the mesh,
   `mesh_launches_per_rank`; the block call's times, `ring_block`; the
   attention kernel's rows and launches on phase 7's runs, `vocab`, and
   on phase 9's, `moe`; the SSD's on mamba2-780m, `mamba2`) and, last,
   the `ok` JSON line;
9. mixture of experts (run before the lines of 8): the attention kernel
   at mixtral-8x7b's shapes (32 / 8 heads, D 128, window 4096) on one
   device at 1 x 8192, where the window binds, and the ring's blocks of
   4096 rows (the diagonal, the window's off-diagonal), and at olmoe's
   prefill (16 / 16 heads, causal, 4 x 256), f32 and bf16, each against
   its plain version and timed beside SDPA (`is_causal` or a bool window
   mask) and the bound; full-width mixtral cut to one SWA layer, batch 1
   x seq 8192, params drawn on the card: the one-device `loss_fn` and
   its gradients in a process of its own (with the MoE layer's forward
   timed whole and in parts: the routing, the expert products, the
   dispatch and combine), then 2 gloo ranks sharing the card (data 1 x
   model 2, not a scaling result) with the sequence split and the 8
   experts 4 a rank over "model" (`ShardCtx(tp_axis="model")`, the
   dispatched slots moved by all-to-all): the shares summed within 1e-5
   of one device's, each rank's expert-block gradients and the summed
   other gradients within 1e-4 of the one-device gradients' largest
   magnitude, the routing against one device's (at most 2 differing
   decisions admitted, each only below a top-k margin of 1e-5: then the
   final hidden states are held on the tokens whose routing groups route
   alike, the loss within 1e-5 plus what the other tokens' cross
   entropies moved, the gradients not), the attention launches as the
   ring derives them, the all-to-all bytes a rank, fwd + bwd s and peak
   memory a rank against one device; full-width olmoe-1b-7b at full
   depth (16 layers, 64 experts, top 8) through the serve entry point in
   a fresh process, params drawn on the card, batch 4, prompt 256, 16
   generated tokens: no kernel launch in the decode loop, prefill on the
   kernels (16 launches, its ms, each layer's dropped pairs; not held
   against the replay, which routes each token alone and drops nothing),
   decode ms a step beside its bytes bound (every weight, and only the
   experts each step routes to), peak memory; at 2 layers the card
   against the CPU on the same params (prefill logits and K/V, 8 decode
   steps' logits and ids, within 1e-4, on the batch rows where no
   routing decision differs, the same rule); full-width mamba2-780m at
   full depth (48 SSD layers) through the trainer's entry, batch 1 x seq
   2048, 3 FP32 steps: finite losses, 48 x 3 SSD launches, s a step and
   peak memory.

The full-width hymba-1.5b and qwen1.5-0.5b params are drawn from their
CPU generator once a run and kept, with the generator's state after the
draw, under build/params for every later draw of the same seed
(`_init_once`, held once a run against a fresh draw).  Each launch count
is read from a run that starts with every count at 0.
Any failed phase raises and the script exits non-zero.  Per-shape rows go
to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.checkpoint.checkpoint import CheckpointManager  # noqa
from repro_torch.configs import (  # noqa: E402
    gemma2_9b, hymba_1_5b, mamba2_780m, mixtral_8x7b, olmoe_1b_7b,
    qwen1_5_0_5b, qwen2_5_14b)
from repro_torch.core import calibrate, channel_conv  # noqa: E402
from repro_torch.core import collectives, halo, perfmodel  # noqa: E402
from repro_torch.core import plan as plan_lib  # noqa: E402
from repro_torch.core import trace as trace_lib  # noqa: E402
from repro_torch.core.perfmodel import H100  # noqa: E402
from repro_torch.core.spatial_conv import (  # noqa: E402
    ConvSharding, conv_calls, spatial_conv2d, split_rows)
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import conv2d as kconv  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import ssd as kssd  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    conv2d_ref, flash_attention_ref, ssd_chunked_ref)
from repro_torch.launch import serve, shardings  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_mesh  # noqa: E402
from repro_torch.models.cnn import layers as cnn_layers  # noqa: E402
from repro_torch.models.cnn import meshnet, resnet  # noqa: E402
from repro_torch.models.lm import modules as lm_modules  # noqa: E402
from repro_torch.models.lm import transformer  # noqa: E402
from repro_torch.models.lm import vocab_parallel  # noqa: E402
from repro_torch.models.lm.modules import ShardCtx  # noqa: E402
from repro_torch.optim.optimizer import (  # noqa: E402
    adamw, sgd, state_tree)
from repro_torch.train.train_loop import (  # noqa: E402
    TrainStepConfig, make_train_step, reduce_replicated_grads)
from repro_torch.utils import (  # noqa: E402
    FP32, interleaved_samples, same_pads, time_fn, tree_leaves, tree_map,
    tree_unflatten, trimmed_mean)

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_FLOPS = {torch.float32: 67e12,     # fp32 on the CUDA cores
              torch.bfloat16: 989e12}   # bf16 on the tensor cores
PEAK_BYTES_S = 3.35e12                  # HBM3
BATCH, STEPS = 2, 3
# kernel vs plain, both fp32-accumulated, the max |difference| over the
# output relative to the output's largest magnitude: sums of up to
# K*K*C = 4608 products in another order (f32), or one bf16 rounding of
# the result that may land on the neighbouring value (bf16: 2^-7)
FWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# dx/dw: cuDNN's gradients against autograd through the plain version,
# reductions over up to N*H*W = 524288 terms (bf16: rounded results)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# full-width forward loss, card vs CPU: fp32 through 19 conv-BN-ReLU
# layers whose sums run in another order on each
LOSS_RTOL = 1e-4
# the spatial path: each rank's block of the conv output, dx and dw (summed
# over the ranks) against the same conv in float64 on the card, over the
# largest magnitude (tests/test_torch_cuda.py's tolerances: f32 sums in
# the kernel's order, cuDNN's gradients over other extents; the
# one-process f32 conv's errors are printed beside); the 2-rank global-BN
# loss against one rank's at LOSS_RTOL
SPATIAL_FWD_TOL, SPATIAL_BWD_TOL = 2e-5, 1e-4
SPATIAL_MODEL = 2
# attention / SSD kernel vs plain, max |difference| over the largest
# output magnitude: f32 sums of up to 2048 keys x 64 dims (attention) or
# cl x n products (SSD) in another order; bf16 one rounding of the output
# that may land on the neighbouring value.  S is fp32 for both dtypes.
LM_FWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# their autograd Functions' gradients: the backward recomputes through
# the plain version, so only the order of the reductions may differ
LM_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# bf16 attention, element by element as well: the kernel rounds each P to
# bf16 (relative error <= 2^-8) and its output once (<= 2^-8 |o|), so
# |o - o32| <= 2^-8 (A + |o32|), where o32 is the plain version in fp32 on
# the same bf16 inputs and A = softmax(S).|v| (both by `attention_limit`).
# The limit is twice that, one bf16 ulp of A + |o32|: unlike LM_FWD_TOL,
# which scales with the largest output, it sees a key tile gone astray in
# a row that averages over a thousand keys.
ATTN_ELEM_ULP = 2.0 ** -7
# hymba-1.5b's earlier paths (phase 4h's FP32 and --remat runs and the
# step breakdown that profiles the same step, phase 5's BF16 run,
# serving's, phase 6's sharded prefill and --remat steps, and the
# one-device runs they are held against) at full width, cut to
# HYMBA_LAYERS of its 32 layers (global attention on layers 0, 8 and 15),
# handed to the trainer and the server as their `cfg` (the registry's
# config cut in depth, which they announce)
HYMBA_LAYERS = 16
HYMBA = dataclasses.replace(hymba_1_5b.CONFIG, n_layers=HYMBA_LAYERS)
LM_BATCH, LM_SEQ = 1, 2048
# the 4-layer full-width forward loss, card vs CPU: fp32 through four
# hybrid blocks whose sums (up to 6400 products) run in another order
LM_LOSS_RTOL = 1e-4
# the 4-layer full-width forward check: types g, s, g, g and a sequence
# longer than the 1024 window, a multiple of the SSD chunk
CHECK_LAYERS, CHECK_SEQ = 4, 1280
# where the full-width hymba and qwen1.5 draws are kept between their
# calls (git-ignored)
PARAMS_DIR = os.path.join(HERE, "build", "params")
DRAW_ONCE = (HYMBA, qwen1_5_0_5b.CONFIG)
_init = transformer.init


def _init_once(gen: torch.Generator, cfg, *, device):
    """`transformer.init`, with each DRAW_ONCE config's full-width draw
    from a fresh CPU generator (as the trainer, serving and the phases
    each make one from a seed) made once a run: the first call draws and
    saves the tree and the generator's state after the draw under
    PARAMS_DIR; every later one, in this process or a spawned one, loads
    both, so that it returns the same bits and leaves the generator as a
    draw would (hymba's draw on the CPU takes about 12 s).  The first load
    of each config in a run is held against a fresh draw, leaf by leaf
    and the generator's state, and raises if they differ.  Any other call
    is `transformer.init`'s own."""
    fresh = gen.device.type == "cpu" and torch.equal(
        gen.get_state(),
        torch.Generator().manual_seed(gen.initial_seed()).get_state())
    if cfg not in DRAW_ONCE or not fresh:
        return _init(gen, cfg, device=device)
    path = os.path.join(PARAMS_DIR,
                        f"{cfg.name}-seed{gen.initial_seed()}.pt")
    if os.path.exists(path):
        saved = torch.load(path, mmap=True)
        if not os.path.exists(f"{path}.checked"):
            again = torch.Generator().manual_seed(gen.initial_seed())
            want = tree_leaves(_init(again, cfg, device="cpu"))
            got = tree_leaves(saved["tree"])
            if not (torch.equal(saved["gen_state"], again.get_state())
                    and len(got) == len(want)
                    and all(torch.equal(a, b) for a, b in zip(got, want))):
                raise AssertionError(f"{cfg.name}: the saved draw is not "
                                     f"transformer.init's")
            open(f"{path}.checked", "w").close()
        gen.set_state(saved["gen_state"])
        tree = saved["tree"]
    else:
        tree = tree_map(lambda t: t.detach(), _init(gen, cfg, device="cpu"))
        os.makedirs(PARAMS_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"tree": tree, "gen_state": gen.get_state()}, tmp)
        os.replace(tmp, path)
    return tree_map(lambda t: t.to(device, copy=True).requires_grad_(), tree)


transformer.init = _init_once


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def sass_count(lib, opcode: str) -> int:
    """How many `opcode` instructions cuobjdump finds in the SASS of the
    built library `lib`."""
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return sum(opcode in line for line in sass.splitlines())


def ptxas_resources(name: str, log: str) -> list[str]:
    """One line per kernel of an `nvcc -Xptxas -v` log: its registers,
    static shared memory (the dynamic ring is not in the log) and
    spills."""
    kernels, out, spill = [], [], ""
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            kernels.append(m.group(1))
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spill = f"spills {m.group(1)} / {m.group(2)} bytes"
        elif (m := re.search(r"Used (\d+) registers(?:.*?(\d+) bytes "
                             r"smem)?", line)) and kernels:
            out.append([kernels[-1], f"{m.group(1)} registers, "
                        f"{m.group(2) or 0} bytes static shared memory, "
                        f"{spill}"])
    filt = shutil.which("c++filt")
    if filt and out:
        names = subprocess.run([filt], input="\n".join(k for k, _ in out),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        for row, nm in zip(out, names):
            row[0] = nm.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("(")[0]
    return [f"  {name}: {k}: {v}" for k, v in out]


def mesh_conv_shapes(cfg) -> list[dict]:
    """The distinct conv calls of one forward, in order, with how many of
    the cfg's layers make each: padded input (N, H, W, C), K, F, stride."""
    shapes: dict[tuple, dict] = {}
    c, hw = cfg.in_channels, cfg.input_hw
    layers = []
    for width in cfg.widths:
        for i in range(cfg.convs_per_block):
            s = 2 if i == 0 else 1
            layers.append((c, hw, width, 3, s))
            hw //= s
            c = width
    layers.append((c, hw, cfg.n_classes, 1, 1))
    names = meshnet.layer_names(cfg)
    for name, (c, hw, f, k, s) in zip(names, layers):
        lo, hi = same_pads(k, s)
        key = (BATCH, hw + lo + hi, hw + lo + hi, c, k, f, s)
        if key not in shapes:
            shapes[key] = {"layer": name, "x": key[:4], "k": k, "f": f,
                           "stride": s, "count": 0}
        shapes[key]["count"] += 1
    return list(shapes.values())


def _check_close(what: str, got: torch.Tensor, want: torch.Tensor,
                 tol: float) -> float:
    """max |got - want|, which must be within tol x max(1, max |want|)."""
    want = want.float()
    err = float((got.float() - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    if not err <= tol * scale:
        raise AssertionError(f"{what}: max |err| {err} > {tol} * {scale}")
    return err


def _timings(fn_kernel, fn_plain, fn_library, flops: float, nbytes: float,
             dtype: torch.dtype) -> dict:
    """Kernel, plain and library times (CUDA events, trimmed mean of 10
    after 2 warmups) and the bound: max(FLOPs / peak, bytes / 3.35 TB/s)."""
    kernel_s = time_fn(fn_kernel, reps=10, warmup=2)
    plain_s = time_fn(fn_plain, reps=10, warmup=2)
    library_s = None if fn_library is None else \
        time_fn(fn_library, reps=10, warmup=2)
    ops_s, bytes_s = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_S
    return {"ms": kernel_s * 1e3, "plain_ms": plain_s * 1e3,
            "library_ms": None if library_s is None else library_s * 1e3,
            "bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "ops_ms": ops_s * 1e3, "bytes_ms": bytes_s * 1e3,
            "gflops": flops / 1e9, "tflops_s": flops / kernel_s / 1e12}


def check_shape(sh: dict, dtype: torch.dtype, gen: torch.Generator,
                elem_tol: dict | None = None) -> dict:
    dev = torch.device("cuda")
    n, hp, wp, c = sh["x"]
    k, f, s = sh["k"], sh["f"], sh["stride"]
    lo, hi = same_pads(k, s)
    x = torch.randn((n, hp - lo - hi, wp - lo - hi, c), generator=gen,
                    device=dev).to(dtype)
    xp = F.pad(x, (0, 0, lo, hi, lo, hi))
    w = (torch.randn((k, k, c, f), generator=gen, device=dev)
         * math.sqrt(2.0 / (k * k * c))).to(dtype)

    y = kconv.conv2d(xp, w, stride=s)
    yr = conv2d_ref(xp, w, stride=s)
    torch.cuda.synchronize()
    err = float((y.float() - yr.float()).abs().max())
    scale = max(1.0, float(yr.float().abs().max()))
    if not err <= FWD_TOL[dtype] * scale:
        # say which side is off: both against the library's conv
        lib = F.conv2d(xp.permute(0, 3, 1, 2).float(),
                       w.permute(3, 2, 0, 1).float(), stride=s) \
            .permute(0, 2, 3, 1)
        raise AssertionError(
            f"{sh['layer']} {dtype}: kernel vs plain max |err| {err} > "
            f"{FWD_TOL[dtype]} * {scale}; max |x| {xp.abs().max()}, "
            f"|w| {w.abs().max()}, |kernel - library| "
            f"{(y.float() - lib).abs().max()}, |plain - library| "
            f"{(yr.float() - lib).abs().max()}")
    if elem_tol is not None:
        # element by element as well: |kernel - plain| <= tol (1 + |plain|)
        tol = elem_tol[dtype]
        worst = float(((y.float() - yr.float()).abs()
                       / (1.0 + yr.float().abs())).max())
        if not worst <= tol:
            raise AssertionError(f"{sh['layer']} {dtype}: kernel vs plain "
                                 f"element error {worst} > {tol} (1 + "
                                 f"|plain|)")

    # the autograd Function (kernel forward, cuDNN backward) vs autograd
    # through the plain version, through one random cotangent
    g = torch.randn(y.shape, generator=gen, device=dev).to(dtype)
    grads = []
    for fwd in (lambda a, b: kconv.Conv2d.apply(a, b, s),
                lambda a, b: conv2d_ref(a, b, stride=s)):
        a = xp.detach().requires_grad_()
        b = w.detach().requires_grad_()
        (fwd(a, b).float() * g.float()).sum().backward()
        grads.append((a.grad, b.grad))
    for nm, got, want in zip(("dx", "dw"), *grads):
        _check_close(f"{sh['layer']} {dtype}: {nm}", got, want,
                     BWD_TOL[dtype])
    del grads

    x_nchw = xp.permute(0, 3, 1, 2)            # channels_last view
    w_oihw = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    p = kconv.plan(tuple(xp.shape), tuple(w.shape), s, dtype)
    row = {"layer": sh["layer"], "dtype": str(dtype).split(".")[-1],
           "x": list(sh["x"]), "k": k, "f": f, "stride": s,
           "count": sh["count"], "max_abs_err": err,
           "plan": dataclasses.asdict(p)}
    row.update(_timings(
        lambda: kconv.conv2d(xp, w, stride=s),
        lambda: conv2d_ref(xp, w, stride=s),
        lambda: F.conv2d(x_nchw, w_oihw, stride=s),
        2.0 * n * y.shape[1] * y.shape[2] * f * k * k * c,
        (xp.numel() + w.numel() + y.numel()) * xp.element_size(), dtype))
    return row


def kernel_phase(card: str, shapes=None, elem_tol=None) -> list[dict]:
    """Kernel-vs-plain rows (`check_shape`) of every conv shape in
    `shapes` (default: mesh1k's at batch 2), float32 then bfloat16."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = shapes or mesh_conv_shapes(meshnet.MESH1K)
    rows = []
    print(f"{'layer':15s} {'dtype':8s} {'x (N,H,W,C)':22s} {'k':>2s} "
          f"{'F':>4s} {'s':>2s} {'n':>2s} {'path tile k splits C/F':29s} "
          f"{'kernel_ms':>10s} "
          f"{'plain_ms':>9s} {'library_ms':>10s} {'bound_ms':>9s} "
          f"{'TFLOP/s':>8s} {'max_err':>9s}   ({card})")
    for dtype in (torch.float32, torch.bfloat16):
        for sh in shapes:
            r = check_shape(sh, dtype, gen, elem_tol)
            rows.append(r)
            p = r["plan"]
            plan = f"{p['path']} {p['tile_m']}x{p['tile_n']} " \
                f"k{p['tile_k']} {p['splits']} {p['c_pad']}/{p['f_pad']}"
            print(f"{r['layer']:15s} {r['dtype']:8s} "
                  f"{str(tuple(r['x'])):22s} "
                  f"{r['k']:2d} {r['f']:4d} {r['stride']:2d} "
                  f"{r['count']:2d} {plan:29s} {r['ms']:10.4f} "
                  f"{r['plain_ms']:9.4f} "
                  f"{r['library_ms']:10.4f} {r['bound_ms']:9.4f} "
                  f"{r['tflops_s']:8.2f} {r['max_abs_err']:9.2e}",
                  flush=True)
            torch.cuda.empty_cache()
    return rows


def train_phase() -> dict:
    ops.reset_launch_counts()
    res = train_cli.main(["--arch", "mesh1k", "--batch", str(BATCH),
                          "--steps", str(STEPS), "--device", "cuda",
                          "--log-every", "1"])
    launches = ops.launch_counts()["conv2d"]
    n_convs = len(meshnet.layer_names(meshnet.MESH1K))
    if not all(math.isfinite(l) for l in res["losses"]):
        raise AssertionError(f"non-finite loss: {res['losses']}")
    if launches != n_convs * STEPS:
        raise AssertionError(f"conv kernel launched {launches} times in "
                             f"{STEPS} steps, want {n_convs} x {STEPS}")
    steady = res["step_s"][1:]
    step_s = sum(steady) / len(steady)
    compute = [t - d for t, d in zip(res["step_s"], res["data_s"])][1:]
    compute_s = sum(compute) / len(compute)
    print(f"train: {STEPS} steps of full-width mesh1k at batch {BATCH}; "
          f"losses {res['losses']}; step seconds {res['step_s']} "
          f"(batch wait + copy {res['data_s']}); steps 2..{STEPS}: "
          f"{step_s:.4f} s/step, {BATCH / step_s:.3f} samples/s; without "
          f"the batch wait {compute_s:.4f} s/step, "
          f"{BATCH / compute_s:.3f} samples/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"conv launches {launches}")
    return {"launches": launches, "losses": res["losses"],
            "step_s": res["step_s"], "data_s": res["data_s"],
            "steady_step_s": step_s, "steady_compute_s": compute_s}


def _annotation(e) -> bool:
    """Whether a profiler event is a `record_function` range's span on
    the device timeline (a layer or a named region, `core.trace`), not a
    kernel: its time is its kernels', counted already."""
    return bool(getattr(e, "is_user_annotation", False))


def _device_breakdown(run_step, classify) -> tuple[float, dict, int]:
    """One call of `run_step` (which must end in a device sync) under
    torch.profiler: (host ms, {group: device ms}, device kernels), each
    kernel's time added to the group `classify(name.lower())` gives."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict[str, float] = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or _annotation(e):
            continue
        n_kernels += 1
        g = classify(e.name.lower())
        groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us() / 1e3
    return wall_ms, groups, n_kernels


def cnn_kind(name: str) -> str:
    """The kind of a CNN step's device kernel, by its lower-case name."""
    if "repro_conv2d" in name:
        return "conv2d kernel (forward, split-K sums included)"
    if any(t in name for t in ("cudnn", "xmma", "dgrad", "wgrad", "conv",
                               "gemm", "cutlass")):
        return "library conv (dgrad/wgrad)"
    return "other"


def profile_phase() -> dict:
    """Device time of one full-width training step (batch 2, batch already
    on the card) by kind of kernel, from torch.profiler's CUDA events."""
    cfg, dev = meshnet.MESH1K, torch.device("cuda")
    model = meshnet.MeshNet(cfg, generator=torch.Generator().manual_seed(0),
                            device=dev)
    params = model.params()
    opt = sgd(0.0, momentum=0.9)
    step = make_train_step(functools.partial(meshnet.loss_fn, cfg=cfg), opt,
                           TrainStepConfig(precision=FP32))
    state = opt.init(params)
    batch = pipeline.to_device(pipeline.synthetic_mesh_batch(
        0, BATCH, cfg.input_hw, cfg.in_channels, out_hw=cfg.out_hw), dev)
    params, state, _, m = step(params, state, None, batch)     # warm

    def run_step():
        float(step(params, state, None, batch)[3]["loss"])

    wall_ms, groups, n_kernels = _device_breakdown(run_step, cnn_kind)
    busy = sum(groups.values())
    if n_kernels == 0:
        print("step breakdown: the profiler saw no device kernels "
              "(not measured)")
        return {"wall_ms": wall_ms, "device_ms": None}
    print(f"step breakdown (one step, batch 2 on the card, host clock "
          f"{wall_ms:.2f} ms): device kernels {busy:.2f} ms, idle share "
          f"{1 - busy / wall_ms:.3f}; " + "; ".join(
              f"{k} {v:.2f} ms" for k, v in groups.items()))
    return {"wall_ms": wall_ms, "device_ms": busy, "groups": groups,
            "n_kernels": n_kernels}


def forward_check() -> dict:
    """Full-width forward loss of one batch-1 sample: card vs CPU."""
    cfg = meshnet.MESH1K
    nb = pipeline.synthetic_mesh_batch(0, 1, cfg.input_hw, cfg.in_channels,
                                       out_hw=cfg.out_hw)
    out = {}
    with torch.no_grad():
        for dev in ("cuda", "cpu"):
            d = torch.device(dev)
            model = meshnet.MeshNet(cfg, generator=torch.Generator()
                                    .manual_seed(0), device=d)
            b = pipeline.to_device(nb, d)
            t0 = time.perf_counter()
            logits = model(b["image"])
            out[dev] = (float(meshnet.bce_loss(logits, b["label"])),
                        logits.float().cpu())
            out[dev + "_s"] = time.perf_counter() - t0
            del model, b
    (lg, yg), (lc, yc) = out["cuda"], out["cpu"]
    rel = abs(lg - lc) / abs(lc)
    dlogit = float((yg - yc).abs().max())
    print(f"forward check, batch 1: loss card {lg!r} cpu {lc!r} rel diff "
          f"{rel:.3e} (tol {LOSS_RTOL}); max |logit diff| {dlogit:.3e}")
    if not (math.isfinite(lg) and rel <= LOSS_RTOL):
        raise AssertionError(f"card loss {lg} vs cpu loss {lc}: rel {rel}")
    return {"loss_cuda": lg, "loss_cpu": lc, "rel_diff": rel,
            "max_logit_diff": dlogit}


# ------------------------------------------------------- spatial path --

def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank_entry(rank: int, world: int, port: int, fn, out_dir: str,
                args: tuple) -> None:
    """One spawned rank on cuda:0: join the gloo group, run fn(rank, world,
    *args), write its dict to out_dir/rank<r>.json, with the wall-clock
    time at which fn was called."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        started = time.time()
        out = fn(rank, world, *args)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"out": out, "started": started}, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, *args) -> list[dict]:
    """fn(rank, world, *args) in `world` fresh processes on the one card,
    one gloo group on a free port; each rank's returned dict.  The
    processes are forked from a server that imported torch, numpy and the
    port once, started at the first call and ended with this process
    (each process still imports this script anew, and starts CUDA on its
    own).  The kernels are built before (the ranks load the cached
    libraries); a rank that raises fails the run."""
    import torch.multiprocessing as mp
    out_dir = os.path.join(HERE, "build", "spatial")
    os.makedirs(out_dir, exist_ok=True)
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.json")
        if os.path.exists(path):
            os.remove(path)
    torch.cuda.empty_cache()
    mp.set_forkserver_preload(
        ["numpy", "torch", "torch.distributed"]
        + sorted(m for m in sys.modules if m.startswith("repro_torch")))
    t0 = time.time()
    mp.start_processes(_rank_entry, args=(world, _free_port(), fn, out_dir,
                                          args),
                       nprocs=world, join=True, start_method="forkserver")
    ended = time.time() - t0
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    print(f"spawned {world} x {fn.__name__}: the last rank reached it "
          f"after {max(o['started'] for o in out) - t0:.1f} s, all ended "
          f"after {ended:.1f} s", flush=True)
    return [o["out"] for o in out]


def _block(t: torch.Tensor, mesh, sh: ConvSharding) -> torch.Tensor:
    """This rank's H (and W) block of a global NHWC tensor."""
    for dim, axis in ((1, sh.h_axis), (2, sh.w_axis)):
        if axis is not None:
            t = pipeline.shard_dim(t, dim, mesh, axis)
    return t


def _conv_f64(x: torch.Tensor, w: torch.Tensor, s: int) -> torch.Tensor:
    """The SAME conv in float64 (`F.conv2d` on NCHW / OIHW views of the
    padded input; `conv2d_ref` sums in fp32): the exact reference the f32
    paths are held against."""
    pads = same_pads(w.shape[0], s)
    xp = F.pad(x, (0, 0) + pads + pads).permute(0, 3, 1, 2)
    return F.conv2d(xp, w.permute(3, 2, 0, 1), stride=s).permute(0, 2, 3, 1)


def conv_parity(mesh, sh: ConvSharding, layers) -> list[dict]:
    """At each of `layers` (meshnet.layer_geometry rows), batch 2, f32:
    this rank's spatial_conv2d (overlap=True) of its block, dx and dw
    (summed over the ranks), each against the same conv in float64 on the
    card; the one-process spatial_conv2d's errors against it beside (two
    f32 orders of a reduction over up to 524288 terms differ by about
    1e-4 of the largest dw, so each is held to the exact value); with
    the kernel launches of the spatial call."""
    dev, rows = torch.device("cuda"), []
    split = sh.h_axis if sh.w_axis is None else sh.w_axis   # the conv's
    for li, (name, c, hw, f, k, s) in layers:
        gen = torch.Generator(device=dev).manual_seed(100 + li)
        x = torch.randn((BATCH, hw, hw, c), generator=gen, device=dev)
        w = torch.randn((k, k, c, f), generator=gen, device=dev) \
            * math.sqrt(2.0 / (k * k * c))
        g = torch.randn((BATCH, hw // s, hw // s, f), generator=gen,
                        device=dev)
        grads = []
        for dt, fn in ((torch.float32, lambda a, b: spatial_conv2d(
                a, b, strides=(s, s), sharding=ConvSharding())),
                       (torch.float64, lambda a, b: _conv_f64(a, b, s))):
            a = x.to(dt, copy=True).requires_grad_()
            b = w.to(dt, copy=True).requires_grad_()
            y_ = fn(a, b)
            (y_ * g.to(dt)).sum().backward()
            grads.append((y_.detach(), a.grad, b.grad))
            del a, b, y_
        (y32, dx32, dw32), (y64, dx64, dw64) = grads
        xl = _block(x, mesh, sh).contiguous().requires_grad_()
        wl = w.clone().requires_grad_()
        before = kconv.conv2d.launches
        y = spatial_conv2d(xl, wl, strides=(s, s), sharding=sh, mesh=mesh,
                           overlap=True)
        calls = kconv.conv2d.launches - before
        (y * _block(g, mesh, sh)).sum().backward()
        dw = reduce_replicated_grads([wl.grad], mesh)[0]
        torch.cuda.synchronize()
        what = f"spatial conv {name} rank {mesh.rank}"
        row = {"layer": name, "x": [BATCH, hw, hw, c], "k": k, "f": f,
               "stride": s, "calls": calls,
               "want_calls": conv_calls(hw // mesh.axis_size(split), k, s)}
        for nm, got, one, exact, tol in (
                ("y", y.detach(), _block(y32, mesh, sh),
                 _block(y64, mesh, sh), SPATIAL_FWD_TOL),
                ("dx", xl.grad, _block(dx32, mesh, sh),
                 _block(dx64, mesh, sh), SPATIAL_BWD_TOL),
                ("dw", dw, dw32, dw64, SPATIAL_BWD_TOL)):
            row[f"err_{nm}"] = _check_close(f"{what} {nm}", got, exact, tol)
            row[f"one_err_{nm}"] = float((one.double() - exact).abs().max())
            row[f"vs_one_{nm}"] = float((got - one).abs().max())
        rows.append(row)
        del x, w, g, grads, y32, dx32, dw32, y64, dx64, dw64, xl, wl, y, dw
    torch.cuda.empty_cache()
    return rows


def spatial_rank(rank: int, world: int) -> dict:
    """One of 2 ranks (data 1 x model 2, H over model) on the card: (a) the
    19 conv-parity rows; (b) the full-width global-BN forward loss against
    one rank's; (c) 3 training steps through the trainer's own entry."""
    mesh = make_mesh(data=1, model=SPATIAL_MODEL)
    sh = ConvSharding(batch_axes=("data",), h_axis="model")
    layers = list(enumerate(meshnet.layer_geometry(meshnet.MESH1K)))
    rows = conv_parity(mesh, sh, layers)

    cfg = dataclasses.replace(meshnet.MESH1K, bn_scope="global")
    dev = torch.device("cuda")
    model = meshnet.MeshNet(cfg, generator=torch.Generator().manual_seed(0),
                            device=dev)
    nb = pipeline.synthetic_mesh_batch(0, BATCH, cfg.input_hw,
                                       cfg.in_channels, out_hw=cfg.out_hw)
    with torch.no_grad():
        part = meshnet.loss_fn(model.params(), pipeline.to_device(
            pipeline.shard_batch(nb, mesh, sh), dev), cfg, sh, mesh)
        loss_ranks = float(mesh.all_reduce(part, mesh.axis_names))
        loss_one = float(meshnet.loss_fn(model.params(), pipeline.to_device(
            nb, dev), cfg)) if rank == 0 else None
    del model
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    halo.reset_staged()
    res = train_cli.main(["--arch", "mesh1k", "--batch", str(BATCH),
                          "--steps", str(STEPS), "--model",
                          str(SPATIAL_MODEL), "--device", "cuda",
                          "--log-every", "1"])
    launches, staged = ops.launch_counts()["conv2d"], halo.staged
    collectives_staged = res["mesh"].staged
    breakdown = spatial_step_breakdown(res["params"], res["mesh"], sh)
    return {"conv_rows": rows, "loss_ranks": loss_ranks,
            "breakdown": breakdown,
            "loss_one": loss_one, "losses": res["losses"],
            "step_s": res["step_s"], "data_s": res["data_s"],
            "launches": launches, "staged": staged,
            "collectives_staged": collectives_staged,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "digest": [float(p.detach().double().sum())
                       for p in tree_leaves(res["params"])]}


def spatial_step_breakdown(params, mesh, sh: ConvSharding) -> dict:
    """One more training step of this rank (batch already on the card, lr
    0) under torch.profiler, by kind of device kernel; and the gradient
    all-reduce alone (the flat fp32 buffer of every param through gloo),
    host clock around synchronised calls, the mean of 3."""
    cfg, dev = meshnet.MESH1K, torch.device("cuda")
    opt = sgd(0.0, momentum=0.9)
    step = make_train_step(functools.partial(
        meshnet.loss_fn, cfg=cfg, plan=sh, mesh=mesh), opt,
        TrainStepConfig(precision=FP32), mesh=mesh)
    state = opt.init(params)
    batch = pipeline.to_device(pipeline.shard_batch(
        pipeline.synthetic_mesh_batch(0, BATCH, cfg.input_hw,
                                      cfg.in_channels, out_hw=cfg.out_hw),
        mesh, sh), dev)
    float(step(params, state, None, batch)[3]["loss"])        # warm

    def run_step():
        float(step(params, state, None, batch)[3]["loss"])
    wall_ms, groups, n_kernels = _device_breakdown(run_step, cnn_kind)
    grads = [torch.ones_like(p) for p in tree_leaves(params)]
    reduce_replicated_grads(grads, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        reduce_replicated_grads(grads, mesh)
    torch.cuda.synchronize()
    return {"wall_ms": wall_ms, "groups": groups, "n_kernels": n_kernels,
            "device_ms": sum(groups.values()),
            "grad_all_reduce_ms": (time.perf_counter() - t0) / 3 * 1e3,
            "grad_mb": sum(g.numel() for g in grads) * 4 / 1e6}


def spatial_hw_rank(rank: int, world: int) -> dict:
    """One of 4 ranks (data 2 x model 2; H over model, W over data): the
    conv-parity rows of block 1's stride-2 and stride-1 layers."""
    mesh = make_mesh(data=2, model=2)
    sh = ConvSharding(batch_axes=(), h_axis="model", w_axis="data")
    layers = list(enumerate(meshnet.layer_geometry(meshnet.MESH1K)))[:2]
    return {"conv_rows": conv_parity(mesh, sh, layers)}


def interior_copy_phase(card: str) -> dict:
    """What the §IV-A split's interior slice costs at a 2-way H shard of
    every mesh1k layer, batch 2, f32: the slice of a contiguous NHWC block
    is not contiguous (N > 1), and its W padding copies it into the
    contiguous tensor the kernel takes.  Times that pad (what the port
    does), the same pad of a contiguous tensor of the slice's shape, and
    the interior conv kernel (CUDA events, one process)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    tot = {"pad_slice_ms": 0.0, "pad_contig_ms": 0.0, "kernel_ms": 0.0}
    for name, c, hw, f, k, s in meshnet.layer_geometry(meshnet.MESH1K):
        lo, hi = same_pads(k, s)
        if lo == hi == 0:
            continue
        hl = hw // SPATIAL_MODEL
        x = torch.randn((BATCH, hl, hw, c), generator=gen, device=dev)
        w = torch.randn((k, k, c, f), generator=gen, device=dev)
        t_lo, i_hi, _ = split_rows(hl, k, s, lo)
        start = t_lo * s - lo
        inner = x.narrow(1, start, (i_hi - 1) * s - lo + k - start)
        dense = inner.contiguous()
        pad = (0, 0) + same_pads(k, s)
        xp = F.pad(inner, pad)
        tot["pad_slice_ms"] += time_fn(lambda: F.pad(inner, pad), reps=10,
                                       warmup=2) * 1e3
        tot["pad_contig_ms"] += time_fn(lambda: F.pad(dense, pad), reps=10,
                                        warmup=2) * 1e3
        tot["kernel_ms"] += time_fn(lambda: kconv.conv2d(xp, w, stride=s),
                                    reps=10, warmup=2) * 1e3
        del x, w, inner, dense, xp
    torch.cuda.empty_cache()
    print(f"interior slice copy, mesh1k at a {SPATIAL_MODEL}-way H shard, "
          f"batch {BATCH}, f32, 18 halo layers summed: pad of the "
          f"non-contiguous slice {tot['pad_slice_ms']:.4f} ms, pad of a "
          f"contiguous tensor of its shape {tot['pad_contig_ms']:.4f} ms, "
          f"interior conv kernels {tot['kernel_ms']:.4f} ms ({card})")
    return tot


def spatial_phase(card: str) -> dict:
    """The sample x spatial path as 2 and 4 processes sharing the one card
    over gloo (halos staged through the host): not a scaling result."""
    ranks = spawn_ranks(spatial_rank, SPATIAL_MODEL)
    hw4 = spawn_ranks(spatial_hw_rank, 4)
    geo = meshnet.layer_geometry(meshnet.MESH1K)
    print(f"spatial conv parity, f32, batch {BATCH}, overlap (interior / "
          f"boundary split): max |error| of each rank's block of y, dx and "
          f"dw (summed over the ranks) against the conv in float64 on the "
          f"card, and in brackets the one-process f32 conv's ({card}):")
    print(f"{'ranks':6s} {'layer':8s} {'x (N,H,W,C)':22s} {'k':>2s} {'s':>2s} "
          f"{'calls':>5s} {'err y':>20s} {'err dx':>20s} {'err dw':>20s}")
    for tag, runs in (("2 H", ranks), ("2x2 HW", hw4)):
        for i, row in enumerate(runs[0]["conv_rows"]):
            rs = [r["conv_rows"][i] for r in runs]
            for r in rs:
                if r["calls"] != r["want_calls"]:
                    raise AssertionError(f"{tag} {r['layer']}: {r['calls']} "
                                         f"conv launches, want "
                                         f"{r['want_calls']}")
            errs = " ".join(
                f"{max(r[f'err_{n}'] for r in rs):9.2e} "
                f"({max(r[f'one_err_{n}'] for r in rs):8.2e})"
                for n in ("y", "dx", "dw"))
            print(f"{tag:6s} {row['layer']:8s} {str(tuple(row['x'])):22s} "
                  f"{row['k']:2d} {row['stride']:2d} {row['calls']:5d} "
                  f"{errs}", flush=True)
    if len(ranks[0]["conv_rows"]) != len(geo) or len(hw4[0]["conv_rows"]) \
            != 2:
        raise AssertionError("spatial conv parity rows missing")

    lo_, l1 = ranks[0]["loss_ranks"], ranks[0]["loss_one"]
    rel = abs(lo_ - l1) / abs(l1)
    print(f"spatial forward check, full-width mesh1k, global BN, batch "
          f"{BATCH}: loss on {SPATIAL_MODEL} ranks {lo_!r} "
          f"({ranks[1]['loss_ranks']!r} on rank 1), one rank {l1!r}, rel "
          f"diff {rel:.3e} (tol {LOSS_RTOL}) ({card})")
    if not (math.isfinite(lo_) and rel <= LOSS_RTOL
            and ranks[1]["loss_ranks"] == lo_):
        raise AssertionError(f"spatial loss {lo_} vs one rank {l1}")

    # conv launches a step: the interior plus a top block where lo > 0 and
    # a bottom block where hi > 0 (spatial_conv.conv_calls); halo messages
    # through the host a step: on 2 ranks each sends or receives one per
    # halo width that is not 0, forward, and again backward except at the
    # first layer, whose input needs no gradient
    per_step = sum(conv_calls(hw // SPATIAL_MODEL, k, s)
                   for _, _, hw, _, k, s in geo)
    halo_step = sum(((same_pads(k, s)[0] > 0) + (same_pads(k, s)[1] > 0))
                    * (1 if i == 0 else 2)
                    for i, (_, _, _, _, k, s) in enumerate(geo))
    for r, out in enumerate(ranks):
        if out["losses"] != ranks[0]["losses"] or \
                out["digest"] != ranks[0]["digest"]:
            raise AssertionError(f"rank {r} diverged: losses "
                                 f"{out['losses']} vs {ranks[0]['losses']}")
        if not all(math.isfinite(x) for x in out["losses"]):
            raise AssertionError(f"non-finite loss: {out['losses']}")
        if out["launches"] != per_step * STEPS:
            raise AssertionError(f"rank {r}: {out['launches']} conv launches "
                                 f"in {STEPS} steps, want {per_step} x "
                                 f"{STEPS}")
        if out["staged"] != halo_step * STEPS:
            raise AssertionError(f"rank {r}: {out['staged']} staged halo "
                                 f"messages, want {halo_step} x {STEPS}")
        steady = out["step_s"][1:]
        print(f"spatial train rank {r}/{SPATIAL_MODEL} (2 processes sharing "
              f"one card over gloo: not a scaling result): full-width "
              f"mesh1k, global batch {BATCH}, uniform plan, losses "
              f"{out['losses']}; step seconds {out['step_s']} (batch wait "
              f"+ copy {out['data_s']}); steps 2..{STEPS}: "
              f"{sum(steady) / len(steady):.4f} s/step; peak memory "
              f"{out['peak_gib']:.2f} GiB; conv launches {out['launches']} "
              f"({per_step} a step); halo messages staged through the host "
              f"{out['staged']} ({halo_step} a step); all-reduces staged "
              f"{out['collectives_staged']} ({card})")
        b = out["breakdown"]
        print(f"spatial step breakdown rank {r} (one step, its block on "
              f"the card, the other rank stepping beside it, host clock "
              f"{b['wall_ms']:.2f} ms): device kernels {b['device_ms']:.2f} "
              f"ms in {b['n_kernels']} kernels, idle share "
              f"{1 - b['device_ms'] / b['wall_ms']:.3f}; " + "; ".join(
                  f"{k} {v:.2f} ms" for k, v in sorted(b["groups"].items()))
              + f"; the gradient all-reduce alone ({b['grad_mb']:.1f} MB "
              f"through gloo) {b['grad_all_reduce_ms']:.2f} ms ({card})")
    return {"ranks": ranks, "hw_ranks": hw4, "launches_per_step": per_step,
            "staged_per_step": halo_step, "loss_rel_diff": rel}


# ------------------------------------------------------ the auto plan --

AUTO_MESH = {"data": 1, "model": SPATIAL_MODEL}
# the CF conv-parity layers of full-width mesh1k: (layer, mode, chunks)
CF_PARITY = [(layer, mode, chunks) for layer in ("conv4_2", "conv5_1",
                                                 "conv6_3")
             for mode, chunks in (("channel", 1), ("channel", 2),
                                  ("filter", 1))]
# the record_function ranges of the plan's collectives (host time)
AUTO_RANGES = ("cf_reduce_scatter", "cf_all_gather", "reshard")


def auto_plan():
    """The plan `--strategy auto` solves on the card for full-width mesh1k
    at batch BATCH on AUTO_MESH (the H100 preset)."""
    return plan_lib.plan_line(H100, meshnet.layer_specs(
        meshnet.MESH1K, BATCH), AUTO_MESH)


def plan_kinds(plan) -> list[str]:
    """Each layer's kind: CF, or the spatial split, or sample, or R."""
    out = []
    for lp in plan.layers.values():
        sh = lp.sharding
        out.append("CF" if getattr(sh, "cf_axis", None) else
                   "HW"[0 if sh.h_axis else 1] if sh.is_spatial else
                   "N" if sh.batch_axes else "R")
    return out


def plan_conv_calls(plan, specs, shape=AUTO_MESH) -> int:
    """Conv kernel launches of one forward under `plan` on one rank of a
    mesh of `shape`: one a sample, replicated or channel/filter layer
    (`chunks` in chunked channel mode), `conv_calls` of its local extent
    a spatially split one (CF x spatial too; an axis of one rank splits
    nothing: `ConvSharding.without_unit_axes`)."""
    layout = Mesh(shape, rank=0)
    n = 0
    for spec in specs:
        sh = plan.sharding(spec.name)
        cf = getattr(sh, "cf_axis", None) is not None
        cut = ConvSharding(h_axis=sh.h_axis, w_axis=sh.w_axis
                           ).without_unit_axes(shape)
        if cut.is_spatial:
            axis = cut.w_axis if cut.w_axis is not None else cut.h_axis
            ext = spec.w if cut.w_axis is not None else spec.h
            n += conv_calls(ext // layout.axis_size(axis), spec.k, spec.s)
        elif cf and sh.mode == "channel" and not sh.is_spatial:
            n += min(channel_conv.default_channel_chunks(),
                     spec.c // layout.axis_size(sh.cf_axis))
        else:
            n += 1
    return n


def _reshard_staged(src, dst) -> int:
    """Collectives a reshard from sharding `src` to `dst` stages, forward
    and backward: each all-gather or all-to-all (a slice sends nothing)."""
    return 2 * sum(op != "slice" for op, *_ in collectives.reshard_steps(
        collectives.layout(src), collectives.layout(dst)))


def _layer_staged(lp, spec, scope: str, bn: bool) -> int:
    """Collectives a layer's conv and BN stage, forward and backward: each
    CF collective, and a BN whose statistics are summed over more than
    one rank."""
    shape = Mesh(AUTO_MESH, rank=0)
    n, sh = 0, lp.sharding
    if getattr(sh, "cf_axis", None) is not None:
        n += 2 * (1 if sh.is_spatial or sh.mode == "filter" else
                  min(channel_conv.default_channel_chunks(),
                      spec.c // SPATIAL_MODEL))
    if not bn:
        return n
    out = lp.out_sharding
    if getattr(out, "cf_axis", None) is not None or out.is_spatial:
        axes = () if scope == "local" else out.spatial_axes + (
            tuple(out.batch_axes) if scope == "global" else ())
    else:
        axes = tuple(out.batch_axes)
    return n + 2 * (shape.axis_size(axes) > 1)


def plan_staged(plan, specs, scope: str) -> int:
    """Collectives one training step under `plan` stages through the host
    on one rank (gloo, CUDA tensors; halos apart): a BN whose statistics
    are summed over more than one rank, and each CF collective and each
    reshard's all-gather or all-to-all, forward and backward alike; then
    the gradient and the loss all-reduces."""
    n = 2
    for i, spec in enumerate(specs):
        lp = plan.layers[spec.name]
        if lp.reshard_in:
            n += _reshard_staged(plan.out_sharding(specs[i - 1].name),
                                 lp.sharding)
        n += _layer_staged(lp, spec, scope, bn=spec.name != "pred")
    return n


def cf_parity(mesh) -> list[dict]:
    """At each CF_PARITY row of full-width mesh1k, batch BATCH, f32: this
    rank's block of y (F-sharded), of dx (C-sharded) and the mesh-summed
    dw of `cf_conv2d`, each against the conv in float64 on the card, with
    the conv kernel's plan at the shard shape and its launches."""
    dev, rows = torch.device("cuda"), []
    geo = {g[0]: g for g in meshnet.layer_geometry(meshnet.MESH1K)}
    p = mesh.axis_size("model")
    for li, (name, mode, chunks) in enumerate(CF_PARITY):
        _, c, hw, f, k, s = geo[name]
        gen = torch.Generator(device=dev).manual_seed(200 + li)
        x = torch.randn((BATCH, hw, hw, c), generator=gen, device=dev)
        w = torch.randn((k, k, c, f), generator=gen, device=dev) \
            * math.sqrt(2.0 / (k * k * c))
        g = torch.randn((BATCH, hw // s, hw // s, f), generator=gen,
                        device=dev)
        a = x.double().requires_grad_()
        b = w.double().requires_grad_()
        y64 = _conv_f64(a, b, s)
        (y64 * g.double()).sum().backward()
        dx64, dw64 = a.grad, b.grad
        del a, b
        xl = pipeline.shard_dim(x, 3, mesh, "model").contiguous() \
            .requires_grad_()
        wl = w.clone().requires_grad_()
        sh = channel_conv.CFSharding(cf_axis="model", mode=mode)
        before = kconv.conv2d.launches
        y = channel_conv.cf_conv2d(xl, wl, strides=(s, s), sharding=sh,
                                   mesh=mesh, channel_chunks=chunks)
        calls = kconv.conv2d.launches - before
        (y * pipeline.shard_dim(g, 3, mesh, "model")).sum().backward()
        dw = reduce_replicated_grads([wl.grad], mesh)[0]
        torch.cuda.synchronize()
        lo, hi = same_pads(k, s)
        c_loc = c // p // chunks if mode == "channel" else c
        f_loc = f if mode == "channel" else f // p
        kp = kconv.plan((BATCH, hw + lo + hi, hw + lo + hi, c_loc),
                        (k, k, c_loc, f_loc), s, torch.float32)
        what = f"CF conv {name} {mode} chunks {chunks} rank {mesh.rank}"
        row = {"layer": name, "mode": mode, "chunks": chunks,
               "x": [BATCH, hw, hw, c], "f": f, "stride": s,
               "shard": [BATCH, hw + lo + hi, hw + lo + hi, c_loc, f_loc],
               "plan": dataclasses.asdict(kp), "calls": calls,
               "want_calls": chunks if mode == "channel" else 1}
        for nm, got, exact, tol in (
                ("y", y.detach(), pipeline.shard_dim(y64, 3, mesh, "model"),
                 SPATIAL_FWD_TOL),
                ("dx", xl.grad, pipeline.shard_dim(dx64, 3, mesh, "model"),
                 SPATIAL_BWD_TOL),
                ("dw", dw, dw64, SPATIAL_BWD_TOL)):
            row[f"err_{nm}"] = _check_close(f"{what} {nm}", got, exact, tol)
        rows.append(row)
        del x, w, g, y64, dx64, dw64, xl, wl, y, dw
    torch.cuda.empty_cache()
    return rows


def _plan_loss(plan_spec: dict, mesh, dev: torch.device) -> float:
    """The full-width mesh1k forward loss of global batch 0 (seed-0
    params) under the plan `plan_spec` lowers to, summed over the ranks."""
    cfg = meshnet.MESH1K
    specs = meshnet.layer_specs(cfg, BATCH)
    plan = plan_lib.plan_from_spec(plan_spec, specs, AUTO_MESH)
    model = meshnet.MeshNet(cfg, generator=torch.Generator().manual_seed(0),
                            device=dev)
    nb = pipeline.synthetic_mesh_batch(0, BATCH, cfg.input_hw,
                                       cfg.in_channels, out_hw=cfg.out_hw)
    b = pipeline.to_device(pipeline.shard_batch(
        nb, mesh, plan.sharding(specs[0].name), plan.sharding("pred")), dev)
    with torch.no_grad():
        part = meshnet.loss_fn(model.params(), b, cfg, plan, mesh)
        return float(mesh.all_reduce(part, mesh.axis_names))


def auto_cpu_rank(rank: int, world: int, plan_spec: dict) -> dict:
    """One of 2 gloo ranks on the CPU (plain versions): `_plan_loss`."""
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))
    mesh = make_mesh(**AUTO_MESH)
    t0 = time.perf_counter()
    loss = _plan_loss(plan_spec, mesh, torch.device("cpu"))
    return {"loss": loss, "seconds": time.perf_counter() - t0}


def auto_rank(rank: int, world: int) -> dict:
    """One of 2 ranks on the card: (a) the CF conv-parity rows; (b) 3
    training steps through the trainer's own entry under `--strategy auto`,
    with its conv launches, staged
    messages and bytes sent by each collective; (c) the forward loss of
    one global batch under that plan; (d) one more step profiled."""
    mesh = make_mesh(**AUTO_MESH)
    rows = cf_parity(mesh)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    halo.reset_staged()
    collectives.reset_sent()
    res = train_cli.main(["--arch", "mesh1k", "--batch", str(BATCH),
                          "--steps", str(STEPS), "--model",
                          str(SPATIAL_MODEL), "--device", "cuda",
                          "--strategy", "auto", "--log-every", "1"])
    launches, staged = ops.launch_counts()["conv2d"], halo.staged
    collectives_staged, sent = res["mesh"].staged, dict(collectives.sent)
    peak = torch.cuda.max_memory_allocated() / 2**30
    plan = res["plan"]
    spec = plan.to_spec(AUTO_MESH)
    loss = _plan_loss(spec, mesh, torch.device("cuda"))
    breakdown = auto_step_breakdown(res["params"], mesh, plan)
    return {"cf_rows": rows, "losses": res["losses"],
            "step_s": res["step_s"], "data_s": res["data_s"],
            "launches": launches, "staged": staged,
            "collectives_staged": collectives_staged, "sent": sent,
            "peak_gib": peak, "plan_spec": spec,
            "describe": plan.describe(), "loss_card": loss,
            "breakdown": breakdown,
            "digest": [float(p.detach().double().sum())
                       for p in tree_leaves(res["params"])]}


def auto_step_breakdown(params, mesh, plan) -> dict:
    """One more training step of this rank under `plan` (batch on the card,
    lr 0) under torch.profiler (`plan_step_breakdown`)."""
    cfg = meshnet.MESH1K
    specs = meshnet.layer_specs(cfg, BATCH)
    batch = pipeline.shard_batch(
        pipeline.synthetic_mesh_batch(0, BATCH, cfg.input_hw,
                                      cfg.in_channels, out_hw=cfg.out_hw),
        mesh, plan.sharding(specs[0].name), plan.sharding("pred"))
    return plan_step_breakdown(functools.partial(
        meshnet.loss_fn, cfg=cfg, plan=plan, mesh=mesh), params, mesh,
        batch, cnn_kind)


def plan_step_breakdown(loss, params, mesh, batch, classify) -> dict:
    """One training step of this rank of `loss` (lr 0) on its block
    `batch` on the card, after a warm one, under torch.profiler: device
    kernels by kind (`classify`; the copies that stage gloo's collectives
    apart), and the host time of the plan's collective ranges
    (AUTO_RANGES)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    opt = sgd(0.0, momentum=0.9)
    step = make_train_step(loss, opt, TrainStepConfig(precision=FP32),
                           mesh=mesh)
    state = opt.init(params)
    batch = pipeline.to_device(batch, torch.device("cuda"))
    float(step(params, state, None, batch)[3]["loss"])        # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(params, state, None, batch)[3]["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict[str, float] = {}
    ranges = {k: 0.0 for k in AUTO_RANGES}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and _annotation(e):
            continue
        if e.device_type == DeviceType.CUDA:
            n_kernels += 1
            name = e.name.lower()
            g = "memcpy (gloo's host staging)" if "memcpy" in name \
                else classify(name)
            groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us() / 1e3
        elif e.name.rsplit("/", 1)[-1] in ranges:
            # `<layer>/<region>` (core.trace.annotate), summed by region
            ranges[e.name.rsplit("/", 1)[-1]] += \
                e.time_range.elapsed_us() / 1e3
    return {"wall_ms": wall_ms, "groups": groups, "n_kernels": n_kernels,
            "device_ms": sum(groups.values()), "host_ranges_ms": ranges}


def auto_phase(card: str) -> dict:
    """The paper's own loop, `--strategy auto`, as 2 processes sharing the
    one card over gloo (not a scaling result): the solve on the H100
    preset, 3 trainer steps, the CF conv parity at the CF
    shard shapes, the card's forward loss under the plan against 2 gloo
    CPU ranks' and one profiled step."""
    specs = meshnet.layer_specs(meshnet.MESH1K, BATCH)
    solved = auto_plan()
    kinds = plan_kinds(solved)
    if "CF" not in kinds or solved.n_reshards == 0:
        raise AssertionError(f"auto plan without a CF layer or a reshard: "
                             f"{kinds}")
    ranks = spawn_ranks(auto_rank, SPATIAL_MODEL)
    if ranks[0]["plan_spec"]["layers"] != solved.to_spec()["layers"]:
        raise AssertionError("the trainer ran another plan than the one "
                             "solved here:\n" + ranks[0]["describe"])
    report = solved.reshard_report(specs, AUTO_MESH)
    print(f"auto plan, full-width mesh1k, batch {BATCH}, mesh {AUTO_MESH}, "
          f"layer kinds {' '.join(kinds)}:")
    print(solved.describe())
    print(plan_lib.reshard_lines(report))

    print(f"CF conv parity, f32, batch {BATCH}, 2 ranks: max |error| of each "
          f"rank's block of y, dx and of dw (summed over the ranks) against "
          f"the conv in float64 on the card, with the conv kernel's plan at "
          f"the shard shape ({card}):")
    for i, row in enumerate(ranks[0]["cf_rows"]):
        rs = [r["cf_rows"][i] for r in ranks]
        for r in rs:
            if r["calls"] != r["want_calls"]:
                raise AssertionError(f"CF {r['layer']} {r['mode']}: "
                                     f"{r['calls']} conv launches, want "
                                     f"{r['want_calls']}")
        kp = row["plan"]
        print(f"  {row['layer']:8s} {row['mode']:7s} chunks {row['chunks']} "
              f"x {tuple(row['x'])} stride {row['stride']} shard (N,H,W,C)"
              f"xF {tuple(row['shard'][:4])}x{row['shard'][4]}: plan "
              f"{kp['path']} {kp['tile_m']}x{kp['tile_n']} k{kp['tile_k']} "
              f"splits {kp['splits']}; calls {row['calls']}; err y "
              f"{max(r['err_y'] for r in rs):.2e} dx "
              f"{max(r['err_dx'] for r in rs):.2e} dw "
              f"{max(r['err_dw'] for r in rs):.2e}", flush=True)

    cpu = spawn_ranks(auto_cpu_rank, SPATIAL_MODEL, ranks[0]["plan_spec"])
    lg, lc = ranks[0]["loss_card"], cpu[0]["loss"]
    rel = abs(lg - lc) / abs(lc)
    print(f"auto forward check, full-width mesh1k, batch {BATCH}, 2 ranks "
          f"under the plan: loss card {lg!r} ({ranks[1]['loss_card']!r} on "
          f"rank 1), 2 gloo CPU ranks {lc!r} ({cpu[0]['seconds']:.1f} s), "
          f"rel diff {rel:.3e} (tol {LOSS_RTOL}) ({card})")
    if not (math.isfinite(lg) and rel <= LOSS_RTOL
            and ranks[1]["loss_card"] == lg and cpu[1]["loss"] == lc):
        raise AssertionError(f"auto plan loss {lg} vs CPU {lc}")

    per_step = plan_conv_calls(solved, specs)
    staged_step = plan_staged(solved, specs, meshnet.MESH1K.bn_scope)
    reshard_bytes = 2 * sum(r["bytes"] for r in report)    # fwd + bwd
    for r, out in enumerate(ranks):
        if out["losses"] != ranks[0]["losses"] or \
                out["digest"] != ranks[0]["digest"]:
            raise AssertionError(f"rank {r} diverged: losses "
                                 f"{out['losses']} vs {ranks[0]['losses']}")
        if not all(math.isfinite(x) for x in out["losses"]):
            raise AssertionError(f"non-finite loss: {out['losses']}")
        if out["launches"] != per_step * STEPS:
            raise AssertionError(f"rank {r}: {out['launches']} conv launches "
                                 f"in {STEPS} steps, want {per_step} x "
                                 f"{STEPS}")
        if out["collectives_staged"] != staged_step * STEPS:
            raise AssertionError(f"rank {r}: {out['collectives_staged']} "
                                 f"collectives staged, want {staged_step} "
                                 f"x {STEPS}")
        if out["sent"].get("reshard", 0) != reshard_bytes * STEPS:
            raise AssertionError(f"rank {r}: reshards sent "
                                 f"{out['sent'].get('reshard', 0)} bytes, "
                                 f"want {reshard_bytes} x {STEPS}")
        steady = out["step_s"][1:]
        print(f"auto train rank {r}/{SPATIAL_MODEL} (2 processes sharing one "
              f"card over gloo: not a scaling result): full-width mesh1k, "
              f"global batch {BATCH}, losses {out['losses']}; step seconds "
              f"{out['step_s']} (batch wait + copy {out['data_s']}); steps "
              f"2..{STEPS}: {sum(steady) / len(steady):.4f} s/step; peak "
              f"memory {out['peak_gib']:.2f} GiB; conv launches "
              f"{out['launches']} ({per_step} a step); halo messages staged "
              f"{out['staged']}; collectives staged through the host "
              f"{out['collectives_staged']} ({staged_step} a step); bytes "
              f"sent {out['sent']} (reshards "
              f"{reshard_bytes} a step) ({card})")
        b = out["breakdown"]
        print(f"auto step breakdown rank {r} (one step, host clock "
              f"{b['wall_ms']:.2f} ms): device kernels {b['device_ms']:.2f} "
              f"ms in {b['n_kernels']} kernels, idle share "
              f"{1 - b['device_ms'] / b['wall_ms']:.3f}; " + "; ".join(
                  f"{k} {v:.2f} ms" for k, v in sorted(b["groups"].items()))
              + "; host ranges: " + "; ".join(
                  f"{k} {v:.2f} ms"
                  for k, v in b["host_ranges_ms"].items()) + f" ({card})")
    return {"ranks": ranks, "cpu": cpu, "kinds": kinds,
            "n_reshards": solved.n_reshards, "reshard_report": report,
            "launches_per_step": per_step, "staged_per_step": staged_step,
            "loss_rel_diff": rel}


# ------------------------------------------------------------ ResNet-50 --

RESNET = resnet.RESNET50
RESNET_BATCH = 32
# the 23 conv shapes, kernel vs plain element by element as well
# (tests/test_torch_cuda.py's TOL): |kernel - plain| <= tol (1 + |plain|)
RESNET_ELEM_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# full-width forward loss at batch 2, card vs CPU (as mesh1k's)
RESNET_CHECK_BATCH = 2
# the auto plan's forward loss of one global batch against the one-device
# card loss on the same params and batch: the same function (every BN of
# the plan normalises as one device does), sums split over 2 ranks
RESNET_PLAN_RTOL = 1e-5
RESNET_MESH = AUTO_MESH


def resnet_conv_shapes(cfg, batch: int) -> list[dict]:
    """The distinct conv calls of one ResNet forward, in graph order, with
    how many convs make each: padded input (N, H, W, C), K, F, stride."""
    g = resnet.resnet_graph(batch, cfg)
    shapes: dict[tuple, dict] = {}
    for name in g.nodes:
        spec = g.nodes[name]["layer"]
        if spec.kind == "pool":
            continue
        lo, hi = same_pads(spec.k, spec.s)
        key = (batch, spec.h + lo + hi, spec.w + lo + hi, spec.c, spec.k,
               spec.f, spec.s)
        if key not in shapes:
            shapes[key] = {"layer": name, "x": key[:4], "k": spec.k,
                           "f": spec.f, "stride": spec.s, "count": 0}
        shapes[key]["count"] += 1
    return list(shapes.values())


def resnet_n_convs(cfg) -> int:
    return sum(s.kind != "pool" for s in resnet.all_specs(1, cfg))


def resnet_kind(name: str) -> str:
    """`cnn_kind`, with the max-pool's amax reduction (a max-reducing
    `reduce_kernel`, the only one a ResNet step runs) apart."""
    if "reduce_kernel" in name and "max" in name:
        return "max-pool amax (forward)"
    return cnn_kind(name)


def resnet_train_phase(card: str) -> dict:
    """The trainer's own entry on full-width ResNet-50, batch 32, 3 steps:
    finite losses and 53 x 3 conv launches."""
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = train_cli.main(["--arch", "resnet50", "--batch",
                          str(RESNET_BATCH), "--steps", str(STEPS),
                          "--device", "cuda", "--log-every", "1"])
    launches = ops.launch_counts()["conv2d"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_convs = resnet_n_convs(RESNET)
    if not all(math.isfinite(l) for l in res["losses"]):
        raise AssertionError(f"non-finite loss: {res['losses']}")
    if launches != n_convs * STEPS:
        raise AssertionError(f"conv kernel launched {launches} times in "
                             f"{STEPS} steps, want {n_convs} x {STEPS}")
    steady = res["step_s"][1:]
    step_s = sum(steady) / len(steady)
    compute = [t - d for t, d in zip(res["step_s"], res["data_s"])][1:]
    compute_s = sum(compute) / len(compute)
    print(f"resnet50 train: {STEPS} steps of full-width ResNet-50 "
          f"({res['n_params']} params) at batch {RESNET_BATCH}; losses "
          f"{res['losses']}; step seconds {res['step_s']} (batch wait + "
          f"copy {res['data_s']}); steps 2..{STEPS}: {step_s:.4f} s/step, "
          f"{RESNET_BATCH / step_s:.2f} samples/s; without the batch wait "
          f"{compute_s:.4f} s/step, {RESNET_BATCH / compute_s:.2f} "
          f"samples/s; peak memory {peak:.2f} GiB; conv launches "
          f"{launches} ({n_convs} a forward) ({card})")
    return {"launches": launches, "losses": res["losses"],
            "step_s": res["step_s"], "data_s": res["data_s"],
            "steady_step_s": step_s, "steady_compute_s": compute_s,
            "peak_gib": peak, "n_params": res["n_params"]}


def resnet_profile_phase(card: str) -> dict:
    """Device time of one full-width ResNet-50 training step (batch 32 on
    the card) by kind of kernel, and the max-pool alone: its forward and
    forward + backward times (CUDA events) and the memory it adds, at
    conv1's output (32, 112, 112, 64)."""
    dev = torch.device("cuda")
    model = resnet.ResNet(RESNET, generator=torch.Generator().manual_seed(0),
                          device=dev)
    params = model.params()
    opt = sgd(0.0, momentum=0.9)
    step = make_train_step(functools.partial(resnet.loss_fn, cfg=RESNET),
                           opt, TrainStepConfig(precision=FP32))
    state = opt.init(params)
    batch = pipeline.to_device(pipeline.synthetic_imagenet_batch(
        0, RESNET_BATCH, RESNET.input_hw, RESNET.n_classes), dev)
    params, state, _, _ = step(params, state, None, batch)     # warm

    def run_step():
        float(step(params, state, None, batch)[3]["loss"])

    wall_ms, groups, n_kernels = _device_breakdown(run_step, resnet_kind)
    busy = sum(groups.values())
    del model, params, state, batch
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.relu(torch.randn((RESNET_BATCH, RESNET.input_hw // 2,
                                RESNET.input_hw // 2, 64), generator=gen,
                               device=dev)).requires_grad_()
    sh = ConvSharding()

    def pool():
        return cnn_layers.max_pool(x, window=3, stride=2, sharding=sh)

    def pool_fwd_bwd():
        return torch.autograd.grad(pool().sum(), x)[0]

    fwd_ms = time_fn(pool, reps=10, warmup=2) * 1e3
    fwd_bwd_ms = time_fn(pool_fwd_bwd, reps=10, warmup=2) * 1e3
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = pool()
    held = torch.cuda.memory_allocated() - base      # output + saved taps
    torch.autograd.grad(y.sum(), x)
    pool_peak = torch.cuda.max_memory_allocated() - base
    del x, y
    torch.cuda.empty_cache()
    if n_kernels == 0:
        print("resnet50 step breakdown: the profiler saw no device kernels "
              "(not measured)")
    else:
        print(f"resnet50 step breakdown (one step, batch {RESNET_BATCH} on "
              f"the card, host clock {wall_ms:.2f} ms): device kernels "
              f"{busy:.2f} ms in {n_kernels} kernels, idle share "
              f"{1 - busy / wall_ms:.3f}; " + "; ".join(
                  f"{k} {v:.2f} ms" for k, v in sorted(groups.items()))
              + f" ({card})")
    print(f"resnet50 max-pool (plain PyTorch: 9 stacked taps, amax) at "
          f"(32, 112, 112, 64): forward {fwd_ms:.3f} ms, forward + "
          f"backward {fwd_bwd_ms:.3f} ms; held after the forward "
          f"{held / 2**20:.1f} MiB, peak over the input through the "
          f"backward {pool_peak / 2**20:.1f} MiB ({card})")
    return {"wall_ms": wall_ms, "device_ms": busy if n_kernels else None,
            "groups": groups, "n_kernels": n_kernels,
            "pool_fwd_ms": fwd_ms, "pool_fwd_bwd_ms": fwd_bwd_ms,
            "pool_held_mib": held / 2**20, "pool_peak_mib": pool_peak / 2**20}


def resnet_forward_check(card: str) -> dict:
    """Full-width ResNet-50 forward loss at batch 2 (seed-0 params): card
    vs CPU."""
    nb = pipeline.synthetic_imagenet_batch(0, RESNET_CHECK_BATCH,
                                           RESNET.input_hw, RESNET.n_classes)
    out = {}
    with torch.no_grad():
        for dev in ("cuda", "cpu"):
            d = torch.device(dev)
            model = resnet.ResNet(RESNET, generator=torch.Generator()
                                  .manual_seed(0), device=d)
            b = pipeline.to_device(nb, d)
            t0 = time.perf_counter()
            out[dev] = float(resnet.loss_fn(model.params(), b, RESNET))
            out[dev + "_s"] = time.perf_counter() - t0
            del model, b
    lg, lc = out["cuda"], out["cpu"]
    rel = abs(lg - lc) / abs(lc)
    print(f"resnet50 forward check, batch {RESNET_CHECK_BATCH}: loss card "
          f"{lg!r} cpu {lc!r} ({out['cpu_s']:.1f} s) rel diff {rel:.3e} "
          f"(tol {LOSS_RTOL}) ({card})")
    if not (math.isfinite(lg) and rel <= LOSS_RTOL):
        raise AssertionError(f"card loss {lg} vs cpu loss {lc}: rel {rel}")
    return {"loss_cuda": lg, "loss_cpu": lc, "rel_diff": rel}


def resnet_auto_plan():
    """The plan `--strategy auto` solves on the card for full-width
    ResNet-50 at batch 32 on RESNET_MESH (the H100 preset)."""
    return plan_lib.plan_graph(H100, resnet.resnet_graph(RESNET_BATCH),
                               resnet.layer_specs(RESNET_BATCH), RESNET_MESH)


def resnet_staged(plan, cfg) -> int:
    """Collectives one ResNet training step under `plan` stages through
    the host on one rank (gloo, CUDA tensors; halos apart): each layer's
    (`_layer_staged`; the pool has no BN), each reshard of `resnet.flow`
    (the residual adds' included), the head's gather of a CF-sharded or
    sum of a spatially sharded last output, forward and backward alike;
    then the gradient and the loss all-reduces."""
    shape = Mesh(RESNET_MESH, rank=0)
    n = 2
    for spec in resnet.all_specs(1, cfg):
        n += _layer_staged(plan.layers[spec.name], spec, cfg.bn_scope,
                           bn=spec.kind != "pool")
    for src, name, kind in resnet.flow(cfg):
        dst = plan.sharding(name) if kind == "in" else \
            plan.out_sharding(name)
        n += _reshard_staged(plan.out_sharding(src), dst)
    last = plan.out_sharding(resnet.last_layer(cfg))
    n += 2 * (shape.axis_size(last.spatial_axes) > 1)
    n += 2 * (getattr(last, "cf_axis", None) is not None)
    return n


def _resnet_plan_loss(plan, mesh, dev: torch.device) -> float:
    """The full-width ResNet-50 forward loss of global batch 0 (seed-0
    params) under `plan`, summed over the ranks (one device: mesh None)."""
    model = resnet.ResNet(RESNET, generator=torch.Generator().manual_seed(0),
                          device=dev)
    nb = pipeline.synthetic_imagenet_batch(0, RESNET_BATCH, RESNET.input_hw,
                                           RESNET.n_classes)
    if mesh is not None:
        nb = pipeline.shard_batch(nb, mesh, plan.sharding("conv1"),
                                  plan.out_sharding(resnet.last_layer(
                                      RESNET)))
    with torch.no_grad():
        part = resnet.loss_fn(model.params(), pipeline.to_device(nb, dev),
                              RESNET, plan, mesh)
        if mesh is None:
            return float(part)
        return float(mesh.all_reduce(part, mesh.axis_names))


def resnet_auto_rank(rank: int, world: int) -> dict:
    """One of 2 ranks on the card: (a) 3 training steps of full-width
    ResNet-50 through the trainer's own entry under `--strategy auto`,
    with its conv launches, staged collectives and bytes sent by each;
    (b) the forward loss of one global batch under that plan; (c) one
    more step profiled."""
    mesh = make_mesh(**RESNET_MESH)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    halo.reset_staged()
    collectives.reset_sent()
    res = train_cli.main(["--arch", "resnet50", "--batch",
                          str(RESNET_BATCH), "--steps", str(STEPS),
                          "--model", str(SPATIAL_MODEL), "--device", "cuda",
                          "--strategy", "auto", "--log-every", "1"])
    launches, staged = ops.launch_counts()["conv2d"], halo.staged
    collectives_staged, sent = res["mesh"].staged, dict(collectives.sent)
    peak = torch.cuda.max_memory_allocated() / 2**30
    plan = res["plan"]
    loss = _resnet_plan_loss(plan, mesh, torch.device("cuda"))
    batch = pipeline.shard_batch(
        pipeline.synthetic_imagenet_batch(0, RESNET_BATCH, RESNET.input_hw,
                                          RESNET.n_classes),
        mesh, plan.sharding("conv1"),
        plan.out_sharding(resnet.last_layer(RESNET)))
    breakdown = plan_step_breakdown(functools.partial(
        resnet.loss_fn, cfg=RESNET, plan=plan, mesh=mesh), res["params"],
        mesh, batch, resnet_kind)
    return {"losses": res["losses"], "step_s": res["step_s"],
            "data_s": res["data_s"], "launches": launches,
            "staged": staged, "collectives_staged": collectives_staged,
            "sent": sent, "peak_gib": peak,
            "plan_spec": plan.to_spec(RESNET_MESH),
            "describe": plan.describe(), "loss_card": loss,
            "breakdown": breakdown,
            "digest": [float(p.detach().double().sum())
                       for p in tree_leaves(res["params"])]}


def resnet_auto_phase(card: str) -> dict:
    """§V-C longest-path-first on ResNet-50, `--strategy auto`, as 2
    processes sharing the one card over gloo (not a scaling result): the
    solve on the H100 preset (it must have a CF layer and a residual-add
    reshard), 3 trainer steps, the forward loss under the plan against
    the one-device card loss, one profiled step."""
    specs = resnet.all_specs(RESNET_BATCH)
    solved = resnet_auto_plan()
    kinds = plan_kinds(solved)
    report = solved.reshard_report(specs, RESNET_MESH,
                                   flow=resnet.flow(RESNET))
    if "CF" not in kinds or not any(r["layer"].endswith("(add)")
                                    for r in report):
        raise AssertionError(f"auto ResNet-50 plan without a CF layer or a "
                             f"residual-add reshard: {kinds}")
    print(f"auto plan, full-width ResNet-50, batch {RESNET_BATCH}, mesh "
          f"{RESNET_MESH}, layer kinds {' '.join(kinds)}:")
    print(solved.describe())
    print(plan_lib.reshard_lines(report))
    one = _resnet_plan_loss(None, None, torch.device("cuda"))
    torch.cuda.empty_cache()
    ranks = spawn_ranks(resnet_auto_rank, SPATIAL_MODEL)
    if ranks[0]["plan_spec"]["layers"] != solved.to_spec()["layers"]:
        raise AssertionError("the trainer ran another plan than the one "
                             "solved here:\n" + ranks[0]["describe"])
    lg = ranks[0]["loss_card"]
    rel = abs(lg - one) / abs(one)
    print(f"auto resnet50 forward check, batch {RESNET_BATCH}, 2 ranks under "
          f"the plan: loss {lg!r} ({ranks[1]['loss_card']!r} on rank 1), "
          f"one device {one!r}, rel diff {rel:.3e} (tol {RESNET_PLAN_RTOL}) "
          f"({card})")
    if not (math.isfinite(lg) and rel <= RESNET_PLAN_RTOL
            and ranks[1]["loss_card"] == lg):
        raise AssertionError(f"auto plan loss {lg} vs one device {one}")
    per_step = plan_conv_calls(solved, [s for s in specs
                                        if s.kind != "pool"])
    staged_step = resnet_staged(solved, RESNET)
    reshard_bytes = 2 * sum(r["bytes"] for r in report)    # fwd + bwd
    for r, out in enumerate(ranks):
        if out["losses"] != ranks[0]["losses"] or \
                out["digest"] != ranks[0]["digest"]:
            raise AssertionError(f"rank {r} diverged: losses "
                                 f"{out['losses']} vs {ranks[0]['losses']}")
        if not all(math.isfinite(x) for x in out["losses"]):
            raise AssertionError(f"non-finite loss: {out['losses']}")
        if out["launches"] != per_step * STEPS:
            raise AssertionError(f"rank {r}: {out['launches']} conv launches "
                                 f"in {STEPS} steps, want {per_step} x "
                                 f"{STEPS}")
        if out["collectives_staged"] != staged_step * STEPS:
            raise AssertionError(f"rank {r}: {out['collectives_staged']} "
                                 f"collectives staged, want {staged_step} "
                                 f"x {STEPS}")
        if out["sent"].get("reshard", 0) != reshard_bytes * STEPS:
            raise AssertionError(f"rank {r}: reshards sent "
                                 f"{out['sent'].get('reshard', 0)} bytes, "
                                 f"want {reshard_bytes} x {STEPS}")
        steady = out["step_s"][1:]
        step_s = sum(steady) / len(steady)
        print(f"auto resnet50 train rank {r}/{SPATIAL_MODEL} (2 processes "
              f"sharing one card over gloo: not a scaling result): "
              f"full-width ResNet-50, global batch {RESNET_BATCH}, losses "
              f"{out['losses']}; step seconds {out['step_s']} (batch wait + "
              f"copy {out['data_s']}); steps 2..{STEPS}: {step_s:.4f} "
              f"s/step, {RESNET_BATCH / step_s:.2f} samples/s (both ranks); "
              f"peak memory {out['peak_gib']:.2f} GiB; conv launches "
              f"{out['launches']} ({per_step} a step); halo messages "
              f"staged {out['staged']}; collectives staged through the "
              f"host {out['collectives_staged']} ({staged_step} a step); "
              f"bytes sent {out['sent']} (reshards {reshard_bytes} a step) "
              f"({card})")
        b = out["breakdown"]
        print(f"auto resnet50 step breakdown rank {r} (one step, host clock "
              f"{b['wall_ms']:.2f} ms): device kernels {b['device_ms']:.2f} "
              f"ms in {b['n_kernels']} kernels, idle share "
              f"{1 - b['device_ms'] / b['wall_ms']:.3f}; " + "; ".join(
                  f"{k} {v:.2f} ms" for k, v in sorted(b["groups"].items()))
              + "; host ranges: " + "; ".join(
                  f"{k} {v:.2f} ms"
                  for k, v in b["host_ranges_ms"].items()) + f" ({card})")
    return {"ranks": ranks, "kinds": kinds, "n_reshards": solved.n_reshards,
            "reshard_report": report, "launches_per_step": per_step,
            "staged_per_step": staged_step, "loss_one_device": one,
            "loss_rel_diff": rel}


# ------------------------------- calibrate -> solve -> profile (4e) --

CALIB_DIR = os.path.join(HERE, "build", "calibrate")
# calibrate.main's timing: one warmup call and CALIB_REPS timed calls a
# table key, so each conv key launches the conv kernel at least 6 times
CALIB_REPS = 5


def calib_rank(rank: int, world: int, path: str, trace_path: str) -> dict:
    """One of 2 ranks on the card: (a) `python -m repro_torch.core.
    calibrate`'s path for full-width mesh1k at batch BATCH on AUTO_MESH
    into `path`, with the conv launches it makes; (b) 3 training steps
    through the trainer's own entry under `--strategy auto --calibrate
    path`; (c) the forward loss of one global batch under that plan; (d)
    `--profile` on that plan, with its attribution report."""
    mesh = make_mesh(**AUTO_MESH)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cal = calibrate.main(["--arch", "mesh1k", "--batch", str(BATCH),
                          "--data", "1", "--model", str(SPATIAL_MODEL),
                          "--device", "cuda", "--reps", str(CALIB_REPS),
                          "--out", path])
    cal_s = time.perf_counter() - t0
    cal_launches = ops.launch_counts()["conv2d"]
    args = ["--arch", "mesh1k", "--batch", str(BATCH), "--model",
            str(SPATIAL_MODEL), "--device", "cuda", "--strategy", "auto",
            "--calibrate", path]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = train_cli.main(args + ["--steps", str(STEPS), "--log-every", "1"])
    launches = ops.launch_counts()["conv2d"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    plan = res["plan"]
    spec = plan.to_spec(AUTO_MESH)
    loss = _plan_loss(spec, mesh, torch.device("cuda"))
    t0 = time.perf_counter()
    prof = train_cli.main(args + ["--profile", trace_path])
    return {"fingerprint": cal.fingerprint, "cal_s": cal_s,
            "cal_launches": cal_launches,
            "train_fingerprint": plan.predicted["calibration"]["fingerprint"],
            "losses": res["losses"], "step_s": res["step_s"],
            "launches": launches, "peak_gib": peak, "plan_spec": spec,
            "describe": plan.describe(),
            "predicted_step_s": plan.predicted["total"], "loss_card": loss,
            "eta": channel_conv.measured_eta(),
            "chunks": list(channel_conv.chunks_decision()),
            "report": prof["report"], "trace_step": prof["trace"].step,
            "trace_meta": {k: v for k, v in prof["trace"].meta.items()
                           if k != "attribution"},
            "profile_s": time.perf_counter() - t0,
            "digest": [float(p.detach().double().sum())
                       for p in tree_leaves(res["params"])]}


def calib_cpu_rank(rank: int, world: int, plan_spec: dict,
                   eta: float | None) -> dict:
    """One of 2 gloo ranks on the CPU (plain versions) with the card
    ranks' measured η installed (so the same chunked-CF default):
    `_plan_loss`."""
    channel_conv.set_measured_eta(eta)
    return auto_cpu_rank(rank, world, plan_spec)


def _kind_changes(specs, before, after) -> list[str]:
    """The layers whose kind (plan_kinds) differs between two plans."""
    return [f"{s.name} {a} -> {b}" for s, a, b in
            zip(specs, plan_kinds(before), plan_kinds(after)) if a != b]


def calibrate_phase(card: str) -> dict:
    """The paper's §V loop on the card: calibrate (2 ranks over gloo,
    every conv table entry timed on the conv kernel), solve on the
    calibration, train 3 steps under it, profile it against its
    prediction; then ResNet-50's solve on a table measured in this one
    process.  Not a scaling result: 2 processes share one card."""
    os.makedirs(CALIB_DIR, exist_ok=True)
    path = os.path.join(CALIB_DIR, "mesh1k_calibration.json")
    trace_path = os.path.join(CALIB_DIR, "mesh1k_step_trace.json")
    for p in (path, trace_path):
        if os.path.exists(p):
            os.remove(p)
    cfg = meshnet.MESH1K
    specs = meshnet.layer_specs(cfg, BATCH)
    ranks = spawn_ranks(calib_rank, SPATIAL_MODEL, path, trace_path)
    cal = calibrate.Calibration.load(path)
    fps = {r[k] for r in ranks for k in ("fingerprint", "train_fingerprint")}
    if fps != {cal.fingerprint}:
        raise AssertionError(f"the ranks hold other calibrations: {fps} vs "
                             f"the file's {cal.fingerprint}")
    conv_keys = sorted(k for k in cal.table.entries if k[0] == "conv")
    want = len(conv_keys) * (1 + CALIB_REPS)
    if ranks[0]["cal_launches"] < want:
        raise AssertionError(f"calibration launched the conv kernel "
                             f"{ranks[0]['cal_launches']} times, want >= "
                             f"{len(conv_keys)} conv keys x "
                             f"{1 + CALIB_REPS}")
    cov = calibrate.coverage(cal, specs, AUTO_MESH)
    if cov != 1.0:
        raise AssertionError(f"calibration coverage {cov} != 1.0")
    m, meta = cal.machine, cal.meta
    print(f"calibration, full-width mesh1k, batch {BATCH}, mesh {AUTO_MESH}, "
          f"2 ranks over gloo on one card ({ranks[0]['cal_s']:.1f} s; "
          f"{meta.get('card', card)}): {cal.summary()}")
    print(f"  fingerprint {cal.fingerprint} on both ranks; coverage {cov}; "
          f"{len(cal.table)} table entries ({len(conv_keys)} conv, "
          f"{sum(k[0] == 'pool' for k in cal.table.entries)} pool, "
          f"{sum(k[0].startswith('shuffle') for k in cal.table.entries)} "
          f"shuffle); conv launches on rank 0 {ranks[0]['cal_launches']} "
          f"(>= {want})")
    print(f"  fitted: achieved peak {m.peak_flops / 1e12:.3f} TFLOP/s, "
          f"efficiency {m.compute_efficiency:.3f}, halfwork "
          f"{m.eff_halfwork:.3e} FLOP, mem_bw {m.mem_bw / 1e9:.1f} GB/s, "
          f"p2p alpha {m.alpha * 1e6:.2f} us beta 1/{1 / m.beta / 1e9:.3f} "
          f"GB/s, coll alpha {m.alpha_coll * 1e6:.2f} us beta "
          f"1/{1 / m.beta_coll / 1e9:.3f} GB/s (gloo through the host on "
          f"one card, not NVLink), eta {m.overlap_eta!r} (samples "
          f"{meta['eta_fit']['samples']}), shuffle x{m.shuffle_factor:.3f} "
          f"(samples {meta['shuffle_fit']['samples']}), composed cf "
          f"x{m.composed_cf_factor:.3f} halo x{m.composed_halo_factor:.3f}; "
          f"H100 preset: peak {H100.peak_flops / 1e12:.1f} TFLOP/s x eff "
          f"{H100.compute_efficiency}, mem_bw {H100.mem_bw / 1e9:.0f} GB/s, "
          f"alpha {H100.alpha * 1e6:.1f} us beta 1/"
          f"{1 / H100.beta / 1e9:.0f} GB/s, coll alpha "
          f"{H100.alpha_coll * 1e6:.1f} us")
    print("  p2p samples (axis, bytes, s): " + str(meta["p2p_samples"]))
    print("  collective samples (op, axis, p, bytes, s): "
          + str(meta["collective_samples"]))
    print(f"  table (kind, n, c, h, w, f, k, s): measured on the conv kernel "
          f"/ the H100 preset's analytic time, ms ({card}):")
    for key in sorted((k for k in cal.table.entries
                       if k[0] in ("conv", "pool")),
                      key=lambda k: calibrate._conv_flops_bytes(k)[0]):
        kind, n, c, h, w, f, k, st = key
        layer = perfmodel.ConvLayer("key", n=n, c=c, h=h, w=w, f=f, k=k,
                                    s=st, kind=kind)
        pre = perfmodel.conv_compute_time(H100, layer, n, c, h, w, f)
        t = cal.table.entries[key]
        print(f"    {str(key):42s} {t * 1e3:9.4f} / {pre * 1e3:9.4f}  "
              f"(x{t / pre:.2f})")

    preset = auto_plan()
    solved = plan_lib.plan_line(cal.machine, specs, AUTO_MESH,
                                table=cal.table)
    if ranks[0]["plan_spec"]["layers"] != solved.to_spec()["layers"]:
        raise AssertionError("the trainer ran another plan than the "
                             "calibration solves:\n" + ranks[0]["describe"])
    changed = _kind_changes(specs, preset, solved)
    print(f"calibrated plan, full-width mesh1k, batch {BATCH}, layer kinds "
          f"{' '.join(plan_kinds(solved))} (H100 preset: "
          f"{' '.join(plan_kinds(preset))}); changed: "
          f"{', '.join(changed) or 'none'}; chunked CF "
          f"{ranks[0]['chunks']}:")
    print(ranks[0]["describe"])
    print("H100 preset plan:")
    print(preset.describe())

    for r, out in enumerate(ranks):
        if out["losses"] != ranks[0]["losses"] or \
                out["digest"] != ranks[0]["digest"]:
            raise AssertionError(f"rank {r} diverged: losses "
                                 f"{out['losses']} vs {ranks[0]['losses']}")
        if not all(math.isfinite(x) for x in out["losses"]):
            raise AssertionError(f"non-finite loss: {out['losses']}")
    cpu = spawn_ranks(calib_cpu_rank, SPATIAL_MODEL, ranks[0]["plan_spec"],
                      ranks[0]["eta"])
    lg, lc = ranks[0]["loss_card"], cpu[0]["loss"]
    rel = abs(lg - lc) / abs(lc)
    steady = ranks[0]["step_s"][1:]
    print(f"calibrated train (2 processes sharing one card over gloo: not a "
          f"scaling result): losses {ranks[0]['losses']} on both ranks; "
          f"steps 2..{STEPS}: {sum(steady) / len(steady):.4f} s/step "
          f"(predicted {ranks[0]['predicted_step_s'] * 1e3:.3f} ms); peak "
          f"{ranks[0]['peak_gib']:.2f} GiB; conv launches "
          f"{ranks[0]['launches']}; forward loss card {lg!r}, 2 gloo CPU "
          f"ranks {lc!r}, rel diff {rel:.3e} (tol {LOSS_RTOL}) ({card})")
    if not (math.isfinite(lg) and rel <= LOSS_RTOL
            and ranks[1]["loss_card"] == lg and cpu[1]["loss"] == lc):
        raise AssertionError(f"calibrated plan loss {lg} vs CPU {lc}")

    report = ranks[0]["report"]
    if list(report["per_layer"]) != [s.name for s in specs]:
        raise AssertionError(f"the attribution covers "
                             f"{list(report['per_layer'])}, not the "
                             f"{len(specs)} layers")
    ts = ranks[0]["trace_step"]
    print(f"attribution of the calibrated plan, {len(report['per_layer'])} "
          f"layers, each timed alone on rank 0 of 2 (the max over the "
          f"ranks; profile {ranks[0]['profile_s']:.1f} s; step fwd "
          f"{ts['fwd_s'] * 1e3:.3f} ms, fwd+bwd {ts['fwd_bwd_s'] * 1e3:.3f} "
          f"ms; peak {ranks[0]['trace_meta']['measured_peak_bytes']} B; "
          f"{card}):")
    print(trace_lib.format_attribution(report))
    print(f"  flagged (x{report['tolerance']} either way): "
          f"{report['flagged']}; worst term {report['worst_term']}; terms "
          + "; ".join(f"{k} predicted {v['predicted_s'] * 1e3:.3f} ms "
                      f"drift x{v['drift']:.2f}"
                      for k, v in report["terms"].items()))

    t0 = time.perf_counter()
    rspecs = resnet.layer_specs(RESNET_BATCH)
    rcal = calibrate.calibrate(rspecs, RESNET_MESH, device="cuda")
    rcov = calibrate.coverage(rcal, rspecs, RESNET_MESH)
    if rcov != 1.0 or len(rcal.table) != min(
            64, rcal.meta["shapes"]["requested"]):
        raise AssertionError(f"resnet50 calibration: coverage {rcov}, "
                             f"{len(rcal.table)} entries of "
                             f"{rcal.meta['shapes']}")
    rgraph = resnet.resnet_graph(RESNET_BATCH)
    rsolved = plan_lib.plan_graph(rcal.machine, rgraph, rspecs, RESNET_MESH,
                                  table=rcal.table)
    rpreset = resnet_auto_plan()
    every = plan_lib.compile_order(rgraph, rspecs)
    rchanged = _kind_changes(every, rpreset, rsolved)
    resnet_s = time.perf_counter() - t0
    print(f"resnet50 calibration, batch {RESNET_BATCH}, shapes of mesh "
          f"{RESNET_MESH}, one process, no live communication "
          f"({resnet_s:.1f} s with the solve; "
          f"{rcal.meta.get('card', card)}): "
          f"{rcal.summary()}; {rcal.meta['shapes']}, coverage {rcov}")
    print(f"calibrated resnet50 plan, layer kinds "
          f"{' '.join(plan_kinds(rsolved))}; changed from the H100 preset's: "
          f"{', '.join(rchanged) or 'none'}:")
    print(rsolved.describe())
    print("H100 preset resnet50 plan:")
    print(rpreset.describe())
    return {"calibration": cal.to_json(), "ranks": ranks, "cpu": cpu,
            "coverage": cov, "loss_rel_diff": rel, "changed": changed,
            "kinds": plan_kinds(solved), "preset_kinds": plan_kinds(preset),
            "resnet50": {"calibration": rcal.to_json(),
                         "kinds": plan_kinds(rsolved),
                         "preset_kinds": plan_kinds(rpreset),
                         "changed": rchanged,
                         "predicted_s": rsolved.predicted["total"],
                         "preset_predicted_s": rpreset.predicted["total"],
                         "seconds": resnet_s}}


# ------------------------------------------------ resilient training --

RESILIENT_DIR = os.path.join(HERE, "build", "resilient")
# a resumed or rolled-back step against the uninterrupted run's: the same
# ops on the same values.  cuDNN's default backward algorithms are not
# deterministic, and ResNet-50 at init amplifies their rounding by about
# 10x a step (5.7e-4 at step 3 in one run, PERF.md §6), so these
# runs pick cuDNN's deterministic algorithms: the compare is of the
# checkpoint, not of cuDNN's order of summation
RESUME_RTOL = 1e-5
RESUME_STEPS = 4
# the elastic run: mesh1k on 4 gloo ranks, the chaos kill at step 5 drops
# 2 (elastic_factorization(2, batch=4): data 1 x model 2), the rollback
# lands on step 4
ELASTIC_ARGS = ["--arch", "mesh1k", "--batch", "4", "--strategy", "auto",
                "--ckpt-every", "2", "--device", "cuda", "--log-every", "1"]
ELASTIC_STEPS, ELASTIC_KILL = 6, 5


def _fresh_dir(*parts) -> str:
    path = os.path.join(RESILIENT_DIR, *parts)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def _loss_at(res: dict) -> dict:
    """{step: loss} of a trainer run (a rolled-back step's last run)."""
    return dict(zip(res["steps"], res["losses"]))


def _events(path: str) -> list[dict]:
    """The records of a metrics JSONL other than the steps."""
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if r["kind"] != "step"]


def _check_steps(what: str, got: dict, want: dict, steps) -> float:
    """The largest relative difference of `got`'s losses from `want`'s at
    `steps`; raises above RESUME_RTOL."""
    rel = max(abs(got[s] - want[s]) / abs(want[s]) for s in steps)
    if not rel <= RESUME_RTOL:
        raise AssertionError(f"{what}: losses {[got[s] for s in steps]} vs "
                             f"{[want[s] for s in steps]} (rel {rel:.2e} > "
                             f"{RESUME_RTOL})")
    return rel


def ckpt_resume_phase(card: str) -> dict:
    """Full-width ResNet-50 at batch 32 in this process, every forward conv
    on the kernel, on cuDNN's deterministic algorithms (RESUME_RTOL): run
    A trains RESUME_STEPS steps; run B 2 steps with a checkpoint at 2; run
    C resumes B's and trains to RESUME_STEPS (its losses within
    RESUME_RTOL of A's); run D trains with `--chaos raise@3` and rolls
    back to step 2 (its step 3 within RESUME_RTOL of A's).  The bytes a
    checkpoint holds, the host ms of `save()` (the copy the caller waits
    for) and the ms of the thread's write; and, before them, A on the
    default algorithms, to show how far those move the losses."""
    base = ["--arch", "resnet50", "--batch", str(RESNET_BATCH), "--device",
            "cuda", "--log-every", "1", "--ckpt-every", "2"]
    default = train_cli.main(base + ["--steps", str(RESUME_STEPS)])
    prev, torch.backends.cudnn.deterministic = \
        torch.backends.cudnn.deterministic, True
    try:
        out = _resume_runs(card, base)
    finally:
        torch.backends.cudnn.deterministic = prev
    spread = max(abs(x - y) / abs(y) for x, y in
                 zip(default["losses"], out["losses"]))
    print(f"ckpt resume: the uninterrupted run on cuDNN's default "
          f"algorithms {default['losses']}, rel {spread:.2e} from the "
          f"deterministic one ({card})")
    out["default_algorithms"] = {"losses": default["losses"],
                                 "rel": spread}
    return out


def _resume_runs(card: str, base: list) -> dict:
    """ckpt_resume_phase's runs A-D."""
    a = train_cli.main(base + ["--steps", str(RESUME_STEPS)])
    want = _loss_at(a)
    b_dir = _fresh_dir("resume")
    b = train_cli.main(base + ["--steps", "2", "--ckpt-dir", b_dir])
    ops.reset_launch_counts()
    c = train_cli.main(base + ["--steps", str(RESUME_STEPS), "--ckpt-dir",
                               b_dir])
    resume_launches = ops.launch_counts()["conv2d"]
    n_convs = resnet_n_convs(RESNET)
    if c["steps"] != list(range(2, RESUME_STEPS)):
        raise AssertionError(f"resumed run took steps {c['steps']}")
    if resume_launches != n_convs * (RESUME_STEPS - 2):
        raise AssertionError(f"resumed run launched the conv kernel "
                             f"{resume_launches} times, want {n_convs} x "
                             f"{RESUME_STEPS - 2}")
    rel_c = _check_steps("resume", _loss_at(c), want,
                         range(2, RESUME_STEPS))
    d_metrics = os.path.join(RESILIENT_DIR, "raise.jsonl")
    d = train_cli.main(base + ["--steps", str(RESUME_STEPS), "--ckpt-dir",
                               _fresh_dir("raise"), "--chaos", "raise@3",
                               "--metrics", d_metrics])
    rollbacks = [e["step"] for e in _events(d_metrics)
                 if e["kind"] == "rollback"]
    if rollbacks != [2] or d["steps"] != [0, 1, 2, 2, 3]:
        raise AssertionError(f"raise@3: rollbacks {rollbacks}, steps "
                             f"{d['steps']}")
    rel_d = _check_steps("raise@3 rollback", _loss_at(d), want, [3])
    ck = b["checkpoint"]
    print(f"ckpt resume, full-width ResNet-50 at batch {RESNET_BATCH}: "
          f"losses {a['losses']}; resumed at 2: {c['losses']} (rel "
          f"{rel_c:.2e}); raise@3 rolled back to 2, steps {d['steps']}, "
          f"step 3 rel {rel_d:.2e}; conv launches of the resumed run "
          f"{resume_launches} ({n_convs} a forward); checkpoint "
          f"{ck['bytes']} bytes, save() host copy {ck['copy_s'] * 1e3:.2f} "
          f"ms, thread write {ck['write_s'] * 1e3:.2f} ms ({card})")
    return {"losses": a["losses"], "resumed": c["losses"],
            "raise_steps": d["steps"], "raise_losses": d["losses"],
            "rel_resume": rel_c, "rel_rollback": rel_d,
            "resume_launches": resume_launches, "checkpoint": ck,
            "resumed_step_s": c["step_s"], "checkpoint_run": {
                k: d["checkpoint"][k] for k in ("copy_s", "write_s",
                                                "bytes")}}


def ckpt_overhead_phase(card: str, cfg=meshnet.MESH1K,
                        device: str = "cuda") -> dict:
    """The reference's `benchmarks/strategy_exec.py` checkpoint-overhead
    bench on the card: full-width mesh1k at batch BATCH in this process,
    the bare train step (lr 0, a batch on the card) and the step plus one
    async `save` of `(params, OptState, None)` in interleaved rounds.
    Both arms' median round (seconds a call), their ratio, the saves'
    host copy and the last write.  A measurement: it gates nothing."""
    dev = torch.device(device)
    model = meshnet.MeshNet(cfg, generator=torch.Generator().manual_seed(0),
                            device=dev)
    params = model.params()
    opt = sgd(0.0, momentum=0.9)
    step = make_train_step(functools.partial(meshnet.loss_fn, cfg=cfg), opt,
                           TrainStepConfig(precision=FP32))
    state = opt.init(params)
    batch = pipeline.to_device(pipeline.synthetic_mesh_batch(
        0, BATCH, cfg.input_hw, cfg.in_channels, out_hw=cfg.out_hw), dev)
    ck = CheckpointManager(_fresh_dir("overhead"), keep=2, async_save=True)
    counter, copies = itertools.count(), []

    def with_save():
        out = step(params, state, None, batch)
        ck.save(next(counter), state_tree(params, state), extra={"step": 0})
        copies.append(ck.last_save["copy_s"])
        return out
    bare = functools.partial(step, params, state, None, batch)
    bare()
    with_save()
    ck.wait()
    copies.clear()
    samples = interleaved_samples({"no_ckpt": bare, "async_ckpt": with_save},
                                  reps=3, rounds=5)
    t0 = time.perf_counter()
    ck.wait()
    drain_s = time.perf_counter() - t0
    med = {k: float(np.median(v)) for k, v in samples.items()}
    ratio = med["async_ckpt"] / med["no_ckpt"]
    copy_ms = float(np.median(copies)) * 1e3
    print(f"ckpt overhead, full-width mesh1k at batch {BATCH}: step "
          f"{med['no_ckpt'] * 1e3:.2f} ms bare, {med['async_ckpt'] * 1e3:.2f}"
          f" ms with one async save a step (median of {len(samples['no_ckpt'])}"
          f" rounds of 3), ratio {ratio:.3f}; save() host copy median "
          f"{copy_ms:.2f} ms of {ck.last_save['bytes']} bytes; last write "
          f"{ck.last_write_s * 1e3:.2f} ms; queue drained {drain_s:.2f} s "
          f"after the last round ({card})")
    return {"samples_s": samples, "median_s": med, "ratio": ratio,
            "copy_ms": [c * 1e3 for c in copies], "bytes":
            ck.last_save["bytes"], "write_s": ck.last_write_s,
            "drain_s": drain_s}


def elastic_rank(rank: int, world: int, args: list) -> dict:
    """One of the spawned ranks of an elastic run (or of its resume), on
    cuDNN's deterministic algorithms: the trainer's own entry with `args`,
    the conv launches it made before and after its remesh (build is
    called once at the start and once by the remesh) and the describe()
    of each plan it built."""
    torch.backends.cudnn.deterministic = True      # see RESUME_RTOL
    marks, plans, build = [], [], train_cli.build

    def marked(args, *a, **k):
        marks.append(ops.launch_counts()["conv2d"])
        out = build(args, *a, **k)
        plans.append((out[-1], {"data": args.data, "model": args.model}))
        return out
    train_cli.build = marked
    ops.reset_launch_counts()
    try:
        res = train_cli.main(args)
    finally:
        train_cli.build = build
    total = ops.launch_counts()["conv2d"]
    before = marks[1] if len(marks) > 1 else total
    specs = meshnet.layer_specs(meshnet.MESH1K, int(args[args.index(
        "--batch") + 1]))
    return {"steps": res["steps"], "losses": res["losses"],
            "step_s": res["step_s"], "left_at": res["left_at"],
            "plans": [p.describe() for p, _ in plans],
            "calls_per_step": [plan_conv_calls(p, specs, shape)
                               for p, shape in plans],
            "launches_before": before, "launches_after": total - before}


def _split_s(r: dict) -> tuple[float | None, float | None]:
    """Mean seconds a step before the remesh (its first step left out)
    and after it (the step that repeats the rolled-back one left out)."""
    steps, ts = r["steps"], r["step_s"]
    cut = next((i for i in range(1, len(steps)) if steps[i] <= steps[i - 1]),
               len(steps))
    pre, post = ts[1:cut], ts[cut + 1:]
    return (sum(pre) / len(pre) if pre else None,
            sum(post) / len(post) if post else None)


def elastic_phase(card: str) -> dict:
    """Full-width mesh1k on 4 ranks spawned on the card over gloo (NCCL
    refuses two ranks on one card: not a scaling result), `--data 2
    --model 2 --strategy auto --steps 6 --ckpt-every 2 --elastic --chaos
    kill@5x2`: the kill drops ranks 2-3, the survivors remesh onto data 1
    x model 2, re-solve, roll back to step 4 and finish.  Held: the
    metrics' fault, remesh (2 ranks) and rollback (step 4) records, ranks
    2-3 leaving at 5, equal losses on the survivors, and their steps 4-5
    within RESUME_RTOL of a 2-rank `--data 1 --model 2` run resumed from
    a copy of the same step-4 checkpoint."""
    ckdir = _fresh_dir("elastic")
    metrics = os.path.join(RESILIENT_DIR, "elastic.jsonl")
    ranks = spawn_ranks(elastic_rank, 4, ELASTIC_ARGS + [
        "--data", "2", "--model", "2", "--steps", str(ELASTIC_STEPS),
        "--ckpt-dir", ckdir, "--elastic", "--chaos",
        f"kill@{ELASTIC_KILL}x2", "--metrics", metrics])
    events = _events(metrics)
    remesh = [e for e in events if e["kind"] == "remesh"]
    rollbacks = [e["step"] for e in events if e["kind"] == "rollback"]
    if not any(e["kind"] == "fault" for e in events) or \
            [e["n_devices"] for e in remesh] != [2] or \
            rollbacks != [ELASTIC_KILL - 1]:
        raise AssertionError(f"elastic events: {events}")
    left = [r["left_at"] for r in ranks]
    if left != [None, None, ELASTIC_KILL, ELASTIC_KILL]:
        raise AssertionError(f"left_at per rank: {left}")
    if ranks[0]["losses"] != ranks[1]["losses"]:
        raise AssertionError(f"survivors' losses differ: "
                             f"{[r['losses'] for r in ranks[:2]]}")
    for r in ranks:      # every forward conv on the kernel, on both meshes
        calls = r["calls_per_step"] + [0]
        want = [calls[0] * ELASTIC_KILL,
                calls[1] * (ELASTIC_STEPS - ELASTIC_KILL + 1)]
        if [r["launches_before"], r["launches_after"]] != want:
            raise AssertionError(f"conv launches before / after the remesh "
                                 f"{r['launches_before']} / "
                                 f"{r['launches_after']}, the plans derive "
                                 f"{want}")
    resume_dir = _fresh_dir("elastic_resume")
    shutil.copytree(os.path.join(ckdir, f"step-{ELASTIC_KILL - 1}"),
                    os.path.join(resume_dir, f"step-{ELASTIC_KILL - 1}"))
    resumed = spawn_ranks(elastic_rank, 2, ELASTIC_ARGS + [
        "--data", "1", "--model", "2", "--steps", str(ELASTIC_STEPS),
        "--ckpt-dir", resume_dir])
    after = range(ELASTIC_KILL - 1, ELASTIC_STEPS)
    rel = _check_steps("elastic vs its 2-rank resume",
                       _loss_at(ranks[0]), _loss_at(resumed[0]), after)
    split = [_split_s(r) for r in ranks]
    for r, (pre, post) in enumerate(split):
        print(f"rank {r}: elastic steps {ranks[r]['steps']}, losses "
              f"{ranks[r]['losses']}, left at {ranks[r]['left_at']}, conv "
              f"launches {ranks[r]['launches_before']} before the remesh, "
              f"{ranks[r]['launches_after']} after; s/step "
              f"{pre if pre is None else round(pre, 4)} before, "
              f"{post if post is None else round(post, 4)} after")
    for when, plan in zip(("before", "after"), ranks[0]["plans"]):
        print(f"elastic plan {when} the remesh:\n{plan}")
    print(f"elastic mesh1k 4 -> 2 gloo ranks on one card: steps "
          f"{list(after)} within {rel:.2e} of the 2-rank resume from "
          f"step-{ELASTIC_KILL - 1} ({resumed[0]['losses']}) ({card})")
    return {"ranks": ranks, "resumed": resumed, "events": events,
            "rel_resume": rel, "s_per_step": split}


# ------------------------------------------------ static analysis (4g) --

AUDIT_DIR = os.path.join(HERE, "build", "audit")
# the layer whose backward is timed with and without the §IV-A split
HALO_BWD_LAYER = "conv2_2"
HALO_BWD_ROUNDS = 4


def audit_plans() -> tuple[dict, list]:
    """The two plans phase 4g audits on AUTO_MESH, full-width mesh1k at
    batch BATCH: the uniform H plan (every layer split over model, halos
    and the interior/boundary split; the workload registry's `uniform_h`
    recipe) and the H100 auto plan (CF layers and reshards)."""
    specs = meshnet.layer_specs(meshnet.MESH1K, BATCH)
    dist = plan_lib._sharding_to_dist(
        ConvSharding(batch_axes=("data",), h_axis="model"))
    uniform = plan_lib.compile_plan({s.name: dist for s in specs}, specs,
                                    AUTO_MESH, machine=H100)
    return {"uniform_h": uniform, "auto": auto_plan()}, specs


def halo_backward_ms(mesh, spec) -> dict:
    """Host ms of one spatially split layer's backward (dL/dx and dL/dw of
    its convs and the halo gradients' exchange) under the §IV-A split,
    whose backward posts the halo gradients before the interior's dL/dx,
    and serialized, in alternating rounds; the median of each."""
    gen = torch.Generator().manual_seed(mesh.rank)
    hl = spec.h // mesh.axis_size("model")
    x0 = torch.randn((spec.n, hl, spec.w, spec.c), generator=gen).cuda()
    w = (torch.randn((spec.k, spec.k, spec.c, spec.f), generator=gen)
         * 0.05).cuda().requires_grad_()
    sh = ConvSharding(h_axis="model")
    out = {"overlapped": [], "serialized": []}

    def once(overlap: bool) -> float:
        x = x0.detach().requires_grad_()
        y = spatial_conv2d(x, w, strides=(spec.s, spec.s), sharding=sh,
                           mesh=mesh, overlap=overlap)
        gy = torch.ones_like(y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y.backward(gy)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for overlap in (True, False):                  # warm both
        once(overlap)
    for _ in range(HALO_BWD_ROUNDS):
        for overlap in (True, False):
            out["overlapped" if overlap else "serialized"].append(
                once(overlap))
    return {k: sorted(v)[len(v) // 2] for k, v in out.items()}


def audit_rank(rank: int, world: int) -> dict:
    """One of 2 ranks on the card: each of `audit_plans` linted and its
    collectives audited on one real step (forward, backward, the gradient
    bucket; seeded params, the synthetic batch), with the conv launches
    of the audited step; then HALO_BWD_LAYER's backward timed."""
    from repro_torch import analysis
    mesh = make_mesh(**AUTO_MESH)
    plans, specs = audit_plans()
    out = {}
    for key, plan in plans.items():
        ops.reset_launch_counts()
        a = analysis.meshnet_audit(plan, specs, meshnet.MESH1K, mesh,
                                   machine=H100, device="cuda")
        launches = ops.launch_counts()["conv2d"]
        findings = analysis.lint_plan(plan, specs, AUTO_MESH) + a.findings
        moved, once, priced = a.bucket()
        out[key] = {
            "describe": plan.describe(), "n_reshards": plan.n_reshards,
            "kinds": plan_kinds(plan),
            "table": analysis.format_findings(findings),
            "findings": [f.to_json() for f in findings],
            "errors": int(mesh.all_max([analysis.error_count(findings)])[0]),
            "counts": a.counts(), "bucket_bytes": moved,
            "priced_once": once, "priced_total": priced,
            "seconds": a.seconds, "launches": launches,
            "calls": plan_conv_calls(plan, specs)}
    spec = next(s for s in specs if s.name == HALO_BWD_LAYER)
    out["halo_bwd"] = halo_backward_ms(mesh, spec)
    return out


def audit_dryrun_rank(rank: int, world: int, out_path: str,
                      log_path: str) -> dict:
    """One of 4 ranks on the card: `python -m repro_torch.launch.dryrun
    --audit` on this gloo group (data 2 x model 2, the H100 preset), its
    findings tables into `log_path` (rank 0)."""
    import io
    from repro_torch.launch import dryrun
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = dryrun.main(["--audit", "--device", "cuda", "--audit-out",
                          out_path])
    if rank == 0:
        with open(log_path, "w") as f:
            f.write(buf.getvalue())
    return {"rc": rc, "seconds": time.perf_counter() - t0}


def audit_phase(card: str) -> dict:
    """Phase 4g, the static-analysis lane on the card: `audit_rank` on 2
    spawned ranks (gloo), then the `dryrun --audit` lane on 4.  Fails on
    any error finding, on a conv launch count other than the plan's, and
    where the uniform plan's audited step shows no pin in either
    direction or the auto plan has no CF layer or no reshard."""
    t0 = time.perf_counter()
    ranks = spawn_ranks(audit_rank, 2)
    for key in ("uniform_h", "auto"):
        r0 = ranks[0][key]
        print(f"audit {key}, full-width mesh1k, batch {BATCH}, mesh "
              f"{AUTO_MESH}, layer kinds {' '.join(r0['kinds'])}:")
        print(r0["describe"])
        print(r0["table"])
        for rank, r in enumerate(ranks):
            a = r[key]
            print(f"audit {key} rank {rank}: {a['errors']} error(s); ops "
                  f"{a['counts']}; grad bucket {a['bucket_bytes']:.0f} B "
                  f"against the priced weight gradients {a['priced_once']:.0f}"
                  f" B once ({a['priced_total']:.0f} B over the inventory's "
                  f"psums); audit step {a['seconds']:.4f} s host; conv "
                  f"launches {a['launches']} (the plan derives "
                  f"{a['calls']}) ({card})")
            if a["errors"]:
                raise AssertionError(f"audit {key}: {a['errors']} error "
                                     f"finding(s) on rank {rank}")
            if a["launches"] != a["calls"]:
                raise AssertionError(f"audit {key} rank {rank}: "
                                     f"{a['launches']} conv launches, the "
                                     f"plan derives {a['calls']}")
    for rank, r in enumerate(ranks):
        c = r["uniform_h"]["counts"]
        if not (c.get("pin/fwd") and c.get("pin/bwd")):
            raise AssertionError(f"audit uniform_h rank {rank}: no pin in "
                                 f"both directions: {c}")
        if "CF" not in r["auto"]["kinds"] or not r["auto"]["n_reshards"]:
            raise AssertionError("audit auto: the H100 plan has no CF layer "
                                 "or no reshard")
        hb = r["halo_bwd"]
        print(f"halo backward, {HALO_BWD_LAYER} (H over model 2), rank "
              f"{rank}: overlapped {hb['overlapped']:.3f} ms, serialized "
              f"{hb['serialized']:.3f} ms (median of {HALO_BWD_ROUNDS}, "
              f"gloo through the host; {card})")
    t_dry = time.perf_counter()
    os.makedirs(AUDIT_DIR, exist_ok=True)
    out_path = os.path.join(AUDIT_DIR, "PLAN_audit.json")
    log_path = os.path.join(AUDIT_DIR, "dryrun.log")
    dry = spawn_ranks(audit_dryrun_rank, 4, out_path, log_path)
    with open(out_path) as f:
        report = json.load(f)
    for name, w in report["workloads"].items():
        print(f"dryrun --audit {name} on {report['mesh']} (the H100 "
              f"preset, {report['collective_backend']}): "
              + ("skipped" if w["skipped"] else
                 f"{w['n_findings']} finding(s), {w['n_errors']} error(s), "
                 f"{w['n_reshards']} reshard point(s)"))
    if any(r["rc"] for r in dry) or report["n_errors"] or \
            len(report["workloads"]) != 6 or \
            any(w["skipped"] for w in report["workloads"].values()):
        raise AssertionError(f"dryrun --audit failed: rc "
                             f"{[r['rc'] for r in dry]}, {report['n_errors']}"
                             f" error(s); see {log_path}")
    phase_s = time.perf_counter() - t0
    print(f"dryrun --audit, 4 card ranks: {time.perf_counter() - t_dry:.1f}"
          f" s; audit phase took {phase_s:.1f} s of this run ({card})")
    return {"ranks": ranks, "dryrun": {"ranks": dry, "report": report},
            "phase_s": phase_s}


# ------------------------------------------ sharded training state (4h) --

# full-width mesh1k, global batch 4 on pod 2 x data 2 x model 1: each rank
# one sample, every leaf of >= 2^14 elements sharded over data (ZeRO)
ZERO_BATCH = 4
ZERO_ARGS = ["--arch", "mesh1k", "--batch", str(ZERO_BATCH), "--steps",
             str(STEPS), "--device", "cuda", "--log-every", "1"]
ZERO_MESH = {"pod": 2, "data": 2, "model": 1}
ZERO_METHODS = ("none", "bf16", "int8_ef")
# `none` against one device on the same global batch: fp32 sums in
# another order (the one-device run takes the batch in 4 micro-batches,
# so that its BN statistics, at mesh1k's local scope, are the ranks')
ZERO_RTOL = 1e-5
# the compressed runs against `none`, per element of the final params, to
# first order: a step's mean gradient is off by at most u G per element
# (G the largest |x| a pod exchange took; u: bf16 keeps 8 significant
# bits, so its rounding moves x by at most 2^-8 |x|; int8's emitted value
# is off by its half step now and the carried residual's, 2 / 254),
# moved into the params by SGD with momentum 0.9 at the trainer's lr;
# ZERO_RTOL of each element beside for the fp32 sums' order
ZERO_UNIT = {"bf16": 2.0 ** -8, "int8_ef": 2 / 254}
ZERO_LAYERS = 19              # mesh1k's convs: one launch each a forward
# --remat against the plain FP32 run: the same operations on the same
# inputs, recomputed
REMAT_RTOL = 1e-6


def zero_rank(rank: int, world: int) -> dict:
    """One of the 4 spawned ranks of phase 4h, on cuDNN's deterministic
    algorithms (see RESUME_RTOL): the trainer's own entry once per pod
    compression.  Each run's losses, step seconds, the digest of its
    final params, this rank's momentum and state bytes, the bytes it put
    on the pod axis a step, the largest |x| a pod exchange took, its peak
    memory and conv launches; for bf16 and int8_ef the largest gap of a
    final param to `none`'s (raw, and less ZERO_RTOL of `none`'s value),
    and for int8_ef the largest |residual| it carries on."""
    import hashlib
    from repro_torch.launch import shardings
    from repro_torch.optim import grad_compress
    from repro_torch.train import train_loop
    torch.backends.cudnn.deterministic = True
    seen, exchange = [], train_loop.cross_pod_mean

    def spy(grads, **kw):
        ef = kw.get("error_feedback") or [0.0] * len(grads)
        seen.append(max(float((g.float() + e).abs().max())
                        for g, e in zip(grads, ef)))
        return exchange(grads, **kw)
    train_loop.cross_pod_mean = spy
    out, none = {}, None
    mesh_args = [f"--{k}={v}" for k, v in ZERO_MESH.items()]
    try:
        for method in ZERO_METHODS:
            seen.clear()
            grad_compress.reset_sent()
            ops.reset_launch_counts()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            res = train_cli.main(ZERO_ARGS + mesh_args +
                                 ["--pod-compression", method])
            params = [p.detach() for p in tree_leaves(res["params"])]
            digest = hashlib.sha256(b"".join(
                p.cpu().numpy().tobytes() for p in params))
            big, small = shardings.state_bytes(res["params"], res["mesh"])
            mu = sum(m.numel() * m.element_size()
                     for m in res["opt_state"].mu)
            row = {
                "losses": res["losses"], "step_s": res["step_s"],
                "grad_norms": res["grad_norms"],
                "digest": digest.hexdigest(),
                "momentum_bytes": mu, "sharded_bytes": big,
                "replicated_bytes": small, "n_leaves": len(params),
                "pod_bytes_per_step": sum(grad_compress.sent.values())
                / STEPS,
                "max_abs": max(seen) if seen else 0.0,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "launches": ops.launch_counts()["conv2d"],
                "calls_per_step": plan_conv_calls(
                    res["plan"], meshnet.layer_specs(meshnet.MESH1K,
                                                     ZERO_BATCH), ZERO_MESH),
                "n_params": res["n_params"]}
            if none is None:
                none = [p.clone() for p in params]
            else:
                gaps = [(p - q).abs() for p, q in zip(params, none)]
                row["param_gap"] = max(float(g.max()) for g in gaps)
                row["param_gap_over_rtol"] = max(
                    float((g - ZERO_RTOL * q.abs()).max())
                    for g, q in zip(gaps, none))
            if res["ef"] is not None:
                row["ef_max"] = max(float(e.abs().max()) for e in res["ef"])
            out[method] = row
            del res, params
    finally:
        train_loop.cross_pod_mean = exchange
    return out


def _zero_bound(method: str, big: float) -> float:
    """ZERO_UNIT's bound on |param - none's param| per element after
    STEPS steps at the trainer's lr schedule (warmup_cosine(3e-3, 10,
    STEPS), evaluated at step + 1) and momentum 0.9: step t's gradient
    error of at most u G reaches the params through every later step's
    lr times its momentum weight."""
    from repro_torch.optim.optimizer import warmup_cosine
    lr = warmup_cosine(3e-3, 10, STEPS)
    weights = sum(lr(t + 1) * sum(0.9 ** j for j in range(t + 1))
                  for t in range(STEPS))
    return ZERO_UNIT[method] * big * weights


def zero_phase(card: str) -> dict:
    """Phase 4h, the sharded training state: full-width mesh1k on 4 ranks
    spawned on the card over gloo (not a scaling result), pod 2 x data 2 x
    model 1, 3 steps through the trainer's entry once per pod compression,
    and a one-device run of the same global batch; then full-width
    hymba-1.5b with and without --remat.  Held: equal losses and params
    on every rank; `none`'s losses within ZERO_RTOL of one device; bf16's
    and int8_ef's final params, element by element, within the rounding
    bound of `none`'s and not equal to them; the bytes on the pod axis a
    step, bf16's half of `none`'s and int8_ef's a quarter plus its fp32
    scales; int8_ef's carried residual nonzero and at most half a step;
    each rank's momentum exactly its blocks; ZERO_LAYERS conv launches a
    step (the uniform plan's H split is over a model axis of one rank,
    which cuts nothing: one dense conv a layer), as the plan derives;
    --remat's losses within REMAT_RTOL of the plain run's, with twice its
    LM kernel launches."""
    t0 = time.perf_counter()
    ranks = spawn_ranks(zero_rank, 4)
    torch.backends.cudnn.deterministic = True
    try:
        ops.reset_launch_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        one = train_cli.main(ZERO_ARGS + ["--grad-accum", str(ZERO_BATCH)])
        one_peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        torch.backends.cudnn.deterministic = False
    for method in ZERO_METHODS:
        rs = [r[method] for r in ranks]
        if any(r["losses"] != rs[0]["losses"] or
               r["digest"] != rs[0]["digest"] for r in rs):
            raise AssertionError(f"{method}: the ranks disagree: "
                                 f"{[(r['losses'], r['digest']) for r in rs]}")
        if any(r["launches"] != ZERO_LAYERS * STEPS or
               r["calls_per_step"] != ZERO_LAYERS for r in rs):
            raise AssertionError(f"{method}: conv launches "
                                 f"{[r['launches'] for r in rs]} (the plan "
                                 f"derives {rs[0]['calls_per_step']} a "
                                 f"step), want {ZERO_LAYERS} x {STEPS} a "
                                 f"rank")
        if any(r["momentum_bytes"] != r["sharded_bytes"] +
               r["replicated_bytes"] for r in rs):
            raise AssertionError(f"{method}: momentum bytes "
                                 f"{[r['momentum_bytes'] for r in rs]} are "
                                 f"not the rank's blocks")
    out = {"ranks": ranks, "one_device_losses": one["losses"],
           "one_device_peak_gib": one_peak,
           "one_device_step_s": one["step_s"]}
    for x in ranks:
        sent = {m: x[m]["pod_bytes_per_step"] for m in ZERO_METHODS}
        want = {"none": sent["none"], "bf16": sent["none"] / 2,
                "int8_ef": sent["none"] / 4 + 4 * x["none"]["n_leaves"]}
        if sent != want or not sent["none"]:
            raise AssertionError(f"bytes on the pod axis a step {sent}, "
                                 f"want {want}")
    print(f"zero, full-width mesh1k, global batch {ZERO_BATCH} on pod 2 x "
          f"data 2 x model 1 (4 gloo ranks on one card: not a scaling "
          f"result); one device, batch {ZERO_BATCH} in {ZERO_BATCH} "
          f"micro-batches: losses {one['losses']}, step host s "
          f"{one['step_s']}, peak {one_peak:.2f} GiB ({card})")
    for method in ZERO_METHODS:
        rs = [x[method] for x in ranks]
        if method == "none":
            want = one["losses"]
            diff = [abs(a - b) for a, b in zip(rs[0]["losses"], want)]
            tol = [ZERO_RTOL * abs(x) for x in want]
            if any(d > t for d, t in zip(diff, tol)):
                raise AssertionError(f"none: |loss - one device's| {diff} "
                                     f"over the bound {tol}")
            check = (f"|loss - one device's| "
                     f"{['%.3e' % d for d in diff]} within "
                     f"{['%.3e' % t for t in tol]}")
            out[method] = {"loss_diff": diff, "loss_tol": tol}
        else:
            big = max(r["max_abs"] for r in rs)
            bound = _zero_bound(method, big)
            gap = max(r["param_gap_over_rtol"] for r in rs)
            raw = max(r["param_gap"] for r in rs)
            if not big > 0 or not raw > 0 or gap > bound:
                raise AssertionError(
                    f"{method}: final params {raw:.3e} from none's "
                    f"({gap:.3e} beyond {ZERO_RTOL} of each), bound "
                    f"{bound:.3e} (max |x| exchanged {big:.4g}): a "
                    f"compressed exchange must move the params, within "
                    f"its rounding")
            diff = [abs(a - b) for a, b in zip(rs[0]["losses"],
                                               ranks[0]["none"]["losses"])]
            check = (f"final params {raw:.3e} from none's ({gap:.3e} "
                     f"beyond {ZERO_RTOL} of each) within {bound:.3e}; "
                     f"|loss - none's| {['%.3e' % d for d in diff]}")
            out[method] = {"param_gap": raw, "param_gap_over_rtol": gap,
                           "bound": bound, "loss_diff": diff}
            if method == "int8_ef":
                ef = max(r["ef_max"] for r in rs)
                half = big / 254 * (1 + 2.0 ** -20)
                if not 0 < ef <= half:
                    raise AssertionError(f"int8_ef: carried residual max "
                                         f"{ef:.3e}, want in (0, "
                                         f"{half:.3e}]: half a step")
                check += f"; residual carried max {ef:.3e} <= {half:.3e}"
                out[method]["ef_max"] = ef
        for i, x in enumerate(rs):
            steady = x["step_s"][1:]
            print(f"rank {i}: zero {method}: losses {x['losses']}; "
                  f"{check}; step host s {x['step_s']} (steps "
                  f"2..{STEPS}: {sum(steady) / len(steady):.4f}); state a "
                  f"rank: {x['sharded_bytes']} B of blocks + "
                  f"{x['replicated_bytes']} B replicated, momentum "
                  f"{x['momentum_bytes']} B; over pod "
                  f"{x['pod_bytes_per_step']:.0f} B a step; max |x| "
                  f"exchanged {x['max_abs']:.4g}; peak "
                  f"{x['peak_gib']:.2f} GiB; conv launches "
                  f"{x['launches']} ({x['calls_per_step']} a step, as the "
                  f"plan derives)")
    plain = lm_train_phase()
    remat = lm_train_phase(remat=True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(remat["losses"],
                                                  plain["losses"]))
    if rel > REMAT_RTOL:
        raise AssertionError(f"--remat: losses {remat['losses']} against "
                             f"{plain['losses']} (rel {rel:.2e})")
    print(f"remat, full-width hymba-1.5b ({HYMBA.n_layers} layers) FP32 at "
          f"batch {LM_BATCH} x seq "
          f"{LM_SEQ}: losses within {rel:.2e} of the plain run's; peak "
          f"{remat['peak_gib']:.2f} GiB against {plain['peak_gib']:.2f}; "
          f"{remat['steady_step_s']:.4f} s/step against "
          f"{plain['steady_step_s']:.4f}; launches {remat['launches']} "
          f"against {plain['launches']} ({card})")
    out.update(plain=plain, remat=remat, remat_rel=rel,
               phase_s=time.perf_counter() - t0)
    print(f"sharded-training-state phase (4 card ranks x 3 compressions, "
          f"one device, hymba with and without --remat) took "
          f"{out['phase_s']:.1f} s of this run ({card})")
    return out


# ---------------------------------------------------------------- LM path --

def admitted_pairs(s: int, window: int | None, delta: int = 0) -> int:
    """(query, key) pairs that causality and the window admit between s
    queries and s keys, query row i at position i + delta (a ring block's
    offset): the work the masks leave, which is what the bound counts."""
    pos = np.arange(s) + delta
    hi = np.minimum(s - 1, pos)
    lo = np.zeros(s, np.int64) if window is None else \
        np.maximum(0, pos - window + 1)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def attention_cases(cfg) -> list[dict]:
    """The attention calls of one forward: full causal on the global
    layers, causal + window on the sliding-window ones (where there are
    any)."""
    types = cfg.layer_types()
    n_win = sum(t in ("swa", "hybrid_s") for t in types)
    n_glob = sum(t != "ssm" for t in types) - n_win
    return [{"mask": "causal", "window": None, "count": n_glob}] + (
        [{"mask": f"window {cfg.window}", "window": cfg.window,
          "count": n_win}] if n_win else [])


def attention_limit(q, k, v, **opts) -> tuple[torch.Tensor, torch.Tensor]:
    """(o32, limit) for bf16 attention: the plain version in fp32 on the
    same inputs, and ATTN_ELEM_ULP x (softmax(S).|v| + |o32|) per
    element."""
    q, k, v = (t.float() for t in (q, k, v))
    want = flash_attention_ref(q, k, v, **opts)
    spread = flash_attention_ref(q, k, v.abs(), **opts)
    return want, ATTN_ELEM_ULP * (spread + want.abs())


def check_attention(case: dict, dtype: torch.dtype, gen: torch.Generator,
                    cfg=HYMBA, b: int = LM_BATCH, s: int = LM_SEQ) -> dict:
    """The kernel at `cfg`'s heads, batch b x s, against its plain
    version, its CPU emulation and (bf16) the element limit; its autograd
    Function; its times beside the bound and one SDPA call's."""
    dev = torch.device("cuda")
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    window, what = case["window"], f"flash_attention {case['mask']} {dtype}"
    q = torch.randn((b, s, hq, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
    o = kfa.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    err = _check_close(what, o, flash_attention_ref(q, k, v, window=window),
                       LM_FWD_TOL[dtype])
    # the CPU emulation of the kernel's tiling, run here on the same
    # inputs, against the kernel itself
    emu_err = _check_close(f"{what} emulation vs kernel",
                           kfa.flash_attention_emulated(q, k, v,
                                                        window=window),
                           o, LM_FWD_TOL[dtype])
    elem = None
    if dtype == torch.bfloat16:
        want, limit = attention_limit(q, k, v, window=window)
        elem = float(((o.float() - want).abs() / limit).max())
        if not elem <= 1.0:
            raise AssertionError(f"{what}: an element is {elem} x its "
                                 f"limit (one bf16 ulp of A + |o32|)")
        del want, limit

    # the autograd Function (kernel forward, backward recomputed through
    # the plain version) vs autograd through the plain version
    g = torch.randn(o.shape, generator=gen, device=dev).to(dtype)
    grads = []
    for fwd in (lambda *a: kfa.FlashAttention.apply(*a, True, window, None,
                                                    None),
                lambda *a: flash_attention_ref(*a, window=window)):
        ts = [t.detach().requires_grad_() for t in (q, k, v)]
        (fwd(*ts).float() * g.float()).sum().backward()
        grads.append([t.grad for t in ts])
    for nm, got, want in zip(("dq", "dk", "dv"), *grads):
        _check_close(f"{what} {nm}", got, want, LM_BWD_TOL[dtype])
    del grads

    # the yardstick: one SDPA call on (B, H, S, D) views, GQA, the same mask
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window is None:
        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
    else:
        pos = torch.arange(s, device=dev)
        keep = (pos[:, None] >= pos[None, :]) & \
            (pos[:, None] - pos[None, :] < window)

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep,
                                                  enable_gqa=True)
    lib_err = float((library().transpose(1, 2).float() - o.float())
                    .abs().max())
    p = kfa.plan(tuple(q.shape), tuple(k.shape), dtype, True, window)
    row = {"kernel": "flash_attention", "mask": case["mask"],
           "model": cfg.name,
           "dtype": str(dtype).split(".")[-1], "count": case["count"],
           "q": [b, s, hq, d], "kv": [b, s, hkv, d], "max_abs_err": err,
           "max_err_over_elem_limit": elem,
           "emulation_vs_kernel_err": emu_err,
           "library_vs_kernel_err": lib_err, "plan": dataclasses.asdict(p),
           "plan_str": f"{p.path} {p.tile_q}x{p.tile_k}"}
    row.update(_timings(
        lambda: kfa.flash_attention(q, k, v, window=window),
        lambda: flash_attention_ref(q, k, v, window=window), library,
        4.0 * d * admitted_pairs(s, window) * b * hq,
        (2 * q.numel() + k.numel() + v.numel()) * q.element_size(), dtype))
    return row


# the SSD shapes: hymba's and mamba2-780m's (d 1536 x expand 2 / head dim
# 64 = 48 heads, state 128, chunk 128; phase 9 trains it at this batch and
# sequence), each one call a layer
SSD_SHAPES = [
    {"model": "hymba-1.5b", "h": HYMBA.ssm_heads, "p": HYMBA.ssm_head_dim,
     "n": HYMBA.ssm_state, "chunk": HYMBA.ssm_chunk,
     "count": HYMBA.n_layers},
    {"model": "mamba2-780m", "h": mamba2_780m.CONFIG.ssm_heads,
     "p": mamba2_780m.CONFIG.ssm_head_dim, "n": mamba2_780m.CONFIG.ssm_state,
     "chunk": mamba2_780m.CONFIG.ssm_chunk,
     "count": mamba2_780m.CONFIG.n_layers},
]


def ssd_inputs(shape: dict, dtype: torch.dtype, gen: torch.Generator,
               b: int = LM_BATCH, l: int = LM_SEQ):
    """xdt, la, B, C at batch b x l: the model's inputs at init, la =
    softplus(dt) * -A with A_log = log(linspace(1, 16)); la stays fp32
    under bf16, as in the model."""
    dev = torch.device("cuda")
    h, p, n = shape["h"], shape["p"], shape["n"]
    xdt = (torch.randn((b, l, h, p), generator=gen, device=dev) * 0.5) \
        .to(dtype)
    dt = F.softplus(torch.randn((b, l, h), generator=gen, device=dev))
    la = (-dt * torch.linspace(1.0, 16.0, h, device=dev)).contiguous()
    B = (torch.randn((b, l, n), generator=gen, device=dev) * 0.5).to(dtype)
    C = (torch.randn((b, l, n), generator=gen, device=dev) * 0.5).to(dtype)
    return xdt, la, B, C


def ssd_work(xdt, la, B, S, chunk: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one call: G = C.B^T once per chunk, then per head
    y over the causal pairs and S; each input read once (C as B), each
    output written once."""
    b, l, h, p = xdt.shape
    n, nc = B.shape[-1], l // chunk
    flops = b * nc * (2.0 * chunk * chunk * n
                      + h * (p * chunk * (chunk + 1) + 2.0 * chunk * p * n))
    nbytes = (2 * xdt.numel() + 2 * B.numel()) * xdt.element_size() \
        + (la.numel() + S.numel()) * 4
    return flops, nbytes


def ssd_plan_str(pl, ctas: int | None = None) -> str:
    """path, the chunk the CTA is built for, its heads and (if given) the
    CTAs an SM holds: "mma 64 h2 3/SM"."""
    return f"{pl.path} {pl.chunk_tile} h{pl.heads}" + (
        "" if ctas is None else f" {ctas}/SM")


def check_ssd(shape: dict, dtype: torch.dtype, gen: torch.Generator,
              b: int = LM_BATCH, l: int = LM_SEQ) -> dict:
    """The kernel at `shape`'s heads, batch b x l, against its plain
    version and (bf16) the element limit; its autograd Function; its
    times beside the bound."""
    dev = torch.device("cuda")
    chunk = shape["chunk"]
    what = f"ssd_chunk {shape['model']} {dtype}"
    xdt, la, B, C = ssd_inputs(shape, dtype, gen, b, l)
    pl = kssd.plan(chunk, shape["n"], dtype)
    if pl.path != ("mma" if dtype == torch.bfloat16 else "fma"):
        raise AssertionError(f"{what} planned {pl}")
    y, S = kssd.ssd_chunk(xdt, la, B, C, chunk=chunk)
    torch.cuda.synchronize()
    yr, Sr = ssd_chunked_ref(xdt, la, B, C, chunk)
    err = max(_check_close(f"{what} y", y, yr, LM_FWD_TOL[dtype]),
              _check_close(f"{what} S", S, Sr, LM_FWD_TOL[torch.float32]))
    del yr, Sr
    elem = None
    if dtype == torch.bfloat16:
        want, limit = kssd.elem_limit(xdt, la, B, C, chunk)
        elem = float(((y.float() - want).abs() / limit).max())
        if not elem <= 1.0:
            raise AssertionError(f"{what}: an element is {elem} x its "
                                 f"limit (2^-7 |y32| + 2^-12 |M|.|xdt|)")
        del want, limit

    gy = torch.randn(y.shape, generator=gen, device=dev).to(dtype)
    gS = torch.randn(S.shape, generator=gen, device=dev)
    grads = []
    for fwd in (lambda *a: kssd.SsdChunk.apply(*a, chunk),
                lambda *a: ssd_chunked_ref(*a, chunk)):
        ts = [t.detach().requires_grad_() for t in (xdt, la, B, C)]
        yy, SS = fwd(*ts)
        ((yy.float() * gy.float()).sum() + (SS * gS).sum()).backward()
        grads.append([t.grad for t in ts])
    for nm, got, want in zip(("dxdt", "dla", "dB", "dC"), *grads):
        _check_close(f"{what} {nm}", got, want, LM_BWD_TOL[dtype])
    del grads

    flops, nbytes = ssd_work(xdt, la, B, S, chunk)
    row = {"kernel": "ssd_chunk", "model": shape["model"],
           "dtype": str(dtype).split(".")[-1], "count": shape["count"],
           "xdt": list(xdt.shape), "n": shape["n"], "chunk": chunk,
           "max_abs_err": err, "max_err_over_elem_limit": elem,
           "plan": dataclasses.asdict(pl),
           "ctas_per_sm": kssd.occupancy(chunk, shape["n"], dtype)}
    row["plan_str"] = ssd_plan_str(pl, row["ctas_per_sm"])
    row.update(_timings(
        lambda: kssd.ssd_chunk(xdt, la, B, C, chunk=chunk),
        lambda: ssd_chunked_ref(xdt, la, B, C, chunk), None, flops, nbytes,
        dtype))
    return row


def lm_kernel_phase(card: str) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    print(f"{'kernel':16s} {'case':12s} {'dtype':8s} {'n':>2s} "
          f"{'plan':15s} {'kernel_ms':>10s} {'plain_ms':>9s} "
          f"{'library_ms':>10s} "
          f"{'bound_ms':>9s} {'TFLOP/s':>8s} {'max_err':>9s}   ({card})")
    for dtype in (torch.float32, torch.bfloat16):
        cases = [(check_attention, c) for c in attention_cases(HYMBA)] + \
            [(check_ssd, s) for s in SSD_SHAPES]
        for check, case in cases:
            r = check(case, dtype, gen)
            rows.append(r)
            if r["kernel"] == "flash_attention" and dtype == torch.bfloat16 \
                    and r["plan"]["path"] != "wgmma":
                raise AssertionError(f"bf16 attention at D = {r['q'][3]} "
                                     f"planned {r['plan']}, not wgmma")
            lib = "none" if r["library_ms"] is None else \
                f"{r['library_ms']:.4f}"
            print(f"{r['kernel']:16s} {r.get('mask', r.get('model')):12s} "
                  f"{r['dtype']:8s} {r['count']:2d} "
                  f"{r.get('plan_str', '-'):15s} {r['ms']:10.4f} "
                  f"{r['plain_ms']:9.4f} {lib:>10s} {r['bound_ms']:9.4f} "
                  f"{r['tflops_s']:8.2f} {r['max_abs_err']:9.2e}"
                  + ("" if r.get("max_err_over_elem_limit") is None else
                     f"  err/elem limit "
                     f"{r['max_err_over_elem_limit']:.3f}")
                  + ("" if r.get("emulation_vs_kernel_err") is None else
                     f"  emulation vs kernel "
                     f"{r['emulation_vs_kernel_err']:.2e}"),
                  flush=True)
            torch.cuda.empty_cache()
    return rows


def lm_train_phase(bf16: bool = False, remat: bool = False) -> dict:
    """3 full-width hymba-1.5b steps through the trainer's own entry, FP32
    or (`--bf16`) bf16 compute with fp32 master weights; with `--remat`
    each layer's forward runs again in the backward."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = train_cli.main(["--arch", "hymba-1.5b", "--batch", str(LM_BATCH),
                          "--seq", str(LM_SEQ), "--steps", str(STEPS),
                          "--device", "cuda", "--log-every", "1"]
                         + (["--bf16"] if bf16 else [])
                         + (["--remat"] if remat else []), cfg=HYMBA)
    counts = ops.launch_counts()
    per_step = HYMBA.n_layers * (2 if remat else 1)
    want = {"conv2d": 0, "flash_attention": per_step * STEPS,
            "ssd_chunk": per_step * STEPS}
    if not all(math.isfinite(l) for l in res["losses"]):
        raise AssertionError(f"non-finite loss: {res['losses']}")
    if counts != want:
        raise AssertionError(f"launches {counts} in {STEPS} steps, want "
                             f"{want} (one forward launch per layer, two "
                             f"under --remat; the backward recomputes "
                             f"through the plain versions)")
    steady = res["step_s"][1:]
    step_s = sum(steady) / len(steady)
    tokens = LM_BATCH * LM_SEQ
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"train: {STEPS} steps of full-width hymba-1.5b "
          f"({HYMBA.n_layers} layers) "
          f"({res['n_params'] / 1e9:.3f} B params, "
          f"{'BF16' if bf16 else 'FP32'}{', --remat' if remat else ''}) "
          f"at batch {LM_BATCH} x "
          f"seq {LM_SEQ}; losses {res['losses']}; step seconds "
          f"{res['step_s']}; steps 2..{STEPS}: {step_s:.4f} s/step, "
          f"{tokens / step_s:.1f} tokens/s; peak memory {peak:.2f} GiB; "
          f"launches {counts}")
    return {"launches": counts, "losses": res["losses"],
            "step_s": res["step_s"], "data_s": res["data_s"],
            "steady_step_s": step_s, "tokens_per_s": tokens / step_s,
            "peak_gib": peak, "n_params": res["n_params"],
            "precision": "bf16" if bf16 else "fp32", "remat": remat}


def lm_forward_check() -> dict:
    """Forward loss of a 4-layer full-width hymba at seq 1280, the same
    params and batch through the card's kernels and the CPU's plain
    versions."""
    cfg = dataclasses.replace(HYMBA, n_layers=CHECK_LAYERS)
    types = cfg.layer_types()
    if types != ["hybrid_g", "hybrid_s", "hybrid_g", "hybrid_g"]:
        raise AssertionError(f"check layers {types}")
    params = transformer.init(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    nb = pipeline.synthetic_lm_batch(0, 1, CHECK_SEQ, cfg.vocab)
    out = {}
    with torch.no_grad():
        for dev in ("cuda", "cpu"):
            d = torch.device(dev)
            p = tree_map(lambda t: t.detach().to(d), params)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            out[dev] = float(transformer.loss_fn(
                p, pipeline.to_device(nb, d), cfg))
            out[dev + "_s"] = time.perf_counter() - t0
            out[dev + "_launches"] = ops.launch_counts()
            del p
    lg, lc = out["cuda"], out["cpu"]
    rel = abs(lg - lc) / abs(lc)
    print(f"forward check, hymba-1.5b {CHECK_LAYERS} layers {types} at seq "
          f"{CHECK_SEQ}: loss card {lg!r} cpu {lc!r} rel diff {rel:.3e} "
          f"(tol {LM_LOSS_RTOL}); card launches {out['cuda_launches']}")
    if not (math.isfinite(lg) and rel <= LM_LOSS_RTOL):
        raise AssertionError(f"card loss {lg} vs cpu loss {lc}: rel {rel}")
    want = {"conv2d": 0, "flash_attention": CHECK_LAYERS,
            "ssd_chunk": CHECK_LAYERS}
    if out["cuda_launches"] != want:
        raise AssertionError(f"card forward launches {out['cuda_launches']}")
    return {"loss_cuda": lg, "loss_cpu": lc, "rel_diff": rel,
            "types": types, "seq": CHECK_SEQ}


def lm_kind(name: str) -> str:
    """The kind of an LM step's device kernel, by its lower-case name."""
    if "flash_fwd" in name:
        return "flash_attention kernel"
    if "ssd_chunk_kernel" in name:
        return "ssd_chunk kernel"
    if any(t in name for t in ("gemm", "cutlass", "xmma", "sm90",
                               "cublas")):
        return "cuBLAS matmuls"
    if "softmax" in name:
        return "softmax (plain attention recompute)"
    if "memcpy" in name:
        return "memcpy (device <-> host)"
    if "reduce" in name:
        return "reductions"
    if any(t in name for t in ("elementwise", "vectorized", "unrolled")):
        return "elementwise"
    return "other"


def lm_profile_phase() -> dict:
    """Device time of one full-width hymba-1.5b step (batch 1 x seq 2048,
    batch on the card) by kind of kernel, and the SSD's inter-chunk
    recurrence timed alone at hymba's shape."""
    dev = torch.device("cuda")
    args = train_cli.parse_args(["--arch", "hymba-1.5b", "--batch",
                                 str(LM_BATCH), "--seq", str(LM_SEQ),
                                 "--steps", str(STEPS)])
    cfg, params, _, loss, mk, prec, _ = train_cli.build(args, dev,
                                                        cfg=HYMBA)
    opt = adamw(0.0)
    step = make_train_step(loss, opt, TrainStepConfig(precision=prec))
    state = opt.init(params)
    batch = pipeline.to_device(mk(0), dev)
    float(step(params, state, None, batch)[3]["loss"])        # warm

    def run_step():
        float(step(params, state, None, batch)[3]["loss"])

    wall_ms, groups, n_kernels = _device_breakdown(run_step, lm_kind)
    del params, state, step, opt
    torch.cuda.empty_cache()

    # the inter-chunk recurrence of one layer: forward, and forward +
    # backward, at hymba's (b, nc, h, p, n), from per-chunk log decays of
    # hymba's range (-0.16 to -700: some underflow)
    nc = LM_SEQ // cfg.ssm_chunk
    gen = torch.Generator(device="cuda").manual_seed(2)
    log_a = -torch.exp(torch.empty((LM_BATCH, nc, cfg.ssm_heads),
                                   device=dev).uniform_(
        math.log(0.16), math.log(700.0), generator=gen))
    S = torch.randn((LM_BATCH, nc, cfg.ssm_heads, cfg.ssm_head_dim,
                     cfg.ssm_state), generator=gen, device=dev)
    fwd_s = time_fn(lambda: lm_modules.inter_chunk_states(log_a, S)[1],
                    reps=10, warmup=2)
    a_g, S_g = log_a.clone().requires_grad_(), S.clone().requires_grad_()

    def fwd_bwd():
        h_in, h_fin = lm_modules.inter_chunk_states(a_g, S_g)
        (h_in.sum() + h_fin.sum()).backward()
        return S_g.grad
    fwd_bwd_s = time_fn(fwd_bwd, reps=10, warmup=2)
    # the same calls' kernels alone: CUDA events above include the gaps
    # in which the card waits for the host to launch the next small op
    _, _, ic_fwd_kernels = _device_breakdown(
        lambda: lm_modules.inter_chunk_states(log_a, S)[1].sum().item(),
        lambda name: "all")
    ic_wall_ms, ic_groups, ic_kernels = _device_breakdown(
        lambda: fwd_bwd().sum().item(), lambda name: "all")
    ic_device_ms = ic_groups.get("all")
    if not torch.isfinite(a_g.grad).all():
        raise AssertionError("the recurrence's gradient is not finite")
    busy = sum(groups.values()) if n_kernels else None
    print(f"step breakdown (one hymba-1.5b step, batch {LM_BATCH} x seq "
          f"{LM_SEQ} on the card, host clock {wall_ms:.2f} ms): " + (
              f"device kernels {busy:.2f} ms in {n_kernels} kernels, idle "
              f"share {1 - busy / wall_ms:.3f}; " + "; ".join(
                  f"{k} {v:.2f} ms" for k, v in sorted(groups.items()))
              if n_kernels else "the profiler saw no device kernels (not "
              "measured)"))
    ic_device = "not measured (the profiler saw no kernels)" \
        if ic_device_ms is None else \
        f"{ic_device_ms:.4f} ms in {ic_kernels} kernels"
    print(f"ssd inter-chunk recurrence ({nc} chunks, one layer, closed "
          f"form): launches per layer {ic_fwd_kernels} forward, "
          f"{ic_kernels} forward + backward (the profiler's device "
          f"kernels); forward {fwd_s * 1e3:.4f} ms, forward + backward "
          f"{fwd_bwd_s * 1e3:.4f} ms (CUDA events, launch gaps included); "
          f"x {cfg.n_layers} layers: {fwd_bwd_s * 1e3 * cfg.n_layers:.2f} "
          f"ms per step; forward + backward device kernels {ic_device} "
          f"(host clock {ic_wall_ms:.2f} ms under the profiler)")
    return {"wall_ms": wall_ms, "device_ms": busy, "groups": groups,
            "n_kernels": n_kernels, "inter_chunk_fwd_ms": fwd_s * 1e3,
            "inter_chunk_fwd_bwd_ms": fwd_bwd_s * 1e3,
            "inter_chunk_fwd_bwd_device_ms": ic_device_ms,
            "inter_chunk_fwd_kernels": ic_fwd_kernels,
            "inter_chunk_fwd_bwd_kernels": ic_kernels}


# ---------------------------------------------------------------- serving --

SERVE_BATCH, SERVE_GEN = 4, 32
# prompt lengths: hymba's is 64 past its 1024 window (a multiple of the
# SSD chunk), so the window masks act in prefill and in decode alike
SERVE_PROMPT = {"hymba-1.5b": 1088, "qwen1.5-0.5b": 256}
SERVE_CFG = {"hymba-1.5b": HYMBA, "qwen1.5-0.5b": qwen1_5_0_5b.CONFIG}
# prefill (the kernels: chunked SSD, blocked flash attention) against the
# replay through the decode step (the recurrence, the plain one-token
# attention): the last prompt position's logits and every layer's K/V
# over the prompt, max |difference| over the largest magnitude.  fp32
# through 32 (24) blocks whose scans and softmaxes sum up to 1088 terms
# in other orders; each kernel alone is within 1e-4 of its plain version
SERVE_TOL = 1e-3
# the decode step on the card against the CPU (no kernel: the same plain
# operations, cuBLAS against the CPU's sums), and 2 sequence shards
# against one (the partial softmaxes merged in another order): logits of
# every step and the final caches, max |difference| over the largest
# magnitude, fp32 through 4 blocks and 16 (79) steps
SERVE_CHECK_TOL = 1e-4
SERVE_CHECK_LAYERS, SERVE_CPU_STEPS = 4, 16
SERVE_DIST_PROMPT, SERVE_DIST_GEN = 64, 16
SERVE_PROFILE_STEPS = 8
# the decode probe: qwen1.5-0.5b at full width, batch 4, 16 prompt tokens
# replayed and 48 generated (63 steps, cache 64)
SERVE_PROBE_PROMPT, SERVE_PROBE_GEN = 16, 48
SERVE_DIR = os.path.join(HERE, "build", "serve")


def serve_kernel_rows(card: str) -> list[dict]:
    """The flash-attention and SSD-chunk kernels held as `lm_kernel_phase`
    holds them (`check_attention`, `check_ssd`), at the prefill shapes
    (batch 4 x each prompt), float32: the serving path's kernel calls,
    timed, with their bound and (attention) one SDPA call's time."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for arch, cfg in SERVE_CFG.items():
        b, s = SERVE_BATCH, SERVE_PROMPT[arch]
        for case in attention_cases(cfg):
            rows.append(check_attention(case, torch.float32, gen, cfg, b, s))
        if cfg.ssm_state:
            shape = {"model": arch, "h": cfg.ssm_heads,
                     "p": cfg.ssm_head_dim, "n": cfg.ssm_state,
                     "chunk": cfg.ssm_chunk, "count": cfg.n_layers}
            rows.append(check_ssd(shape, torch.float32, gen, b, s))
        torch.cuda.empty_cache()
    for r in rows:
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f}"
        case = r.get("mask", f"chunk {r.get('chunk')}")
        print(f"prefill kernel {r['kernel']:16s} {r['model']:13s} "
              f"{case:12s} x{r['count']:2d}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f}, library {lib}, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}), max err "
              f"{r['max_abs_err']:.2e} ({card})", flush=True)
    return rows


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (on the host, in float64)."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def decode_kind(name: str) -> str:
    """The kind of a decode step's device kernel, by its lower-case name."""
    if any(t in name for t in ("gemm", "gemv", "cutlass", "xmma", "sm90",
                               "cublas")):
        return "cuBLAS matmuls"
    if "reduce" in name or "softmax" in name:
        return "reductions"
    if any(t in name for t in ("elementwise", "vectorized", "unrolled",
                               "copy", "cat", "index")):
        return "elementwise / copies"
    return "other"


def state_bytes(caches: list) -> dict:
    """Bytes of the decode state by entry: K/V, SSM state, conv buffers."""
    out = {"kv": 0, "ssm": 0, "conv": 0}
    for entry in caches:
        for name, t in entry.items():
            key = "kv" if name in ("k", "v") else name
            out[key] += t.numel() * t.element_size()
    return out


def serve_arch_phase(arch: str, card: str) -> dict:
    """Full-width `arch` through the serve entry point on the card (batch
    4, its prompt, 32 generated tokens), then `transformer.prefill` of
    the same prompt with the kernels: prefill's last logits against the
    replay's at the last prompt position, its K/V against the decode
    caches' first positions; then 8 decode steps under torch.profiler."""
    cfg, prompt = SERVE_CFG[arch], SERVE_PROMPT[arch]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve.run(serve.parse_args(
        ["--arch", arch, "--batch", str(SERVE_BATCH), "--prompt-len",
         str(prompt), "--gen", str(SERVE_GEN), "--device", "cuda"]),
        keep={prompt - 1}, cfg=cfg)
    decode_launches = ops.launch_counts()
    decode_peak = torch.cuda.max_memory_allocated() / 2**30
    if any(decode_launches.values()):
        raise AssertionError(f"the decode loop launched {decode_launches}: "
                             f"its attention and recurrence are plain")
    params, caches = res["params"], res["caches"]
    tokens = torch.as_tensor(res["prompts"], device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    last, kv = transformer.prefill(params, cfg, tokens)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    prefill_peak = torch.cuda.max_memory_allocated() / 2**30
    types = cfg.layer_types()
    want = {"conv2d": 0,
            "flash_attention": sum(t != "ssm" for t in types),
            "ssd_chunk": sum(t == "ssm" or t.startswith("hybrid")
                             for t in types)}
    if launches != want:
        raise AssertionError(f"prefill launched {launches}, want {want}")
    logit_err = _rel_err(last[:, 0], res["logits"][prompt - 1])
    first_id_agrees = bool(torch.equal(
        last[:, 0].argmax(-1).cpu(), torch.as_tensor(res["ids"][:, 0])))
    kv_err = max(_rel_err(entry[name][:, :prompt], t)
                 for entry, layer_kv in zip(caches, kv)
                 if layer_kv is not None
                 for name, t in zip(("k", "v"), layer_kv))
    del kv, last
    if not (logit_err <= SERVE_TOL and kv_err <= SERVE_TOL):
        raise AssertionError(f"{arch}: prefill against the replay: logits "
                             f"{logit_err:.3e}, K/V {kv_err:.3e} over the "
                             f"largest magnitude (tol {SERVE_TOL})")
    prefill_s = time_fn(lambda: transformer.prefill(params, cfg, tokens)[0],
                        reps=3, warmup=1)

    gen_ms = res["step_ms"][prompt - 1:]
    decode_ms = float(np.median(gen_ms))
    replay_ms = float(np.median(res["step_ms"][:prompt - 1]))
    cache = state_bytes(caches)
    bound_ms = weight_bytes / PEAK_BYTES_S * 1e3

    # 8 decode steps under the profiler, at the last prompt positions
    # again (their K/V are written anew; the work is a step's)
    ctx, tok = res["ctx"], tokens[:, -1:]

    def run_steps():
        for i in range(prompt - SERVE_PROFILE_STEPS, prompt):
            transformer.decode_step(params, cfg, tok, caches, i, ctx)
        torch.cuda.synchronize()
    run_steps()
    wall_ms, groups, n_kernels = _device_breakdown(run_steps, decode_kind)
    busy = sum(groups.values()) if n_kernels else None
    idle = None if busy is None else 1 - busy / wall_ms
    tokens_per_s = SERVE_BATCH / decode_ms * 1e3
    print(f"serve {arch}: full width ({n_params / 1e9:.3f} B params, "
          f"{cfg.n_layers} layers), batch {SERVE_BATCH}, prompt {prompt}, "
          f"gen {SERVE_GEN}, max_len {res['max_len']}, FP32; ids of row 0 "
          f"{res['ids'][0].tolist()} ({card})")
    print(f"serve {arch}: prefill {prefill_s * 1e3:.2f} ms "
          f"({SERVE_BATCH * prompt / prefill_s:.1f} tokens/s), launches "
          f"{launches}, peak {prefill_peak:.2f} GiB; decode {decode_ms:.3f} "
          f"ms/step median of {len(gen_ms)} generation steps (replay "
          f"{replay_ms:.3f}), {tokens_per_s:.1f} tokens/s at batch "
          f"{SERVE_BATCH}; bytes bound {bound_ms:.3f} ms/step (weights "
          f"{weight_bytes / 1e9:.3f} GB read once a step at "
          f"{PEAK_BYTES_S / 1e12:.2f} TB/s), the step {decode_ms / bound_ms:.2f}x "
          f"it; decode peak {decode_peak:.2f} GiB; state K/V "
          f"{cache['kv'] / 1e6:.1f} MB, SSM {cache['ssm'] / 1e6:.1f} MB, "
          f"conv {cache['conv'] / 1e6:.1f} MB ({card})")
    print(f"serve {arch}: prefill against the replay at position "
          f"{prompt - 1}: logits {logit_err:.3e}, K/V {kv_err:.3e} of the "
          f"largest magnitude (tol {SERVE_TOL}); first generated id agrees: "
          f"{first_id_agrees}; profiler, {SERVE_PROFILE_STEPS} decode steps: "
          + (f"{n_kernels / SERVE_PROFILE_STEPS:.1f} device kernels a step, "
             f"{busy / SERVE_PROFILE_STEPS:.3f} ms busy of "
             f"{wall_ms / SERVE_PROFILE_STEPS:.3f} a step, idle share "
             f"{idle:.3f}; " + "; ".join(f"{k} {v:.2f} ms" for k, v in
                                        sorted(groups.items()))
             if n_kernels else "no device kernels seen (not measured)")
          + f" ({card})", flush=True)
    out = {"arch": arch, "n_params": n_params, "weight_bytes": weight_bytes,
           "prompt": prompt, "max_len": res["max_len"],
           "ids": res["ids"].tolist(), "prefill_launches": launches,
           "prefill_ms": prefill_s * 1e3,
           "prefill_tokens_per_s": SERVE_BATCH * prompt / prefill_s,
           "prefill_peak_gib": prefill_peak, "decode_peak_gib": decode_peak,
           "decode_ms": decode_ms, "replay_ms": replay_ms,
           "decode_tokens_per_s": tokens_per_s, "bound_ms": bound_ms,
           "state_bytes": cache, "logit_err": logit_err, "kv_err": kv_err,
           "first_id_agrees": first_id_agrees, "step_ms": res["step_ms"],
           "profile_wall_ms": wall_ms, "profile_device_ms": busy,
           "profile_groups": groups, "profile_kernels": n_kernels,
           "kernels_per_step": n_kernels / SERVE_PROFILE_STEPS,
           "idle_share": idle}
    del res, params, caches
    torch.cuda.empty_cache()
    return out


def serve_arch_rank(rank: int, world: int, arch: str, card: str) -> dict:
    """`serve_arch_phase` in a fresh process (one spawned rank)."""
    return serve_arch_phase(arch, card)


def host_state() -> dict:
    """What in this process an eager, host-bound step could feel: its OS
    threads, Python threads, torch's intra- and inter-op threads, live
    child processes, the objects the garbage collector tracks, and the
    profiler's and cuDNN's switches."""
    me, kids = os.getpid(), 0
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                kids += int(f.read().rsplit(")", 1)[1].split()[1]) == me
        except OSError:
            pass
    return {"os_threads": len(os.listdir("/proc/self/task")),
            "py_threads": sorted(t.name for t in threading.enumerate()),
            "torch_threads": torch.get_num_threads(),
            "interop_threads": torch.get_num_interop_threads(),
            "children": kids, "gc_objects": len(gc.get_objects()),
            "profiler_on": torch.autograd._profiler_enabled(),
            "cudnn_deterministic": torch.backends.cudnn.deterministic,
            "cudnn_benchmark": torch.backends.cudnn.benchmark}


def decode_probe(params=None) -> dict:
    """The host-bound decode step alone: qwen1.5-0.5b at full width
    (`params`, else drawn from seed 0), batch 4, SERVE_PROBE_PROMPT
    tokens replayed and SERVE_PROBE_GEN generated; the median step ms
    and this process's `host_state`."""
    cfg = SERVE_CFG["qwen1.5-0.5b"]
    if params is None:
        params = transformer.init(torch.Generator().manual_seed(0), cfg,
                                  device="cuda")
    prompts = serve.prompts_for(cfg, SERVE_BATCH, SERVE_PROBE_PROMPT, 0)
    caches = transformer.init_decode_state(
        cfg, SERVE_BATCH, SERVE_PROBE_PROMPT + SERVE_PROBE_GEN, device="cuda")
    res = serve.generate(params, cfg, torch.as_tensor(prompts, device="cuda"),
                         SERVE_PROBE_GEN, caches, ShardCtx())
    return {"ms": float(np.median(res["step_ms"])), "state": host_state()}


def decode_probe_rank(rank: int, world: int) -> dict:
    """`decode_probe` in a fresh process (one spawned rank)."""
    return decode_probe()


def probe_phase(card: str) -> list[dict]:
    """The decode probe in this process and in a fresh one: whether what
    the earlier phases left in this process slows the eager step, or the
    host as a whole varies."""
    cfg = SERVE_CFG["qwen1.5-0.5b"]
    params = transformer.init(torch.Generator().manual_seed(0), cfg,
                              device="cuda")
    out = [dict(decode_probe(params), process="this"),
           dict(spawn_ranks(decode_probe_rank, 1)[0], process="fresh")]
    del params
    torch.cuda.empty_cache()
    for r in out:
        st = r["state"]
        print(f"decode probe (qwen1.5-0.5b full width, batch {SERVE_BATCH}, "
              f"{SERVE_PROBE_PROMPT + SERVE_PROBE_GEN - 1} steps, cache "
              f"{SERVE_PROBE_PROMPT + SERVE_PROBE_GEN}), {r['process']} "
              f"process: {r['ms']:.3f} ms a step (median); "
              f"{st['os_threads']} OS threads, Python threads "
              f"{st['py_threads']}, torch threads {st['torch_threads']} / "
              f"{st['interop_threads']}, {st['children']} children, "
              f"{st['gc_objects']} gc objects, profiler "
              f"{st['profiler_on']}, cudnn deterministic "
              f"{st['cudnn_deterministic']} benchmark "
              f"{st['cudnn_benchmark']} ({card})", flush=True)
    return out


def _cut_hymba():
    """Full-width hymba cut to SERVE_CHECK_LAYERS layers and its params
    (seed 0, on the CPU)."""
    cfg = dataclasses.replace(HYMBA, n_layers=SERVE_CHECK_LAYERS)
    return cfg, transformer.init(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")


def _decode_run(cfg, params, prompts, gen: int, device, mesh=None) -> dict:
    """`serve.generate` of `prompts` on `device` (the KV cache split along
    S over `mesh`'s model axis where there is one): every step's logits
    and the final caches (gathered whole), on the host."""
    ctx = ShardCtx() if mesh is None else ShardCtx(mesh=mesh,
                                                   seq_axis="model")
    p = tree_map(lambda t: t.detach().to(device), params)
    # this rank's block of the state: the whole batch, its sequence shard
    caches = transformer.init_decode_state(
        cfg, prompts.shape[0], serve.cache_len(prompts.shape[1], gen,
                                               ctx.seq_size) // ctx.seq_size,
        device=device)
    specs = None if mesh is None else \
        shardings.kv_cache_specs(caches, mesh, False, "model")
    steps = prompts.shape[1] + gen - 1
    res = serve.generate(p, cfg, torch.as_tensor(prompts, device=device),
                         gen, caches, ctx, keep=range(steps))
    caches = shardings.gather_caches(res["caches"], specs, mesh)
    return {"logits": torch.stack([res["logits"][i].cpu()
                                   for i in range(steps)]),
            "ids": res["ids"].cpu(), "step_ms": res["step_ms"],
            "caches": [{k: t.cpu() for k, t in c.items()} for c in caches]}


def serve_cpu_check(card: str) -> dict:
    """Full-width hymba cut to 4 layers: 16 teacher-forced decode steps on
    the card and on the CPU, the same params and tokens; every step's
    logits and the final caches."""
    cfg, params = _cut_hymba()
    prompts = serve.prompts_for(cfg, SERVE_BATCH, SERVE_CPU_STEPS, 0)
    runs = {dev: _decode_run(cfg, params, prompts, 1, torch.device(dev))
            for dev in ("cuda", "cpu")}
    logit_err = _rel_err(runs["cuda"]["logits"], runs["cpu"]["logits"])
    cache_err = max(_rel_err(g[k], w[k]) for g, w in zip(
        runs["cuda"]["caches"], runs["cpu"]["caches"]) for k in g)
    print(f"serve card vs cpu: hymba-1.5b full width, {SERVE_CHECK_LAYERS} "
          f"layers, batch {SERVE_BATCH}, {SERVE_CPU_STEPS} decode steps: "
          f"logits {logit_err:.3e}, caches {cache_err:.3e} of the largest "
          f"magnitude (tol {SERVE_CHECK_TOL}) ({card})", flush=True)
    if not (logit_err <= SERVE_CHECK_TOL and cache_err <= SERVE_CHECK_TOL):
        raise AssertionError(f"decode card vs cpu: logits {logit_err}, "
                             f"caches {cache_err}")
    return {"layers": SERVE_CHECK_LAYERS, "steps": SERVE_CPU_STEPS,
            "logit_err": logit_err, "cache_err": cache_err}


def serve_rank(rank: int, world: int) -> dict:
    """One of 2 gloo ranks on the card: the cut hymba's serve loop with
    the KV cache split along S over model 2; every step's logits and the
    gathered caches saved under SERVE_DIR."""
    cfg, params = _cut_hymba()
    mesh = make_mesh(1, world)
    prompts = serve.prompts_for(cfg, SERVE_BATCH, SERVE_DIST_PROMPT, 0)
    run = _decode_run(cfg, params, prompts, SERVE_DIST_GEN,
                      torch.device("cuda"), mesh)
    path = os.path.join(SERVE_DIR, f"rank{rank}.pt")
    torch.save({"logits": run["logits"], "caches": run["caches"]}, path)
    return {"ids": run["ids"].tolist(), "path": path,
            "step_ms": run["step_ms"], "staged": mesh.staged}


def serve_dist_phase(card: str) -> dict:
    """The sequence-sharded decode: 2 gloo ranks sharing the card against
    one rank, the cut hymba, prompt 64, gen 16: every step's logits, the
    ids and the caches."""
    os.makedirs(SERVE_DIR, exist_ok=True)
    cfg, params = _cut_hymba()
    prompts = serve.prompts_for(cfg, SERVE_BATCH, SERVE_DIST_PROMPT, 0)
    one = _decode_run(cfg, params, prompts, SERVE_DIST_GEN,
                      torch.device("cuda"))
    del params
    ranks = spawn_ranks(serve_rank, 2)
    errs, cache_errs = [], []
    for r in ranks:
        got = torch.load(r["path"])
        if r["ids"] != one["ids"].tolist():
            raise AssertionError(f"2 ranks generated {r['ids']}, one rank "
                                 f"{one['ids'].tolist()}")
        errs.append(_rel_err(got["logits"], one["logits"]))
        cache_errs.append(max(_rel_err(g[k], w[k]) for g, w in zip(
            got["caches"], one["caches"]) for k in g))
    steps = SERVE_DIST_PROMPT + SERVE_DIST_GEN - 1
    ms2 = [float(np.median(r["step_ms"])) for r in ranks]
    ms1 = float(np.median(one["step_ms"]))
    # a step's merge, per attention layer: a max of (B, Hq) and one sum of
    # (B, Hq, D + 1), fp32
    merge_bytes = cfg.n_layers * SERVE_BATCH * cfg.n_heads * \
        (cfg.head_dim + 2) * 4
    print(f"serve 2 ranks (gloo, one card; not a scaling result): hymba-1.5b "
          f"full width, {SERVE_CHECK_LAYERS} layers, model 2, batch "
          f"{SERVE_BATCH}, prompt {SERVE_DIST_PROMPT}, gen {SERVE_DIST_GEN}: "
          f"ids equal; logits {max(errs):.3e}, caches "
          f"{max(cache_errs):.3e} of the largest magnitude over {steps} "
          f"steps (tol {SERVE_CHECK_TOL}); {ms2} ms/step (median) a rank "
          f"against {ms1:.3f} on one; merge all-reduces {merge_bytes} B a "
          f"step a rank, staged collectives {[r['staged'] for r in ranks]} "
          f"({card})", flush=True)
    if not (max(errs) <= SERVE_CHECK_TOL
            and max(cache_errs) <= SERVE_CHECK_TOL):
        raise AssertionError(f"2 ranks against one: logits {errs}, caches "
                             f"{cache_errs}")
    return {"logit_err": errs, "cache_err": cache_errs, "ms_per_step": ms2,
            "one_rank_ms": ms1, "merge_bytes": merge_bytes,
            "staged": [r["staged"] for r in ranks], "steps": steps}


def serve_phase(card: str) -> dict:
    t0 = time.perf_counter()
    train_cli.set_fp32_numerics(torch.device("cuda"), echo=False)
    out = {"kernel_rows": serve_kernel_rows(card),
           "probe": probe_phase(card)}
    for arch in SERVE_CFG:
        out[arch] = spawn_ranks(serve_arch_rank, 1, arch, card)[0]
    out["cpu_check"] = serve_cpu_check(card)
    out["dist"] = serve_dist_phase(card)
    out["phase_s"] = time.perf_counter() - t0
    print(f"serving phase (prefill kernel rows, decode probe, hymba and "
          f"qwen at full width, card vs cpu, 2 ranks) took {out['phase_s']:.1f} s of "
          f"this run ({card})")
    return out


# --------------------------------------------------------- LM on a mesh --

# the ring's block calls at hymba's training shape on the 2-rank mesh
# (seq 2048 over model 2: 1024 a rank): the causal diagonal (every layer,
# both ranks; at 1024 rows window 1024 admits what causality does), the
# full off-diagonal (the 3 global layers on rank 1) and the window-1024
# off-diagonal (the 29 window layers on rank 1), whose last row sees no
# key; count: the calls of one forward over both ranks
MESH_MODEL = 2
MESH_S = LM_SEQ // MESH_MODEL
MESH_BLOCKS = [
    {"mask": "causal diagonal", "delta": 0, "window": None,
     "count": MESH_MODEL * HYMBA.n_layers},
    {"mask": "off-diagonal", "delta": MESH_S, "window": None,
     "count": sum(t == "hybrid_g" for t in HYMBA.layer_types())},
    {"mask": f"window-{HYMBA.window} off-diagonal", "delta": MESH_S,
     "window": HYMBA.window,
     "count": sum(t == "hybrid_s" for t in HYMBA.layer_types())},
]
MESH_STEPS = 2
MESH_ARGS = ["--arch", "hymba-1.5b", "--batch", str(LM_BATCH), "--seq",
             str(LM_SEQ), "--steps", str(MESH_STEPS), "--model",
             str(MESH_MODEL), "--remat", "--device", "cuda", "--log-every",
             "1"]
# the sharded prefill against the one-device prefill of the same params
# and prompts: the last logits and every K/V block, max |difference| over
# the largest magnitude (fp32 through 32 blocks whose softmaxes merge
# across the shards and whose SSD states cross them, in other orders)
MESH_PREFILL_TOL = 1e-4
# the 2-rank losses against the one-device FP32 run's (--remat leaves
# the losses bit for bit, as phase 4h holds; the ring merges in another
# order)
MESH_LOSS_RTOL = 1e-5


def ring_blocks(rank: int, world: int, s_local: int) -> int:
    """The ring's block calls (kernel launches) of one hymba forward on
    `rank` of `world` sequence shards: causality skips the later shards'
    blocks, a window stops the ring after `ring_steps`."""
    from repro_torch.core.ring_attention import ring_steps
    return sum(min(rank + 1, ring_steps(world, s_local, HYMBA.window
                                        if t == "hybrid_s" else None))
               for t in HYMBA.layer_types())


def check_attention_block(case: dict, dtype: torch.dtype,
                          gen: torch.Generator, cfg=HYMBA, b: int = LM_BATCH,
                          s: int = MESH_S) -> dict:
    """The kernel's block call (the ring's tile: query rows `delta` after
    the keys, o in fp32 and lse) at `cfg`'s heads, b x s against b x s,
    against its plain version and its CPU emulation on the rows that see a
    key (o; lse fp32 for both dtypes), every other row's lse <= -1e29 and
    o finite; bf16 element by element within one bf16 ulp; its autograd
    Function's gradients in both outputs; its times beside the bound and
    one SDPA call's with the block's bool mask."""
    dev = torch.device("cuda")
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    delta, window = case["delta"], case["window"]
    what = f"flash_attention block {case['mask']} {dtype}"
    opts = dict(delta=delta, window=window)
    q = torch.randn((b, s, hq, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
    o, lse = kfa.flash_attention_block(q, k, v, **opts)
    torch.cuda.synchronize()
    want_o, want_lse = flash_attention_ref(q, k, v, return_lse=True, **opts)
    seen = want_lse[0, 0] > -1e29
    n_unseen = int((~seen).sum())
    if o.dtype != torch.float32 or not torch.isfinite(o).all():
        raise AssertionError(f"{what}: o {o.dtype}, finite "
                             f"{bool(torch.isfinite(o).all())}")
    if not bool((lse[..., ~seen] <= -1e29).all()):
        raise AssertionError(f"{what}: a row with no key has lse "
                             f"{float(lse[..., ~seen].max())} > -1e29")
    err = _check_close(what, o[:, seen], want_o[:, seen], LM_FWD_TOL[dtype])
    lse_err = _check_close(f"{what} lse", lse[..., seen], want_lse[..., seen],
                           LM_FWD_TOL[torch.float32])
    emu_o, emu_lse = kfa.flash_attention_emulated(q, k, v, return_lse=True,
                                                  **opts)
    emu_err = max(
        _check_close(f"{what} emulation vs kernel", emu_o[:, seen],
                     o[:, seen], LM_FWD_TOL[dtype]),
        _check_close(f"{what} emulation lse vs kernel", emu_lse[..., seen],
                     lse[..., seen], LM_FWD_TOL[torch.float32]))
    del emu_o, emu_lse
    elem = None
    if dtype == torch.bfloat16:
        spread = flash_attention_ref(q, k, v.abs(), return_lse=True,
                                     **opts)[0]
        limit = ATTN_ELEM_ULP * (spread + want_o.abs())
        elem = float(((o - want_o).abs() / limit)[:, seen].max())
        if not elem <= 1.0:
            raise AssertionError(f"{what}: an element is {elem} x its "
                                 f"limit (one bf16 ulp of A + |o32|)")
        del spread, limit
    # the autograd Function (kernel forward, both outputs' gradients
    # recomputed through the plain version) vs autograd through the plain
    # version; the rows with no key get no lse cotangent (a merge gives
    # them weight 0)
    go = torch.randn(o.shape, generator=gen, device=dev)
    gl = torch.randn(lse.shape, generator=gen, device=dev) * seen
    grads = []
    for fwd in (lambda *a: kfa.FlashAttentionBlock.apply(
                    *a, delta, True, window, None, None),
                lambda *a: flash_attention_ref(*a, return_lse=True, **opts)):
        ts = [t.detach().requires_grad_() for t in (q, k, v)]
        ob, lb = fwd(*ts)
        ((ob * go).sum() + (torch.where(seen, lb, 0) * gl).sum()).backward()
        grads.append([t.grad for t in ts])
    for nm, got, want in zip(("dq", "dk", "dv"), *grads):
        _check_close(f"{what} {nm}", got, want, LM_BWD_TOL[dtype])
    del grads, want_o, want_lse

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pos = torch.arange(s, device=dev)
    keep = pos[:, None] + delta >= pos[None, :]
    if window is not None:
        keep &= pos[:, None] + delta - pos[None, :] < window

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep,
                                              enable_gqa=True)
    lib_err = float((library().transpose(1, 2).float() - o)[:, seen]
                    .abs().max())
    p = kfa.plan(tuple(q.shape), tuple(k.shape), dtype, True, window)
    row = {"kernel": "flash_attention_block", "mask": case["mask"],
           "delta": delta, "window": window, "model": cfg.name,
           "dtype": str(dtype).split(".")[-1], "count": case["count"],
           "q": [b, s, hq, d], "kv": [b, s, hkv, d], "max_abs_err": err,
           "lse_err": lse_err, "rows_without_key": n_unseen,
           "max_err_over_elem_limit": elem,
           "emulation_vs_kernel_err": emu_err,
           "library_vs_kernel_err": lib_err, "plan": dataclasses.asdict(p),
           "plan_str": f"{p.path} {p.tile_q}x{p.tile_k}",
           "pairs": admitted_pairs(s, window, delta)}
    row.update(_timings(
        lambda: kfa.flash_attention_block(q, k, v, **opts),
        lambda: flash_attention_ref(q, k, v, return_lse=True, **opts),
        library, 4.0 * d * row["pairs"] * b * hq,
        (q.numel() + k.numel() + v.numel()) * q.element_size()
        + 4 * (o.numel() + lse.numel()), dtype))
    return row


def lm_mesh_rank(rank: int, world: int, first_ids: list) -> dict:
    """One rank of the 2-rank hymba-1.5b phase on the card (gloo, data 1
    x model 2): the sharded prefill of serving's prompts (544 tokens a
    rank) against the one-device prefill of the same params, in this
    process; then MESH_STEPS steps of `launch.train` with --model 2
    --remat; then one more step under torch.profiler (lr 0) for the
    step's device time by kind and idle share."""
    dev = torch.device("cuda")
    cfg, prompt = HYMBA, SERVE_PROMPT["hymba-1.5b"]
    mesh = make_mesh(data=1, model=world)
    ctx = ShardCtx(mesh=mesh, seq_axis="model", batch_axes=("data",))
    params = transformer.init(torch.Generator().manual_seed(0), cfg,
                              device=dev)
    tokens = torch.as_tensor(serve.prompts_for(cfg, SERVE_BATCH, prompt, 0),
                             device=dev)
    mine = pipeline.shard_dim(tokens, 1, mesh, "model").contiguous()
    sl = mine.shape[1]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    halo.reset_staged()
    last, kv = transformer.prefill(params, cfg, mine, ctx)
    torch.cuda.synchronize()
    prefill_launches = ops.launch_counts()
    prefill_staged = halo.staged
    prefill_peak = torch.cuda.max_memory_allocated() / 2**30
    prefill_s = time_fn(lambda: transformer.prefill(params, cfg, mine,
                                                    ctx)[0],
                        reps=3, warmup=1, host=True)
    one_last, one_kv = transformer.prefill(params, cfg, tokens)
    logit_err = _rel_err(last, one_last)
    kv_err = max(_rel_err(t, w[:, rank * sl:(rank + 1) * sl])
                 for layer, one in zip(kv, one_kv) if layer is not None
                 for t, w in zip(layer, one))
    ids = last[:, 0].argmax(-1).cpu()
    first_agrees = bool(torch.equal(ids, one_last[:, 0].argmax(-1).cpu())
                        and ids.tolist() == list(first_ids))
    del params, last, kv, one_last, one_kv, tokens, mine
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    halo.reset_staged()
    res = train_cli.main(MESH_ARGS, cfg=HYMBA)
    train_launches = ops.launch_counts()
    train_staged = halo.staged
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    mesh2 = res["mesh"]
    loss = functools.partial(transformer.loss_fn, cfg=cfg, remat=True,
                             ctx=ShardCtx(mesh=mesh2, seq_axis="model",
                                          batch_axes=("data",)))
    step = make_train_step(loss, adamw(0.0), TrainStepConfig(precision=FP32),
                           mesh=mesh2)
    batch = pipeline.to_device(pipeline.shard_lm_batch(
        pipeline.synthetic_lm_batch(0, LM_BATCH, LM_SEQ, cfg.vocab), mesh2,
        "model", ("data",)), dev)
    params, state = res["params"], res["opt_state"]
    wall_ms, groups, n_kernels = _device_breakdown(
        lambda: float(step(params, state, None, batch)[3]["loss"]), lm_kind)
    busy = sum(groups.values()) if n_kernels else None
    copies = groups.get(lm_kind("memcpy"), 0.0)
    return {"rank": rank, "s_local": sl,
            "prefill_launches": prefill_launches,
            "prefill_staged": prefill_staged, "prefill_peak_gib": prefill_peak,
            "prefill_ms": prefill_s * 1e3, "logit_err": logit_err,
            "kv_err": kv_err, "first_ids": ids.tolist(),
            "first_id_agrees": first_agrees, "losses": res["losses"],
            "step_s": res["step_s"], "train_launches": train_launches,
            "train_staged": train_staged, "train_peak_gib": train_peak,
            "n_params": res["n_params"], "profile_wall_ms": wall_ms,
            "profile_device_ms": busy, "profile_groups": groups,
            "profile_kernels": n_kernels,
            "idle_share": None if busy is None else 1 - busy / wall_ms,
            "idle_share_without_copies": None if busy is None else
            1 - (busy - copies) / wall_ms}


def lm_mesh_phase(card: str, plain: dict, served: dict) -> dict:
    """Phase 6, the LM on a mesh: the ring's block calls at hymba's ring
    shapes (f32 and bf16) against the plain version; then 2 ranks spawned
    on the card over gloo (data 1 x model 2, not a scaling result), each
    running `lm_mesh_rank`.  Held: the sharded prefill's logits and K/V
    within MESH_PREFILL_TOL of the one-device prefill's and its first
    generated ids equal to serving's (phase 5b); the 2-rank losses equal
    on both ranks and within MESH_LOSS_RTOL of the one-device FP32 run's
    first MESH_STEPS (`plain`, phase 4h); the launches a rank as the ring
    derives them (prefill and each forward: the attention kernel once a
    block the causal skip leaves, the SSD kernel once a layer; --remat
    runs every forward twice)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = [check_attention_block(case, dtype, gen)
            for dtype in (torch.float32, torch.bfloat16)
            for case in MESH_BLOCKS]
    for r in rows:
        print(f"ring block {r['mask']} (delta {r['delta']}, window "
              f"{r['window']}), {r['dtype']}, q {r['q']} kv {r['kv']}: "
              f"{r['plan_str']}; max |err| {r['max_abs_err']:.3e}, lse "
              f"{r['lse_err']:.3e}, rows with no key "
              f"{r['rows_without_key']}"
              + (f", err/elem limit {r['max_err_over_elem_limit']:.3f}"
                 if r["max_err_over_elem_limit"] is not None else "")
              + f"; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"SDPA (bool mask) {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{r['pairs']} pairs), {r['tflops_s']:.1f} TFLOP/s ({card})")
    ids = [row[0] for row in served["hymba-1.5b"]["ids"]]
    torch.cuda.empty_cache()
    ranks = spawn_ranks(lm_mesh_rank, MESH_MODEL, ids)
    want_losses = plain["losses"][:MESH_STEPS]
    for r in ranks:
        i = r["rank"]
        fwd = ring_blocks(i, MESH_MODEL, r["s_local"])
        want_prefill = {"conv2d": 0, "flash_attention": fwd,
                        "ssd_chunk": HYMBA.n_layers}
        train_fwd = ring_blocks(i, MESH_MODEL, MESH_S)
        want_train = {"conv2d": 0,
                      "flash_attention": 2 * MESH_STEPS * train_fwd,
                      "ssd_chunk": 2 * MESH_STEPS * HYMBA.n_layers}
        if r["prefill_launches"] != want_prefill or \
                r["train_launches"] != want_train:
            raise AssertionError(f"rank {i}: launches prefill "
                                 f"{r['prefill_launches']} (want "
                                 f"{want_prefill}), train "
                                 f"{r['train_launches']} (want "
                                 f"{want_train})")
        if not (r["logit_err"] <= MESH_PREFILL_TOL and
                r["kv_err"] <= MESH_PREFILL_TOL and r["first_id_agrees"]):
            raise AssertionError(f"rank {i}: sharded prefill against one "
                                 f"device: logits {r['logit_err']:.3e}, K/V "
                                 f"{r['kv_err']:.3e} (tol "
                                 f"{MESH_PREFILL_TOL}), first ids "
                                 f"{r['first_ids']} against {ids}")
        rel = [abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                   want_losses)]
        if r["losses"] != ranks[0]["losses"] or len(rel) != MESH_STEPS or \
                not max(rel) <= MESH_LOSS_RTOL:
            raise AssertionError(f"rank {i}: losses {r['losses']} against "
                                 f"rank 0's {ranks[0]['losses']} and one "
                                 f"device's {want_losses} (rel {rel})")
        r["loss_rel"] = rel
    for r in ranks:
        steady = r["step_s"][1:]
        g = r["profile_groups"]
        print(f"rank {r['rank']}: sharded prefill, hymba-1.5b full width, "
              f"batch {SERVE_BATCH} x {r['s_local'] * MESH_MODEL} "
              f"({r['s_local']} a rank): logits {r['logit_err']:.3e}, K/V "
              f"{r['kv_err']:.3e} of the largest one-device magnitude (tol "
              f"{MESH_PREFILL_TOL}); first ids {r['first_ids']} = serving's "
              f"{r['first_id_agrees']}; {r['prefill_ms']:.1f} ms, launches "
              f"{r['prefill_launches']}, halo/ring messages staged "
              f"{r['prefill_staged']}, peak {r['prefill_peak_gib']:.2f} GiB "
              f"({card})")
        print(f"rank {r['rank']}: mesh train, hymba-1.5b FP32 --remat, "
              f"batch {LM_BATCH} x seq {LM_SEQ} over model {MESH_MODEL}: "
              f"losses {r['losses']} (rel {['%.2e' % x for x in r['loss_rel']]}"
              f" of one device's {want_losses}); step s {r['step_s']}"
              f" (steady {sum(steady) / len(steady):.3f}); launches "
              f"{r['train_launches']}; messages staged {r['train_staged']}; "
              f"peak {r['train_peak_gib']:.2f} GiB ({card})")
        print(f"rank {r['rank']}: mesh step breakdown (one step, host clock "
              f"{r['profile_wall_ms']:.1f} ms): " + (
                  f"device kernels {r['profile_device_ms']:.1f} ms in "
                  f"{r['profile_kernels']} kernels, idle share "
                  f"{r['idle_share']:.3f} ({r['idle_share_without_copies']:.3f}"
                  f" with the copies counted idle); " + "; ".join(
                      f"{k} {v:.1f} ms" for k, v in sorted(g.items()))
                  if r["profile_kernels"] else "no device kernels seen (not "
                  "measured)") + f" ({card})")
    out = {"block_rows": rows, "ranks": ranks,
           "phase_s": time.perf_counter() - t0}
    print(f"LM-on-a-mesh phase (6 ring block rows, 2 card ranks: sharded "
          f"prefill, {MESH_STEPS} --remat steps, a profiled step) took "
          f"{out['phase_s']:.1f} s of this run ({card})")
    return out


# ------------------------------------------------- the vocab-parallel loss --

# full width, depth cut: gemma2-9b to one local-4096 + global unit at batch
# 1 x seq 4096 (the tied table, 917.5 M rows x d; 2048 tokens a rank),
# qwen2.5-14b to one layer at batch 1 x seq 2048 (the untied unembed);
# data 1 x model 2, FP32, params drawn on the card from VOCAB_SEED
VOCAB_MODEL = 2
VOCAB_RUNS = [
    {"arch": "gemma2-9b",
     "cfg": dataclasses.replace(gemma2_9b.CONFIG, n_layers=2), "seq": 4096},
    {"arch": "qwen2.5-14b",
     "cfg": dataclasses.replace(qwen2_5_14b.CONFIG, n_layers=1),
     "seq": 2048},
]
VOCAB_SEED = 26
VOCAB_DIR = os.path.join(HERE, "build", "vocab")
# the ranks' shares summed against the one-device dense loss: fp32 sums of
# 256,000 exponentials a token in another order (streamed over two blocks)
VOCAB_LOSS_RTOL = 1e-5
# each gradient against the one-device one, over its largest magnitude:
# the same products split over two vocab blocks and two sequence shards
VOCAB_GRAD_TOL = 1e-4
# the attention kernel at the shapes phase 7's runs give it: gemma2-9b
# (D 256, 16 / 8 heads, softcap 50) on one device at 1 x 4096, causal and
# window 4096 (at this length the window admits what causality does), and
# beside them at 1 x 8192, where the window binds (no run launches these:
# count 0); the ring's blocks of 2048 rows on the 2-rank run: each layer's
# diagonal on both ranks and its off-diagonal on rank 1.  qwen2.5-14b (D
# 128, 40 / 8 heads, no softcap, every layer global) on one device at 1 x
# 2048, and the ring's blocks of 1024 rows: the diagonal on both ranks, the
# off-diagonal on rank 1.  count: the calls of one forward (the ring's
# summed over the ranks)
GEMMA = gemma2_9b.CONFIG
QWEN25 = qwen2_5_14b.CONFIG
GEMMA_WINDOW = f"window {GEMMA.window}"
VOCAB_ATTN = [
    {"cfg": GEMMA, "s": 4096, "mask": "causal", "window": None, "count": 1},
    {"cfg": GEMMA, "s": 4096, "mask": GEMMA_WINDOW, "window": GEMMA.window,
     "count": 1},
    {"cfg": GEMMA, "s": 8192, "mask": "causal", "window": None, "count": 0},
    {"cfg": GEMMA, "s": 8192, "mask": GEMMA_WINDOW, "window": GEMMA.window,
     "count": 0},
    {"cfg": GEMMA, "s": 2048, "delta": 0, "mask": "causal diagonal",
     "window": None, "count": 2},
    {"cfg": GEMMA, "s": 2048, "delta": 0, "mask": f"{GEMMA_WINDOW} diagonal",
     "window": GEMMA.window, "count": 2},
    {"cfg": GEMMA, "s": 2048, "delta": 2048, "mask": "off-diagonal",
     "window": None, "count": 1},
    {"cfg": GEMMA, "s": 2048, "delta": 2048,
     "mask": f"{GEMMA_WINDOW} off-diagonal", "window": GEMMA.window,
     "count": 1},
    {"cfg": QWEN25, "s": 2048, "mask": "causal", "window": None, "count": 1},
    {"cfg": QWEN25, "s": 1024, "delta": 0, "mask": "causal diagonal",
     "window": None, "count": 2},
    {"cfg": QWEN25, "s": 1024, "delta": 1024, "mask": "off-diagonal",
     "window": None, "count": 1},
]
KERNEL_LAUNCHES = 20        # kernel launches an event pair
# a call at least this long (its warm call's time) is timed in one pair
# (which then lasts 40 ms or more)
LONG_CALL_MS = 2.0
# the yardstick against the kernel's output (o on the rows that see a
# key) over its largest magnitude: a wrong mask or softcap shows at O(1);
# within it, what the library's own tiles and roundings leave
LIBRARY_TOL = 5e-2


def _ms_a_launch(fn, reps: int = 5) -> float:
    """ms a call of `fn`: KERNEL_LAUNCHES calls between a pair of CUDA
    events, the trimmed mean of `reps` pairs after one warm call (one pair
    where the warm call takes LONG_CALL_MS or more)."""
    def pair(n: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    if pair(1) >= LONG_CALL_MS:
        reps = 1
    return trimmed_mean([pair(KERNEL_LAUNCHES) for _ in range(reps)])


# what `_flex_mask` reads: the query rows' offset and the window (a large
# number for none), 0-dim tensors on the card, so that every mask of one
# shape and dtype runs one compiled kernel
_FLEX = {}


def _flex_mask(b, h, qi, ki):
    qpos = qi + _FLEX["delta"]
    return (qpos >= ki) & (qpos - ki < _FLEX["window"])


def _flex_softcap(score, b, h, qi, ki):
    return GEMMA.attn_softcap * torch.tanh(score / GEMMA.attn_softcap)


def flex_library(q, k, v, *, window, delta, block: bool):
    """The yardstick for softcapped attention: one compiled
    `flex_attention` call (GQA, the softcap as its score_mod, causality,
    the window and `delta` as its block mask) on (B, H, S, D) views of
    q, k, v; with `block`, its lse too.  Returns the call, ready to time.
    Compiled for each shape: with dynamic shapes inductor fails to lower
    it (torch 2.11, "unbacked_bindings").  Never called by the port."""
    from torch.nn.attention.flex_attention import (
        create_block_mask, flex_attention)
    if "fn" not in _FLEX:
        # its caches in the checkout's build directory, its kernels
        # compiled in this process
        import torch._inductor.config
        os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(
            HERE, "build", "inductor")
        os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, "build",
                                                      "triton")
        torch._inductor.config.compile_threads = 1
        _FLEX["delta"] = torch.zeros((), dtype=torch.int64, device=q.device)
        _FLEX["window"] = torch.zeros((), dtype=torch.int64, device=q.device)
        torch._dynamo.config.recompile_limit = 64
        _FLEX["fn"] = torch.compile(flex_attention, dynamic=False)
    _FLEX["delta"].fill_(delta)
    _FLEX["window"].fill_(2 ** 40 if window is None else window)
    s = q.shape[1]
    mask = create_block_mask(_flex_mask, None, None, s, s, device=q.device)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fn = _FLEX["fn"]

    def library():
        return fn(qt, kt, vt, score_mod=_flex_softcap, block_mask=mask,
                  enable_gqa=True, return_lse=block)
    return library


def sdpa_library(q, k, v, *, window, delta, block: bool):
    """The yardstick without a softcap: one SDPA call on (B, H, S, D)
    views, GQA, `is_causal` for a one-device causal call, else the
    block's bool mask.  Never called by the port."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window is None and delta == 0 and not block:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    s = q.shape[1]
    pos = torch.arange(s, device=q.device)
    keep = pos[:, None] + delta >= pos[None, :]
    if window is not None:
        keep &= pos[:, None] + delta - pos[None, :] < window
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=keep, enable_gqa=True)


def vocab_attention_row(case: dict, dtype: torch.dtype,
                        gen: torch.Generator) -> dict:
    """The attention kernel at `case`'s config (its heads, D and softcap)
    on one device at b x s (`case["b"]`, 1 where it has none), or (a case
    with `delta`) the ring's block call at b x s rows against as many
    keys, `delta` after them.  Held against
    the plain version: max |err| within LM_FWD_TOL of the largest
    magnitude (o and, for a block, lse), bf16 element by element within
    one bf16 ulp of A + |o32|.  Its ms (KERNEL_LAUNCHES a pair), the plain
    version's, one library call's (`flex_library` with a softcap, else
    `sdpa_library`, held within LIBRARY_TOL of the kernel) and the bound
    over the admitted pairs."""
    dev = torch.device("cuda")
    cfg, s, b = case["cfg"], case["s"], case.get("b", 1)
    hq, hkv, d, cap = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.attn_softcap
    block = "delta" in case
    delta = case.get("delta", 0)
    opts = dict(window=case["window"], softcap=cap)
    what = f"{cfg.name} {'block ' if block else ''}{case['mask']} {dtype}"
    q = torch.randn((b, s, hq, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
    p = kfa.plan(tuple(q.shape), tuple(k.shape), dtype, True, case["window"])
    if (p.path, p.d_pad) != ("wgmma" if dtype == torch.bfloat16 else "fma",
                             d):
        raise AssertionError(f"{what} planned {p}")
    if block:
        def kernel():
            return kfa.flash_attention_block(q, k, v, delta=delta, **opts)

        def plain():
            return flash_attention_ref(q, k, v, delta=delta,
                                       return_lse=True, **opts)
    else:
        def kernel():
            return kfa.flash_attention(q, k, v, **opts)

        def plain():
            return flash_attention_ref(q, k, v, **opts)
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    o, w = (got[0], want[0]) if block else (got, want)
    # a block's rows that see a key (at these shapes every row does)
    seen = want[1][0, 0] > -1e29 if block else slice(None)
    err = _check_close(what, o[:, seen], w[:, seen], LM_FWD_TOL[dtype])
    lse_err = _check_close(f"{what} lse", got[1][..., seen],
                           want[1][..., seen],
                           LM_FWD_TOL[torch.float32]) if block else None
    del want, w
    elem = None
    if dtype == torch.bfloat16:
        ref_opts = dict(opts, delta=delta, return_lse=True) if block else opts
        want = flash_attention_ref(*(t.float() for t in (q, k, v)),
                                   **ref_opts)
        spread = flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                     **ref_opts)
        w, a = (want[0], spread[0]) if block else (want, spread)
        elem = float(((o.float() - w).abs()
                      / (ATTN_ELEM_ULP * (a + w.abs())))[:, seen].max())
        del want, spread, w, a
        if not elem <= 1.0:
            raise AssertionError(f"{what}: an element is {elem} x its limit "
                                 f"(one bf16 ulp of A + |o32|)")
    make = flex_library if cap else sdpa_library
    library = make(q, k, v, window=case["window"], delta=delta, block=block)
    t0 = time.perf_counter()
    lib = library()
    torch.cuda.synchronize()
    library_first_s = time.perf_counter() - t0
    lib_o = (lib[0] if isinstance(lib, tuple) else lib).transpose(1, 2)
    lib_err = float((lib_o.float() - o.float())[:, seen].abs().max()) / \
        float(o.float()[:, seen].abs().max())
    if not lib_err <= LIBRARY_TOL:
        raise AssertionError(f"{what}: the library call is {lib_err:.3e} "
                             f"of the largest magnitude from the kernel "
                             f"(tol {LIBRARY_TOL}): not the same function")
    del got, o, lib, lib_o
    torch.cuda.empty_cache()
    pairs = b * admitted_pairs(s, case["window"], delta)
    flops = 4.0 * d * pairs * hq
    nbytes = (q.numel() + k.numel() + v.numel()) * q.element_size() + (
        4 * (q.numel() + b * hq * s) if block else
        q.numel() * q.element_size())
    ms = _ms_a_launch(kernel)
    library_ms = _ms_a_launch(library)
    plain_ms = time_fn(plain, reps=3, warmup=1) * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    return {"kernel": "flash_attention_block" if block else
            "flash_attention", "model": cfg.name, "mask": case["mask"],
            "delta": delta, "window": case["window"], "softcap": cap,
            "dtype": str(dtype).split(".")[-1], "count": case["count"],
            "q": list(q.shape), "kv": list(k.shape), "pairs": pairs,
            "max_abs_err": err, "lse_err": lse_err,
            "max_err_over_elem_limit": elem, "plan": dataclasses.asdict(p),
            "plan_str": f"{p.path} {p.tile_q}x{p.tile_k} d{p.d_pad}",
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "flex_attention (compiled)" if cap else "SDPA",
            "library_vs_kernel_err": lib_err,
            "library_first_call_s": library_first_s,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "tflops_s": flops / ms / 1e9}


def vocab_kernel_rows(card: str) -> list[dict]:
    """Phase 7's kernel rows: every VOCAB_ATTN case in f32 and bf16,
    printed."""
    gen = torch.Generator(device="cuda").manual_seed(VOCAB_SEED)
    rows = []
    for dt, c in itertools.product((torch.float32, torch.bfloat16),
                                   VOCAB_ATTN):
        rows.append(r := vocab_attention_row(c, dt, gen))
        print(f"{r['model']} attention {r['kernel']} {r['mask']} (delta "
              f"{r['delta']}), {r['dtype']}, q {r['q']} kv {r['kv']}, "
              f"softcap {r['softcap']}, {r['count']} a forward: "
              f"{r['plan_str']}; max |err| {r['max_abs_err']:.3e}"
              + ("" if r["lse_err"] is None else f", lse {r['lse_err']:.3e}")
              + ("" if r["max_err_over_elem_limit"] is None else
                 f", err/elem limit {r['max_err_over_elem_limit']:.3f}")
              + f"; kernel {r['ms']:.4f} ms ({KERNEL_LAUNCHES} launches a "
              f"pair), plain {r['plain_ms']:.4f} ms, {r['library']} "
              f"{r['library_ms']:.4f} ms (its first call "
              f"{r['library_first_call_s']:.1f} s; "
              f"{r['library_vs_kernel_err']:.2e} from the kernel), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {r['pairs']} "
              f"pairs), {r['tflops_s']:.1f} TFLOP/s ({card})", flush=True)
    return rows


def _grad_err(got: torch.Tensor, want: torch.Tensor, scale: float) -> float:
    """max |got - want| over `scale` (the gradient's largest magnitude)."""
    return float((got.float() - want.float()).abs().max()) / scale


def _vocab_setup(run: dict, dev: torch.device):
    """The run's config, its params drawn on the card from VOCAB_SEED (the
    same on every process) and its global batch 0."""
    cfg = run["cfg"]
    params = transformer.init(torch.Generator(device=dev).manual_seed(
        VOCAB_SEED), cfg, device=dev)
    return cfg, params, pipeline.synthetic_lm_batch(0, 1, run["seq"],
                                                    cfg.vocab)


def vocab_dense_rank(rank: int, world: int, i: int) -> dict:
    """One device, in its own process: the dense `loss_fn` of VOCAB_RUNS[i]
    and its gradients (forward + backward timed on the host clock,
    synchronised: the first pass, as the ranks time theirs, and a second,
    warm one), saved under VOCAB_DIR for the ranks."""
    dev = torch.device("cuda")
    cfg, params, nb = _vocab_setup(VOCAB_RUNS[i], dev)
    batch = pipeline.to_device(nb, dev)
    leaves = tree_leaves(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loss = transformer.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    torch.autograd.grad(transformer.loss_fn(params, batch, cfg), leaves)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    path = os.path.join(VOCAB_DIR, f"{VOCAB_RUNS[i]['arch']}.pt")
    torch.save({"loss": loss.item(), "grads": tree_unflatten(
        params, iter(g.cpu() for g in grads))}, path)
    return {"loss": loss.item(), "s": seconds, "s_warm": warm,
            "peak_gib": peak, "launches": launches, "path": path,
            "n_params": sum(t.numel() for t in leaves)}


def vocab_rank(rank: int, world: int, i: int) -> dict:
    """One of VOCAB_MODEL gloo ranks on the card (data 1 x model
    VOCAB_MODEL): VOCAB_RUNS[i]'s `loss_fn(vocab_parallel=True)` on this
    rank's vocabulary blocks (`shardings.vocab_blocks`) and its sequence
    block, forward + backward timed; the shares and the layer gradients
    summed over the ranks; this rank's table blocks' gradients against
    the one-device gradient's rows and the summed layer gradients against
    its layers' (`vocab_dense_rank`'s file)."""
    dev = torch.device("cuda")
    run = VOCAB_RUNS[i]
    mesh = make_mesh(data=1, model=world)
    ctx = ShardCtx(mesh=mesh, seq_axis="model", batch_axes=("data",))
    cfg, params, nb = _vocab_setup(run, dev)
    blocks = shardings.vocab_blocks(params, mesh)
    del params
    batch = pipeline.to_device(pipeline.shard_lm_batch(
        nb, mesh, "model", ("data",)), dev)
    leaves = tree_leaves(blocks)
    tables = [n for n in shardings.VOCAB_DIMS if n in blocks]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    vocab_parallel.reset_sent()
    halo.reset_staged()
    mesh.barrier()
    t0 = time.perf_counter()
    share = transformer.loss_fn(blocks, batch, cfg, ctx=ctx,
                                vocab_parallel=True)
    grads = torch.autograd.grad(share, leaves)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    sent = dict(vocab_parallel.sent)
    staged = halo.staged
    peak = torch.cuda.max_memory_allocated() / 2**30
    gtree = tree_unflatten(blocks, iter(grads))
    loss = float(mesh.all_reduce(share.detach(), "model"))
    layers = [g for n in sorted(gtree) if n not in tables
              for g in tree_leaves(gtree[n])]
    flat = mesh.all_reduce(torch.cat([g.flatten() for g in layers]),
                           "model")
    want = torch.load(os.path.join(VOCAB_DIR, f"{run['arch']}.pt"),
                      mmap=True)
    errs, at = {}, 0
    for n in sorted(gtree):
        if n in tables:
            continue
        for g, w in zip(tree_leaves(gtree[n]), tree_leaves(want["grads"][n])):
            w = w.to(dev)
            errs[n] = max(errs.get(n, 0.0), _grad_err(
                flat[at:at + g.numel()].view_as(g), w,
                float(w.abs().max())))
            at += g.numel()
    for n in tables:
        dim = shardings.VOCAB_DIMS[n]
        g, w = gtree[n], want["grads"][n]
        m = g.shape[dim]
        lo = mesh.index("model") * m
        real = min(m, cfg.vocab - lo)
        errs[n] = _grad_err(g.narrow(dim, 0, real),
                            w.narrow(dim, lo, real).to(dev),
                            float(w.abs().max()))
        if real < m and g.narrow(dim, real, m - real).any():
            raise AssertionError(f"{n}: a padded row has a gradient")
    s_local = run["seq"] // world
    vshard = shardings.vocab_padded(cfg.vocab, world) // world
    return {"rank": rank, "share": share.item(), "loss": loss, "s": seconds,
            "peak_gib": peak, "launches": launches, "sent": sent,
            "staged": staged, "grad_err": errs, "want_loss": want["loss"],
            "block_bytes": vshard * cfg.d_model * 4,
            "chunk_bytes": s_local * vshard * 4,
            "dense_logit_bytes": run["seq"] * cfg.vocab * 4,
            "n_params": sum(t.numel() for t in leaves)}


def vocab_dense_runs(rank: int, world: int) -> dict:
    """`vocab_dense_rank` of every VOCAB_RUNS config, in turn, in one
    process (a later config's first pass finds the process warm)."""
    out = []
    for i in range(len(VOCAB_RUNS)):
        out.append(vocab_dense_rank(rank, world, i))
        gc.collect()
        torch.cuda.empty_cache()
    return {"runs": out}


def vocab_rank_runs(rank: int, world: int) -> dict:
    """`vocab_rank` of every VOCAB_RUNS config, in turn, on the same
    spawned ranks."""
    out = []
    for i in range(len(VOCAB_RUNS)):
        out.append(vocab_rank(rank, world, i))
        gc.collect()
        torch.cuda.empty_cache()
    return {"runs": out}


def vocab_phase(card: str) -> dict:
    """Phase 7, the vocab-parallel loss: the attention kernel's rows at
    the shapes of its runs (`vocab_kernel_rows`: gemma2's D 256, qwen2.5's
    D 128), then for each VOCAB_RUNS config the one-device
    dense loss and gradients in a process of its own, then VOCAB_MODEL
    gloo ranks sharing the card (not a scaling result) running
    `loss_fn(vocab_parallel=True)` with its backward.  Held: the ranks'
    shares summed within VOCAB_LOSS_RTOL of the one-device loss; each
    rank's table-block gradients and the layer gradients summed over the
    ranks within VOCAB_GRAD_TOL of the one-device gradients' largest
    magnitude; the attention launches a rank as the ring derives them (a
    block call a step the causal skip leaves), one a layer on one device;
    the table rotations 4 (P - 1) + P messages of one block a rank."""
    from repro_torch.core.ring_attention import ring_steps
    t0 = time.perf_counter()
    rows = vocab_kernel_rows(card)
    shutil.rmtree(VOCAB_DIR, ignore_errors=True)
    os.makedirs(VOCAB_DIR)
    out = {"kernel_rows": rows, "runs": []}
    ones = spawn_ranks(vocab_dense_runs, 1)[0]["runs"]
    every = spawn_ranks(vocab_rank_runs, VOCAB_MODEL)
    for i, run in enumerate(VOCAB_RUNS):
        cfg = run["cfg"]
        one, ranks = ones[i], [r["runs"][i] for r in every]
        os.remove(one["path"])
        s_local = run["seq"] // VOCAB_MODEL
        types = cfg.layer_types()
        want_one = {"conv2d": 0, "flash_attention": len(types),
                    "ssd_chunk": 0}
        if one["launches"] != want_one:
            raise AssertionError(f"{run['arch']} one device: launches "
                                 f"{one['launches']}, want {want_one}")
        p = VOCAB_MODEL
        for r in ranks:
            rel = abs(r["loss"] - one["loss"]) / abs(one["loss"])
            r["loss_rel"] = rel
            blocks = sum(min(r["rank"] + 1, ring_steps(
                p, s_local, cfg.window if t == "swa" else None))
                for t in types)
            want = {"conv2d": 0, "flash_attention": blocks, "ssd_chunk": 0}
            msgs = 4 * (p - 1) + p
            if not (rel <= VOCAB_LOSS_RTOL and
                    max(r["grad_err"].values()) <= VOCAB_GRAD_TOL and
                    r["launches"] == want and
                    r["sent"]["messages"] == msgs and
                    r["sent"]["bytes"] == msgs * r["block_bytes"]):
                raise AssertionError(
                    f"{run['arch']} rank {r['rank']}: loss {r['loss']!r} "
                    f"against one device's {one['loss']!r} (rel {rel:.2e}, "
                    f"tol {VOCAB_LOSS_RTOL}); gradients {r['grad_err']} (tol "
                    f"{VOCAB_GRAD_TOL}); launches {r['launches']} (want "
                    f"{want}); table messages {r['sent']} (want {msgs} of "
                    f"{r['block_bytes']} B)")
            print(f"vocab-parallel {run['arch']} ({cfg.n_layers} "
                  f"layer{'s' * (cfg.n_layers > 1)} {types}, full width, "
                  f"{r['n_params'] / 1e6:.1f} M params "
                  f"a rank against {one['n_params'] / 1e6:.1f} M), batch 1 x "
                  f"seq {run['seq']} over model {p}, rank {r['rank']}: loss "
                  f"{r['loss']!r} against one device's {one['loss']!r} (rel "
                  f"{rel:.2e}); gradients over their largest magnitude "
                  + ", ".join(f"{k} {v:.2e}" for k, v in
                              sorted(r["grad_err"].items()))
                  + f"; fwd + bwd (first pass) {r['s']:.3f} s against "
                  f"{one['s']:.3f} (warm {one['s_warm']:.3f}); "
                  f"peak {r['peak_gib']:.2f} GiB against "
                  f"{one['peak_gib']:.2f}; launches {r['launches']} (one "
                  f"device {one['launches']}); table rotations "
                  f"{r['sent']['messages']} messages, "
                  f"{r['sent']['bytes'] / 1e9:.3f} GB staged through the host "
                  f"(all halo/ring messages staged {r['staged']}); logits "
                  f"never formed: the dense {r['dense_logit_bytes'] / 1e9:.2f}"
                  f" GB, a rank's largest chunk "
                  f"{r['chunk_bytes'] / 1e9:.3f} GB ({card})", flush=True)
        out["runs"].append({"arch": run["arch"], "cfg_name": cfg.name,
                            "layers": cfg.n_layers,
                            "seq": run["seq"], "one": one, "ranks": ranks})
    shutil.rmtree(VOCAB_DIR, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t0
    print(f"vocab-parallel phase ({len(rows)} attention rows, "
          f"{len(VOCAB_RUNS)} configs on one device and {VOCAB_MODEL} card "
          f"ranks) took {out['phase_s']:.1f} s of this run ({card})")
    return out


# ------------------------------------------------ mixture of experts (9) --

# full width: mixtral-8x7b cut to one SWA layer at batch 1 x seq 8192
# (1.71 B params: 1.41 B of experts), one device and MOE_MODEL gloo ranks
# with the sequence split and the experts over "model" (expert
# parallelism: 4 of 8 a rank); olmoe-1b-7b at full depth (16 layers, 64
# experts, top 8, 6.9 B params) served at batch 4 x prompt 256, 16
# generated tokens, and at 2 layers against the CPU; mamba2-780m at full
# depth trained at batch 1 x seq 2048.  The MoE params are drawn on the
# card from MOE_SEED (a CPU draw of olmoe would take minutes)
MOE_MODEL = 2
MIXTRAL = dataclasses.replace(mixtral_8x7b.CONFIG, n_layers=1)
MIXTRAL_SEQ = 8192
OLMOE = olmoe_1b_7b.CONFIG
MAMBA2 = mamba2_780m.CONFIG
MOE_SEED = 27
MOE_DIR = os.path.join(HERE, "build", "moe")
OLMOE_PROMPT, OLMOE_GEN = 256, 16
OLMOE_CHECK_LAYERS, OLMOE_CHECK_PROMPT, OLMOE_CHECK_GEN = 2, 4, 5
MAMBA2_SEQ = 2048
# routing is discrete: a token whose k-th and (k+1)-th router
# probabilities lie closer than this may pick the other expert under
# another order of summation (the card against the CPU, one device against
# two ranks); a routing decision that differs with a wider margin fails,
# and so do more than MOE_MAX_FLIPS admitted ones in one comparison (so
# that most of what is compared stays held: see `_flips`)
MOE_FLIP_MARGIN = 1e-5
MOE_MAX_FLIPS = 2
# the ranks' loss shares summed against the one-device loss: fp32 sums
# over 8192 tokens, the experts' products over other row counts (plus,
# where a routing decision differs, what its tokens' cross entropies
# differ by)
MOE_LOSS_RTOL = 1e-5
# each gradient (a rank's expert blocks, the others summed over the ranks)
# against the one-device one, over the latter's largest magnitude; and, as
# it, each token's final hidden state, where no routing decision of its
# group differs
MOE_GRAD_TOL = 1e-4
# olmoe at 2 layers, card against CPU: prefill logits and K/V, 8 decode
# steps' logits, over the largest magnitude (fp32 through 2 blocks of 64
# experts; the attention kernel against its plain version on the CPU)
MOE_CHECK_TOL = 1e-4
# the attention kernel at the shapes of phase 9's runs: mixtral (32 / 8
# heads, D 128, window 4096) on one device at 1 x 8192, where the window
# binds, and the ring's blocks of 4096 rows on the 2 ranks: the diagonal on
# both, the off-diagonal within the window on rank 1; olmoe's prefill (16 /
# 16 heads, D 128, causal) at 4 x 256, one call a layer
MIXTRAL_WINDOW = f"window {MIXTRAL.window}"
MOE_ATTN = [
    {"cfg": MIXTRAL, "s": MIXTRAL_SEQ, "mask": MIXTRAL_WINDOW,
     "window": MIXTRAL.window, "count": 1},
    {"cfg": MIXTRAL, "s": MIXTRAL_SEQ // MOE_MODEL, "delta": 0,
     "mask": f"{MIXTRAL_WINDOW} diagonal", "window": MIXTRAL.window,
     "count": MOE_MODEL},
    {"cfg": MIXTRAL, "s": MIXTRAL_SEQ // MOE_MODEL,
     "delta": MIXTRAL_SEQ // MOE_MODEL,
     "mask": f"{MIXTRAL_WINDOW} off-diagonal", "window": MIXTRAL.window,
     "count": 1},
    {"cfg": OLMOE, "b": SERVE_BATCH, "s": OLMOE_PROMPT, "mask": "causal",
     "window": None, "count": OLMOE.n_layers},
]


def moe_kernel_rows(card: str) -> list[dict]:
    """Phase 9's kernel rows: every MOE_ATTN case in f32 and bf16 (held
    and timed as phase 7's, SDPA the library call), printed."""
    gen = torch.Generator(device="cuda").manual_seed(MOE_SEED)
    rows = []
    for dt, c in itertools.product((torch.float32, torch.bfloat16),
                                   MOE_ATTN):
        rows.append(r := vocab_attention_row(c, dt, gen))
        print(f"{r['model']} attention {r['kernel']} {r['mask']} (delta "
              f"{r['delta']}), {r['dtype']}, q {r['q']} kv {r['kv']}, "
              f"{r['count']} a forward: {r['plan_str']}; max |err| "
              f"{r['max_abs_err']:.3e}"
              + ("" if r["lse_err"] is None else f", lse {r['lse_err']:.3e}")
              + ("" if r["max_err_over_elem_limit"] is None else
                 f", err/elem limit {r['max_err_over_elem_limit']:.3f}")
              + f"; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"SDPA {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, {r['pairs']} pairs), "
              f"{r['tflops_s']:.1f} TFLOP/s ({card})", flush=True)
    return rows


def _card_init(cfg, dev: torch.device, layers: int | None = None):
    """`cfg` (cut to `layers`) and its params drawn on the card from
    MOE_SEED: the same bits in every process."""
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg, transformer.init(torch.Generator(device=dev).manual_seed(
        MOE_SEED), cfg, device=dev)


@contextlib.contextmanager
def _observed(module, name: str, keep):
    """While open, `module.name` wrapped: each call's `keep(result,
    *args)` appended to the yielded list (the port calls it by its
    module's name, so every caller sees the wrapper)."""
    log, fn = [], getattr(module, name)

    def observed(*a, **k):
        out = fn(*a, **k)
        log.append(keep(out, *a))
        return out
    setattr(module, name, observed)
    try:
        yield log
    finally:
        setattr(module, name, fn)


def routes_logged():
    """Every MoE layer's `Routing` (`moe_route`'s, which `moe_apply`
    calls), in call order, its tensors left on their device."""
    return _observed(lm_modules, "moe_route", lambda r, *a: r)


def final_hidden_logged():
    """Each forward's final hidden state (after the final norm: what
    `transformer._logits` takes), detached."""
    return _observed(transformer, "_logits",
                     lambda out, params, cfg, x: x.detach())


def _routes(log: list) -> list[dict]:
    """Each logged layer's routing on the host: expert ids, kept mask,
    top-k margins and each token's routing group."""
    return [{"idx": r.idx.cpu(), "keep": r.keep.cpu(),
             "margin": r.margin.cpu(), "group": r.group.cpu()} for r in log]


def _flips(got: list[dict], want: list[dict], rows=slice(None),
           carry: str = "positions") -> dict:
    """Routing decisions of `got` (each logged layer's routing, in call
    order) that differ from `want`'s (its tokens `rows` of the sequence):
    tokens whose set of k experts differs (two of its experts trading
    places within the top k change nothing: each takes one slot of a
    different expert's buffer either way).  Such a token taints its whole
    routing group (the slots of the group's later pairs may move), and a
    taint is carried to the next entries: to every later position of its
    row ("positions": the next layers' attention), or to its whole row
    ("rows": a decode loop, whose caches carry it to every later step).
    A differing decision on a token that came in tainted is excused; every
    other counts, and must have a top-k margin below MOE_FLIP_MARGIN, at
    most MOE_MAX_FLIPS of them.  On the untainted tokens the kept experts
    must be equal.  Returns the count, the widest margin, the tokens
    tainted after the last entry and the rows tainted anywhere."""
    n, widest, taint = 0, 0.0, None
    for g, w in zip(got, want):
        idx, ref = g["idx"], w["idx"][:, rows]
        b, s, _ = idx.shape
        t_in = torch.zeros((b, s), dtype=torch.bool) if taint is None \
            else taint.expand(b, s)
        differ = (idx.sort(-1).values != ref.sort(-1).values).any(-1)
        new = differ & ~t_in
        n += int(new.sum())
        if new.any():
            widest = max(widest, float(w["margin"][:, rows][new].max()))
        hit = torch.zeros((b, int(g["group"].max()) + 1), dtype=torch.bool)
        bb, ss = differ.nonzero(as_tuple=True)
        hit[bb, g["group"][ss]] = True
        t_out = t_in | hit[:, g["group"]]
        kept = torch.where(g["keep"], idx, -1).sort(-1).values
        k_ref = torch.where(w["keep"][:, rows], ref, -1).sort(-1).values
        if ((kept != k_ref).any(-1) & ~t_out).any():
            raise AssertionError("the kept experts differ on a token whose "
                                 "routing group routes alike")
        taint = t_out.any(-1, keepdim=True) if carry == "rows" \
            else t_out.cumsum(-1) > 0
    if widest >= MOE_FLIP_MARGIN or n > MOE_MAX_FLIPS:
        raise AssertionError(f"{n} routing decisions differ (at most "
                             f"{MOE_MAX_FLIPS} admitted), the widest top-k "
                             f"margin {widest:.3e} (admitted below "
                             f"{MOE_FLIP_MARGIN})")
    return {"flips": n, "widest_margin": widest, "tainted": t_out,
            "rows": taint.reshape(b, -1).any(-1)}


@torch.no_grad()
def token_ce(params: dict, cfg, x: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """Each token's cross entropy (b, s) from its final hidden state x,
    as `transformer.loss_fn` forms the mean."""
    logits = transformer._logits(params, cfg, x).float()
    return torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, labels.long()[..., None])[..., 0]


def moe_dense_rank(rank: int, world: int) -> dict:
    """One device, in its own process: mixtral cut to one layer, the dense
    `loss_fn` at batch 1 x MIXTRAL_SEQ and its gradients (forward +
    backward timed on the host clock, synchronised: the first pass and a
    warm one), its routing; then the MoE layer's parts timed alone on the
    layer's own input (CUDA events, 5 calls each): the routing, the
    expert products on the dispatched buffers, and the whole layer
    forward.  Loss, gradients, routing, the final hidden states and each
    token's cross entropy saved under MOE_DIR."""
    dev = torch.device("cuda")
    cfg, params = _card_init(MIXTRAL, dev)
    batch = pipeline.to_device(pipeline.synthetic_lm_batch(
        0, 1, MIXTRAL_SEQ, cfg.vocab), dev)
    leaves = tree_leaves(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with routes_logged() as log, final_hidden_logged() as hidden:
        t0 = time.perf_counter()
        loss = transformer.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    routes = _routes(log)
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    torch.autograd.grad(transformer.loss_fn(params, batch, cfg), leaves)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    split = moe_time_split(params["layers"][0], cfg, batch, params)
    path = os.path.join(MOE_DIR, "mixtral.pt")
    torch.save({"loss": loss.item(), "routes": routes,
                "hidden": hidden[0].cpu(),
                "ce": token_ce(params, cfg, hidden[0], batch["labels"]).cpu(),
                "grads": tree_unflatten(params, iter(g.cpu() for g in
                                                     grads))}, path)
    drops = [int((~r["keep"]).sum()) for r in routes]
    return {"loss": loss.item(), "s": seconds, "s_warm": warm,
            "peak_gib": peak, "launches": launches, "path": path,
            "drops": drops, "split": split,
            "min_margin": min(float(r["margin"].min()) for r in routes),
            "n_params": sum(t.numel() for t in leaves)}


def moe_time_split(lp: dict, cfg, batch: dict, params: dict) -> dict:
    """The MoE layer's forward on its input in the one-device run (the
    layer's ln2 of the attention's residual), timed whole and in parts,
    ms a call (CUDA events, 5 calls after one warm): `moe_route`, the
    three expert products (`torch.bmm`) on buffers of the dispatched
    shape, and the rest of `moe_apply` (the index copy into the
    buffers, the index add out of them) as the difference."""
    with torch.no_grad():
        x = transformer._embed(params, cfg, batch["tokens"])
        h = lm_modules.norm_apply(cfg, lp["ln1"], x)
        pos = torch.arange(x.shape[1], device=x.device)
        x = x + lm_modules.attn_apply(lp["attn"], h, cfg=cfg, positions=pos,
                                      window=cfg.window)
        h = lm_modules.norm_apply(cfg, lp["ln2"], x)
        p = lp["moe"]
        r = lm_modules.moe_route(p["router"], h, cfg)
        nb = h.shape[0] * r.n_groups * r.cap
        xe = torch.randn((cfg.n_experts, nb, cfg.d_model), device=h.device)

        def experts():
            g = torch.bmm(xe, p["wi"])
            return torch.bmm(F.silu(torch.bmm(xe, p["wg"])) * g, p["wo"])
        out = {"route_ms": time_fn(lambda: lm_modules.moe_route(
                   p["router"], h, cfg), reps=5, warmup=1) * 1e3,
               "experts_ms": time_fn(experts, reps=5, warmup=1) * 1e3,
               "layer_ms": time_fn(lambda: lm_modules.moe_apply(p, h, cfg),
                                   reps=5, warmup=1) * 1e3,
               "buffer_rows": nb, "cap": r.cap, "groups": r.n_groups}
        out["dispatch_combine_ms"] = out["layer_ms"] - out["route_ms"] \
            - out["experts_ms"]
        # the bound over every buffer row (the empty slots too: what the
        # batched products do) and over the kept pairs' rows only (what
        # the layer needs)
        kept = int(r.keep.sum())
        w_bytes = 4.0 * 3 * cfg.n_experts * cfg.d_model * cfg.d_ff
        for key, rows in (("", cfg.n_experts * nb), ("kept_", kept)):
            flops = 2.0 * 3 * rows * cfg.d_model * cfg.d_ff
            out[f"experts_{key}gflop"] = flops / 1e9
            out[f"experts_{key}bound_ms"] = max(
                flops / PEAK_FLOPS[torch.float32],
                (w_bytes + 4.0 * 2 * rows * cfg.d_model) / PEAK_BYTES_S) * 1e3
        out["kept_pairs"] = kept
    return out


def moe_rank(rank: int, world: int) -> dict:
    """One of MOE_MODEL gloo ranks on the card (data 1 x model
    MOE_MODEL): mixtral's `loss_fn` on this rank's sequence block with its
    experts over "model" (`ShardCtx(tp_axis="model")`, the blocks of
    `shardings.expert_blocks`), forward + backward timed; the routing of
    its tokens against the one-device run's (`_flips`), the final hidden
    states of the tokens whose groups route alike against the one-device
    rows, and what the other tokens' cross entropies differ by (summed
    over the ranks: the room a differing decision gives the loss); the
    shares and the other gradients summed over the ranks, its expert
    blocks' gradients against the one-device rows; the bytes each
    all-to-all sent and one dispatch all-to-all timed alone."""
    dev = torch.device("cuda")
    mesh = make_mesh(data=1, model=world)
    ctx = ShardCtx(mesh=mesh, seq_axis="model", batch_axes=("data",),
                   tp_axis="model")
    cfg, params = _card_init(MIXTRAL, dev)
    blocks = shardings.expert_blocks(params, mesh)
    del params
    batch = pipeline.to_device(pipeline.shard_lm_batch(
        pipeline.synthetic_lm_batch(0, 1, MIXTRAL_SEQ, cfg.vocab), mesh,
        "model", ("data",)), dev)
    leaves = tree_leaves(blocks)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    collectives.reset_sent()
    halo.reset_staged()
    mesh.barrier()
    with routes_logged() as log, final_hidden_logged() as hidden:
        t0 = time.perf_counter()
        share = transformer.loss_fn(blocks, batch, cfg, ctx=ctx)
        grads = torch.autograd.grad(share, leaves)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    sent = dict(collectives.sent)
    staged = halo.staged
    routes = _routes(log)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = torch.load(os.path.join(MOE_DIR, "mixtral.pt"), mmap=True)
    s_local = MIXTRAL_SEQ // world
    i = mesh.index("model")
    mine = slice(i * s_local, (i + 1) * s_local)
    flips = _flips(routes, want["routes"], mine)
    # what no routing decision moved: the untainted tokens' final hidden
    # states; and the loss, up to what the tainted tokens' cross
    # entropies differ by
    clean = ~flips["tainted"]
    x, x_ref = hidden[0].cpu(), want["hidden"][:, mine]
    hidden_err = float((x - x_ref)[clean].abs().max()) / float(
        x_ref[clean].abs().max())
    ce = token_ce(blocks, cfg, hidden[0], batch["labels"]).cpu()
    moved = float(mesh.all_reduce(torch.tensor(
        float((ce - want["ce"][:, mine])[~clean].abs().sum())
        / MIXTRAL_SEQ, dtype=torch.float64), "model"))
    del hidden, x, x_ref
    gtree = tree_unflatten(blocks, iter(grads))
    loss = float(mesh.all_reduce(share.detach(), "model"))
    errs = {}
    experts = {id(lp["moe"][n]) for lp in gtree["layers"]
               for n in shardings.EXPERT_LEAVES}
    e_loc = cfg.n_experts // world
    for (path, g), w in zip(_leaf_paths(gtree), tree_leaves(want["grads"])):
        if id(g) in experts:
            w = w[i * e_loc:(i + 1) * e_loc]
        else:
            g = mesh.all_reduce(g, "model")
        w = w.to(dev)
        errs[path] = _grad_err(g, w, float(w.abs().max()))
    xe = torch.randn((cfg.n_experts, sent_rows(cfg, s_local), cfg.d_model),
                     device=dev)
    a2a = []
    for _ in range(3):
        mesh.barrier()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        collectives.all_to_all(xe, mesh, "model", 0, 1)
        torch.cuda.synchronize()
        a2a.append(time.perf_counter() - t1)
    return {"rank": rank, "share": share.item(), "loss": loss,
            "want_loss": want["loss"], "s": seconds, "peak_gib": peak,
            "launches": launches, "sent": sent, "staged": staged,
            "grad_err": errs, "hidden_err": hidden_err,
            "ce_moved": moved, "held_tokens": int(clean.sum()),
            "flips": {k: flips[k] for k in ("flips", "widest_margin")},
            "drops": [int((~r["keep"]).sum()) for r in routes],
            "a2a_ms": [t * 1e3 for t in a2a],
            "a2a_bytes": xe.numel() * 4 * (world - 1) // world,
            "n_params": sum(t.numel() for t in leaves)}


def sent_rows(cfg, s_local: int, b: int = 1) -> int:
    """Rows of one expert's dispatch buffer on a rank: b x its groups x
    the capacity."""
    gs = min(s_local * MOE_MODEL, lm_modules.MOE_GROUP)
    cap = max(1, int(cfg.capacity_factor * cfg.top_k * gs / cfg.n_experts))
    return b * (s_local // gs) * cap


def _leaf_paths(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, leaf) in `tree_leaves` order; the path's head names the
    group an error is reported under (embed, layers.attn, layers.moe,
    ...)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _leaf_paths(tree[k], f"{prefix}.{k}" if prefix
                                      else k)]
    if isinstance(tree, (list, tuple)):
        return [pl for t in tree for pl in _leaf_paths(t, prefix)]
    return [(prefix, tree)]


def olmoe_serve_rank(rank: int, world: int, card: str) -> dict:
    """A fresh process: full-width olmoe-1b-7b at full depth through the
    serve entry point (`launch.serve`, batch 4, prompt OLMOE_PROMPT,
    OLMOE_GEN generated tokens; params drawn on the card) with no kernel
    launch in the decode loop, then `transformer.prefill` of the same
    prompt on the kernels (16 attention launches), timed, with each
    layer's dropped (token, choice) pairs; then cut to OLMOE_CHECK_LAYERS
    layers, the card against the CPU on the same params: prefill's last
    logits and K/V and OLMOE_CHECK_GEN + OLMOE_CHECK_PROMPT - 1 decode
    steps' logits and ids."""
    dev = torch.device("cuda")
    draw = transformer.init

    def on_card(gen, cfg, *, device):
        return draw(torch.Generator(device=dev).manual_seed(
            gen.initial_seed()), cfg, device=device)
    transformer.init = on_card
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with routes_logged() as steps:
        res = serve.run(serve.parse_args(
            ["--arch", "olmoe-1b-7b", "--batch", str(SERVE_BATCH),
             "--prompt-len", str(OLMOE_PROMPT), "--gen", str(OLMOE_GEN),
             "--seed", str(MOE_SEED), "--device", "cuda"]))
    transformer.init = draw
    decode_launches = ops.launch_counts()
    if any(decode_launches.values()):
        raise AssertionError(f"olmoe decode loop launched kernels: "
                             f"{decode_launches}")
    cfg, params = res["cfg"], res["params"]
    tokens = torch.as_tensor(res["prompts"], device=dev)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    transformer.prefill(params, cfg, tokens)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    ops.reset_launch_counts()
    with routes_logged() as log:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = transformer.prefill(params, cfg, tokens)[0]
        torch.cuda.synchronize()
        prefill_warm_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = ops.launch_counts()
    routes = _routes(log)
    peak = torch.cuda.max_memory_allocated() / 2**30
    gen_ms = res["step_ms"][OLMOE_PROMPT - 1:]
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    # the bytes a generation step needs: every weight but the experts',
    # and of each layer's experts those its 4 tokens route to (at most 4
    # x top-k of 64), the step's own routing
    expert_bytes = sum(params["layers"][0]["moe"][n][0].numel() * 4
                       for n in shardings.EXPERT_LEAVES)
    routed = [len(r.idx.unique()) for r in
              steps[(OLMOE_PROMPT - 1) * cfg.n_layers:]]
    gen_bytes = [weight_bytes - cfg.n_layers * cfg.n_experts * expert_bytes
                 + expert_bytes * sum(routed[j:j + cfg.n_layers])
                 for j in range(0, len(routed), cfg.n_layers)]
    del steps
    replay_ms = res["step_ms"][:OLMOE_PROMPT - 1]
    first = res["ids"][0].tolist()
    del params, res, last
    torch.cuda.empty_cache()
    check = olmoe_cpu_check(dev)
    return {"prefill_ms": prefill_ms, "prefill_warm_ms": prefill_warm_ms,
            "prefill_launches": prefill_launches,
            "drops": [int((~r["keep"]).sum()) for r in routes],
            "pairs": SERVE_BATCH * OLMOE_PROMPT * cfg.top_k,
            "cap": max(1, int(cfg.capacity_factor * cfg.top_k
                              * min(OLMOE_PROMPT, lm_modules.MOE_GROUP)
                              / cfg.n_experts)),
            "min_margin": min(float(r["margin"].min()) for r in routes),
            "decode_ms": float(np.median(gen_ms)),
            "replay_ms": float(np.median(replay_ms)),
            "weight_bytes": weight_bytes,
            "bound_ms": weight_bytes / PEAK_BYTES_S * 1e3,
            "routed_experts": [min(routed), max(routed)],
            "routed_bound_ms": float(np.median(gen_bytes)) / PEAK_BYTES_S
            * 1e3,
            "peak_gib": peak, "ids_row0": first, "check": check}


def olmoe_cpu_check(dev: torch.device) -> dict:
    """olmoe cut to OLMOE_CHECK_LAYERS layers, params drawn on the card
    and copied to the CPU: prefill of the serve prompt (batch 4 x
    OLMOE_PROMPT) on the card (kernels) and the CPU (plain versions) --
    last logits, every layer's K/V, the routing -- then the decode loop on
    both: every step's logits and the ids.  Each comparison is held on
    the batch rows where no routing decision differs (`_flips`: a group
    is a whole row here; at most MOE_MAX_FLIPS decisions, each below
    MOE_FLIP_MARGIN, may differ, so at least 2 of the 4 rows are held)."""
    cfg, params = _card_init(OLMOE, dev, OLMOE_CHECK_LAYERS)
    cpu = tree_map(lambda t: t.detach().cpu(), params)
    prompts = serve.prompts_for(cfg, SERVE_BATCH, OLMOE_PROMPT, MOE_SEED)
    short = prompts[:, :OLMOE_CHECK_PROMPT]
    got = {}
    for name, p, d in (("card", params, dev), ("cpu", cpu, "cpu")):
        with routes_logged() as log:
            last, kv = transformer.prefill(p, cfg, torch.as_tensor(
                prompts, device=d))
        with routes_logged() as steps:
            run = _decode_run(cfg, p, short, OLMOE_CHECK_GEN, d)
        got[name] = {"last": last.cpu(),
                     "kv": [tuple(t.cpu() for t in l) for l in kv],
                     "routes": _routes(log), "steps": _routes(steps),
                     "run": run}
    card, host = got["card"], got["cpu"]
    out = {"flips": _flips(card["routes"], host["routes"], carry="rows"),
           "decode_flips": _flips(card["steps"], host["steps"],
                                  carry="rows")}
    held = ~out["flips"].pop("rows")
    held_dec = ~out["decode_flips"].pop("rows")
    for f in (out["flips"], out["decode_flips"]):
        del f["tainted"]
    out["held_rows"] = [int(held.sum()), int(held_dec.sum())]
    out["prefill_logits"] = _rel_err(card["last"][held], host["last"][held])
    out["prefill_kv"] = max(_rel_err(a[held], b[held]) for la, lb in
                            zip(card["kv"], host["kv"])
                            for a, b in zip(la, lb))
    out["decode_logits"] = _rel_err(card["run"]["logits"][:, held_dec],
                                    host["run"]["logits"][:, held_dec])
    out["ids_equal"] = bool(torch.equal(card["run"]["ids"][held_dec],
                                        host["run"]["ids"][held_dec]))
    out["steps"] = card["run"]["logits"].shape[0]
    bad = [k for k in ("prefill_logits", "prefill_kv", "decode_logits")
           if not out[k] <= MOE_CHECK_TOL]
    if bad or not out["ids_equal"] or not (held.any() and held_dec.any()):
        raise AssertionError(f"olmoe {OLMOE_CHECK_LAYERS} layers, card "
                             f"against CPU: {out} (tol {MOE_CHECK_TOL})")
    return out


def mamba2_train_phase(card: str) -> dict:
    """Full-width mamba2-780m at full depth (48 SSD layers) through the
    trainer's own entry, FP32, batch 1 x MAMBA2_SEQ, 3 steps: finite
    losses, 48 x 3 SSD-chunk launches, no attention."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = train_cli.main(["--arch", "mamba2-780m", "--batch", "1", "--seq",
                          str(MAMBA2_SEQ), "--steps", str(STEPS),
                          "--device", "cuda", "--log-every", "1"])
    counts = ops.launch_counts()
    want = {"conv2d": 0, "flash_attention": 0,
            "ssd_chunk": MAMBA2.n_layers * STEPS}
    if not all(math.isfinite(l) for l in res["losses"]) or counts != want:
        raise AssertionError(f"mamba2 train: losses {res['losses']}, "
                             f"launches {counts} (want {want})")
    steady = res["step_s"][1:]
    out = {"losses": res["losses"], "step_s": res["step_s"],
           "steady_step_s": sum(steady) / len(steady),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": counts, "n_params": res["n_params"]}
    print(f"mamba2-780m train: full width and depth ({MAMBA2.n_layers} SSD "
          f"layers, {out['n_params'] / 1e9:.3f} B params, FP32), batch 1 x "
          f"seq {MAMBA2_SEQ}, {STEPS} steps: losses {res['losses']}, step "
          f"seconds {res['step_s']}, {out['steady_step_s']:.4f} s a step "
          f"after the first, peak {out['peak_gib']:.2f} GiB, launches "
          f"{counts} ({card})", flush=True)
    return out


def moe_phase(card: str) -> dict:
    """Phase 9, mixture of experts: the attention kernel's rows at
    mixtral's and olmoe's shapes (`moe_kernel_rows`); mixtral cut to one
    layer, the one-device loss and gradients in a process of its own,
    then MOE_MODEL gloo ranks sharing the card (not a scaling result)
    with the sequence split and the experts over "model"; olmoe through
    the serve entry point in a fresh process; mamba2 through the
    trainer's entry.  Held on the ranks: the routing against one device's
    (`_flips`), the final hidden states of the tokens whose groups route
    alike within MOE_GRAD_TOL of the largest magnitude, the summed shares
    within MOE_LOSS_RTOL of the one-device loss plus what the other
    tokens' cross entropies moved, every gradient within MOE_GRAD_TOL of
    its largest magnitude (where no routing decision differs), the
    attention launches a rank as the ring derives them, the all-to-all
    bytes a rank."""
    from repro_torch.core.ring_attention import ring_steps
    t0 = time.perf_counter()
    rows = moe_kernel_rows(card)
    shutil.rmtree(MOE_DIR, ignore_errors=True)
    os.makedirs(MOE_DIR)
    cfg = MIXTRAL
    one = spawn_ranks(moe_dense_rank, 1)[0]
    ranks = spawn_ranks(moe_rank, MOE_MODEL)
    shutil.rmtree(MOE_DIR, ignore_errors=True)
    if one["launches"] != {"conv2d": 0, "flash_attention": cfg.n_layers,
                           "ssd_chunk": 0}:
        raise AssertionError(f"mixtral one device: launches "
                             f"{one['launches']}")
    s_local = MIXTRAL_SEQ // MOE_MODEL
    half = cfg.n_experts * sent_rows(cfg, s_local) * cfg.d_model * 4 \
        * (MOE_MODEL - 1) // MOE_MODEL
    for r in ranks:
        rel = abs(r["loss"] - one["loss"]) / abs(one["loss"])
        r["loss_rel"] = rel
        # a differing routing decision may move the loss by what its
        # group's cross entropies moved, and every gradient (its tokens'
        # backward reaches every leaf): the gradients are held where none
        # differs
        limit = MOE_LOSS_RTOL + r["ce_moved"] / abs(one["loss"])
        blocks = cfg.n_layers * min(r["rank"] + 1, ring_steps(
            MOE_MODEL, s_local, cfg.window))
        want = {"conv2d": 0, "flash_attention": blocks, "ssd_chunk": 0}
        sent = {k: r["sent"].get(k) for k in ("moe_dispatch", "moe_combine")}
        exact = r["flips"]["flips"] == 0
        if not (r["launches"] == want and all(
                v == 2 * cfg.n_layers * half for v in sent.values()) and
                rel <= limit and r["hidden_err"] <= MOE_GRAD_TOL and
                (not exact or max(r["grad_err"].values()) <= MOE_GRAD_TOL)):
            raise AssertionError(
                f"mixtral rank {r['rank']}: loss {r['loss']!r} against one "
                f"device's {one['loss']!r} (rel {rel:.2e}, limit "
                f"{limit:.2e}); final hidden states {r['hidden_err']:.2e} "
                f"on {r['held_tokens']} tokens (tol {MOE_GRAD_TOL}); "
                f"gradients {r['grad_err']} (tol {MOE_GRAD_TOL}, held where "
                f"no routing decision differs); routing {r['flips']}; "
                f"launches {r['launches']} (want {want}); all-to-all bytes "
                f"{sent} (want {2 * cfg.n_layers * half} each)")
        print(f"expert-parallel mixtral-8x7b (1 layer, full width, "
              f"{r['n_params'] / 1e6:.1f} M params a rank against "
              f"{one['n_params'] / 1e6:.1f} M), batch 1 x seq {MIXTRAL_SEQ} "
              f"over model {MOE_MODEL}, {cfg.n_experts // MOE_MODEL} experts "
              f"a rank, rank {r['rank']}: loss {r['loss']!r} against one "
              f"device's {one['loss']!r} (rel {rel:.2e}, limit "
              f"{limit:.2e}); routing {r['flips']['flips']} decisions "
              f"differ; final hidden states {r['hidden_err']:.2e} of the "
              f"largest magnitude on the {r['held_tokens']} tokens whose "
              f"groups route alike; dropped pairs "
              f"{r['drops']} (one device {one['drops']}); gradients over "
              f"their largest magnitude "
              + ", ".join(f"{k} {v:.2e}" for k, v in
                          sorted(r["grad_err"].items()))
              + f"; fwd + bwd (first pass) {r['s']:.3f} s against "
              f"{one['s']:.3f} (warm {one['s_warm']:.3f}); peak "
              f"{r['peak_gib']:.2f} GiB against {one['peak_gib']:.2f}; "
              f"attention launches {r['launches']['flash_attention']} (the "
              f"ring derives {blocks}); all-to-all {sent} bytes sent, "
              f"staged through the host; one dispatch all-to-all of "
              f"{r['a2a_bytes'] / 1e6:.1f} MB sent alone "
              + ", ".join(f"{t:.1f}" for t in r["a2a_ms"])
              + f" ms (gloo, one card: not a scaling result) ({card})",
              flush=True)
    sp = one["split"]
    print(f"mixtral MoE layer forward, one device, batch 1 x seq "
          f"{MIXTRAL_SEQ} ({sp['groups']} groups, cap {sp['cap']}, "
          f"{sp['buffer_rows']} buffer rows an expert): layer "
          f"{sp['layer_ms']:.3f} ms = routing {sp['route_ms']:.3f} + expert "
          f"products {sp['experts_ms']:.3f} ({sp['experts_gflop']:.1f} "
          f"GFLOP over every buffer row, bound {sp['experts_bound_ms']:.3f}; "
          f"over the {sp['kept_pairs']} kept pairs' rows "
          f"{sp['experts_kept_gflop']:.1f} GFLOP, bound "
          f"{sp['experts_kept_bound_ms']:.3f}) + dispatch and "
          f"combine {sp['dispatch_combine_ms']:.3f} ms; smallest top-k "
          f"margin {one['min_margin']:.3e} ({card})", flush=True)
    served = spawn_ranks(olmoe_serve_rank, 1, card)[0]
    ch = served["check"]
    if served["prefill_launches"] != {"conv2d": 0, "flash_attention":
                                      OLMOE.n_layers, "ssd_chunk": 0}:
        raise AssertionError(f"olmoe prefill launches "
                             f"{served['prefill_launches']}")
    print(f"serve olmoe-1b-7b: full width and depth ({OLMOE.n_layers} "
          f"layers, {OLMOE.n_experts} experts, top {OLMOE.top_k}, "
          f"{served['weight_bytes'] / 4e9:.3f} B params, FP32, drawn on "
          f"the card), batch {SERVE_BATCH}, prompt {OLMOE_PROMPT}, gen "
          f"{OLMOE_GEN}: prefill {served['prefill_ms']:.2f} ms (warm "
          f"{served['prefill_warm_ms']:.2f}), launches "
          f"{served['prefill_launches']} (not held against the replay: the "
          f"replay routes each token alone and drops nothing); dropped "
          f"(token, choice) pairs a "
          f"layer {served['drops']} of {served['pairs']} (cap "
          f"{served['cap']}); decode {served['decode_ms']:.3f} ms/step "
          f"median of {OLMOE_GEN} generation steps (replay "
          f"{served['replay_ms']:.3f}), bytes bound "
          f"{served['bound_ms']:.3f} ms (every weight read once: the "
          f"batched expert products read all {OLMOE.n_experts} experts), "
          f"{served['routed_bound_ms']:.3f} ms over the experts each step "
          f"routes to ({served['routed_experts'][0]}-"
          f"{served['routed_experts'][1]} a layer, median of the steps); "
          f"peak {served['peak_gib']:.2f} GiB; ids of row 0 "
          f"{served['ids_row0']} ({card})", flush=True)
    print(f"serve olmoe card vs cpu, {OLMOE_CHECK_LAYERS} layers, batch "
          f"{SERVE_BATCH}: prefill logits {ch['prefill_logits']:.3e}, K/V "
          f"{ch['prefill_kv']:.3e}, {ch['steps']} decode steps' logits "
          f"{ch['decode_logits']:.3e} of the largest magnitude (tol "
          f"{MOE_CHECK_TOL}), ids equal {ch['ids_equal']}, routing "
          f"{ch['flips']['flips']} prefill and "
          f"{ch['decode_flips']['flips']} decode decisions differ (held on "
          f"{ch['held_rows'][0]} and {ch['held_rows'][1]} of "
          f"{SERVE_BATCH} rows) ({card})", flush=True)
    mamba = mamba2_train_phase(card)
    out = {"kernel_rows": rows, "one": one, "ranks": ranks,
           "olmoe": served, "mamba2": mamba,
           "phase_s": time.perf_counter() - t0}
    print(f"mixture-of-experts phase ({len(rows)} attention rows, mixtral "
          f"on one device and {MOE_MODEL} card ranks, olmoe served, mamba2 "
          f"trained) took {out['phase_s']:.1f} s of this run ({card})")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    shutil.rmtree(PARAMS_DIR, ignore_errors=True)
    t_start = t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f}s")
    resources = [line for name, path in sorted(libs.items())
                 for line in ptxas_resources(
                     name, path.with_suffix(".log").read_text())]
    # the bf16 conv and attention paths must run on the tensor cores'
    # wgmma, the bf16 SSD path on their mma.sync
    hgmma = {name: sass_count(libs[name], "HGMMA")
             for name in ("conv2d", "flash_attention")}
    hgmma["ssd"] = sass_count(libs["ssd"], "HMMA")
    for name, n in hgmma.items():
        op = "HMMA" if name == "ssd" else "HGMMA"
        print(f"{name} library: {n} {op} instructions in its SASS")
        if n == 0:
            raise AssertionError(f"no {op} in the {name} library: its "
                                 f"bf16 path does not use the tensor "
                                 f"cores")

    rows = kernel_phase(card)
    lm_rows = lm_kernel_phase(card)
    train = train_phase()
    fwd = forward_check()
    breakdown = profile_phase()
    t_spatial = time.perf_counter()
    interior = interior_copy_phase(card)
    spatial = spatial_phase(card)
    spatial["phase_s"] = time.perf_counter() - t_spatial
    print(f"spatial phases (interior copy, 2 and 4 spawned ranks) took "
          f"{spatial['phase_s']:.1f} s of this run ({card})")
    t_auto = time.perf_counter()
    auto = auto_phase(card)
    auto["phase_s"] = time.perf_counter() - t_auto
    print(f"auto-plan phase (2 card ranks, 2 CPU ranks) took "
          f"{auto['phase_s']:.1f} s of this run ({card})")
    t_resnet = time.perf_counter()
    print(f"resnet50 conv shapes, batch {RESNET_BATCH}: kernel vs plain "
          f"(and element by element within {RESNET_ELEM_TOL[torch.float32]} "
          f"/ {RESNET_ELEM_TOL[torch.bfloat16]} (1 + |plain|)), plan "
          f"(path, tile, k step, K splits, C/F after padding), times:")
    resnet_rows = kernel_phase(card, resnet_conv_shapes(RESNET, RESNET_BATCH),
                               RESNET_ELEM_TOL)
    for dt in ("float32", "bfloat16"):
        sel = [r for r in resnet_rows if r["dtype"] == dt]
        tot = {k: sum(r[k] * r["count"] for r in sel)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                         "gflops")}
        print(f"resnet50 conv, one forward ({sum(r['count'] for r in sel)} "
              f"calls, {tot['gflops']:.2f} GFLOP) {dt}: kernel "
              f"{tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, "
              f"F.conv2d {tot['library_ms']:.3f} ms, bound "
              f"{tot['bound_ms']:.3f} ms ({card})")
    resnet_train = resnet_train_phase(card)
    resnet_fwd = resnet_forward_check(card)
    resnet_breakdown = resnet_profile_phase(card)
    resnet_auto = resnet_auto_phase(card)
    resnet_s = time.perf_counter() - t_resnet
    print(f"resnet50 phases (conv rows, train, forward check, breakdown, "
          f"2-rank auto plan) took {resnet_s:.1f} s of this run ({card})")
    t_calib = time.perf_counter()
    calib = calibrate_phase(card)
    calib["phase_s"] = time.perf_counter() - t_calib
    print(f"calibrate-solve-profile phase (2 card ranks, 2 CPU ranks, the "
          f"resnet50 table) took {calib['phase_s']:.1f} s of this run "
          f"({card})")
    t_res = time.perf_counter()
    resume = ckpt_resume_phase(card)
    overhead = ckpt_overhead_phase(card)
    elastic = elastic_phase(card)
    resilient_s = time.perf_counter() - t_res
    print(f"resilient-training phases (ResNet-50 resume and rollback, "
          f"checkpoint overhead, 4 -> 2 elastic ranks) took "
          f"{resilient_s:.1f} s of this run ({card})")
    audit = audit_phase(card)
    zero = zero_phase(card)
    lm_train = zero["plain"]           # the FP32 hymba run, without --remat
    lm_train_bf16 = lm_train_phase(bf16=True)
    lm_fwd = lm_forward_check()
    lm_breakdown = lm_profile_phase()
    served = serve_phase(card)
    meshed = lm_mesh_phase(card, lm_train, served)
    shutil.rmtree(PARAMS_DIR, ignore_errors=True)   # the last draw kept
    vocab = vocab_phase(card)
    moe = moe_phase(card)

    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump({"card": card, "shapes": rows, "lm_shapes": lm_rows,
                   "train": train, "forward_check": fwd,
                   "step_breakdown": breakdown,
                   "interior_copy": interior, "spatial": spatial,
                   "auto": auto,
                   "resnet50": {"shapes": resnet_rows,
                                "train": resnet_train,
                                "forward_check": resnet_fwd,
                                "step_breakdown": resnet_breakdown,
                                "auto": resnet_auto, "phase_s": resnet_s},
                   "calibrate": calib,
                   "ckpt_resume": resume, "ckpt_overhead": overhead,
                   "elastic": elastic, "resilient_phase_s": resilient_s,
                   "audit": audit, "zero": zero,
                   "lm_train": lm_train,
                   "lm_train_bf16": lm_train_bf16,
                   "lm_forward_check": lm_fwd,
                   "lm_step_breakdown": lm_breakdown,
                   "serve": served, "lm_mesh": meshed, "vocab": vocab,
                   "moe": moe,
                   "hgmma": hgmma, "resources": resources}, f,
                  indent=1)

    # the kernels line: each kernel's numbers over one forward of its model
    # in float32 (bf16 beside), each shape's times the calls that make it
    def entry(name, source, replaces, launches, rs, scope):
        rs = [r for r in rs if r["count"]]
        f32 = [r for r in rs if r["dtype"] == "float32"]
        bf16 = [r for r in rs if r["dtype"] == "bfloat16"]

        def total(sel, key):
            if any(r[key] is None for r in sel):
                return None
            return sum(r[key] * r["count"] for r in sel)

        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in f32),
            "ms": total(f32, "ms"), "plain_ms": total(f32, "plain_ms"),
            "bound_ms": total(f32, "bound_ms"),
            "bound_by": "operations" if total(f32, "ops_ms")
            >= total(f32, "bytes_ms") else "bytes",
            "library_ms": total(f32, "library_ms"), "scope": scope,
            "bf16": {"max_abs_err": max(r["max_abs_err"] for r in bf16),
                     "ms": total(bf16, "ms"),
                     "plain_ms": total(bf16, "plain_ms"),
                     "bound_ms": total(bf16, "bound_ms"),
                     "library_ms": total(bf16, "library_ms")},
        }

    def serve_launches(name):
        """The kernel's launches in each arch's prefill (the decode loop's
        are 0: asserted in the phase)."""
        return {f"{arch} prefill": served[arch]["prefill_launches"][name]
                for arch in SERVE_CFG}

    def serve_prefill(name):
        """The kernel's times over one prefill's calls (batch 4 x the
        prompt, float32), per arch that runs it."""
        out = {}
        for arch in SERVE_CFG:
            sel = [r for r in served["kernel_rows"]
                   if r["kernel"] == name and r["model"] == arch]
            if sel:
                out[arch] = {k: None if any(r[k] is None for r in sel) else
                             sum(r[k] * r["count"] for r in sel)
                             for k in ("ms", "plain_ms", "bound_ms",
                                       "library_ms")}
                out[arch]["max_abs_err"] = max(r["max_abs_err"] for r in sel)
        return out

    def mesh_launches(name):
        """The kernel's launches a rank on the 2-rank mesh: the sharded
        prefill's and the --remat training run's."""
        return [{"prefill": r["prefill_launches"][name],
                 "train": r["train_launches"][name]}
                for r in meshed["ranks"]]

    def ring_block():
        """The block call's numbers over one forward's ring tiles on the
        2-rank mesh (both ranks), float32 (bf16 beside)."""
        out = {"scope": f"one hymba-1.5b forward ({HYMBA.n_layers} layers) "
                        f"on {MESH_MODEL} ranks, "
                        f"{MESH_S} rows a block: " + ", ".join(
                            f"{c['count']} {c['mask']}" for c in MESH_BLOCKS)}
        for dt in ("float32", "bfloat16"):
            sel = [r for r in meshed["block_rows"] if r["dtype"] == dt]
            out[dt] = {k: sum(r[k] * r["count"] for r in sel)
                       for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
            out[dt]["max_abs_err"] = max(r["max_abs_err"] for r in sel)
        return out

    def vocab_rows():
        """The kernel on phase 7's runs, per config: its rows' times the
        calls of one forward, summed, one device and the ring's blocks on
        VOCAB_MODEL ranks apart (f32, bf16 beside); the rows no run
        launches (count 0) each on its own; the phase's launches (one
        device, then a rank each)."""
        rows = vocab["kernel_rows"]
        keys = ("ms", "plain_ms", "library_ms", "bound_ms")
        out = {}
        for run in vocab["runs"]:
            name = run["cfg_name"]
            sel = [r for r in rows if r["model"] == name]
            cut = f"{run['arch']} cut to {run['layers']} layer" \
                f"{'s' * (run['layers'] > 1)}"
            out[run["arch"]] = o = {
                "library": sel[0]["library"],
                "one_device_scope": f"one {cut} forward, batch 1 x seq "
                                    f"{run['seq']}: " + ", ".join(
                    f"{r['count']} {r['mask']}" for r in sel
                    if r["kernel"] == "flash_attention" and r["count"]
                    and r["dtype"] == "float32"),
                "ring_scope": f"one {cut} forward on {VOCAB_MODEL} ranks, "
                              f"{run['seq'] // VOCAB_MODEL} rows a block: "
                              + ", ".join(
                    f"{r['count']} {r['mask']}" for r in sel
                    if r["kernel"] == "flash_attention_block"
                    and r["dtype"] == "float32"),
                "launches": [run["one"]["launches"]["flash_attention"]] + [
                    r["launches"]["flash_attention"] for r in run["ranks"]],
                "not_launched": [
                    {k: r[k] for k in ("mask", "dtype", "q", "max_abs_err")
                     + keys + ("bound_by",)}
                    for r in sel if not r["count"]]}
            for dt in ("float32", "bfloat16"):
                for part, kernel in (("one_device", "flash_attention"),
                                     ("ring", "flash_attention_block")):
                    cs = [r for r in sel if r["kernel"] == kernel
                          and r["dtype"] == dt and r["count"]]
                    o.setdefault(dt, {})[part] = dict(
                        {k: sum(r[k] * r["count"] for r in cs)
                         for k in keys},
                        max_abs_err=max(r["max_abs_err"] for r in cs))
        return out

    def moe_rows():
        """The kernel on phase 9's runs: mixtral's one-device call and its
        ring blocks on MOE_MODEL ranks, olmoe's prefill calls, each part's
        rows times the calls of one forward, summed (f32, bf16 beside);
        the launches of each run (mixtral one device, then a rank each;
        olmoe's prefill)."""
        rows = moe["kernel_rows"]
        keys = ("ms", "plain_ms", "library_ms", "bound_ms")
        out = {"library": "SDPA",
               "launches": {
                   "mixtral one device": moe["one"]["launches"][
                       "flash_attention"],
                   "mixtral ranks": [r["launches"]["flash_attention"]
                                     for r in moe["ranks"]],
                   "olmoe prefill": moe["olmoe"]["prefill_launches"][
                       "flash_attention"]}}
        parts = (("mixtral_one_device", MIXTRAL.name, "flash_attention"),
                 ("mixtral_ring", MIXTRAL.name, "flash_attention_block"),
                 ("olmoe_prefill", OLMOE.name, "flash_attention"))
        for part, model, kernel in parts:
            sel = [r for r in rows if r["model"] == model
                   and r["kernel"] == kernel]
            o = out[part] = {"scope": ", ".join(
                f"{r['count']} {r['mask']} at {r['q']}" for r in sel
                if r["dtype"] == "float32")}
            for dt in ("float32", "bfloat16"):
                cs = [r for r in sel if r["dtype"] == dt]
                o[dt] = dict({k: sum(r[k] * r["count"] for r in cs)
                              for k in keys},
                             max_abs_err=max(r["max_abs_err"] for r in cs))
        return out

    n_glob = sum(t == "hybrid_g" for t in HYMBA.layer_types())
    lm_scope = f"one hymba-1.5b forward ({HYMBA.n_layers} layers), batch " \
        f"{LM_BATCH} x seq {LM_SEQ}, float32: "
    kernels = [
        dict(entry("conv2d", "src/repro_torch/kernels/csrc/conv2d.cu",
                   "src/repro/kernels/conv2d.py:43", train["launches"], rows,
                   "one mesh1k forward, batch 2, float32: 19 conv calls"),
             spatial_launches_per_rank=[r["launches"]
                                        for r in spatial["ranks"]],
             auto_launches_per_rank=[r["launches"]
                                     for r in auto["ranks"]],
             calibrate_launches_per_rank=[r["cal_launches"]
                                          for r in calib["ranks"]],
             resume_launches=resume["resume_launches"],
             elastic_launches_per_rank=[[r["launches_before"],
                                         r["launches_after"]]
                                        for r in elastic["ranks"]],
             audit_launches_per_rank=[[r["uniform_h"]["launches"],
                                       r["auto"]["launches"]]
                                      for r in audit["ranks"]],
             zero_launches_per_rank=[[r[m]["launches"]
                                      for m in ZERO_METHODS]
                                     for r in zero["ranks"]],
             resnet50=dict(entry(
                 "conv2d", "src/repro_torch/kernels/csrc/conv2d.cu",
                 "src/repro/kernels/conv2d.py:43", resnet_train["launches"],
                 resnet_rows, f"one ResNet-50 forward, batch {RESNET_BATCH}, "
                 f"float32: {resnet_n_convs(RESNET)} conv calls at "
                 f"{len(resnet_rows) // 2} shapes"),
                 auto_launches_per_rank=[r["launches"] for r in
                                         resnet_auto["ranks"]])),
        dict(entry("flash_attention",
                   "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:77",
                   lm_train["launches"]["flash_attention"],
                   [r for r in lm_rows if r["kernel"] == "flash_attention"],
                   lm_scope + f"{n_glob} causal + "
                   f"{HYMBA.n_layers - n_glob} window-{HYMBA.window} "
                   f"calls"),
             remat_launches=zero["remat"]["launches"]["flash_attention"],
             serve_launches=serve_launches("flash_attention"),
             serve_prefill=serve_prefill("flash_attention"),
             mesh_launches_per_rank=mesh_launches("flash_attention"),
             ring_block=ring_block(), vocab=vocab_rows(), moe=moe_rows()),
        dict(entry("ssd_chunk", "src/repro_torch/kernels/csrc/ssd.cu",
                   "src/repro/kernels/ssd.py:55",
                   lm_train["launches"]["ssd_chunk"],
                   [r for r in lm_rows if r["kernel"] == "ssd_chunk"
                    and r["model"] == "hymba-1.5b"],
                   lm_scope + f"{HYMBA.n_layers} calls"),
             remat_launches=zero["remat"]["launches"]["ssd_chunk"],
             serve_launches=serve_launches("ssd_chunk"),
             serve_prefill=serve_prefill("ssd_chunk"),
             mesh_launches_per_rank=mesh_launches("ssd_chunk"),
             mamba2=dict(entry(
                 "ssd_chunk", "src/repro_torch/kernels/csrc/ssd.cu",
                 "src/repro/kernels/ssd.py:55",
                 moe["mamba2"]["launches"]["ssd_chunk"],
                 [r for r in lm_rows if r["kernel"] == "ssd_chunk"
                  and r["model"] == "mamba2-780m"],
                 f"one mamba2-780m forward, batch {LM_BATCH} x seq "
                 f"{LM_SEQ}, float32: {MAMBA2.n_layers} calls"))),
    ]
    print("kernel resources (ptxas):")
    print("\n".join(resources))
    print("; ".join(f"{name} library: {n} "
                    f"{'HMMA' if name == 'ssd' else 'HGMMA'} instructions "
                    f"in its SASS" for name, n in hgmma.items()))
    print(f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s of "
          f"this run, the build included ({card})")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
