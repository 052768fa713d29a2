"""Batched serving entry point, port of `repro.launch.serve`: replay the prompt
batch through the decode step, then greedy-decode with the
sequence-sharded KV cache (the paper's decomposition applied to
inference).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --smoke --batch 4 --prompt-len 32 --gen 16 [--device cuda|cpu]
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
      --arch hymba-1.5b --smoke --model 2 --device cpu

Runs on CUDA unless `--device cpu` is given; asking for CUDA where there
is none raises.  One process per rank under torchrun (NCCL on the card,
gloo on the CPU), `--data x --model` of them: the model axis splits the
KV cache along the sequence (`core.decode_attention`), the data axis
splits the batch.  Params are drawn from a CPU generator seeded with
`--seed` (`transformer.init`), so every rank and device starts from the
same weights; the prompts are the reference's (`np.random.default_rng`).

The loop is the reference's: a teacher-forced replay of the prompt, one
token a step, then greedy generation (`transformer.prefill` runs the
prompt through the kernels in one pass; the reference's server does not
seed the decode state with it).  Nothing in the loop copies to the host:
the next token is the argmax on the device, and each step's time is a
pair of CUDA events read after the loop (the host clock on the CPU).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.launch import shardings
from repro_torch.launch.mesh import batch_axes
from repro_torch.launch.train import arch_config, set_fp32_numerics, setup
from repro_torch.models.lm import transformer
from repro_torch.models.lm.modules import ShardCtx


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True,
                    help="an LM arch: " + ", ".join(registry.LM_ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.set_defaults(pod=1)         # the mesh is data x model (train.setup)
    args = ap.parse_args(argv)
    if registry.canon(args.arch) not in registry.LM_ARCHS:
        ap.error(f"--arch {args.arch}: serving takes an LM arch "
                 f"({', '.join(registry.LM_ARCHS)})")
    if args.prompt_len < 1 or args.gen < 1:
        ap.error("--prompt-len and --gen must be >= 1")
    if args.batch % args.data:
        ap.error(f"--batch {args.batch} must split over --data {args.data}")
    return args


def prompts_for(cfg, batch: int, prompt_len: int, seed: int) -> np.ndarray:
    """The reference's prompt batch: (batch, prompt_len) int32 ids in
    [1, vocab)."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab, (batch, prompt_len), dtype=np.int32)


def cache_len(prompt_len: int, gen: int, model: int) -> int:
    """The cache's length: prompt + generated tokens, padded to a multiple
    of the model axis (the sequence shards)."""
    return -(-(prompt_len + gen) // model) * model


@torch.no_grad()
def generate(params: dict, cfg, tokens: torch.Tensor, gen: int,
             caches: list, ctx: ShardCtx, keep=()) -> dict:
    """The serve loop on this rank's block of the batch: `tokens` (B,
    prompt_len) replayed one a step through `transformer.decode_step`,
    then `gen` greedy tokens.  Returns the generated ids (B, gen) on the
    device, the caches, each step's ms and the logits (B, V) of each step
    in `keep` (on the device)."""
    prompt_len = tokens.shape[1]
    steps = prompt_len + gen - 1
    cuda = tokens.is_cuda
    marks = [torch.cuda.Event(enable_timing=True) if cuda else None
             for _ in range(steps + 1)]
    clock = [0.0] * (steps + 1)
    kept, out = {}, []
    tok = tokens[:, :1]

    def mark(i):
        if cuda:
            marks[i].record()
        else:
            clock[i] = time.perf_counter()
    mark(0)
    for i in range(steps):
        logits, caches = transformer.decode_step(params, cfg, tok, caches, i,
                                                 ctx)
        if i in keep:
            kept[i] = logits[:, 0]
        if i + 1 < prompt_len:
            tok = tokens[:, i + 1:i + 2]
        else:
            tok = logits[:, -1:].argmax(-1)
            out.append(tok)
        mark(i + 1)
    if cuda:
        torch.cuda.synchronize()
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        step_ms = [(b - a) * 1e3 for a, b in zip(clock, clock[1:])]
    if not torch.isfinite(logits).all():
        raise FloatingPointError("the last decode step's logits are not "
                                 "finite")
    return {"ids": torch.cat(out, 1), "caches": caches, "step_ms": step_ms,
            "logits": kept}


def run(args: argparse.Namespace, keep=(), cfg=None) -> dict:
    """Serve one prompt batch as `args` say (the arch cut in depth where
    `cfg` says so: `train.arch_config`); rank 0 prints the summary and
    the generated ids.  Returns the run's cfg, params, prompts, the global
    ids (numpy, on every rank), this rank's caches and `generate`'s
    timings and kept logits."""
    device, mesh, rank = setup(args)
    set_fp32_numerics(device, echo=rank == 0)
    cfg = arch_config(args, cfg, echo=rank == 0)
    params = transformer.init(torch.Generator().manual_seed(args.seed), cfg,
                              device=device)
    max_len = cache_len(args.prompt_len, args.gen, args.model)
    prompts = prompts_for(cfg, args.batch, args.prompt_len, args.seed)
    split = args.data > 1
    ctx = ShardCtx(mesh=mesh, seq_axis="model" if args.model > 1 else None,
                   batch_axes=batch_axes(mesh) if split else ())
    rows = args.batch // args.data
    first = mesh.index(ctx.batch_axes) * rows if split else 0
    tokens = torch.as_tensor(prompts[first:first + rows], device=device)

    t0 = time.perf_counter()
    # this rank's block of the state: its rows, its shard of the sequence
    caches = transformer.init_decode_state(cfg, rows, max_len // args.model,
                                           device=device)
    specs = None if mesh is None else \
        shardings.kv_cache_specs(caches, mesh, split, "model")
    res = generate(params, cfg, tokens, args.gen, caches, ctx, keep)
    ids = res["ids"]
    if split:
        ids = mesh.all_gather(ids, ctx.batch_axes, 0)
    ids = ids.cpu().numpy()
    dt = time.perf_counter() - t0
    steps = args.prompt_len + args.gen - 1
    if rank == 0:
        shape = dict(mesh.shape) if mesh else {"data": 1, "model": 1}
        print(f"arch={cfg.name} mesh={shape} {steps} decode steps in "
              f"{dt:.1f}s ({dt / steps * 1e3:.1f} ms/step, eager, on "
              f"{device})")
        print("generated token ids:\n", ids)
    res.update(cfg=cfg, params=params, prompts=prompts, ids=ids, ctx=ctx,
               mesh=mesh, specs=specs, max_len=max_len, seconds=dt,
               device=device)
    return res


def main(argv=None, cfg=None) -> dict:
    return run(parse_args(argv), cfg=cfg)


if __name__ == "__main__":
    main()
