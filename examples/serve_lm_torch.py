"""Batched LM serving on the port (PyTorch; the H100 by default) with a
sequence-sharded KV cache (the paper's spatial decomposition applied to
inference), the counterpart of examples/serve_lm.py: a batch of prompts
replayed a token a step through the decode path, then greedy decoding
with flash-decoding-style partial-softmax merges across the sequence
shards.

  PYTHONPATH=src python examples/serve_lm_torch.py [--device cuda|cpu]
  PYTHONPATH=src torchrun --nproc-per-node 8 examples/serve_lm_torch.py \\
      --device cpu

qwen1.5-0.5b SMOKE on a data 2 x model 4 mesh of 8 ranks, batch 2, a
16-token prompt, 12 generated tokens, the reference's prompts (numpy's
generator, seed 0).  Run alone, the script starts its 8 ranks itself
(`launch.mesh.spawn_local`: one gloo group over a FileStore); under
torchrun it joins the group it is given.  On the card the 8 ranks share
it over gloo (NCCL refuses two ranks on one card): a parity run, not a
scaling result.  Rank 0 alone prints.  The loop is `launch.serve`'s
(`run`, `generate`).  The params are `transformer.init`'s draw from seed
0 (the reference draws from `jax.random.PRNGKey(0)`; its tree carried
over by `transformer.params_from_jax` gives the reference's ids).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch.distributed as dist

from repro_torch.launch import serve
from repro_torch.launch.mesh import spawn_local
from repro_torch.utils import resolve_device

ARCH = "qwen1.5-0.5b"
DATA, MODEL = 2, 4
B, PROMPT, GEN = 2, 16, 12
MAXLEN = ((PROMPT + GEN + 3) // 4) * 4     # multiple of the seq shards


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def run(args: argparse.Namespace, params=None) -> dict:
    """This rank's part of the run (joining torchrun's group, or the one
    that exists); `params`: the port's param tree to serve, else the draw
    from seed 0.  Returns `launch.serve.run`'s dict."""
    sargs = serve.parse_args(
        ["--arch", ARCH, "--smoke", "--batch", str(B), "--prompt-len",
         str(PROMPT), "--gen", str(GEN), "--data", str(DATA), "--model",
         str(MODEL), "--seed", "0", "--device", args.device])
    if serve.cache_len(PROMPT, GEN, MODEL) != MAXLEN:
        raise AssertionError(f"cache of {serve.cache_len(PROMPT, GEN, MODEL)}"
                             f" positions, the reference's {MAXLEN}")
    # the empty sharded cache; the prompt replayed through the decode
    # path, then generated (bulk prefill, `transformer.prefill`, runs the
    # ring-attention kernels instead)
    res = serve.run(sargs, params=params)
    if dist.get_rank() == 0:
        print(f"served batch={B} on mesh {dict(res['mesh'].shape)} "
              f"(KV cache sharded over 'model')")
        print("generated ids:\n", np.asarray(res["ids"]))
    return res


def main(argv=None, params=None) -> dict | None:
    """Serve on the process group that exists (torchrun's, or a caller's)
    and return `run`'s dict; with none, start the DATA x MODEL ranks
    (`spawn_local`) and return None."""
    args = parse_args(argv)
    resolve_device(args.device)
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        return run(args, params)
    spawn_local(run, DATA * MODEL, args, params)
    return None


if __name__ == "__main__":
    main()
