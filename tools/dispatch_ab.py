#!/usr/bin/env python3
"""What a kernel call costs on its way to the launch, on one card.

    python3 tools/dispatch_ab.py

Needs one CUDA card and `nvcc`.  For each kernel at a small shape (the
call bound by the host) and at a shape of the main path, it times four
ways to the same launch on the same inputs:

- `launch`: the ctypes launch function itself, called directly (what the
  kernel modules called before the launch became an operator);
- `custom_op`: the same function behind a `torch.library.custom_op`
  (`repro_ab::*`, made here; the operators' first registration);
- `op`: the operator as the kernel modules register it
  (`kernels._build.define_op`: `torch.library.Library`, a kernel for
  every backend and a fake implementation);
- `main`: the call the main path makes (`ops.*`: the autograd Function,
  the argument checks, the operator).

Each time is KERNEL_CALLS back-to-back calls between a pair of CUDA
events, the trimmed mean of REPS pairs after a warm-up, in turns: launch,
custom_op, op, main, main, op, custom_op, launch.  Where the kernel is
shorter than the host's work per call, the events measure the host's
rate of calls.  Rows go to chiprun_out/dispatch_ab.json.
"""
from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

from repro_torch.kernels import conv2d as tconv  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd as tssd  # noqa: E402

KERNEL_CALLS, REPS = 50, 7
ORDER = ("launch", "custom_op", "op", "main", "main", "op", "custom_op",
         "launch")


def _custom_ops():
    """The launch functions behind `torch.library.custom_op`s."""
    @torch.library.custom_op("repro_ab::attention", mutates_args=())
    def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: int | None, softcap: float | None,
                  scale: float | None) -> torch.Tensor:
        return tfa._attention_launch(q, k, v, causal, window, softcap,
                                     scale)

    @torch.library.custom_op("repro_ab::ssd", mutates_args=())
    def ssd(xdt: torch.Tensor, la: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
        return tssd._ssd_launch(xdt, la, B, C, chunk)

    @torch.library.custom_op("repro_ab::conv", mutates_args=())
    def conv(x: torch.Tensor, w: torch.Tensor, stride: int,
             interior_first: bool) -> torch.Tensor:
        return tconv._conv_launch(x, w, stride, interior_first)
    return attention, ssd, conv


def _ms(fn) -> float:
    def pair() -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(KERNEL_CALLS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / KERNEL_CALLS
    pair()
    t = sorted(pair() for _ in range(REPS))[1:-1]
    return sum(t) / len(t)


def cases():
    """(name, {way: fn}) for each kernel and shape."""
    attention, ssd, conv = _custom_ops()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for what, (b, s, hq, hkv, d) in (("small", (1, 128, 4, 4, 64)),
                                     ("hymba", (1, 2048, 25, 5, 64))):
        q = torch.randn(b, s, hq, d, generator=g, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn(b, s, hkv, d, generator=g, device=dev,
                            dtype=torch.bfloat16) for _ in "kv")
        out.append((f"flash_attention {what} bf16 causal", {
            "launch": lambda q=q, k=k, v=v: tfa._attention_launch(
                q, k, v, True, None, None, None),
            "custom_op": lambda q=q, k=k, v=v: attention(
                q, k, v, True, None, None, None),
            "op": lambda q=q, k=k, v=v: tfa._attention_op(
                q, k, v, True, None, None, None),
            "main": lambda q=q, k=k, v=v: ops.flash_attention(q, k, v)}))
    for what, (b, l, h, p, n, chunk), dt in (
            ("small", (1, 128, 2, 64, 16, 64), torch.float32),
            ("hymba", (1, 2048, 50, 64, 16, 64), torch.float32),
            ("hymba", (1, 2048, 50, 64, 16, 64), torch.bfloat16)):
        xdt = torch.randn(b, l, h, p, generator=g, device=dev).to(dt)
        la = -torch.rand(b, l, h, generator=g, device=dev)
        B, C = (torch.randn(b, l, n, generator=g, device=dev).to(dt)
                for _ in "BC")
        out.append((f"ssd_chunk {what} {str(dt)[6:]}", {
            "launch": lambda a=(xdt, la, B, C), c=chunk:
                tssd._ssd_launch(*a, c),
            "custom_op": lambda a=(xdt, la, B, C), c=chunk: ssd(*a, c),
            "op": lambda a=(xdt, la, B, C), c=chunk: tssd._ssd_op(*a, c),
            "main": lambda a=(xdt, la, B, C), c=chunk:
                ops.ssd_chunk(*a, chunk=c)}))
    for what, (n, hw, c, k, f, s), dt in (
            ("small", (2, 10, 16, 3, 16, 1), torch.bfloat16),
            ("mesh1k pred", (2, 16, 512, 1, 1, 1), torch.bfloat16),
            ("mesh1k conv6_2", (2, 18, 512, 3, 512, 1), torch.bfloat16)):
        x = torch.randn(n, hw, hw, c, generator=g, device=dev).to(dt)
        w = torch.randn(k, k, c, f, generator=g, device=dev).to(dt)
        out.append((f"conv2d {what} {str(dt)[6:]}", {
            "launch": lambda x=x, w=w, s=s: tconv._conv_launch(x, w, s,
                                                               False),
            "custom_op": lambda x=x, w=w, s=s: conv(x, w, s, False),
            "op": lambda x=x, w=w, s=s: tconv._conv_op(x, w, s, False),
            "main": lambda x=x, w=w, s=s: ops.conv2d(x, w, stride=s)}))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("dispatch_ab: needs a CUDA card", file=sys.stderr)
        return 1
    import subprocess
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    rows = []
    for name, fns in cases():
        ms = {way: [] for way in fns}
        for way in ORDER:
            ms[way].append(_ms(fns[way]))
        row = {"case": name, "card": card,
               **{f"{way}_ms": sum(t) / len(t) for way, t in ms.items()},
               "turns": ms}
        rows.append(row)
        print(f"{name}: " + ", ".join(
            f"{way} {row[f'{way}_ms'] * 1e3:.1f} us" for way in fns)
            + f" (a call, {card})", flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "dispatch_ab.json"),
              "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
