#!/usr/bin/env python3
"""A/B of the flash-attention kernel against an earlier version of it, on
one card.

    python3 tools/attn_ab.py [--parent-src OLD.cu] [--parent-tree DIR]

Needs one CUDA card and `nvcc`.  For hymba-1.5b's attention calls at
batch 1 x seq 2048 (25 q heads, 5 kv heads, head dim 64; causal, and
causal + window 1024), in float32 and bfloat16, it holds this tree's
kernel (`kernels/flash_attention.py::flash_attention`) against
`flash_attention_ref` and times it, the earlier kernel built from OLD.cu
(if given), one `F.scaled_dot_product_attention` call (the yardstick) and
the bound, in turns: earlier, this, this, earlier.  Each sample is 20
back-to-back launches between one pair of CUDA events; a time is the
trimmed mean of 10 samples after 2 warm-up samples.  OLD.cu is a source
with the first C entry point, `repro_flash_attention(q, k, v, o, dtype,
b, sq, sk, hq, hkv, d, scale, softcap, causal, window, stream)`; it is
built beside this tree's kernels and called on the same inputs.

With --parent-tree DIR (a checkout of the earlier tree) it also times the
full-width hymba-1.5b training step (batch 1 x seq 2048, batch already on
the card, host clock around 4 synchronised steps after 2 warm-ups), FP32
and BF16 (bf16 compute, fp32 master weights), in four fresh processes:
DIR's package, this one, this one, DIR's.

Rows go to chiprun_out/attn_ab.json.  `--step-only --src DIR/src` is the
step timing of one process (used by the above).
"""
from __future__ import annotations

import ctypes
import math
import sys
import time

from ab_common import HERE, main, parent_fn, print_totals, timing_row, turns

STEP_REPS, STEP_WARMUP = 4, 2
LAUNCHES, REPS, WARMUP = 20, 10, 2


def step_only(src: str) -> dict:
    """Seconds per full-width hymba-1.5b step, FP32 and BF16, of the
    package under `src`."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.optim.optimizer import adamw
    from repro_torch.train.train_loop import TrainStepConfig, make_train_step
    from repro_torch.utils import BF16, FP32

    dev = torch.device("cuda")
    args = train_cli.parse_args(["--arch", "hymba-1.5b", "--batch", "1",
                                 "--seq", "2048"])
    train_cli.set_fp32_numerics(dev)
    _, params, _, loss, mk, _, _ = train_cli.build(args, dev)
    batch = pipeline.to_device(mk(0), dev)
    out = {"src": src}
    for name, prec in (("fp32", FP32), ("bf16", BF16)):
        opt = adamw(0.0)     # lr 0: every step sees the same params
        step = make_train_step(loss, opt, TrainStepConfig(precision=prec))
        state = opt.init(params)
        for _ in range(STEP_WARMUP):
            float(step(params, state, None, batch)[3]["loss"])
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(STEP_REPS):
            t0 = time.perf_counter()
            lv = float(step(params, state, None, batch)[3]["loss"])
            times.append(time.perf_counter() - t0)
        out[name] = {"step_s": times, "mean_s": sum(times) / len(times),
                     "loss": lv, "launches": ops.launch_counts(),
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del opt, step, state
        torch.cuda.empty_cache()
    return out


def report(name: str, row: dict) -> None:
    for prec in ("fp32", "bf16"):
        r = row[prec]
        print(f"step {name:6s} {prec}: mean {r['mean_s'] * 1e3:.3f} ms "
              f"over {STEP_REPS} steps (min {min(r['step_s']) * 1e3:.3f}), "
              f"{2048 / r['mean_s']:.1f} tokens/s, loss {r['loss']!r}, "
              f"peak {r['peak_gib']:.2f} GiB, launches {r['launches']}",
              flush=True)


I64 = ctypes.c_int64
# the first C entry: repro_flash_attention(q, k, v, o, dtype, b, sq, sk,
# hq, hkv, d, scale, softcap, causal, window, stream)
PARENT_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [I64] * 6 + \
    [ctypes.c_float, ctypes.c_float, ctypes.c_int, I64, ctypes.c_void_p]


def time_launches(fn) -> float:
    """ms per call of `fn`: LAUNCHES calls between one pair of CUDA events
    a sample, trimmed mean of REPS samples after WARMUP."""
    import torch
    from repro_torch.utils import trimmed_mean
    samples = []
    for i in range(WARMUP + REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(LAUNCHES):
            fn()
        end.record()
        end.synchronize()
        if i >= WARMUP:
            samples.append(start.elapsed_time(end) / LAUNCHES)
    return trimmed_mean(samples)


def kernel_ab(parent_src: str | None) -> list[dict]:
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels.ref import flash_attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    old = parent_fn(parent_src, "flash_attention", PARENT_ARGTYPES) \
        if parent_src else None
    dev = torch.device("cuda")
    cfg = cs.HYMBA
    b, s, hq, hkv, d = cs.LM_BATCH, cs.LM_SEQ, cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, failed = [], []
    print(f"{'case':12s} {'dtype':8s} {'plan':24s} {'n':>2s} {'new_ms':>9s} "
          f"{'parent_ms':>9s} {'library_ms':>10s} {'bound_ms':>9s} "
          f"{'TFLOP/s':>8s} {'err':>9s} {'parent_err':>10s}")
    for dtype in (torch.float32, torch.bfloat16):
        for case in cs.attention_cases(cfg):
            window = case["window"]
            q = torch.randn((b, s, hq, d), generator=gen, device=dev).to(dtype)
            k = torch.randn((b, s, hkv, d), generator=gen, device=dev) \
                .to(dtype)
            v = torch.randn((b, s, hkv, d), generator=gen, device=dev) \
                .to(dtype)
            p = kfa.plan(tuple(q.shape), tuple(k.shape), dtype, True, window)
            o = kfa.flash_attention(q, k, v, window=window)
            want = flash_attention_ref(q, k, v, window=window).float()
            tol = cs.LM_FWD_TOL[dtype] * max(1.0, float(want.abs().max()))
            err = float((o.float() - want).abs().max())
            if not err <= tol:
                failed.append(f"{case['mask']} {dtype}: max |err| {err} > "
                              f"{tol}")
                print(failed[-1], flush=True)
            elem = None
            if dtype == torch.bfloat16:
                want32, limit = cs.attention_limit(q, k, v, window=window)
                elem = float(((o.float() - want32).abs() / limit).max())
                if not elem <= 1.0:
                    failed.append(f"{case['mask']} {dtype}: an element is "
                                  f"{elem} x its limit")
                    print(failed[-1], flush=True)
                del want32, limit

            def run_old():
                oo = torch.empty_like(q)
                e = old(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        oo.data_ptr(), 0 if dtype == torch.float32 else 1,
                        b, s, s, hq, hkv, d, 1.0 / math.sqrt(d), 0.0, 1,
                        window or 0, torch.cuda.current_stream().cuda_stream)
                if e:
                    raise RuntimeError(f"parent kernel: cudaError_t {e}")
                return oo

            p_err = None if old is None else \
                float((run_old().float() - want).abs().max())
            new_t, old_t = turns(
                time_launches,
                lambda: kfa.flash_attention(q, k, v, window=window),
                None if old is None else run_old)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            if window is None:
                def library():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True)
            else:
                pos = torch.arange(s, device=dev)
                keep = (pos[:, None] >= pos[None, :]) & \
                    (pos[:, None] - pos[None, :] < window)

                def library():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=keep, enable_gqa=True)
            lib_ms = time_launches(library)
            flops = 4.0 * d * cs.admitted_pairs(s, window) * b * hq
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * \
                q.element_size()
            row = {"case": case["mask"], "dtype": str(dtype).split(".")[-1],
                   "count": case["count"], "q": [b, s, hq, d],
                   "kv": [b, s, hkv, d], "plan": p.__dict__,
                   "max_abs_err": err, "max_err_over_elem_limit": elem,
                   "parent_max_abs_err": p_err,
                   **timing_row(new_t, old_t, lib_ms, flops, nbytes, dtype)}
            rows.append(row)
            ms, bound_ms = row["ms"], row["bound_ms"]
            plan_s = f"{p.path} {p.tile_q}x{p.tile_k} d{p.d_pad} s{p.stages}"
            par = "-" if row["parent_ms"] is None else \
                f"{row['parent_ms']:9.4f}"
            print(f"{case['mask']:12s} {row['dtype']:8s} {plan_s:24s} "
                  f"{case['count']:2d} {ms:9.4f} {par:>9s} {lib_ms:10.4f} "
                  f"{bound_ms:9.4f} {row['tflops_s']:8.2f} {err:9.2e} "
                  f"{'-' if p_err is None else f'{p_err:.2e}':>10s}"
                  + ("" if elem is None else f"  err/elem limit {elem:.3f}"),
                  flush=True)
            del q, k, v, o, want
            torch.cuda.empty_cache()
    print_totals(rows, "one hymba-1.5b forward's attention")
    if failed:
        raise AssertionError("kernel vs plain: " + "; ".join(failed))
    return rows


if __name__ == "__main__":
    sys.exit(main(__doc__, "attn_ab", __file__, kernel_ab, step_only,
                  report))
