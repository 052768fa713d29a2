#!/usr/bin/env python3
"""A/B of the SSD-chunk kernel against an earlier version of it, on one
card.

    python3 tools/ssd_ab.py [--parent-src OLD.cu] [--parent-tree DIR]

Needs one CUDA card and `nvcc`.  At hymba-1.5b's SSD shape (batch 1 x
seq 2048, 50 heads x 64, state 16, chunk 64) and mamba2-780m's (48 heads,
state 128, chunk 128), in float32 and bfloat16, on the model's inputs
(`chip_smoke.SSD_SHAPES`), it holds this tree's kernel
(`kernels/ssd.py::ssd_chunk`) against `ssd_chunked_ref` (y at
LM_FWD_TOL, S at the f32 tolerance; bf16 y also element by element
within `ssd.elem_limit`) and times it, the earlier kernel built from
OLD.cu (if given), the plain version and the bound, in turns: earlier,
this, this, earlier.  Each sample is 20 back-to-back launches between one
pair of CUDA events; a time is the trimmed mean of 10 samples after 2
warm-up samples.  Such a time includes the wrapper's host time wherever
that is longer than the kernel, so each kernel's device time alone is
also taken from torch.profiler (`device_ms`, the mean over 20 calls).
OLD.cu is a source with the same C entry point,
`repro_ssd_chunk(xdt, la, B, C, y, S, dtype, bnc, cl, h, p, n, stream)`
(PR 12's: `git show 484af4a:src/repro_torch/kernels/csrc/ssd.cu`); it is
built beside this tree's kernels and called on the same inputs.

With --parent-tree DIR (a checkout of the earlier tree) it also times the
full-width hymba-1.5b training step, FP32 and BF16, in four fresh
processes (DIR's package, this one, this one, DIR's), as
`tools/attn_ab.py` does.

Rows go to chiprun_out/ssd_ab.json.
"""
from __future__ import annotations

import ctypes
import sys

from ab_common import HERE, main, parent_fn, print_totals, timing_row, turns
from attn_ab import report, step_only, time_launches

I64 = ctypes.c_int64
PARENT_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] + [I64] * 5 + \
    [ctypes.c_void_p]


def device_ms(fn, calls: int = 20) -> float:
    """ms per call of the `ssd_chunk_kernel` that `fn` launches, from the
    profiler's device events (no host time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA
          and "ssd_chunk_kernel" in e.name]
    if len(us) != calls:
        raise RuntimeError(f"the profiler saw {len(us)} ssd_chunk_kernel "
                           f"launches, not {calls}")
    return sum(us) / calls / 1e3


def kernel_ab(parent_src: str | None) -> list[dict]:
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import torch
    from repro_torch.kernels import ssd as kssd
    from repro_torch.kernels.ref import ssd_chunked_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    old = parent_fn(parent_src, "ssd_chunk", PARENT_ARGTYPES) \
        if parent_src else None
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, failed = [], []
    print(f"{'model':12s} {'dtype':8s} {'plan':22s} {'n':>2s} "
          f"{'new_ms':>9s} {'parent_ms':>9s} {'new_dev':>9s} {'par_dev':>9s} "
          f"{'plain_ms':>9s} {'bound_ms':>9s} {'TFLOP/s':>8s} {'err':>9s} "
          f"{'parent_err':>10s}")
    for dtype in (torch.float32, torch.bfloat16):
        for shape in cs.SSD_SHAPES:
            xdt, la, B, C = cs.ssd_inputs(shape, dtype, gen)
            chunk = shape["chunk"]
            b, l, h, p = xdt.shape
            n = B.shape[-1]
            pl = kssd.plan(chunk, n, dtype)
            y, S = kssd.ssd_chunk(xdt, la, B, C, chunk=chunk)
            yr, Sr = ssd_chunked_ref(xdt, la, B, C, chunk)

            def err_of(got_y, got_S):
                return max(float((got_y.float() - yr.float()).abs().max()),
                           float((got_S - Sr).abs().max()))
            what = f"{shape['model']} {dtype}"
            for nm, got, want, tol in (
                    ("y", y, yr, cs.LM_FWD_TOL[dtype]),
                    ("S", S, Sr, cs.LM_FWD_TOL[torch.float32])):
                e = float((got.float() - want.float()).abs().max())
                lim = tol * max(1.0, float(want.float().abs().max()))
                if not e <= lim:
                    failed.append(f"{what} {nm}: max |err| {e} > {lim}")
                    print(failed[-1], flush=True)
            elem = None
            if dtype == torch.bfloat16:
                y32, limit = kssd.elem_limit(xdt, la, B, C, chunk)
                elem = float(((y.float() - y32).abs() / limit).max())
                if not elem <= 1.0:
                    failed.append(f"{what}: an element is {elem} x its "
                                  f"limit")
                    print(failed[-1], flush=True)
                del y32, limit

            def run_old():
                yo = torch.empty_like(xdt)
                So = torch.empty_like(S)
                e = old(xdt.data_ptr(), la.data_ptr(), B.data_ptr(),
                        C.data_ptr(), yo.data_ptr(), So.data_ptr(),
                        0 if dtype == torch.float32 else 1, b * l // chunk,
                        chunk, h, p, n,
                        torch.cuda.current_stream().cuda_stream)
                if e:
                    raise RuntimeError(f"parent kernel: cudaError_t {e}")
                return yo, So

            p_err = None if old is None else err_of(*run_old())
            new_t, old_t = turns(
                time_launches,
                lambda: kssd.ssd_chunk(xdt, la, B, C, chunk=chunk),
                None if old is None else run_old)
            plain_ms = time_launches(
                lambda: ssd_chunked_ref(xdt, la, B, C, chunk))
            dev_ms = device_ms(
                lambda: kssd.ssd_chunk(xdt, la, B, C, chunk=chunk))
            dev_old = None if old is None else device_ms(run_old)
            flops, nbytes = cs.ssd_work(xdt, la, B, S, chunk)
            row = {"model": shape["model"],
                   "dtype": str(dtype).split(".")[-1],
                   "count": shape["count"], "xdt": [b, l, h, p], "n": n,
                   "chunk": chunk, "plan": pl.__dict__,
                   "max_abs_err": err_of(y, S),
                   "max_err_over_elem_limit": elem,
                   "parent_max_abs_err": p_err, "plain_ms": plain_ms,
                   "device_ms": dev_ms, "parent_device_ms": dev_old,
                   **timing_row(new_t, old_t, None, flops, nbytes, dtype)}
            rows.append(row)
            par = "-" if row["parent_ms"] is None else \
                f"{row['parent_ms']:9.4f}"
            par_dev = "-" if dev_old is None else f"{dev_old:9.4f}"
            row["ctas_per_sm"] = kssd.occupancy(chunk, n, dtype)
            print(f"{shape['model']:12s} {row['dtype']:8s} "
                  f"{cs.ssd_plan_str(pl, row['ctas_per_sm']):22s} "
                  f"{shape['count']:2d} "
                  f"{row['ms']:9.4f} {par:>9s} {dev_ms:9.4f} "
                  f"{par_dev:>9s} {plain_ms:9.4f} "
                  f"{row['bound_ms']:9.4f} {row['tflops_s']:8.2f} "
                  f"{row['max_abs_err']:9.2e} "
                  f"{'-' if p_err is None else f'{p_err:.2e}':>10s}"
                  + ("" if elem is None else f"  err/elem limit {elem:.3f}"),
                  flush=True)
            del xdt, la, B, C, y, S, yr, Sr
            torch.cuda.empty_cache()
    print_totals(rows, "one hymba-1.5b forward's SSD")
    for dt in ("float32", "bfloat16"):
        sel = [r for r in rows if r["dtype"] == dt]
        print(f"one hymba-1.5b forward's SSD, {dt}, device time alone: "
              + ", ".join(
                  f"{key} " + ("-" if any(r[key] is None for r in sel) else
                               f"{sum(r[key] * r['count'] for r in sel):.4f}")
                  for key in ("device_ms", "parent_device_ms")), flush=True)
    if failed:
        raise AssertionError("kernel vs plain: " + "; ".join(failed))
    return rows


if __name__ == "__main__":
    sys.exit(main(__doc__, "ssd_ab", __file__, kernel_ab, step_only,
                  report))
