#!/usr/bin/env python3
"""Planted faults in the bf16 SSD-chunk kernel, and the margins by which
its two checks catch them, on one card.

    python3 tools/ssd_faults.py

Needs one CUDA card and `nvcc`.  It builds this tree's
`csrc/ssd.cu` as it is and two copies with one fault each:

* `diagonal`: the last row tile of y skips its diagonal tile of M;
* `no_low`: y = M.xdt skips the product of M's low part (M rounded to
  bf16 alone, as attention rounds P).

At hymba-1.5b's and mamba2-780m's SSD shapes (`chip_smoke.SSD_SHAPES`,
batch 1 x seq 2048, bf16, the model's inputs) and seeds 1 and 2, it prints
for each build the worst error of y over its LM_FWD_TOL limit (1e-2 of the
largest |y|) and over the element-wise limit `ssd.elem_limit` (2^-7 |y32|
+ 2^-12 |M|.|xdt|).  A check catches a fault where its ratio exceeds 1.
Rows go to chiprun_out/ssd_faults.json.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))

DIAGONAL = ("    for (int kt = 0; kt <= it; ++kt) {\n"
            "      uint32_t ah[4], al[4], b[4];",
            "    for (int kt = 0; kt <= it - (it == CLM / TILE - 1); ++kt) {\n"
            "      uint32_t ah[4], al[4], b[4];")
NO_LOW = ("      mma(acc[0], al, b[0], b[1]);\n"
          "      mma(acc[1], al, b[2], b[3]);\n", "")
FAULTS = {"as committed": [], "diagonal": [DIAGONAL], "no_low": [NO_LOW]}


def build(name: str, edits: list[tuple[str, str]]):
    """`repro_ssd_chunk` of csrc/ssd.cu with `edits` applied, built into
    build/faults/."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "ssd.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the source no longer has the line "
                               f"to change")
        src = src.replace(old, new)
    out = _build.BUILD_DIR.parent / "faults"
    out.mkdir(parents=True, exist_ok=True)
    tag = name.replace(" ", "_")
    (out / f"{tag}.cu").write_text(src)
    subprocess.run(_build.nvcc_command(_build.find_nvcc(), out / f"{tag}.cu",
                                       out / f"{tag}.so"),
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(out / f"{tag}.so")).repro_ssd_chunk
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] + \
        [ctypes.c_int64] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_faults: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import ssd as kssd
    from repro_torch.kernels.ref import ssd_chunked_ref

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    fns = {name: build(name, edits) for name, edits in FAULTS.items()}
    rows = []
    print(f"{'model':12s} {'seed':>4s} {'build':14s} {'err/LM_FWD_TOL':>15s} "
          f"{'err/elem limit':>15s}")
    for shape in cs.SSD_SHAPES:
        for seed in (1, 2):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            xdt, la, B, C = cs.ssd_inputs(shape, torch.bfloat16, gen)
            chunk = shape["chunk"]
            b, l, h, p = xdt.shape
            n = B.shape[-1]
            yr, _ = ssd_chunked_ref(xdt, la, B, C, chunk)
            tol = cs.LM_FWD_TOL[torch.bfloat16] * \
                max(1.0, float(yr.float().abs().max()))
            y32, limit = kssd.elem_limit(xdt, la, B, C, chunk)
            for name, fn in fns.items():
                y = torch.empty_like(xdt)
                S = torch.empty((b, l // chunk, h, p, n), device="cuda")
                err = fn(xdt.data_ptr(), la.data_ptr(), B.data_ptr(),
                         C.data_ptr(), y.data_ptr(), S.data_ptr(), 1,
                         b * l // chunk, chunk, h, p, n,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError_t {err}")
                torch.cuda.synchronize()
                row = {"model": shape["model"], "seed": seed, "build": name,
                       "err_over_tol": float((y.float() - yr.float()).abs()
                                             .max()) / tol,
                       "err_over_elem_limit": float(
                           ((y.float() - y32).abs() / limit).max())}
                rows.append(row)
                print(f"{shape['model']:12s} {seed:4d} {name:14s} "
                      f"{row['err_over_tol']:15.3f} "
                      f"{row['err_over_elem_limit']:15.3f}", flush=True)
            del xdt, la, B, C, yr, y32, limit
            torch.cuda.empty_cache()
    bad = [r for r in rows if r["build"] == "as committed"
           and max(r["err_over_tol"], r["err_over_elem_limit"]) > 1]
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    Path(HERE, "chiprun_out", "ssd_faults.json").write_text(
        json.dumps({"card": card, "rows": rows}, indent=1))
    if bad:
        print(f"the committed kernel fails a check: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
