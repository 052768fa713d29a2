#!/usr/bin/env python3
"""The dry run's cells as one markdown table: a row an (arch, shape),
its pod1 and pod2 cells' JSONs under a directory (`python -m
repro_torch.launch.sweep --out DIR`) side by side, in the sweep's
order: ok or the failure's last line, the peak a rank against 80 GiB
(over marked), the three roofline terms in ms, the dominant one, the
trace's seconds.

    python3 tools/dryrun_table.py [DIR]          (default build/dryrun)
"""
from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))

from repro_torch.launch.dryrun import HBM_CAPACITY, cell_tag  # noqa: E402
from repro_torch.launch.sweep import cells  # noqa: E402


def _cell(d: str, arch: str, shape: str, pod2: bool) -> dict | None:
    path = os.path.join(d, cell_tag(arch, shape, pod2) + ".json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _fmt(r: dict | None, key) -> str:
    if r is None:
        return "not run"
    if not r.get("ok"):
        return "failed: " + (r.get("error") or ["?"])[-1].replace(
            "|", "/")[:60]
    return key(r)


def _peak(r: dict) -> str:
    peak = r["per_device"]["peak_bytes"]
    return f"{peak / 2 ** 30:.2f}" + ("" if peak <= HBM_CAPACITY
                                      else " **over**")


COLUMNS = [
    ("peak GiB a rank (of 80)", _peak),
    ("compute ms", lambda r: f"{r['roofline_s']['compute'] * 1e3:.2f}"),
    ("memory ms", lambda r: f"{r['roofline_s']['memory'] * 1e3:.2f}"),
    ("collective ms",
     lambda r: f"{r['roofline_s']['collective'] * 1e3:.2f}"),
    ("dominant", lambda r: r["dominant"]),
    ("trace s", lambda r: f"{r['timing']['trace_s']}"),
]


def main(argv) -> int:
    d = argv[0] if argv else os.path.join(HERE, "build", "dryrun")
    print("| cell (pod1 / pod2) | result | "
          + " | ".join(name for name, _ in COLUMNS) + " |")
    print("|---" * (len(COLUMNS) + 2) + "|")
    for arch, shape, pod2 in cells():
        if pod2:
            continue
        rs = [_cell(d, arch, shape, mp) for mp in (False, True)]
        ok = all(r is not None and r.get("ok") for r in rs)
        result = "ok" if ok else " / ".join(
            _fmt(r, lambda r: "ok") for r in rs)
        cols = [" / ".join(_fmt(r, key) for r in rs) if ok else ""
                for _, key in COLUMNS]
        print(f"| {arch}-{shape} | {result} | " + " | ".join(cols) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
