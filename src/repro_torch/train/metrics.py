"""Structured training telemetry, port of `repro.train.metrics`: JSONL
step records (loss, wall-clock step time, samples/s) with a human-readable
echo.  Records carry the same schema as the reference's."""
from __future__ import annotations

import json
import time
from typing import IO, Mapping

SCHEMA = "repro/metrics@1"


class MetricsLogger:
    """JSONL step-record writer with a human-readable echo.

    path: JSONL output file (None = echo only).  Lines are objects with a
          "kind" field: one "run" header, one "step" record per logged
          step, then a "done" footer.
    echo: also print a terminal line per record.
    """

    def __init__(self, path: str | None = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._f: IO | None = open(path, "w") if path else None
        self._t0 = time.time()

    def _emit(self, rec: Mapping) -> None:
        if self._f is not None:
            self._f.write(json.dumps(rec, sort_keys=True) + "\n")
            self._f.flush()

    def log_run(self, **meta) -> None:
        self._emit({"kind": "run", "schema": SCHEMA,
                    "time": time.time(), **meta})
        if self.echo and meta:
            print(" ".join(f"{k}={v}" for k, v in meta.items()
                           if not isinstance(v, (dict, list))))

    def log_step(self, step: int, loss: float, *,
                 step_time_s: float | None = None,
                 samples_per_s: float | None = None,
                 echo: bool | None = None, **extra) -> None:
        rec = {"kind": "step", "step": step, "loss": float(loss)}
        if step_time_s is not None:
            rec["step_time_s"] = step_time_s
        if samples_per_s is not None:
            rec["samples_per_s"] = samples_per_s
        rec.update(extra)
        self._emit(rec)
        if self.echo if echo is None else echo:
            tail = f" ({step_time_s:.3f}s/step" if step_time_s else "("
            if samples_per_s:
                tail += f", {samples_per_s:.1f} samples/s"
            tail += ")" if step_time_s or samples_per_s else ""
            print(f"step {step:5d} loss {float(loss):.4f} {tail}".rstrip())

    def log_done(self, step: int, **fields) -> None:
        self._emit({"kind": "done", "step": step,
                    "wall_s": time.time() - self._t0, **fields})

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
