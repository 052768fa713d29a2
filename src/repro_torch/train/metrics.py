"""Structured training telemetry, port of `repro.train.metrics`: JSONL
step records (loss, wall-clock step time, samples/s) and free-form event
records (faults, rollbacks, remeshes, stragglers) with a human-readable
echo, and the `--debug-nans` check.  Records carry the same schema as
the reference's."""
from __future__ import annotations

import json
import math
import time
from typing import IO, Mapping, Sequence

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

    def log_event(self, kind: str, **fields) -> None:
        """A free-form record (checkpoint saved, straggler, profile...)."""
        self._emit({"kind": kind, "time": time.time(), **fields})

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


def debug_nan_check(step: int, metrics: Mapping, params=None,
                    layer_names: Sequence[str] | None = None) -> None:
    """Raise FloatingPointError on the first non-finite loss/grad_norm.

    The per-step check reads only the metric floats.  When it trips and
    `params` is given, the parameter list is scanned layer by layer
    (`layer_names` aligned with a models.cnn list layout; any other tree
    is scanned whole) with `utils.assert_no_nans`, whose keypath names the
    first offending layer and parameter as the reference's does.
    """
    bad = [k for k in ("loss", "grad_norm")
           if k in metrics and not math.isfinite(float(metrics[k]))]
    if not bad:
        return
    head = f"--debug-nans: non-finite {'/'.join(bad)} at step {step}"
    if params is not None:
        from repro_torch.utils import assert_no_nans
        if (layer_names is not None and isinstance(params, (list, tuple))
                and len(layer_names) == len(params)):
            pairs = list(zip(layer_names, params))
        else:
            pairs = [("params", params)]
        for name, p in pairs:
            try:
                assert_no_nans(p, where=f"layer {name!r} ")
            except AssertionError as e:
                raise FloatingPointError(f"{head}; {e}") from None
    raise FloatingPointError(
        f"{head}; parameters are all finite (transient in the loss/grad "
        "path — rerun with a lower lr or inspect the batch)")
