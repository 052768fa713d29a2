"""The fault-tolerant training loop and straggler monitoring, port of
`repro.runtime.fault_tolerance`.

The loop's contract, as in the reference:

  * checkpoint every `ckpt_every` steps (async, atomic — see
    repro_torch.checkpoint), recording the solved plan spec in the
    manifest;
  * on a step fault: roll back to the latest committed checkpoint, rebuild
    the step function, continue; give up after `max_failures`
    *consecutive* failures;
  * on device loss (`DeviceLoss`, carrying the surviving global ranks):
    hand the survivors to the `remesh` callback, which rebuilds the mesh
    from them, re-solves the plan on the shrunk mesh under the same
    mem_limit (launch.train --elastic), and returns a fresh step factory
    plus a state template built for the new mesh; the checkpoint's global
    arrays are restored into it;
  * deterministic data: batches are derived from the step index, so a
    restart replays the exact stream;
  * with a `metrics` MetricsLogger every fault, rollback, remesh and
    flagged straggler emits a ``repro/metrics@1`` event record.

What the port adds, for a mesh of processes and for state updated in
place: `leaves(state)` is the tree the checkpoint holds and
`load(state_like, tree)` the state rebuilt from a restored one (both the
identity by default: the reference's pytree state); `agree(step)` makes
every rank restore the same step (rank 0's, broadcast: launch.train),
after the writer's `wait()`; a `remesh` that returns None marks this
process as one that is not a survivor, and `run` returns at once with
`left_at` set.  Without a checkpoint manager (`ckpt` None) nothing is
saved and a fault is re-raised.

StragglerMonitor implements the detection half of straggler mitigation:
an online median/MAD filter over step times; slow steps beyond `k` MADs
are flagged and counted, and the `action` hook is called with them.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Sequence

import numpy as np

log = logging.getLogger("repro_torch.runtime")


class DeviceLoss(RuntimeError):
    """A step fault caused by devices (here: ranks) leaving the fleet.

    Carries the global ranks that survive; a `ResilientLoop` with a
    `remesh` callback recovers elastically, anything else treats it as
    fatal (a same-mesh retry cannot succeed without the lost ranks).
    """

    def __init__(self, survivors: Sequence, message: str | None = None):
        self.survivors = list(survivors)
        super().__init__(message or
                         f"device loss: {len(self.survivors)} survivors")


class StragglerMonitor:
    def __init__(self, k: float = 5.0, warmup: int = 3,
                 action: Callable[[int, float], None] | None = None):
        self.k = k
        self.warmup = warmup
        self.times: list[float] = []
        self.flagged: list[tuple[int, float]] = []
        self.action = action

    def record(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) <= self.warmup:
            return False
        hist = np.asarray(self.times[:-1])
        med = np.median(hist)
        mad = np.median(np.abs(hist - med)) + 1e-9
        if dt > med + self.k * mad and dt > 1.5 * med:
            self.flagged.append((step, dt))
            log.warning("straggler step %d: %.3fs (median %.3fs)",
                        step, dt, med)
            if self.action:
                self.action(step, dt)
            return True
        return False

    @property
    def stats(self) -> dict:
        t = np.asarray(self.times) if self.times else np.zeros(1)
        return {"median": float(np.median(t)),
                "p95": float(np.percentile(t, 95)),
                "flagged": len(self.flagged)}


@dataclasses.dataclass
class ResilientLoop:
    """Runs `run_step(state, step) -> state, metrics` with
    checkpoint/restart (see the module docstring)."""
    ckpt: Any                      # CheckpointManager | None
    make_step: Callable[[], Callable]
    ckpt_every: int = 50
    max_failures: int = 3
    remesh: Callable[[Sequence], tuple[Callable, Any] | None] | None = None
    metrics: Any = None            # MetricsLogger | None
    plan_spec: Any = None          # dict | Callable[[], dict] | None
    leaves: Callable[[Any], Any] | None = None
    load: Callable[[Any, Any], Any] | None = None
    agree: Callable[[int | None], int | None] | None = None
    left_at: int | None = None

    def _plan(self) -> dict | None:
        return self.plan_spec() if callable(self.plan_spec) \
            else self.plan_spec

    def _tree(self, state):
        return state if self.leaves is None else self.leaves(state)

    def _event(self, kind: str, **fields):
        if self.metrics is not None:
            self.metrics.log_event(kind, **fields)

    def _rollback(self, state_like, start_step: int):
        """Restore the latest committed checkpoint (the step every rank
        agrees on) into `state_like`; fall back to the template itself at
        `start_step` when nothing is committed yet."""
        step = self.ckpt.latest_step()
        if self.agree is not None:
            step = self.agree(step)
        restored, manifest = (None, None) if step is None else \
            self.ckpt.restore(self._tree(state_like), step)
        if restored is not None:
            step = manifest["extra"]["step"]
            log.info("rolled back to step %d", step)
            self._event("rollback", step=step)
            state = restored if self.load is None else \
                self.load(state_like, restored)
            return state, step
        self._event("rollback", step=start_step, note="no checkpoint")
        return state_like, start_step

    def run(self, state, start_step: int, num_steps: int,
            monitor: StragglerMonitor | None = None,
            inject_failure: Callable[[int], None] | None = None):
        step_fn = self.make_step()
        failures = 0
        step = start_step
        metrics = None
        while step < num_steps:
            try:
                t0 = time.perf_counter()
                if inject_failure:
                    inject_failure(step)           # test hook
                state, metrics = step_fn(state, step)
                dt = time.perf_counter() - t0
                if monitor and monitor.record(step, dt):
                    self._event("straggler", step=step, dt_s=dt,
                                **monitor.stats)
                failures = 0
                step += 1
                if self.ckpt is not None and step % self.ckpt_every == 0:
                    self.ckpt.save(step, self._tree(state),
                                   extra={"step": step}, plan=self._plan())
            except KeyboardInterrupt:
                raise
            except DeviceLoss as e:
                failures += 1
                log.error("step %d lost devices (%d survive); "
                          "failure %d/%d", step, len(e.survivors),
                          failures, self.max_failures)
                self._event("fault", step=step, error="DeviceLoss",
                            survivors=len(e.survivors), failures=failures)
                if failures > self.max_failures or self.remesh is None \
                        or self.ckpt is None:
                    raise
                self.ckpt.wait()
                # elastic restart: new mesh + re-solved plan from the
                # survivors, then the checkpoint restored into its template
                rebuilt = self.remesh(e.survivors)
                if rebuilt is None:            # this rank is not a survivor
                    self.left_at = step
                    return state, step, metrics
                self.make_step, state_like = rebuilt
                self._event("remesh", step=step,
                            n_devices=len(e.survivors))
                state, step = self._rollback(state_like, start_step)
                step_fn = self.make_step()
            except Exception as e:     # noqa: BLE001 — any step fault
                failures += 1
                log.error("step %d failed (%s); failure %d/%d",
                          step, type(e).__name__, failures,
                          self.max_failures)
                self._event("fault", step=step, error=type(e).__name__,
                            failures=failures)
                if failures > self.max_failures or self.ckpt is None:
                    raise
                self.ckpt.wait()
                state, step = self._rollback(state, start_step)
                step_fn = self.make_step()
        if self.ckpt is not None:
            self.ckpt.wait()
        return state, step, metrics
