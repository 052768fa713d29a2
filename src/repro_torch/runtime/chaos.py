"""Fault-injection menu for the elastic / fault-tolerance paths, port of
`repro.runtime.chaos`.

Every entry is a factory returning an `inject(step)` hook compatible with
`ResilientLoop.run(..., inject_failure=)`: called before each step, it
does nothing, plants filesystem damage, or raises the failure it
simulates.  Hooks fire once: the recovery path must make progress past
the injection step, not loop on it.  A hook is a function of the step, so
on a mesh of processes it fires on every rank at the same step.

  raise_at_step           a plain step fault
  drop_device_at_step     raises DeviceLoss with the surviving global
                          ranks (the tail of the list is dropped)
  corrupt_checkpoint_tmp  plants a half-written tmp-<step> directory and a
                          malformed step-* entry in the checkpoint dir, the
                          debris a crash mid-save leaves; training must
                          shrug it off (latest_step ignores, gc sweeps)

`parse` maps the ``--chaos`` CLI grammar onto these:

  --chaos raise@7              step fault at step 7
  --chaos kill@5               drop 1 rank at step 5
  --chaos kill@5x2             drop 2 ranks at step 5
  --chaos corrupt@3            plant checkpoint debris at step 3
  --chaos corrupt@3,raise@7    hooks compose left to right
"""
from __future__ import annotations

import os
from typing import Callable, Sequence

from repro_torch.runtime.fault_tolerance import DeviceLoss

Hook = Callable[[int], None]


def _once(step: int, fire: Callable[[int], None]) -> Hook:
    armed = {"on": True}

    def hook(s: int) -> None:
        if s == step and armed["on"]:
            armed["on"] = False
            fire(s)
    return hook


def raise_at_step(step: int,
                  message: str = "chaos: injected step fault") -> Hook:
    def fire(s):
        raise RuntimeError(f"{message} (step {s})")
    return _once(step, fire)


def drop_device_at_step(step: int, n_drop: int = 1,
                        devices: Sequence | None = None) -> Hook:
    """Simulate `n_drop` ranks leaving at `step`: raises DeviceLoss
    carrying the survivors (the tail of the list is dropped).  `devices`
    defaults to every global rank of the process group (one, without
    one); pass the mesh's own ranks when it runs on a subset."""
    def fire(s):
        devs = list(devices) if devices is not None else _world_ranks()
        if n_drop >= len(devs):
            raise ValueError(f"cannot drop {n_drop} of {len(devs)} devices")
        raise DeviceLoss(devs[:-n_drop],
                         f"chaos: {n_drop} device(s) lost at step {s}")
    return _once(step, fire)


def _world_ranks() -> list[int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return list(range(dist.get_world_size()))
    return [0]


def corrupt_checkpoint_tmp(ckpt_dir: str, step: int) -> Hook:
    """Plant the debris of a crash mid-save: a torn `tmp-<step>` staging
    directory (partial arrays file, no manifest) plus a malformed
    `step-garbage` entry.  Never raises: the run must continue, with
    `latest_step` ignoring the garbage and the next gc sweeping the tmp."""
    def fire(s):
        tmp = os.path.join(ckpt_dir, f"tmp-{s}")
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            f.write(b"\x00torn write")
        os.makedirs(os.path.join(ckpt_dir, "step-garbage"), exist_ok=True)
    return _once(step, fire)


def compose(*hooks: Hook) -> Hook:
    def hook(s: int) -> None:
        for h in hooks:
            h(s)
    return hook


def parse(spec: str, ckpt_dir: str | None = None,
          devices: Sequence | None = None, plant: bool = True) -> Hook:
    """`--chaos` grammar -> a composed hook (see module docstring).  With
    `plant` False (a rank that is not the checkpoint's writer) `corrupt`
    is parsed and checked but plants nothing."""
    hooks = []
    for part in spec.split(","):
        kind, _, at = part.strip().partition("@")
        if not at:
            raise ValueError(f"chaos spec {part!r}: expected kind@step")
        if kind == "raise":
            hooks.append(raise_at_step(int(at)))
        elif kind == "kill":
            step_s, _, n_s = at.partition("x")
            hooks.append(drop_device_at_step(int(step_s),
                                             int(n_s) if n_s else 1,
                                             devices=devices))
        elif kind == "corrupt":
            if ckpt_dir is None:
                raise ValueError("chaos 'corrupt' needs the checkpoint dir")
            step = int(at)
            if plant:
                hooks.append(corrupt_checkpoint_tmp(ckpt_dir, step))
        else:
            raise ValueError(f"unknown chaos kind {kind!r} "
                             "(raise | kill | corrupt)")
    return compose(*hooks)
