"""Mesh-independent checkpoints with async save and atomic-rename commit,
port of `repro.checkpoint.checkpoint` (numpy and the standard library; a
torch tensor leaf is copied to the host).

Format (schema ``repro/ckpt@1``), the reference's, so a checkpoint either
package writes restores in the other: one directory per step,

  manifest.json    schema, step, a description of the tree, the leaves'
                   global shapes and dtypes, the caller's extras, the
                   solved plan's ``repro/plan@1`` record (or null), time
  arrays.npz       the leaves `a0 … aN` as *global* numpy arrays, in
                   `jax.tree.flatten` order: dict keys sorted, lists and
                   tuples in order, None no leaf

The tree description (`treedef`) is the port's own (`treedef_str`): it
cannot write jax's PyTreeDef string, and neither package parses it on
restore.  Global arrays make a checkpoint mesh-independent: `restore`
hands each leaf back under its template leaf's dtype (and, for a torch
template, on its device), so restoring onto another mesh is the caller
building its template under the plan of that mesh.

The contract `runtime.fault_tolerance` relies on, as in the reference:

  * a save is staged in `<dir>/tmp-<step>` and committed with os.replace
    onto `<dir>/step-<step>`, so a crash mid-save never tears the latest
    good checkpoint;
  * `latest_step` reads only committed `step-<int>` directories; other
    names that start with "step-" are ignored;
  * leftover `tmp-*` directories are swept at construction and on every
    gc pass; `keep` rotates old checkpoints;
  * async mode copies every leaf to host memory on the caller (a real
    copy: the port's optimizer updates its tensors in place, so a view
    would be written with the values of later steps) and writes on a
    daemon thread; a write's error surfaces at the next `save` or `wait`.

On a mesh of processes only one process (mesh rank 0) writes: the others
construct the manager with `writer=False`, which neither sweeps nor
writes and reads what the writer committed.
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
import time
from typing import Any

import numpy as np

SCHEMA = "repro/ckpt@1"

_STEP_RE = re.compile(r"^step-(\d+)$")


class CheckpointError(RuntimeError):
    """A checkpoint cannot be restored into the caller's state template.

    Messages carry the manifest-derived diagnosis (leaf counts, global
    shapes, the recorded plan's mesh) instead of a bare assert, so an
    elastic restart can tell "wrong architecture" from "stale directory".
    """


def flatten(tree: Any) -> list:
    """The leaves of a tree of dicts, lists and tuples in
    `jax.tree.flatten` order: dict keys sorted, None no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for t in tree for l in flatten(t)]
    return [tree]


def unflatten(tree: Any, leaves) -> Any:
    """`tree`'s structure with the next of `leaves` (an iterator) in
    place of each of its leaves."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unflatten(t, leaves) for t in tree)
    return next(leaves)


def treedef_str(tree: Any) -> str:
    """The port's description of a tree's structure: dict keys, lists
    `[...]`, tuples `(...)`, None, a leaf `*`."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {treedef_str(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(treedef_str(t) for t in tree) + "]"
    if isinstance(tree, tuple):
        return "(" + ", ".join(treedef_str(t) for t in tree) + \
            ("," if len(tree) == 1 else "") + ")"
    return "*"


def to_host(x: Any) -> np.ndarray:
    """A numpy copy of a leaf that shares no memory with it."""
    if hasattr(x, "detach"):                      # a torch tensor
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


def _like(arr: np.ndarray, ref: Any) -> Any:
    """`arr` as the template leaf `ref` holds it: a torch template gets a
    tensor of its dtype on its device, anything else a numpy array of its
    dtype."""
    if hasattr(ref, "detach"):
        import torch
        return torch.from_numpy(arr).to(device=ref.device, dtype=ref.dtype)
    return arr.astype(np.asarray(ref).dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True,
                 writer: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self.writer = writer
        os.makedirs(directory, exist_ok=True)
        self._q: queue.Queue = queue.Queue()
        self._worker = None
        self._error: list[BaseException] = []
        self.last_save: dict = {}      # the last save's host copy
        self.last_write_s: float | None = None    # the last write's seconds
        if not writer:
            return
        self.sweep_tmp()
        if async_save:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # ---------------- public API ----------------
    def save(self, step: int, tree: Any, extra: dict | None = None,
             plan: dict | None = None):
        """Checkpoint `tree` at `step` (nothing where this process is not
        the writer).  `plan` (optional) is the solved NetworkPlan spec
        (core.plan.NetworkPlan.to_spec) recorded in the manifest, so a
        restart, possibly on another mesh, can recover the distribution
        strategy the run was executing.  The host copy happens here;
        `last_save` holds its seconds (`copy_s`) and bytes."""
        if not self.writer:
            return
        t0 = time.perf_counter()
        host = [to_host(x) for x in flatten(tree)]      # device->host, sync
        self.last_save = {"step": int(step), "copy_s":
                          time.perf_counter() - t0,
                          "bytes": sum(a.nbytes for a in host)}
        manifest = {
            "schema": SCHEMA,
            "step": int(step),
            "treedef": treedef_str(tree),
            "shapes": [list(a.shape) for a in host],
            "dtypes": [str(a.dtype) for a in host],
            "extra": extra or {},
            "plan": plan,
            "time": time.time(),
        }
        if self.async_save:
            self._raise_pending()
            self._q.put((int(step), host, manifest))
        else:
            self._write(int(step), host, manifest)

    def restore(self, tree_like: Any, step: int | None = None):
        """Restore into the structure of `tree_like`: (tree, manifest), or
        (None, None) where nothing is committed.  Each global array comes
        back under its template leaf's dtype (a torch template's on its
        device too) — whatever mesh the template was built for."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        manifest = self.read_manifest(step)
        path = os.path.join(self.dir, f"step-{step}")
        data = np.load(os.path.join(path, "arrays.npz"))
        leaves = flatten(tree_like)
        plan = manifest.get("plan") or {}
        hint = (f" (checkpoint recorded plan on mesh {plan.get('mesh')})"
                if plan.get("mesh") else "")
        if len(leaves) != len(manifest["shapes"]):
            raise CheckpointError(
                f"step-{step} holds {len(manifest['shapes'])} leaves but "
                f"the restore template has {len(leaves)} — different model/"
                f"optimizer structure, not a mesh change{hint}")
        out = []
        for i, ref in enumerate(leaves):
            arr = data[f"a{i}"]
            if tuple(arr.shape) != tuple(ref.shape):
                raise CheckpointError(
                    f"step-{step} leaf {i}: global shape {tuple(arr.shape)} "
                    f"vs template {tuple(ref.shape)} — checkpoints store "
                    f"GLOBAL arrays, so a mesh change alone cannot cause "
                    f"this; the architecture differs{hint}")
            out.append(_like(arr, ref))
        return unflatten(tree_like, iter(out)), manifest

    def read_manifest(self, step: int | None = None) -> dict | None:
        """The manifest alone (no arrays) — how an elastic restart reads
        the recorded plan spec before building any state."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = os.path.join(self.dir, f"step-{step}", "manifest.json")
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointError(
                f"step-{step} has no readable manifest ({e}) — torn "
                f"checkpoint directory; remove it or restore an earlier "
                f"step") from e

    def latest_step(self) -> int | None:
        return max(self._committed(), default=None)

    def sweep_tmp(self) -> list[str]:
        """Remove leftover `tmp-*` staging directories (a crash mid-save
        abandons them; they are never a valid restore source)."""
        swept = []
        for d in os.listdir(self.dir):
            if d.startswith("tmp-"):
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)
                swept.append(d)
        return swept

    def wait(self):
        """Block until pending async saves are durable."""
        self._q.join()
        self._raise_pending()

    # ---------------- internals ----------------
    def _committed(self) -> list[int]:
        """Committed step numbers; malformed names (step-abc, step-, plain
        files) are ignored instead of crashing the scan."""
        out = []
        for d in os.listdir(self.dir):
            m = _STEP_RE.match(d)
            if m and os.path.isdir(os.path.join(self.dir, d)):
                out.append(int(m.group(1)))
        return out

    def _raise_pending(self):
        if self._error:
            raise self._error.pop()

    def _drain(self):
        while True:
            step, host, manifest = self._q.get()
            try:
                self._write(step, host, manifest)
            except BaseException as e:     # surfaced on next save()/wait()
                self._error.append(e)
            finally:
                self._q.task_done()

    def _write(self, step: int, host, manifest):
        t0 = time.perf_counter()
        tmp = os.path.join(self.dir, f"tmp-{step}")
        final = os.path.join(self.dir, f"step-{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": a for i, a in enumerate(host)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)             # atomic commit
        self._gc()
        self.last_write_s = time.perf_counter() - t0

    def _gc(self):
        self.sweep_tmp()
        steps = sorted(self._committed())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step-{s}"),
                          ignore_errors=True)
