"""Data pipeline, port of `repro.data.pipeline`: deterministic per-step
synthetic batches (bit-identical numpy), a step-addressable prefetch
thread, and the copy of a batch to the device.

The paper benchmarks the mesh-tangling problem on synthetic data (§VI);
these batches match its shapes.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable

import numpy as np
import torch


def synthetic_mesh_batch(step: int, batch: int, hw: int, channels: int = 18,
                         out_hw: int | None = None) -> dict:
    """Mesh-tangling lookalike: random fields (state variables) and a
    per-pixel tangle mask on the prediction grid."""
    rng = np.random.default_rng(1234 + step)
    x = rng.standard_normal((batch, hw, hw, channels), dtype=np.float32)
    out_hw = out_hw or hw // 64
    y = (rng.random((batch, out_hw, out_hw, 1)) < 0.1).astype(np.float32)
    return {"image": x, "label": y}


def synthetic_imagenet_batch(step: int, batch: int, hw: int = 224,
                             n_classes: int = 1000) -> dict:
    """ImageNet-shaped batch: standard-normal NHWC RGB images and uniform
    class labels (N,)."""
    rng = np.random.default_rng(4321 + step)
    x = rng.standard_normal((batch, hw, hw, 3), dtype=np.float32)
    y = rng.integers(0, n_classes, size=(batch,), dtype=np.int32)
    return {"image": x, "label": y}


def synthetic_lm_batch(step: int, batch: int, seq: int, vocab: int) -> dict:
    """Uniform random token ids; labels are the tokens shifted by one."""
    rng = np.random.default_rng(9876 + step)
    tokens = rng.integers(0, vocab, size=(batch, seq + 1), dtype=np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def shard_dim(a, dim: int, mesh, axis):
    """This rank's block of `a` (a numpy array or a tensor) along `dim`
    over a (possibly product) axis: shard `mesh.index(axis)` of
    `mesh.axis_size(axis)` equal ones, a view."""
    m = mesh.axis_size(axis)
    if a.shape[dim] % m:
        raise ValueError(f"extent {a.shape[dim]} of dim {dim} does not "
                         f"divide over {axis} ({m} shards)")
    n = a.shape[dim] // m
    i = mesh.index(axis)
    return a[(slice(None),) * dim + (slice(i * n, (i + 1) * n),)]


def shard_batch(batch: dict, mesh, sharding, label_sharding=None) -> dict:
    """This rank's block of a global CNN batch.

    Every rank draws the same global batch and keeps its block, so a step
    sees the same data on any mesh.  The image is cut by `sharding` as
    given (the first layer's fitted sharding: N, H, W and, under a
    CFSharding, C); the labels as the output they are compared with is,
    by `label_sharding` (default `sharding`): a per-pixel label grid
    (N, H, W, 1) fitted 1x1 to the grid, class labels (N,) along its batch
    axes (in the reference GSPMD cuts them).  Blocks are contiguous
    copies."""
    if mesh is None:
        return batch
    out = {}
    for k, v in batch.items():
        sh = sharding if k == "image" else label_sharding or sharding
        if k != "image" and v.ndim == 4:
            sh = sh.fit(v.shape[1], v.shape[2], 1, 1, dict(mesh.shape))
        for dim, axes in enumerate(sh.x_spec()[:v.ndim]):
            if axes:
                v = shard_dim(v, dim, mesh, axes)
        out[k] = np.ascontiguousarray(v)
    return out


def shard_lm_batch(batch: dict, mesh, seq_axis="model",
                   batch_axes=("pod", "data")) -> dict:
    """This rank's block of a global token batch (`synthetic_lm_batch`'s,
    with an encoder-decoder's `frames` (B, S_enc, d) or a VLM's
    `patch_embeds` (B, S_img, d)): B over the batch axes of the mesh, S
    over `seq_axis`, contiguous copies (the reference's `P(batch_axes,
    "model")` placement).  Every rank draws the same global batch, so a
    step sees the same tokens on any mesh.

    A patch prefix is part of the sequence that is split, as the
    reference concatenates it in the global view: the prefix + text
    sequence of S_img + S positions is cut into equal blocks, and each
    rank gets the prefix rows (`patch_embeds`) and the text tokens
    (`tokens`) of its block, either possibly empty, and its block of the
    labels with -1 (unscored) over the prefix."""
    if mesh is None:
        return batch
    ba = tuple(a for a in batch_axes if a in mesh.axis_names)
    out = {}
    for k, v in batch.items():
        if ba:
            v = shard_dim(v, 0, mesh, ba)
        out[k] = v
    if seq_axis is not None:
        prefix = _prefix_block(out, mesh, seq_axis) \
            if "patch_embeds" in out else {}
        out = {k: prefix[k] if k in prefix else
               shard_dim(v, 1, mesh, seq_axis) for k, v in out.items()}
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def _prefix_block(batch: dict, mesh, seq_axis) -> dict:
    """This rank's block along `seq_axis` of the prefix + text sequence:
    its rows of `patch_embeds`, of `tokens` and of the labels preceded by
    -1 over the prefix."""
    n_img = batch["patch_embeds"].shape[1]
    total = n_img + batch["tokens"].shape[1]
    m = mesh.axis_size(seq_axis)
    if total % m:
        raise ValueError(f"prefix {n_img} + text "
                         f"{batch['tokens'].shape[1]} does not divide over "
                         f"{seq_axis} ({m} shards)")
    lo = mesh.index(seq_axis) * (total // m)
    hi = lo + total // m
    labels = np.concatenate([np.full(batch["labels"].shape[:1] + (n_img,), -1,
                                     batch["labels"].dtype),
                             batch["labels"]], axis=1)
    return {"patch_embeds": batch["patch_embeds"][:, min(lo, n_img):
                                                  min(hi, n_img)],
            "tokens": batch["tokens"][:, max(lo - n_img, 0):
                                      max(hi - n_img, 0)],
            "labels": labels[:, lo:hi]}


def to_device(batch: dict, device: torch.device) -> dict:
    """numpy batch -> tensors on `device`; to the card through pinned host
    memory with a non-blocking copy on the current stream."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


class Prefetcher:
    """Double-buffered host-side prefetch of a step-indexed batch factory.

    Queue entries are tagged with their step index and `get(step)` is
    step-addressable: a request behind the stream restarts the filler
    thread at that step, one ahead of it skips stale entries.
    """

    DEPTH = 2     # batches made ahead

    def __init__(self, make_batch: Callable[[int], dict], start_step: int = 0):
        self._make = make_batch
        self._start(start_step)

    def _start(self, step: int):
        self._q: queue.Queue = queue.Queue(maxsize=self.DEPTH)
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._fill,
                                   args=(step, self._q, self._stop),
                                   daemon=True)
        self._t.start()

    def _fill(self, s: int, q: queue.Queue, stop: threading.Event):
        while not stop.is_set():
            item = (s, self._make(s))
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue
            s += 1

    def seek(self, step: int):
        """Restart the stream at `step`."""
        self.close()
        self._start(step)

    def get(self, step: int) -> dict:
        """The batch for exactly `step`."""
        while True:
            s, b = self._q.get()
            if s == step:
                return b
            if s > step:
                self.seek(step)

    def close(self):
        """Stop the filler thread and wait for it (at most one batch)."""
        self._stop.set()
        self._t.join(timeout=60)
