"""Shared small utilities (jax-free copies of `repro.utils`)."""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Any, Sequence

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def same_pads(k: int, s: int) -> tuple[int, int]:
    """TF/XLA 'SAME' padding amounts for kernel k, stride s, size % s == 0.
    Asymmetric at stride 2: same_pads(3, 2) == (0, 1)."""
    total = max(k - s, 0)
    lo = total // 2
    return lo, total - lo


def fingerprint(obj: Any) -> str:
    """Short stable content hash of a JSON-able object (dataclasses and
    tuples welcome); equal to `repro.utils.fingerprint` for equal input."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = dataclasses.asdict(obj)
    blob = json.dumps(obj, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f}{unit}"
        n /= 1024.0
    return f"{n:.2f}PiB"


def human_count(n: float) -> str:
    for unit in ("", "K", "M", "B", "T"):
        if abs(n) < 1000.0:
            return f"{n:.2f}{unit}"
        n /= 1000.0
    return f"{n:.2f}Q"


def tree_leaves(tree: Any) -> list:
    """Leaves of a params tree of lists/tuples/dicts, dict keys sorted (the
    order `jax.tree.leaves` uses)."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for t in tree for l in tree_leaves(t)]
    return [tree]


def tree_num_params(tree: Any) -> int:
    """The number of elements over the tree's leaves (tensors, or
    anything with a `numel` or a `size`), as `repro.utils.tree_num_params`
    counts them."""
    return sum(int(l.numel()) if hasattr(l, "numel") else int(l.size)
               for l in tree_leaves(tree))


def load_example(name: str):
    """`examples/<name>.py` of the checkout this package lies in, imported
    as the module `name`, its directory put on `sys.path` (so that its
    functions pickle into spawned ranks)."""
    import importlib
    import os
    import sys
    path = os.path.normpath(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), os.pardir, os.pardir, "examples"))
    if not os.path.isfile(os.path.join(path, f"{name}.py")):
        raise FileNotFoundError(f"no {name}.py under {path}")
    if path not in sys.path:
        sys.path.insert(0, path)
    return importlib.import_module(name)


def tree_map(fn, tree: Any) -> Any:
    """`fn` applied to every leaf, the tree's structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def tree_unflatten(tree: Any, leaves) -> Any:
    """`tree`'s structure with the next of `leaves` (an iterator, in
    `tree_leaves` order) in place of each of its leaves."""
    if isinstance(tree, dict):
        out = {k: tree_unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_unflatten(t, leaves) for t in tree)
    return next(leaves)


def leaves_with_path(tree: Any, path: str = "") -> list[tuple[str, Any]]:
    """(keypath, leaf) of every leaf in `tree_leaves` order, the keypath
    in `jax.tree_util.keystr`'s form: `['key']` for a dict entry, `[i]`
    for a list or tuple item, `.name` for a NamedTuple field."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in leaves_with_path(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f, t in zip(tree._fields, tree)
                for kv in leaves_with_path(t, f"{path}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree)
                for kv in leaves_with_path(t, f"{path}[{i}]")]
    return [(path, tree)]


def assert_no_nans(tree: Any, where: str = "") -> None:
    """AssertionError naming the first leaf that holds a NaN, by its
    keypath (`leaves_with_path`), as `repro.utils.assert_no_nans` does."""
    for path, leaf in leaves_with_path(tree):
        if leaf is None:
            continue
        t = leaf.detach() if isinstance(leaf, torch.Tensor) else \
            torch.as_tensor(leaf)
        if t.is_floating_point() and bool(torch.isnan(t).any()):
            raise AssertionError(f"NaN in {where}{path}")


def trimmed_mean(xs: Sequence[float], trim: float = 0.2) -> float:
    """Mean of `xs` after dropping the `trim` fraction from each tail."""
    xs = sorted(xs)
    k = int(len(xs) * trim)
    kept = xs[k:len(xs) - k] or xs
    return sum(kept) / len(kept)


def _on_cuda(out: Any) -> bool:
    leaves = [l for l in tree_leaves(out) if isinstance(l, torch.Tensor)]
    return bool(leaves) and leaves[0].is_cuda


def _sync(out: Any) -> None:
    if _on_cuda(out):
        torch.cuda.synchronize()


def time_fn(fn, *args, reps: int = 5, warmup: int = 1,
            return_samples: bool = False, host: bool = False):
    """Seconds per call of `fn(*args)`, trimmed mean over `reps` samples.

    When the result lies on the card each sample is taken with CUDA events
    on the current stream (device time, launch queue included); otherwise,
    or with `host`, with the host clock, each call ended by
    `torch.cuda.synchronize()` where the result is on the card (what a
    gloo collective staged through the host takes).  Warmup calls absorb
    kernel builds and autotuning.  With `return_samples` returns
    ``(estimate, samples)``, the per-rep seconds beside the estimate.
    """
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    samples = []
    if _on_cuda(out) and not host:
        torch.cuda.synchronize()
        for _ in range(max(reps, 1)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / 1e3)
    else:
        _sync(out)
        for _ in range(max(reps, 1)):
            t0 = time.perf_counter()
            _sync(fn(*args))
            samples.append(time.perf_counter() - t0)
    est = trimmed_mean(samples)
    return (est, samples) if return_samples else est


def interleaved_samples(fns, reps: int = 5, rounds: int = 4
                        ) -> dict[str, list[float]]:
    """Per-round mean seconds a call of competing zero-argument callables,
    {tag: [round means]}, on the host clock.

    The candidates are timed in alternating rounds (A, B, A, B, ...), so
    load drift during the run hits every one equally; a round of `reps`
    calls ends in `torch.cuda.synchronize()` where the result is on the
    card.  Warm every callable first."""
    samples = {tag: [] for tag in fns}
    for _ in range(rounds):
        for tag, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(max(reps, 1)):
                out = fn()
            _sync(out)
            samples[tag].append((time.perf_counter() - t0) / max(reps, 1))
    return samples


def interleaved_min(fns, reps: int = 5, rounds: int = 4) -> dict[str, float]:
    """{tag: seconds a call}: the minimum over `interleaved_samples`'
    round means, the round the host interfered least with."""
    return {tag: min(ts)
            for tag, ts in interleaved_samples(fns, reps, rounds).items()}


@dataclasses.dataclass(frozen=True)
class Precision:
    """Mixed-precision policy."""
    param_dtype: torch.dtype = torch.float32     # master weights
    compute_dtype: torch.dtype = torch.bfloat16  # activations / conv inputs
    accum_dtype: torch.dtype = torch.float32     # loss / BN stats

    def cast_compute(self, tree):
        """Differentiable cast of every floating leaf to the compute dtype;
        gradients flow back to the master leaves in their own dtype."""
        return tree_map(
            lambda x: x.to(self.compute_dtype)
            if torch.is_floating_point(x) else x, tree)


FP32 = Precision(torch.float32, torch.float32, torch.float32)
BF16 = Precision(torch.float32, torch.bfloat16, torch.float32)


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on.  CUDA is the default of every
    entry point; asking for it where there is none raises (no silent CPU
    path)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            f"False; pass --device cpu / device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev
