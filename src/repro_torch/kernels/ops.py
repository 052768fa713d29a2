"""Dispatch by the tensor's device: CUDA tensors go to the hand-written
kernel, CPU tensors to its plain version.  There is no other switch and no
fallback between the two."""
from __future__ import annotations

import torch

from repro_torch.kernels import conv2d as _conv
from repro_torch.kernels import ref as _ref


def conv2d(x: torch.Tensor, w: torch.Tensor, *,
           stride: int = 1) -> torch.Tensor:
    """VALID conv, NHWC x HWIO -> NHWC (x's dtype, fp32 accumulation)."""
    if x.is_cuda:
        return _conv.conv2d(x, w, stride=stride)
    if x.device.type == "cpu":
        _conv.check_args(x, w, stride)
        return _ref.conv2d_ref(x, w, stride=stride)
    raise ValueError(f"no conv2d for device {x.device}")


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    _conv.conv2d.launches = 0


def launch_counts() -> dict[str, int]:
    return {"conv2d": _conv.conv2d.launches}
