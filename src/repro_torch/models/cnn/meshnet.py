"""The paper's mesh-tangling models (§VI), port of
`repro.models.cnn.meshnet`: fully-convolutional VGG-style segmentation of
1024^2 (1K) / 2048^2 (2K) 18-channel inputs, six blocks of three (1K) or
five (2K) conv-BN-ReLU layers with a stride-2 conv at each block head, and
a final 1x1 conv for prediction.

Parameters are a list of dicts in execution order, named as in the
reference (`{"conv": {"w"}, "bn": {"gamma", "beta"}}`, the last layer
`{"conv": {"w"}}`).  `MeshNet` holds them as an `nn.Module` and loads the
reference's params with `params_from_jax`.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.core.spatial_conv import ConvSharding
from repro_torch.launch.mesh import Mesh
from repro_torch.models.cnn import layers as L

VGG_WIDTHS = (64, 128, 256, 512, 512, 512)


@dataclasses.dataclass(frozen=True)
class MeshNetConfig:
    name: str
    input_hw: int = 1024
    in_channels: int = 18
    convs_per_block: int = 3          # 3 for 1K, 5 for 2K
    widths: tuple = VGG_WIDTHS
    n_classes: int = 1                # per-pixel tangling logit
    bn_scope: str = "local"           # paper §III-B default

    @property
    def out_hw(self) -> int:
        return self.input_hw // (2 ** len(self.widths))


MESH1K = MeshNetConfig("mesh1k", input_hw=1024, convs_per_block=3)
MESH2K = MeshNetConfig("mesh2k", input_hw=2048, convs_per_block=5)


def init(gen: torch.Generator, cfg: MeshNetConfig,
         dtype=torch.float32) -> list[dict]:
    """He-normal conv weights from `gen`, BN gamma 1 / beta 0."""
    params = []
    c_in = cfg.in_channels
    for width in cfg.widths:
        for _ in range(cfg.convs_per_block):
            params.append({"conv": L.conv_init(gen, 3, c_in, width, dtype),
                           "bn": L.bn_init(width, dtype)})
            c_in = width
    params.append({"conv": L.conv_init(gen, 1, c_in, cfg.n_classes, dtype)})
    return params


def layer_names(cfg: MeshNetConfig) -> list[str]:
    """Execution-order layer names, as in the reference."""
    return [f"conv{b+1}_{i+1}" for b in range(len(cfg.widths))
            for i in range(cfg.convs_per_block)] + ["pred"]


def layer_geometry(cfg: MeshNetConfig) -> list[tuple]:
    """(name, c_in, hw_in, f, k, stride) of every conv, in execution
    order: the stride-2 conv at each block head, then the 1x1 pred."""
    out, c, hw = [], cfg.in_channels, cfg.input_hw
    names = layer_names(cfg)
    for b, width in enumerate(cfg.widths):
        for i in range(cfg.convs_per_block):
            s = 2 if i == 0 else 1
            out.append((names[len(out)], c, hw, width, 3, s))
            hw //= s
            c = width
    out.append(("pred", c, hw, cfg.n_classes, 1, 1))
    return out


def apply(params: Sequence[dict], x: torch.Tensor, cfg: MeshNetConfig,
          plan: ConvSharding | None = None, mesh: Mesh | None = None,
          overlap: bool = True) -> torch.Tensor:
    """This rank's block x (N, H, W, C_in) -> its block of the per-pixel
    logits (N, H/64, W/64, n_classes).

    `plan`: one ConvSharding for every layer (None: `ConvSharding()`, the
    one-device plan); per-layer plans come with the solver slice.  `mesh`:
    the process mesh the plan's axes name (None: one device).  Each layer
    fits the plan to its global extents (§III-A); BN takes the conv
    output's 1x1 fit, as the reference."""
    sh = plan or ConvSharding()
    for li in range(len(params) - 1):
        lp = params[li]
        stride = 2 if li % cfg.convs_per_block == 0 else 1
        x = L.conv_apply(lp["conv"], x, stride=stride, sharding=sh,
                         mesh=mesh, overlap=overlap)
        x = L.bn_apply(lp["bn"], x, sharding=L.fitted(sh, x, 1, 1, mesh),
                       mesh=mesh, scope=cfg.bn_scope)
        x = L.relu(x)
    return L.conv_apply(params[-1]["conv"], x, stride=1, sharding=sh,
                        mesh=mesh, overlap=overlap)


def loss_fn(params: Sequence[dict], batch: dict, cfg: MeshNetConfig,
            plan: ConvSharding | None = None, mesh: Mesh | None = None,
            overlap: bool = True) -> torch.Tensor:
    """Per-pixel sigmoid BCE of the model's logits: this rank's share of
    the global mean, its local BCE sum over the GLOBAL element count.
    Summed over the ranks (`Mesh.all_reduce`) it is the global mean; its
    gradient, summed over the ranks, is the global mean's."""
    sh = plan or ConvSharding()
    logits = apply(params, batch["image"], cfg, plan, mesh, overlap)
    shards = 1 if mesh is None else \
        mesh.axis_size(tuple(sh.batch_axes) + sh.spatial_axes)
    return bce_sum(logits, batch["label"]) / (logits.numel() * shards)


def bce_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sum of the sigmoid BCE in fp32, written out as the reference does."""
    logits = logits.float()
    bce = torch.clamp_min(logits, 0) - logits * labels \
        + torch.log1p(torch.exp(-logits.abs()))
    return bce.sum()


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid BCE in fp32 (one device)."""
    return bce_sum(logits, labels) / logits.numel()


class MeshNet(nn.Module):
    """The params of one MeshNet as a module: `self.layers[name]` holds a
    `conv` ParameterDict (`w`) and, for body layers, a `bn` ParameterDict
    (`gamma`, `beta`)."""

    def __init__(self, cfg: MeshNetConfig, *, generator: torch.Generator,
                 device: torch.device | str, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleDict()
        for name, lp in zip(layer_names(cfg), init(generator, cfg, dtype)):
            self.layers[name] = nn.ModuleDict({
                k: nn.ParameterDict({pk: nn.Parameter(v.to(device))
                                     for pk, v in sub.items()})
                for k, sub in lp.items()})

    def params(self) -> list[dict]:
        """The parameter tree in the reference's layout (the module's own
        Parameters, not copies)."""
        return [{k: dict(sub.items()) for k, sub in layer.items()}
                for layer in self.layers.values()]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply(self.params(), x, self.cfg)

    @torch.no_grad()
    def params_from_jax(self, tree: Sequence[dict]) -> "MeshNet":
        """Load the reference's param list (numpy arrays, or anything
        `np.asarray` takes) into this module, in place."""
        mine = self.params()
        if len(tree) != len(mine):
            raise ValueError(f"{len(tree)} layers given, {len(mine)} wanted")
        for name, src, dst in zip(self.layers.keys(), tree, mine):
            if set(src) != set(dst):
                raise ValueError(f"layer {name}: keys {sorted(src)} != "
                                 f"{sorted(dst)}")
            for k in dst:
                if set(src[k]) != set(dst[k]):
                    raise ValueError(f"layer {name}.{k}: keys "
                                     f"{sorted(src[k])} != {sorted(dst[k])}")
                for pk, p in dst[k].items():
                    a = np.array(src[k][pk], dtype=np.float32)
                    if a.shape != tuple(p.shape):
                        raise ValueError(f"{name}.{k}.{pk}: shape {a.shape} "
                                         f"!= {tuple(p.shape)}")
                    p.copy_(torch.from_numpy(a))
        return self
