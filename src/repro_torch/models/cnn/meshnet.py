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


def apply(params: Sequence[dict], x: torch.Tensor, cfg: MeshNetConfig,
          plan: ConvSharding | None = None) -> torch.Tensor:
    """x: (N, H, W, C_in) -> per-pixel logits (N, H/64, W/64, n_classes).

    `plan`: one ConvSharding for every layer (None: `ConvSharding()`, the
    one-device plan).  Per-layer plans come with the solver slice."""
    sh = plan or ConvSharding()
    for li in range(len(params) - 1):
        lp = params[li]
        stride = 2 if li % cfg.convs_per_block == 0 else 1
        x = L.conv_apply(lp["conv"], x, stride=stride, sharding=sh)
        x = L.bn_apply(lp["bn"], x, sharding=sh, scope=cfg.bn_scope)
        x = L.relu(x)
    return L.conv_apply(params[-1]["conv"], x, stride=1, sharding=sh)


def loss_fn(params: Sequence[dict], batch: dict, cfg: MeshNetConfig,
            plan: ConvSharding | None = None) -> torch.Tensor:
    """Per-pixel sigmoid BCE of the model's logits."""
    return bce_loss(apply(params, batch["image"], cfg, plan), batch["label"])


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid BCE in fp32, written out as the reference does."""
    logits = logits.float()
    bce = torch.clamp_min(logits, 0) - logits * labels \
        + torch.log1p(torch.exp(-logits.abs()))
    return bce.mean()


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
