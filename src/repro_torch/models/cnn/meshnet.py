"""The paper's mesh-tangling models (§VI), port of
`repro.models.cnn.meshnet`: fully-convolutional VGG-style segmentation of
1024^2 (1K) / 2048^2 (2K) 18-channel inputs, six blocks of three (1K) or
five (2K) conv-BN-ReLU layers with a stride-2 conv at each block head, and
a final 1x1 conv for prediction.

Parameters are a list of dicts in execution order, named as in the
reference (`{"conv": {"w"}, "bn": {"gamma", "beta"}}`, the last layer
`{"conv": {"w"}}`).  `MeshNet` holds them as an `nn.Module` and loads the
reference's params with `params_from_jax`.

`apply` and `loss_fn` take a `core.plan.NetworkPlan` (per-layer
shardings with §III-C reshard points, keyed by the `layer_specs` names),
a single ConvSharding or CFSharding (one for every layer), or a list of
them; the last two are fitted to the layers' geometry first, with a
reshard wherever the fit drops a spatial axis.  `apply` runs the
per-layer callables of `layer_fns`: each layer reshards its input, then
runs conv -> BN -> ReLU, under its name (`core.trace.layer_context`).
A layer whose params a rank holds at rest (each leaf `launch.shardings.
fsdp_tree_specs` cuts held as its block over "data") gathers them where
it runs and reduce-scatters their gradients in its backward
(`shardings.AtUse`); a leaf held whole is used as it is.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.core import trace
from repro_torch.core.perfmodel import ConvLayer
from repro_torch.core.plan import NetworkPlan
from repro_torch.launch import shardings
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


@functools.lru_cache(maxsize=None)
def global_params(cfg: MeshNetConfig) -> list[dict]:
    """`init`'s tree of `cfg` as meta tensors: the global shape of every
    leaf, nothing drawn."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily(), torch.device("meta"):
        return init(torch.Generator(), cfg)


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


def layer_specs(cfg: MeshNetConfig, n: int) -> list[ConvLayer]:
    """Perf-model view (paper §V): one ConvLayer per conv."""
    return [ConvLayer(name, n=n, c=c, h=hw, w=hw, f=f, k=k, s=s)
            for name, c, hw, f, k, s in layer_geometry(cfg)]


def network_plan(cfg: MeshNetConfig, plan, mesh: Mesh | None
                 ) -> NetworkPlan:
    """`plan` as a NetworkPlan over cfg's layers (`NetworkPlan.of`): a
    NetworkPlan as it is; a sharding (None: `ConvSharding()`) or a list of
    them fitted to the layers' geometry on `mesh`."""
    return NetworkPlan.of(plan, specs=layer_specs(cfg, 1), mesh=mesh)


def layer_fns(cfg: MeshNetConfig, plan=None, mesh: Mesh | None = None,
              overlap: bool = True) -> list[tuple]:
    """Execution-order ``(name, fn)`` pairs, ``fn(layer_params, x) -> y``.

    Each fn runs one layer end to end under `trace.layer_context(name)`:
    the §III-C reshard from the previous layer's output sharding into this
    layer's, the conv (stride 2 at each block head), and for body layers
    the reshard to the output sharding, BN (under the conv output's 1x1
    fit, as the reference) and ReLU.  `apply` is the composition of these
    fns, so the whole network and the segmented profiler
    (`core.trace.trace_plan`, which times each fn alone) share one
    definition of a layer.  A layer's params held at rest are gathered
    in its fn (`shardings.AtUse`).  `plan`: see `network_plan`."""
    plan = network_plan(cfg, plan, mesh)
    names = layer_names(cfg)
    shapes = global_params(cfg)

    def held(li, lp, use):
        return use(lp, shardings.held_rest(lp, shapes[li], mesh))

    def body_fn(li, name, stride):
        def fn(lp, x):
            with trace.layer_context(name), shardings.AtUse(mesh) as use:
                lp = held(li, lp, use)
                x = plan.reshard(x, name, mesh,
                                 src=names[li - 1] if li else None)
                x = L.conv_apply(lp["conv"], x, stride=stride,
                                 sharding=plan.sharding(name), mesh=mesh,
                                 overlap=overlap)
                x = plan.reshard_out(x, name, mesh)
                x = L.bn_apply(lp["bn"], x, sharding=L.fitted(
                    plan.out_sharding(name), x, 1, 1, mesh), mesh=mesh,
                    scope=cfg.bn_scope)
                return L.relu(x)
        return fn

    def pred_fn(lp, x):
        with trace.layer_context("pred"), shardings.AtUse(mesh) as use:
            lp = held(len(names) - 1, lp, use)
            x = plan.reshard(x, "pred", mesh, src=names[-2])
            return L.conv_apply(lp["conv"], x, stride=1,
                                sharding=plan.sharding("pred"), mesh=mesh,
                                overlap=overlap)

    fns = [(name, body_fn(li, name, 2 if li % cfg.convs_per_block == 0
                          else 1))
           for li, name in enumerate(names[:-1])]
    return fns + [("pred", pred_fn)]


def apply(params: Sequence[dict], x: torch.Tensor, cfg: MeshNetConfig,
          plan=None, mesh: Mesh | None = None,
          overlap: bool = True) -> torch.Tensor:
    """This rank's block x (N, H, W, C_in), cut by the first layer's
    sharding -> its block of the per-pixel logits (N, H/64, W/64,
    n_classes) under the pred layer's: the `layer_fns` in turn.

    `plan`: see `network_plan`.  `mesh`: the process mesh the plan's axes
    name (None: one device)."""
    fns = layer_fns(cfg, plan, mesh, overlap)
    if len(params) != len(fns):
        raise ValueError(f"{len(params)} layers of params for the "
                         f"{len(fns)} layers of {cfg.name}")
    for (_, fn), lp in zip(fns, params):
        x = fn(lp, x)
    return x


def loss_fn(params: Sequence[dict], batch: dict, cfg: MeshNetConfig,
            plan=None, mesh: Mesh | None = None,
            overlap: bool = True) -> torch.Tensor:
    """Per-pixel sigmoid BCE of the model's logits: this rank's share of
    the global mean.  Its logits are its block under the pred layer's
    sharding, whose blocks tile the global logits once per replica (the
    mesh axes it leaves unassigned), so the global count times the
    replication is the local count times the mesh size.  Summed over the
    ranks (`Mesh.all_reduce`) it is the global mean; its gradient, summed
    over the ranks, is the global mean's."""
    logits = apply(params, batch["image"], cfg, plan, mesh, overlap)
    ranks = 1 if mesh is None else mesh.size
    return bce_sum(logits, batch["label"]) / (logits.numel() * ranks)


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
