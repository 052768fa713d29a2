"""ResNet-50 (He et al.) for ImageNet-1K, the paper's §VI-B2 workload, port
of `repro.models.cnn.resnet`.

Parameters are the reference's tree: `conv1` {w}, `bn1` {gamma, beta},
`blocks` (a list of bottlenecks, each `conv1`/`bn1`, `conv2`/`bn2`,
`conv3`/`bn3` and, where the block changes the channel count or strides,
`proj`/`bn_proj`) and `head` {w, b}.  `ResNet` holds them as an
`nn.Module` and loads the reference's params with `params_from_jax`.

`apply` and `loss_fn` take a `core.plan.NetworkPlan` keyed by the names
`layer_specs` and `resnet_graph` give every conv and the pool (`conv1`,
`pool1`, `res{s}{b}_branch2a|2b|2c`, `res{s}{b}_branch1`), or one
ConvSharding / CFSharding for every layer (fitted to each layer's
geometry).  The reference lets GSPMD find where each tensor comes from;
here every reshard names its producer: a block's `2a` and `branch1` take
the block input (the previous block's `2c` output, or `pool1`'s), `2b`
takes `2a`'s output and `2c` `2b`'s, and the shortcut (identity or
`branch1`) moves to `2c`'s output sharding before the add.  `flow` reads
these sources off `resnet_graph`, and `apply` takes them from there.

`resnet_graph` exports the branchy layer DAG (`core.dag.DiGraph`) that
the strategy optimizer's longest-path-first pass solves (§V-C).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn

from repro_torch.core import dag
from repro_torch.core.perfmodel import ConvLayer
from repro_torch.core.plan import NetworkPlan, compile_order
from repro_torch.launch.mesh import Mesh
from repro_torch.models.cnn import layers as L

STAGES = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)
EXPANSION = 4


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet50"
    input_hw: int = 224
    in_channels: int = 3
    n_classes: int = 1000
    stages: tuple = STAGES
    widths: tuple = WIDTHS
    bn_scope: str = "local"


RESNET50 = ResNetConfig()


def _blocks(cfg: ResNetConfig):
    """(name prefix, c_in, width, stride, hw_in) of every bottleneck."""
    c_in, hw = 64, cfg.input_hw // 4         # conv1 /2, pool1 /2
    for s, (n_blocks, width) in enumerate(zip(cfg.stages, cfg.widths)):
        for b in range(n_blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            yield f"res{s+2}{chr(ord('a')+b)}_branch", c_in, width, stride, hw
            hw //= stride
            c_in = width * EXPANSION


def _has_proj(c_in: int, width: int, stride: int) -> bool:
    """The projection rule: a channel change or a stride."""
    return c_in != width * EXPANSION or stride != 1


def _bottleneck_init(gen, c_in, width, stride, dtype):
    p = {"conv1": L.conv_init(gen, 1, c_in, width, dtype),
         "bn1": L.bn_init(width, dtype),
         "conv2": L.conv_init(gen, 3, width, width, dtype),
         "bn2": L.bn_init(width, dtype),
         "conv3": L.conv_init(gen, 1, width, width * EXPANSION, dtype),
         "bn3": L.bn_init(width * EXPANSION, dtype)}
    if _has_proj(c_in, width, stride):
        p["proj"] = L.conv_init(gen, 1, c_in, width * EXPANSION, dtype)
        p["bn_proj"] = L.bn_init(width * EXPANSION, dtype)
    return p


def init(gen: torch.Generator, cfg: ResNetConfig = RESNET50,
         dtype=torch.float32) -> dict:
    """He-normal conv weights and the head from `gen`, BN gamma 1 /
    beta 0, in the reference's tree."""
    params = {"conv1": L.conv_init(gen, 7, cfg.in_channels, 64, dtype),
              "bn1": L.bn_init(64, dtype), "blocks": []}
    c_out = 64
    for _, c_in, width, stride, _ in _blocks(cfg):
        params["blocks"].append(
            _bottleneck_init(gen, c_in, width, stride, dtype))
        c_out = width * EXPANSION
    params["head"] = L.dense_init(gen, c_out, cfg.n_classes, dtype)
    return params


# ---------------------------------------------------------------------------
# perf-model / strategy views
# ---------------------------------------------------------------------------

def layer_specs(n: int, cfg: ResNetConfig = RESNET50) -> list[ConvLayer]:
    """The main path's convs and the pool in execution order (the line
    the perf model costs; the projections are `resnet_graph`'s)."""
    out = [ConvLayer("conv1", n=n, c=cfg.in_channels, h=cfg.input_hw,
                     w=cfg.input_hw, f=64, k=7, s=2),
           ConvLayer("pool1", n=n, c=64, h=cfg.input_hw // 2,
                     w=cfg.input_hw // 2, f=64, k=3, s=2, kind="pool")]
    for pre, c_in, width, stride, hw in _blocks(cfg):
        hw2 = hw // stride
        out += [ConvLayer(pre + "2a", n=n, c=c_in, h=hw, w=hw, f=width,
                          k=1, s=1),
                ConvLayer(pre + "2b", n=n, c=width, h=hw, w=hw, f=width,
                          k=3, s=stride),
                ConvLayer(pre + "2c", n=n, c=width, h=hw2, w=hw2,
                          f=width * EXPANSION, k=1, s=1)]
    return out


def resnet_graph(n: int, cfg: ResNetConfig = RESNET50) -> dag.DiGraph:
    """Branchy DAG (residual shortcuts included) for §V-C longest-path-
    first, built in the reference's node and edge order."""
    g = dag.DiGraph()
    specs = layer_specs(n, cfg)
    g.add_node("conv1", layer=specs[0])
    g.add_node("pool1", layer=specs[1])
    g.add_edge("conv1", "pool1")
    prev, i = "pool1", 2
    for pre, c_in, width, stride, hw in _blocks(cfg):
        names = [specs[i + j].name for j in range(3)]
        for j in range(3):
            g.add_node(names[j], layer=specs[i + j])
        g.add_edge(prev, names[0])
        g.add_edge(names[0], names[1])
        g.add_edge(names[1], names[2])
        if _has_proj(c_in, width, stride):
            pname = pre + "1"
            g.add_node(pname, layer=ConvLayer(
                pname, n=n, c=c_in, h=hw, w=hw, f=width * EXPANSION, k=1,
                s=stride))
            g.add_edge(prev, pname)
            g.add_edge(pname, names[2])
        prev = names[2]
        i += 3
    return g


def all_specs(n: int, cfg: ResNetConfig = RESNET50) -> list[ConvLayer]:
    """Every layer a plan holds: the main path, then the projections in
    graph order (`core.plan.compile_order`)."""
    return compile_order(resnet_graph(n, cfg), layer_specs(n, cfg))


@functools.lru_cache(maxsize=None)
def flow(cfg: ResNetConfig = RESNET50) -> tuple[tuple[str, str, str], ...]:
    """The tensors that move between layers, read off `resnet_graph`:
    (src, name, "in") where layer `src`'s output feeds layer `name`,
    (src, name, "add") where a shortcut made by `src` joins `name`'s
    output.  An edge into a 2c from other than its 2b is the projection
    shortcut; a 2c whose only predecessor is its 2b adds the block input
    (what feeds its 2a).  `apply` takes every source from here, and so
    does `NetworkPlan.reshard_report`."""
    g = resnet_graph(1, cfg)
    out = []
    for u, v in g.edges:
        if not v.endswith("2c") or u == v[:-1] + "b":
            out.append((u, v, "in"))
        else:
            out.append((u, v, "add"))
        if v.endswith("2c") and list(g.predecessors(v)) == [u]:
            out += [(x, v, "add") for x in g.predecessors(v[:-1] + "a")]
    return tuple(out)


def _sources(cfg: ResNetConfig) -> dict[tuple[str, str], str]:
    """{(layer, "in" | "add"): the layer whose output it takes}."""
    return {(v, kind): u for u, v, kind in flow(cfg)}


def last_layer(cfg: ResNetConfig = RESNET50) -> str:
    """The conv whose output sharding the head's input has."""
    return list(_blocks(cfg))[-1][0] + "2c"


def network_plan(cfg: ResNetConfig, plan, mesh: Mesh | None) -> NetworkPlan:
    """`plan` as a NetworkPlan over cfg's layers (`NetworkPlan.of`): a
    NetworkPlan as it is; a sharding (None: `ConvSharding()`) fitted to
    every layer's geometry on `mesh`, with the reshards flagged against
    the graph."""
    if isinstance(plan, NetworkPlan):
        return plan
    return NetworkPlan.of(plan, specs=all_specs(1, cfg), mesh=mesh,
                          graph=resnet_graph(1, cfg))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _bottleneck_apply(p, x, *, pre, src, stride, plan: NetworkPlan, mesh,
                      scope, overlap):
    """`pre` is the block's name prefix (e.g. "res3a_branch"): convs are
    named pre+"2a"/"2b"/"2c" and the projection pre+"1", as in
    `resnet_graph`.  `src` maps (layer, "in" | "add") to the layer whose
    output sharding that layer's input, or its shortcut, has (`flow`)."""
    def conv(name, pp, z, s):
        z = plan.reshard(z, name, mesh, src=src[name, "in"])
        z = L.conv_apply(pp, z, stride=s, sharding=plan.sharding(name),
                         mesh=mesh, overlap=overlap)
        return plan.reshard_out(z, name, mesh)

    def bn(name, pp, z):
        return L.bn_apply(pp, z, sharding=L.fitted(
            plan.out_sharding(name), z, 1, 1, mesh), mesh=mesh, scope=scope)

    y = L.relu(bn(pre + "2a", p["bn1"], conv(pre + "2a", p["conv1"], x, 1)))
    y = L.relu(bn(pre + "2b", p["bn2"], conv(pre + "2b", p["conv2"], y,
                                             stride)))
    y = bn(pre + "2c", p["bn3"], conv(pre + "2c", p["conv3"], y, 1))
    if "proj" in p:
        x = bn(pre + "1", p["bn_proj"], conv(pre + "1", p["proj"], x,
                                             stride))
    x = plan.reshard_add(x, src[pre + "2c", "add"], pre + "2c", mesh)
    return L.relu(x + y)


def apply(params: dict, x: torch.Tensor, cfg: ResNetConfig = RESNET50,
          plan=None, mesh: Mesh | None = None,
          overlap: bool = True) -> torch.Tensor:
    """This rank's block x (N, H, W, 3), cut by conv1's sharding -> the
    logits (N, n_classes) of its samples under the last conv's batch
    axes (every channel on every rank).

    `plan`: see `network_plan`.  `mesh`: the process mesh the plan's axes
    name (None: one device)."""
    plan = network_plan(cfg, plan, mesh)
    x = L.conv_apply(params["conv1"], x, stride=2,
                     sharding=plan.sharding("conv1"), mesh=mesh,
                     overlap=overlap)
    x = plan.reshard_out(x, "conv1", mesh)
    x = L.relu(L.bn_apply(params["bn1"], x, sharding=L.fitted(
        plan.out_sharding("conv1"), x, 1, 1, mesh), mesh=mesh,
        scope=cfg.bn_scope))
    src = _sources(cfg)
    x = plan.reshard(x, "pool1", mesh, src=src["pool1", "in"])
    x = L.max_pool(x, window=3, stride=2, sharding=plan.sharding("pool1"),
                   mesh=mesh)
    for p, (pre, _, _, stride, _) in zip(params["blocks"], _blocks(cfg)):
        x = _bottleneck_apply(p, x, pre=pre, src=src, stride=stride,
                              plan=plan, mesh=mesh, scope=cfg.bn_scope,
                              overlap=overlap)
    x = L.global_avg_pool(x, sharding=L.fitted(
        plan.out_sharding(last_layer(cfg)), x, 1, 1, mesh), mesh=mesh)
    return L.dense_apply(params["head"], x)


def nll_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sum over the samples of the log-softmax NLL, in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None]).sum()


def loss_fn(params: dict, batch: dict, cfg: ResNetConfig = RESNET50,
            plan=None, mesh: Mesh | None = None,
            overlap: bool = True) -> torch.Tensor:
    """Softmax cross-entropy of the logits: this rank's share of the
    global mean.  Its logits are its samples under the last conv's batch
    axes, replicated over the other mesh axes, so the global count times
    the replication is the local count times the mesh size (as
    `meshnet.loss_fn`); summed over the ranks it is the global mean, and
    its gradient, summed over the ranks, the global mean's."""
    logits = apply(params, batch["image"], cfg, plan, mesh, overlap)
    ranks = 1 if mesh is None else mesh.size
    return nll_sum(logits, batch["label"]) / (logits.shape[0] * ranks)


class ResNet(nn.Module):
    """The params of one ResNet as a module, in the reference's tree:
    `conv1`, `bn1`, `head` ParameterDicts and `blocks`, a ModuleList of
    ModuleDicts of ParameterDicts."""

    def __init__(self, cfg: ResNetConfig = RESNET50, *,
                 generator: torch.Generator, device: torch.device | str,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        tree = init(generator, cfg, dtype)

        def pd(sub):
            return nn.ParameterDict({k: nn.Parameter(v.to(device))
                                     for k, v in sub.items()})
        self.conv1, self.bn1, self.head = (pd(tree[k]) for k in
                                           ("conv1", "bn1", "head"))
        self.blocks = nn.ModuleList(
            nn.ModuleDict({k: pd(sub) for k, sub in b.items()})
            for b in tree["blocks"])

    def params(self) -> dict:
        """The parameter tree in the reference's layout (the module's own
        Parameters, not copies)."""
        return {"conv1": dict(self.conv1.items()),
                "bn1": dict(self.bn1.items()),
                "blocks": [{k: dict(sub.items()) for k, sub in b.items()}
                           for b in self.blocks],
                "head": dict(self.head.items())}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply(self.params(), x, self.cfg)

    @torch.no_grad()
    def params_from_jax(self, tree: dict) -> "ResNet":
        """Load the reference's param tree (numpy arrays, or anything
        `np.asarray` takes) into this module, in place."""
        def load(path, src, dst):
            if isinstance(dst, torch.Tensor):
                a = np.array(src, dtype=np.float32)
                if a.shape != tuple(dst.shape):
                    raise ValueError(f"{path}: shape {a.shape} != "
                                     f"{tuple(dst.shape)}")
                dst.copy_(torch.from_numpy(a))
            elif isinstance(dst, dict):
                if set(src) != set(dst):
                    raise ValueError(f"{path}: keys {sorted(src)} != "
                                     f"{sorted(dst)}")
                for k in dst:
                    load(f"{path}.{k}", src[k], dst[k])
            else:
                if len(src) != len(dst):
                    raise ValueError(f"{path}: {len(src)} entries given, "
                                     f"{len(dst)} wanted")
                for i, (a, b) in enumerate(zip(src, dst)):
                    load(f"{path}[{i}]", a, b)
        load("params", tree, self.params())
        return self
