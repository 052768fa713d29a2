"""Distribution descriptors, port of `repro.core.distribution`: the paper's
D = (D^(0), ..., D^(M-1)) notation (§II-C) as concrete objects shared by the
perf model, the strategy optimizer and the runtime sharding rules.

A `Dist` maps each *logical* tensor dimension of a layer to the mesh axes
that partition it (empty tuple = replicated).  CNN layers use dims
N/H/W/C/F; transformer blocks use N/S (sequence) /HEADS/FFN/EXPERTS/VOCAB.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class Dist:
    name: str
    dims: Mapping[str, tuple[str, ...]]   # logical dim -> mesh axes

    def axes(self, dim: str) -> tuple[str, ...]:
        return tuple(self.dims.get(dim, ()))

    def ways(self, dim: str, mesh_shape: Mapping[str, int]) -> int:
        w = 1
        for a in self.axes(dim):
            w *= mesh_shape[a]
        return w

    def spec(self, *dims: str) -> tuple:
        """The mesh axes of each dim of a tensor whose dims are the given
        logical dims ('_' = replicated dimension), None where replicated:
        the reference's PartitionSpec as a plain tuple."""
        return tuple((self.axes(d) or None) if d != "_" else None
                     for d in dims)

    def local(self, dim: str, size: int, mesh_shape) -> int:
        w = self.ways(dim, mesh_shape)
        assert size % w == 0, f"{dim}={size} not divisible by {w} ({self.name})"
        return size // w

    def same_as(self, other: "Dist") -> bool:
        keys = set(self.dims) | set(other.dims)
        return all(self.axes(k) == other.axes(k) for k in keys)


# --- canonical CNN strategies (paper §III) --------------------------------
def sample(batch_axes=("data",)) -> Dist:
    return Dist("sample", {"N": tuple(batch_axes)})


def spatial(h_axes=("model",), batch_axes=()) -> Dist:
    return Dist("spatial", {"N": tuple(batch_axes), "H": tuple(h_axes)})


def hybrid(batch_axes=("data",), h_axes=("model",)) -> Dist:
    return Dist("hybrid", {"N": tuple(batch_axes), "H": tuple(h_axes)})


def channel_filter(cf_axes=("model",), batch_axes=("data",)) -> Dist:
    """Paper §III-D (sketched there, implemented here as a beyond-paper
    feature): C of the input and F of the output partitioned."""
    return Dist("channel_filter",
                {"N": tuple(batch_axes), "C": tuple(cf_axes),
                 "F": tuple(cf_axes)})


# --- canonical transformer strategies -------------------------------------
def seq_parallel(batch_axes=("data",), seq_axes=("model",)) -> Dist:
    """The paper's spatial parallelism on the sequence dimension."""
    return Dist("seq_parallel", {"N": tuple(batch_axes),
                                 "S": tuple(seq_axes)})


def tensor_parallel(batch_axes=("data",), tp_axes=("model",)) -> Dist:
    """Channel/filter parallelism on heads/ffn (paper §III-D analogue)."""
    return Dist("tensor_parallel", {"N": tuple(batch_axes),
                                    "HEADS": tuple(tp_axes),
                                    "FFN": tuple(tp_axes)})


def expert_parallel(batch_axes=("data",), ep_axes=("model",)) -> Dist:
    return Dist("expert_parallel", {"N": tuple(batch_axes),
                                    "EXPERTS": tuple(ep_axes)})
