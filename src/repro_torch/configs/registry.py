"""Architecture registry: `get(name)` -> config; `--arch <id>` everywhere.

Each ported architecture lives in `repro_torch/configs/<id>.py` exposing
CONFIG (full size) and SMOKE (the reference's reduced config for CPU
runs).  The port covers the CNNs (ResNet-50 and the mesh-tangling nets)
and every LM of the reference: decoder-only (dense, hybrid, SSM and
mixture-of-experts), the encoder-decoder (seamless-m4t-large-v2) and the
VLM backbone with its patch-prefix frontend (pixtral-12b).

`ARCHS` (the LMs, in the reference's order), `CNN_ARCHS`, `SHAPES` (the
LM cells of the dry run: sequence, global batch, kind),
`FULL_ATTN_500K` and `SOLVABLE_ARCHS` are the reference's; `canon` maps
every alias the reference's does to the same id.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "gemma2_9b", "qwen2_5_14b", "qwen1_5_0_5b", "olmo_1b", "mixtral_8x7b",
    "olmoe_1b_7b", "hymba_1_5b", "pixtral_12b", "mamba2_780m",
    "seamless_m4t_large_v2",
]
CNN_ARCHS = ["resnet50", "mesh1k", "mesh2k"]

# the archs the §V-C strategy optimizer can solve (--strategy auto,
# calibrate, --mem-limit): the CNN family; the LMs train under the uniform
# sharding only
SOLVABLE_ARCHS = list(CNN_ARCHS)

_ALIASES = {a.replace("_", "-"): a for a in ARCHS + CNN_ARCHS}
_ALIASES.update({
    "gemma2-9b": "gemma2_9b", "qwen2.5-14b": "qwen2_5_14b",
    "qwen1.5-0.5b": "qwen1_5_0_5b", "olmo-1b": "olmo_1b",
    "mixtral-8x7b": "mixtral_8x7b", "olmoe-1b-7b": "olmoe_1b_7b",
    "hymba-1.5b": "hymba_1_5b", "pixtral-12b": "pixtral_12b",
    "mamba2-780m": "mamba2_780m",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
})

# the LM family's dry-run cells (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

# archs whose 500K-token prefill is quadratic (pure full attention at long
# range); their long_500k decode cell runs but is flagged
FULL_ATTN_500K = {"qwen2_5_14b", "qwen1_5_0_5b", "olmo_1b", "olmoe_1b_7b",
                  "pixtral_12b", "seamless_m4t_large_v2"}


def canon(name: str) -> str:
    """The arch id of `name`: the reference's aliases, else `name` with
    "-" and "." read as "_"."""
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get(name: str, smoke: bool = False):
    arch = canon(name)
    if arch not in CNN_ARCHS + ARCHS:
        raise ValueError(f"unknown arch {name!r}; ported: "
                         f"{CNN_ARCHS + ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.SMOKE if smoke else mod.CONFIG
