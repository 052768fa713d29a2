"""Architecture registry: `get(name)` -> config; `--arch <id>` everywhere.

Each ported architecture lives in `repro_torch/configs/<id>.py` exposing
CONFIG (full size) and SMOKE (the reference's reduced config for CPU
runs).  The port covers the CNNs (ResNet-50 and the mesh-tangling nets)
and the decoder-only LMs, dense, hybrid, SSM and mixture-of-experts;
the encoder-decoder and the VLM backbone raise until their slice lands.
"""
from __future__ import annotations

import importlib

CNN_ARCHS = ["resnet50", "mesh1k", "mesh2k"]
LM_ARCHS = ["hymba_1_5b", "qwen1_5_0_5b", "gemma2_9b", "qwen2_5_14b",
            "olmo_1b", "mamba2_780m", "mixtral_8x7b", "olmoe_1b_7b"]
NOT_PORTED = ["pixtral_12b", "seamless_m4t_large_v2"]


def canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get(name: str, smoke: bool = False):
    arch = canon(name)
    if arch not in CNN_ARCHS + LM_ARCHS:
        known = arch in NOT_PORTED
        raise ValueError(
            f"arch {name!r} is not ported yet" if known else
            f"unknown arch {name!r}; ported: {CNN_ARCHS + LM_ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.SMOKE if smoke else mod.CONFIG
