"""olmo-1b [dense]: 16L d=2048 16H (kv=16) ff=8192 vocab=50304 —
non-parametric LayerNorm, SwiGLU, untied head.  [arXiv:2402.00838; hf]
The same CONFIG and SMOKE as `repro.configs.olmo_1b`."""
import dataclasses

from repro_torch.models.lm.config import LMConfig

CONFIG = LMConfig(
    name="olmo-1b", family="dense", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, head_dim=128, d_ff=8192, vocab=50_304,
    rope_theta=10_000.0, mlp="swiglu", norm="nonparam_ln",
    tie_embeddings=True)

SMOKE = dataclasses.replace(
    CONFIG, name="olmo-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=256, vocab=256)
