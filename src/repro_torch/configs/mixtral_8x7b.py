"""mixtral-8x7b [moe]: 32L d=4096 32H (GQA kv=8) ff=14336 vocab=32000,
8 experts top-2, sliding-window attention (4096).  [arXiv:2401.04088; hf]
The same CONFIG and SMOKE as `repro.configs.mixtral_8x7b`."""
import dataclasses

from repro_torch.models.lm.config import LMConfig

CONFIG = LMConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab=32_000,
    rope_theta=1e6, window=4096, layer_pattern="swa", mlp="swiglu",
    norm="rmsnorm", n_experts=8, top_k=2, tie_embeddings=False)

SMOKE = dataclasses.replace(
    CONFIG, name="mixtral-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=96, vocab=256, window=16,
    n_experts=4, top_k=2)
