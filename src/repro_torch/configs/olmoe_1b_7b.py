"""olmoe-1b-7b [moe]: 16L d=2048 16H (kv=16) expert ff=1024 vocab=50304,
64 experts top-8.  [arXiv:2409.02060; hf]
The same CONFIG and SMOKE as `repro.configs.olmoe_1b_7b`."""
import dataclasses

from repro_torch.models.lm.config import LMConfig

CONFIG = LMConfig(
    name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1024, vocab=50_304,
    rope_theta=10_000.0, mlp="swiglu", norm="rmsnorm",
    n_experts=64, top_k=8, tie_embeddings=True)

SMOKE = dataclasses.replace(
    CONFIG, name="olmoe-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=64, vocab=256, n_experts=8, top_k=2)
