"""hymba-1.5b [hybrid]: 32L d=1600 25H (GQA kv=5) ff=5504 vocab=32001,
ssm_state=16 — parallel attention + mamba heads in every block; full
attention on layers {0, mid, last}, SWA elsewhere.  [arXiv:2411.13676; hf]
The same CONFIG and SMOKE as `repro.configs.hymba_1_5b`."""
import dataclasses

from repro_torch.models.lm.config import LMConfig

CONFIG = LMConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, head_dim=64, d_ff=5504, vocab=32_001,
    rope_theta=10_000.0, window=1024, layer_pattern="hymba", mlp="swiglu",
    norm="rmsnorm", ssm_state=16, ssm_expand=2, ssm_head_dim=64,
    tie_embeddings=True)

SMOKE = dataclasses.replace(
    CONFIG, name="hymba-smoke", n_layers=5, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab=256, window=16,
    ssm_state=8, ssm_head_dim=16)
